"""The plan-program megakernel: one launch runs a whole ``PlanProgram``.

Port of ``repro/kernels/plan_program_kernel.py`` (``plan_program_pallas``);
the kernel is ``csrc/plan_program.cu``, a bytecode VM over a register
file, in one of two layouts: ``word`` (one uint32 a lane a row, any
program) and ``packed`` (32 lanes a word, for the programs
``core.plan_program.bit_sliceable`` admits).  The packed layout keeps
its file in shared memory; the word layout keeps it there where one
lane's file fits the opt-in and in a global scratch tensor otherwise
(``register_file``), which the TPU kernel, with its file in VMEM, never
needed to choose.  The word layout walks, in each step, only the rows
the step may change and, in each row, only its live selects
(``core.plan_program.word_tables``), where the TPU kernel walks every
row at its plan's widest.  Its plain versions are
``kernels.ref.plan_program_vm`` (the program's semantics),
``kernels.ref.plan_program_rows`` (the word layout's walk on its own
tables) and ``kernels.ref.plan_program_packed`` (the packed layout's
arithmetic on its tables).  ``OPCODES`` numbers the step stream in the
same order as the reference, and ``control_digest`` salts the digest of
a program's control state with that numbering.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.core import integrity
from repro_torch.kernels import _build
from repro_torch.kernels._build import KernelLaunchError

OPCODES = ("permute", "xor", "and", "andn", "add", "rotlv", "xor_const",
           "eq_const")
LAYOUTS = ("packed", "word")

# Shared memory an sm_90 block may opt in to: the packed layout's whole
# footprint (control blob and register file) must fit it.
PACKED_SMEM_BYTES = 232448

# Where the word layout keeps its register file; ``LAYOUT_LAUNCHES``
# counts a launch under "packed", "word" (shared) or "word_global".
PLACEMENTS = ("shared", "global")
# The global placement indexes one CTA's file with 32-bit word offsets.
GLOBAL_FILE_WORDS = 2**31 - 1

LAUNCHES = {"plan_program": 0}
LAYOUT_LAUNCHES = {"packed": 0, "word": 0, "word_global": 0}
_LOCK = threading.Lock()


def control_digest(steps, consts, plan_parts=()) -> str:
    """Content digest of one program's kernel-visible control state,
    salted with the opcode numbering."""
    return integrity.content_digest(
        ("|".join(OPCODES), steps, consts) + tuple(plan_parts))


def register_file(n: int, n_regs: int, smem_bytes: int,
                  lanes: int = 1) -> str:
    """Where the word layout keeps a CTA's register files — n_regs
    registers plus one scratch register, n uint32 rows each, a lane:
    ``"shared"`` when ``lanes`` lanes' files fit the shared memory a block
    may opt in to, else ``"global"`` (a scratch tensor allocated for the
    launch, one slab a CTA) while one lane's file stays within the
    kernel's 32-bit word offsets.  Raises ``ValueError`` past both."""
    words = (n_regs + 1) * n
    if words * 4 * lanes <= smem_bytes:
        return "shared"
    if words <= GLOBAL_FILE_WORDS:
        return "global"
    raise ValueError(
        f"one lane of an n={n}, n_regs={n_regs} program needs a "
        f"{words * 4}-byte register file: over the {smem_bytes} bytes of "
        f"shared memory a block may use and over the {GLOBAL_FILE_WORDS} "
        "words a CTA's global file may index")


def lanes_per_cta(n: int, n_regs: int, d: int, smem_bytes: int, *,
                  sms: int = 1) -> int:
    """Lanes each CTA owns in the word layout: a power of two (the kernel
    finds a thread's lane by shifts), the fewest that run all ``d`` lanes
    in one wave of ``sms`` CTAs (the card's SMs), capped at the power of
    two that covers ``d`` and at the global file's word offsets.  A step
    costs a CTA a chain of dependent loads and a barrier whatever its
    lanes (each thread takes V = 4 lanes of a row at once), so a second
    wave costs more than wider CTAs: GCM's 1024 records of 64 B ran 1.65
    ms at 8 lanes a CTA (128 CTAs, files in global memory) against 2.12
    ms at the 4 whose files fit shared memory (256 CTAs, two waves), 256
    of 1 KiB 10.36 against 18.00 ms (NVIDIA H100, ``chip_smoke.py``'s
    ``gcm_phase``).  The placement follows the lanes
    (``register_file(..., lanes)``).  Raises where ``register_file``
    does."""
    words = (n_regs + 1) * n
    register_file(n, n_regs, smem_bytes)
    lanes = 1
    while (lanes < d and -(-d // lanes) > sms
           and 2 * lanes * words <= GLOBAL_FILE_WORDS):
        lanes *= 2
    return lanes


_SMS: dict = {}


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def word_threads(n: int, lanes: int) -> int:
    """Threads of a word-layout CTA: one a V-word group of a row (V = 4
    lanes, or fewer when the CTA has fewer), a power of two (a group's
    owner thread is its index masked) from 32 to 1024."""
    groups = n * lanes // min(lanes, 4)
    return min(1024, max(32, 1 << (max(groups, 1) - 1).bit_length()))


def packed_threads(n: int) -> int:
    """Threads of a packed CTA: a warp per 32 rows, at most 1024."""
    return min(1024, 32 * -(-max(n, 1) // 32))


def packed_smem_words(n: int, n_phys: int, blob_words: int) -> int:
    """Shared memory of a packed CTA before its state staging, in words:
    the control blob and n_phys registers of n + 1 words, 16-B aligned."""
    return blob_words + -(-n_phys * (n + 1) // 4) * 4


def packed_chunk(n: int, n_phys: int, blob_words: int,
                 smem_bytes: int) -> int:
    """Rows of state a packed CTA stages at a time (128 B each) in the
    shared memory left behind its control and registers: as few chunks as
    fit, of equal size.  Raises when not one row fits."""
    fit = (smem_bytes // 4 - packed_smem_words(n, n_phys, blob_words)) // 32
    if fit < 1:
        raise ValueError(f"packed layout needs more than {smem_bytes} bytes "
                         "of shared memory a block")
    n = max(n, 1)
    return -(-n // -(-n // fit))


_SMEM_OPTIN: dict = {}


def smem_optin(device: torch.device) -> int:
    """The card's opt-in shared memory per block, in bytes."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _SMEM_OPTIN:
        import ctypes
        val = ctypes.c_int(0)
        err = _build.library().pp_smem_optin(index, ctypes.byref(val))
        if err != 0:
            raise KernelLaunchError(f"cudaDeviceGetAttribute failed: {err}")
        _SMEM_OPTIN[index] = val.value
    return _SMEM_OPTIN[index]


def plan_program_cuda(state, ctl, *, layout=None, lanes=None, threads=None,
                      placement=None):
    """Launch the megakernel on a CUDA state.

    state: (n, D) int32 or uint32 (bit-cast to uint32 through the
    launch); ctl: the program's control tables
    (``core.plan_program.build_control``) on the state's device; layout:
    ``"packed"`` or ``"word"``, by default the one ``build_control``
    chose; lanes, threads: the word layout's lanes a CTA (a power of two
    whose register files fit the placement) and threads a CTA (a power of
    two from 32 to 1024), by default ``lanes_per_cta``'s and
    ``word_threads``'s (for timing alternatives); placement: the word
    layout's register file, ``"shared"`` or ``"global"``, by default
    ``register_file``'s for those lanes (``"global"`` runs any word
    program, for timing and tests).  Returns (n, D) in state's dtype.
    """
    if not state.is_cuda:
        raise ValueError(f"megakernel needs a CUDA state, got {state.device}")
    if state.dtype not in (torch.int32, torch.uint32):
        raise ValueError(f"megakernel states are int32/uint32, got "
                         f"{state.dtype}")
    if state.dim() != 2 or not state.is_contiguous():
        raise ValueError("state must be a contiguous (n, D) tensor")
    layout = ctl["layout"] if layout is None else layout
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if layout == "packed" and ctl["blob"] is None:
        raise ValueError("this program is not bit-sliceable: it runs in "
                         "the word layout only")
    n, d = state.shape
    tables = [ctl[k] for k in ("consts", "blob", "w_steps", "w_ranges",
                               "w_rp", "w_cols", "w_wts")
              if ctl[k] is not None]
    for t in tables:
        if (t.device != state.device or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError("control tables must be contiguous int32 on "
                             "the state's device")
    if ctl["n"] != n:
        raise ValueError(f"the program runs on {ctl['n']}-row states, got "
                         f"{n}")
    out = torch.empty_like(state)
    if d == 0 or n == 0:
        return out
    lib = _build.library()
    stream = _build.stream_handle(state.device)
    if layout == "packed":
        chunk = packed_chunk(n, ctl["n_phys"], ctl["blob_words"],
                             smem_optin(state.device))
        steps = ctl["packed_steps"]
        err = lib.pp_packed(
            state.data_ptr(), out.data_ptr(), steps.ctypes.data,
            steps.shape[0], ctl["blob"].data_ptr(), ctl["blob_words"],
            ctl["off_cbits"], ctl["n_steps"], ctl["period"], n, d,
            ctl["n_phys"], ctl["rounds"], ctl["const_stride"],
            ctl["out_reg"], packed_threads(n), chunk,
            int(d % 4 == 0 and state.data_ptr() % 16 == 0), stream)
    else:
        smem = smem_optin(state.device)
        n_phys = ctl["n_phys"]
        if lanes is None:
            lanes = lanes_per_cta(n, n_phys - 1, d, smem,
                                  sms=sm_count(state.device))
        if placement is None:
            placement = register_file(n, n_phys - 1, smem, lanes)
        elif placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}, got "
                             f"{placement!r}")
        room = smem // 4 if placement == "shared" else GLOBAL_FILE_WORDS
        if lanes < 1 or lanes & (lanes - 1) or n_phys * n * lanes > room:
            raise ValueError(f"lanes={lanes}: need a power of two whose "
                             f"register files fit the {placement} "
                             f"placement ({room} words)")
        if threads is None:
            threads = word_threads(n, lanes)
        elif not (32 <= threads <= 1024 and threads & (threads - 1) == 0):
            raise ValueError(f"threads={threads}: need a power of two from "
                             "32 to 1024")
        file = None
        if placement == "global":
            file = torch.empty(-(-d // lanes) * n_phys * n * lanes,
                               dtype=torch.int32, device=state.device)
        wts = ctl["w_wts"]
        err = lib.pp_megakernel(
            state.data_ptr(), out.data_ptr(), ctl["w_steps"].data_ptr(),
            ctl["n_steps"], ctl["w_rounds"], ctl["w_cycle"],
            ctl["w_ranges"].data_ptr(),
            ctl["w_rp"].data_ptr(), ctl["w_cols"].data_ptr(),
            None if wts is None else wts.data_ptr(),
            ctl["consts"].data_ptr(), n, d, n_phys, ctl["rounds"],
            ctl["const_stride"], lanes.bit_length() - 1, threads,
            ctl["out_reg"], None if file is None else file.data_ptr(),
            stream)
        if placement == "global":
            layout = "word_global"
    with _LOCK:
        LAUNCHES["plan_program"] += 1
        LAYOUT_LAUNCHES[layout] += 1
    if err != 0:
        raise KernelLaunchError(f"plan_program launch failed ({layout} "
                                f"layout): cudaError {err}")
    return out
