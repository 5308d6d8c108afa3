"""The plan-program megakernel: one launch runs a whole ``PlanProgram``.

Port of ``repro/kernels/plan_program_kernel.py`` (``plan_program_pallas``);
the kernel is ``csrc/plan_program.cu``, a bytecode VM over a register
file held in shared memory, and its plain version is
``kernels.ref.plan_program_vm``.  ``OPCODES`` numbers the step stream
in the same order as the reference, and ``control_digest`` salts the
digest of a program's control state with that numbering.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.core import integrity
from repro_torch.kernels import _build
from repro_torch.kernels._build import KernelLaunchError

OPCODES = ("permute", "xor", "and", "andn", "add", "rotlv", "xor_const",
           "eq_const")

LAUNCHES = {"plan_program": 0}
_LOCK = threading.Lock()


def control_digest(steps, consts, plan_parts=()) -> str:
    """Content digest of one program's kernel-visible control state,
    salted with the opcode numbering."""
    return integrity.content_digest(
        ("|".join(OPCODES), steps, consts) + tuple(plan_parts))


def lanes_per_cta(n: int, n_regs: int, d: int, smem_bytes: int) -> int:
    """Lanes each CTA owns: whole lanes whose register file — n_regs
    registers plus one scratch register, n uint32 rows each — fits the
    shared memory a block may opt in to.  The largest power of two that
    fits, capped at ``d``.  Raises when not even one lane fits."""
    per_lane = (n_regs + 1) * n * 4
    fit = smem_bytes // per_lane
    if fit < 1:
        raise ValueError(
            f"one lane of an n={n}, n_regs={n_regs} program needs "
            f"{per_lane} bytes of shared memory; the card allows "
            f"{smem_bytes} per block")
    lanes = 1
    while lanes * 2 <= fit:
        lanes *= 2
    return max(1, min(lanes, d))


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


def plan_program_cuda(state, steps, plan_tbl, koff, kcnt, folds, w_flat, woff,
                      consts, *, n_regs, rounds=1, const_stride=0):
    """Launch the megakernel on a CUDA state.

    state: (n, D) int32 or uint32 (bit-cast to uint32 through the
    launch); steps: (n_steps, 6) int32; plan_tbl: (K_total, n) int32;
    koff/kcnt/folds/woff: (n_plans,) int32; w_flat: (KW_total, n) int32
    or None; consts: (n_consts, n) int32.  Returns (n, D) in state's
    dtype.
    """
    if not state.is_cuda:
        raise ValueError(f"megakernel needs a CUDA state, got {state.device}")
    if state.dtype not in (torch.int32, torch.uint32):
        raise ValueError(f"megakernel states are int32/uint32, got "
                         f"{state.dtype}")
    if state.dim() != 2 or not state.is_contiguous():
        raise ValueError("state must be a contiguous (n, D) tensor")
    n, d = state.shape
    tables = [steps, plan_tbl, koff, kcnt, folds, woff, consts]
    if w_flat is not None:
        tables.append(w_flat)
    for t in tables:
        if (t.device != state.device or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError("control tables must be contiguous int32 on "
                             "the state's device")
    if plan_tbl.shape[1] != n or consts.shape[1] != n:
        raise ValueError("plan and constant rows must have n entries")
    out = torch.empty_like(state)
    if d == 0 or n == 0:
        return out
    lanes = lanes_per_cta(n, n_regs, d, smem_optin(state.device))
    lib = _build.library()
    err = lib.pp_megakernel(
        state.data_ptr(), out.data_ptr(), steps.data_ptr(), steps.shape[0],
        plan_tbl.data_ptr(), koff.data_ptr(), kcnt.data_ptr(),
        folds.data_ptr(), None if w_flat is None else w_flat.data_ptr(),
        woff.data_ptr(), consts.data_ptr(), n, d, n_regs, rounds,
        const_stride, lanes, _build.stream_handle(state.device))
    with _LOCK:
        LAUNCHES["plan_program"] += 1
    if err != 0:
        raise KernelLaunchError(f"plan_program launch failed: cudaError "
                                f"{err}")
    return out
