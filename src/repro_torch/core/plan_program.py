"""Plan programs: whole permutation schedules as one object.

Port of ``repro.core.plan_program``.  A ``PlanProgram`` is an ordered
step list over a small register file of ``(n, D)`` integer states —
PERMUTE (a crossbar pass of a static gather plan, REAL add or GF(2)
XOR accumulation), XOR/AND/ANDN/ADD between registers, ROTLV /
XOR_CONST / EQ_CONST against constant rows — executed ``rounds`` times
with per-round constants at ``const + round * const_stride``.

Two executors share the IR:

* ``backend='chained'`` — one ``crossbar.apply_plan`` per PERMUTE and
  elementwise PyTorch ops between them: the reference lowering and the
  pass-count ledger.
* ``backend='megakernel'`` — one launch of the CUDA VM
  (``kernels/plan_program_kernel.py``) on a CUDA state, or its plain
  version (``kernels.ref.plan_program_vm``) on a CPU state, over control
  tables encoded once per (program, device) and cached under a digest
  guard: the VM's plan table (n rows a select column), and the word
  layout's row walk (``word_tables``: the rows each step may change, a
  CSR of the live selects).  The cache entry also holds
  the kernel's layout, decided once per program on the host
  (``bit_sliceable``): ``packed`` (32 lanes a word) for GF(2) programs
  whose output provably depends on bit 0 only, such as Keccak-f[1600],
  and ``word`` for every other program.

Telemetry counts program launches and the crossbar passes they replaced.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch._device import resolve
from repro_torch.core import abstract as _abstract
from repro_torch.core import crossbar as xb
from repro_torch.core import integrity as _integrity
from repro_torch.core import plan_algebra as pa
from repro_torch.core import semiring as sr_mod
from repro_torch.core.semiring import GF2, REAL

PERMUTE = "permute"      # dst = plans[plan] @ regs[a]
XOR = "xor"              # dst = regs[a] ^ regs[b]
AND = "and"              # dst = regs[a] & regs[b]
ANDN = "andn"            # dst = (~regs[a]) & regs[b]
ADD = "add"              # dst = regs[a] + regs[b]        (wrapping)
ROTLV = "rotlv"          # dst = rotl(regs[a], consts[const])  per row
XOR_CONST = "xor_const"  # dst = regs[a] ^ consts[const][:, None]
EQ_CONST = "eq_const"    # dst = (regs[a] == consts[const][:, None])  0/1

_BINARY_OPS = (XOR, AND, ANDN, ADD)
_CONST_OPS = (ROTLV, XOR_CONST, EQ_CONST)
OPS = (PERMUTE,) + _BINARY_OPS + _CONST_OPS


@dataclasses.dataclass(frozen=True)
class Step:
    """One program step: registers ``a``/``b``, plan and constant slots."""

    op: str
    dst: int
    a: int
    b: int = -1
    plan: int = -1
    const: int = -1


@dataclasses.dataclass(frozen=True, eq=False)
class PlanProgram:
    """A validated, immutable schedule over ``n``-row states.

    steps: one round's step tuple; plans: gather-normal plans (n -> n,
    REAL or GF2); consts: (n_consts, n) int32 numpy table or None;
    n_regs: register-file size (register 0 is the state in/out);
    rounds: trip count; const_stride: per-round advance of every
    constant reference.
    """

    name: str
    n: int
    steps: Tuple[Step, ...]
    plans: Tuple[xb.PermutePlan, ...]
    consts: Optional[np.ndarray]
    n_regs: int
    rounds: int = 1
    const_stride: int = 0

    def __post_init__(self):
        n_consts = 0 if self.consts is None else self.consts.shape[0]
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")
        for i, plan in enumerate(self.plans):
            if plan.mode != xb.GATHER:
                raise ValueError(
                    f"program {self.name!r} plan slot {i} is in scatter "
                    "form; gather-normalise with plan_algebra.to_gather "
                    "before building the program")
            if plan.n_in != self.n or plan.n_out != self.n:
                raise ValueError(
                    f"program {self.name!r} plan slot {i} is "
                    f"{plan.n_in}->{plan.n_out}, not {self.n}->{self.n}: "
                    "program plans must preserve the state geometry")
            if plan.semiring not in (REAL, GF2):
                raise ValueError(
                    f"program {self.name!r} plan slot {i} uses semiring "
                    f"{plan.semiring.name!r}; the megakernel's integer "
                    "datapath executes REAL and GF2 plans only")
        for s, step in enumerate(self.steps):
            if step.op not in OPS:
                raise ValueError(f"step {s}: unknown op {step.op!r}")
            regs = [step.dst, step.a] + (
                [step.b] if step.op in _BINARY_OPS else [])
            if not all(0 <= r < self.n_regs for r in regs):
                raise ValueError(
                    f"step {s} ({step.op}): register out of range "
                    f"(n_regs={self.n_regs})")
            if step.op == PERMUTE and not 0 <= step.plan < len(self.plans):
                raise ValueError(f"step {s}: plan slot {step.plan} out of "
                                 f"range ({len(self.plans)} plans)")
            if step.op in _CONST_OPS:
                last = step.const + (self.rounds - 1) * self.const_stride
                if not (0 <= step.const < n_consts and 0 <= last < n_consts):
                    raise ValueError(
                        f"step {s} ({step.op}): const rows "
                        f"[{step.const}, {last}] out of range ({n_consts} "
                        f"rows, stride {self.const_stride} x "
                        f"{self.rounds} rounds)")

    @property
    def passes(self) -> int:
        """Crossbar passes a chained execution would issue."""
        return self.rounds * sum(1 for s in self.steps if s.op == PERMUTE)

    @property
    def total_steps(self) -> int:
        return self.rounds * len(self.steps)

    @property
    def uses_rotlv(self) -> bool:
        return any(s.op == ROTLV for s in self.steps)

    def unroll(self) -> "PlanProgram":
        """Single-trip form with every round's constant references
        resolved (semantically identical)."""
        steps = []
        for r in range(self.rounds):
            off = r * self.const_stride
            for s in self.steps:
                steps.append(s if s.const < 0 else
                             dataclasses.replace(s, const=s.const + off))
        return PlanProgram(f"{self.name}[unrolled]", self.n, tuple(steps),
                           self.plans, self.consts, self.n_regs)

    def prefix(self, n_steps: int) -> "PlanProgram":
        """The single-trip program truncated to its first ``n_steps``."""
        if self.rounds != 1:
            raise ValueError("prefix() needs a single-trip program; call "
                             ".unroll() first")
        if not 0 <= n_steps <= len(self.steps):
            raise ValueError(f"prefix length {n_steps} out of range "
                             f"(program has {len(self.steps)} steps)")
        return PlanProgram(f"{self.name}[:{n_steps}]", self.n,
                           self.steps[:n_steps], self.plans, self.consts,
                           self.n_regs)


class ProgramBuilder:
    """Incremental construction with table dedup: plans by identity
    (gather-normalised first), constants by value."""

    def __init__(self, name: str, n: int, *, n_regs: int = 4):
        self.name = name
        self.n = n
        self.n_regs = n_regs
        self._steps: List[Step] = []
        self._plans: List[xb.PermutePlan] = []
        self._consts: List[np.ndarray] = []

    def plan_slot(self, plan: xb.PermutePlan) -> int:
        if plan.mode != xb.GATHER:
            plan = pa.to_gather(plan)
        for i, p in enumerate(self._plans):
            if p is plan:
                return i
        self._plans.append(plan)
        return len(self._plans) - 1

    def const_slot(self, row) -> int:
        row = np.asarray(row, np.int32).reshape(-1)
        if row.shape[0] != self.n:
            raise ValueError(f"const row has {row.shape[0]} entries, "
                             f"state has {self.n} rows")
        for i, c in enumerate(self._consts):
            if np.array_equal(c, row):
                return i
        self._consts.append(row)
        return len(self._consts) - 1

    def permute(self, dst: int, a: int, plan: xb.PermutePlan) -> None:
        self._steps.append(Step(PERMUTE, dst, a, plan=self.plan_slot(plan)))

    def xor(self, dst: int, a: int, b: int) -> None:
        self._steps.append(Step(XOR, dst, a, b))

    def and_(self, dst: int, a: int, b: int) -> None:
        self._steps.append(Step(AND, dst, a, b))

    def andn(self, dst: int, a: int, b: int) -> None:
        self._steps.append(Step(ANDN, dst, a, b))

    def add(self, dst: int, a: int, b: int) -> None:
        self._steps.append(Step(ADD, dst, a, b))

    def rotlv(self, dst: int, a: int, amounts) -> None:
        self._steps.append(
            Step(ROTLV, dst, a, const=self.const_slot(amounts)))

    def xor_const(self, dst: int, a: int, row) -> None:
        self._steps.append(
            Step(XOR_CONST, dst, a, const=self.const_slot(row)))

    def xor_const_at(self, dst: int, a: int, slot: int) -> None:
        """XOR with a pre-placed constant row (``add_const_rows``)."""
        self._steps.append(Step(XOR_CONST, dst, a, const=slot))

    def rotlv_at(self, dst: int, a: int, slot: int) -> None:
        self._steps.append(Step(ROTLV, dst, a, const=slot))

    def eq_const(self, dst: int, a: int, row) -> None:
        """dst = 0/1 mask of where ``regs[a]`` equals the constant row."""
        self._steps.append(
            Step(EQ_CONST, dst, a, const=self.const_slot(row)))

    def eq_const_at(self, dst: int, a: int, slot: int) -> None:
        self._steps.append(Step(EQ_CONST, dst, a, const=slot))

    def build(self, *, rounds: int = 1,
              const_stride: int = 0) -> PlanProgram:
        consts = (np.stack(self._consts).astype(np.int32)
                  if self._consts else None)
        return PlanProgram(self.name, self.n, tuple(self._steps),
                           tuple(self._plans), consts, self.n_regs,
                           rounds, const_stride)

    def add_const_rows(self, rows) -> int:
        """Append a block of constant rows verbatim (no dedup); returns
        the first row's index."""
        rows = np.asarray(rows, np.int32)
        if rows.ndim != 2 or rows.shape[1] != self.n:
            raise ValueError(f"const block must be (rows, {self.n}), got "
                             f"{rows.shape}")
        base = len(self._consts)
        self._consts.extend(rows)
        return base


# ---------------------------------------------------------------------------
# Telemetry: program launches and the passes they replaced
# ---------------------------------------------------------------------------

_PROGRAM_LAUNCHES = 0
_PASSES_AVOIDED = 0
_COUNT_LOCK = threading.Lock()


def program_launch_count() -> int:
    with _COUNT_LOCK:
        return _PROGRAM_LAUNCHES


def passes_avoided_count() -> int:
    with _COUNT_LOCK:
        return _PASSES_AVOIDED


def reset_program_counters() -> None:
    global _PROGRAM_LAUNCHES, _PASSES_AVOIDED
    with _COUNT_LOCK:
        _PROGRAM_LAUNCHES = 0
        _PASSES_AVOIDED = 0


# ---------------------------------------------------------------------------
# Encoded control tables, cached per (program, device)
# ---------------------------------------------------------------------------

_EXEC_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_EXEC_CACHE_CAPACITY = 16
_EXEC_STATS = {"hits": 0, "misses": 0}


def program_cache_info() -> dict:
    return dict(_EXEC_STATS, size=len(_EXEC_CACHE),
                capacity=_EXEC_CACHE_CAPACITY)


_obs.metrics.gauge_fn("program_exec_cache_size", lambda: len(_EXEC_CACHE))


def clear_program_cache() -> None:
    for key in list(_EXEC_CACHE):
        _integrity.PROGRAM_GUARD.drop(key)
    _EXEC_CACHE.clear()
    _EXEC_STATS.update(hits=0, misses=0)


_OPCODE = {op: i for i, op in enumerate(OPS)}


def encode_steps(program: PlanProgram) -> np.ndarray:
    """One round's step stream as (n_steps, 6) int32 rows (opcode, dst,
    a, b, plan, const); unused fields are clamped to 0."""
    rows = [(_OPCODE[s.op], s.dst, s.a, max(s.b, 0), max(s.plan, 0),
             max(s.const, 0)) for s in program.steps]
    return np.asarray(rows, np.int32).reshape(-1, 6)


def _control_digest(program: PlanProgram, ctl: dict) -> str:
    """The program's control content and the word layout's tables built
    from it: a change to either breaks the seal."""
    from repro_torch.kernels import plan_program_kernel as ppk
    parts = []
    for plan in program.plans:
        parts.append(plan.idx)
        parts.append(plan.weights)
    parts += [ctl[k] for k in WORD_TABLES]
    return ppk.control_digest(encode_steps(program), program.consts, parts)


def _plan_fold(plan: xb.PermutePlan) -> str:
    return "xor" if plan.semiring is GF2 else "add"


# A renaming whose register assignment returns to the start only after
# more rounds than this copies back through an AND step instead.
_MAX_RENAME_PERIOD = 64


def rename_registers(program: PlanProgram):
    """The step stream over physical registers, as both megakernel layouts
    run it: ``(rows, period, out_reg)``, rows of (opcode, dst, a, b, plan,
    const, barrier).

    Each thread of the kernels owns the same rows of every register in
    every step, so only a PERMUTE, which gathers any row, crosses threads.
    A block barrier goes before a step (``barrier`` = 1) only where it is
    needed: a PERMUTE reading a register written since the last barrier,
    or a step writing a register a PERMUTE has read since then; and before
    each round's first step.  There are n_regs + 1 physical registers.  A
    PERMUTE whose destination is its source, and a step whose destination
    a PERMUTE is still reading, write the free one instead (if no PERMUTE
    since the barrier reads it), which then takes the destination's name:
    no copy back, and fewer barriers.  The assignment of names changes
    from round to round; ``rows`` holds one round's rows for each of
    ``period`` rounds, after which the assignment is back where it
    started, and register 0 ends in physical register ``out_reg``.  Where
    the period would exceed ``_MAX_RENAME_PERIOD`` rounds, an in-place
    PERMUTE writes the last physical register and an AND of it with itself
    copies it back (period 1).  Host data only; the same for every state.
    """
    n_regs = program.n_regs
    start = list(range(n_regs))

    def with_barriers(rows):
        written, perm_reads, out = set(), set(), []
        for i, (code, dst, a, b, p, c) in enumerate(rows):
            permute = code == _OPCODE[PERMUTE]
            need = (i == 0 or (permute and a in written)
                    or dst in perm_reads)
            if need:
                written, perm_reads = set(), set()
            written.add(dst)
            if permute:
                perm_reads.add(a)
            out.append((code, dst, a, b, p, c, int(need)))
        return out

    def one_round(names, free):
        rows, written, perm_reads = [], set(), set()
        for i, s in enumerate(program.steps):
            code = _OPCODE[s.op]
            a = names[s.a]
            b = names[s.b] if s.op in _BINARY_OPS else 0
            dst = names[s.dst]
            if i == 0:
                written, perm_reads = set(), set()
            if ((s.op == PERMUTE and s.dst == s.a)
                    or (dst in perm_reads and free not in perm_reads)):
                names[s.dst], free, dst = free, dst, free
            if (s.op == PERMUTE and a in written) or dst in perm_reads:
                written, perm_reads = set(), set()
            written.add(dst)
            if s.op == PERMUTE:
                perm_reads.add(a)
            rows.append((code, dst, a, b, max(s.plan, 0), max(s.const, 0)))
        return rows, free

    names, free, rows = list(start), n_regs, []
    for period in range(1, _MAX_RENAME_PERIOD + 1):
        one, free = one_round(names, free)
        rows.extend(with_barriers(one))
        if names == start:
            break
    else:
        rows = []
        for s in program.steps:
            code = _OPCODE[s.op]
            if s.op == PERMUTE and s.dst == s.a:
                rows += [(code, n_regs, s.a, 0, s.plan, 0),
                         (_OPCODE[AND], s.a, n_regs, n_regs, 0, 0)]
            else:
                rows.append((code, s.dst, s.a, max(s.b, 0), max(s.plan, 0),
                             max(s.const, 0)))
        return np.asarray(with_barriers(rows), np.int32).reshape(-1, 7), 1, 0
    names, free = list(start), n_regs
    for _ in range(program.rounds % period):
        free = one_round(names, free)[1]
    return np.asarray(rows, np.int32).reshape(-1, 7), period, names[0]


def _clean_after_rounds(program: PlanProgram) -> tuple:
    """Per register, whether it provably holds zero high bits (bits 1-31
    of every word) after the last round.  Register 0 starts tainted (the
    input), the others clean (zero).  An XOR-fold PERMUTE writes 0/1, so
    its output is clean; a single-select ADD-fold gather (a move) is
    clean when its source is; XOR is clean when both sources are, AND
    when either is, ANDN (~a & b) when b is, XOR_CONST (0/1 constants)
    when its source is.  The caller admits no other step."""
    def one_round(clean):
        c = list(clean)
        for s in program.steps:
            if s.op == PERMUTE:
                c[s.dst] = (program.plans[s.plan].semiring is GF2
                            or c[s.a])
            elif s.op == XOR:
                c[s.dst] = c[s.a] and c[s.b]
            elif s.op == AND:
                c[s.dst] = c[s.a] or c[s.b]
            elif s.op == ANDN:
                c[s.dst] = c[s.b]
            else:  # XOR_CONST
                c[s.dst] = c[s.a]
        return tuple(c)

    clean = (False,) + (True,) * (program.n_regs - 1)
    seen = {}
    for k in range(program.rounds):
        if clean in seen:       # a cycle: skip its whole turns
            period = k - seen[clean]
            for _ in range((program.rounds - k) % period):
                clean = one_round(clean)
            return clean
        seen[clean] = k
        clean = one_round(clean)
    return clean


def _r4(words: int) -> int:
    return -(-words // 4) * 4


# Renamed steps (period x steps a round) the packed kernel takes as a
# launch parameter (kMaxPackedSteps in csrc/plan_program.cu).
MAX_PACKED_STEPS = 120


def packed_sections(program: PlanProgram) -> tuple:
    """Word offsets of the packed layout's control blob: (cbits, total
    words).  The plan rows as uint16 at 0, then on a 16-byte boundary the
    constant rows as bits (ceil(n / 32) words a row)."""
    n = program.n
    k_total = sum(int(p.idx.shape[1]) for p in program.plans)
    n_consts = 1 if program.consts is None else program.consts.shape[0]
    off_cbits = _r4(-(-k_total * n // 2))
    return off_cbits, off_cbits + _r4(n_consts * -(-n // 32))


def bit_sliceable(program: PlanProgram) -> bool:
    """Whether the program runs exactly on 32 lanes a word (the packed
    megakernel layout): its output then depends on bit 0 of its input
    only, and every register's bit 0 on bit 0s only.  It holds when
    every PERMUTE's plan is unweighted and either GF(2) (the XOR fold
    reads bit 0 and writes 0/1) or a single-select REAL gather (a move:
    bit 0 of the output is bit 0 of the source, so Keccak's χ shifts
    qualify; an ADD fold over two or more selects carries into bit 1 and
    does not); every other step is XOR, AND, ANDN or an XOR_CONST whose
    constant rows, over all rounds, are 0/1; register 0 provably ends
    with zero high bits (``_clean_after_rounds``); n fits the 16-bit plan
    rows; the renamed step table fits the kernel's parameter
    (``MAX_PACKED_STEPS``); and the layout's shared memory fits an sm_90
    block.  A static property of the program, decided from host data."""
    from repro_torch.kernels import plan_program_kernel as ppk
    if program.n >= 2**15:
        return False
    for s in program.steps:
        if s.op == PERMUTE:
            plan = program.plans[s.plan]
            if plan.weights is not None or (plan.semiring is not GF2
                                            and plan.idx.shape[1] != 1):
                return False
        elif s.op == XOR_CONST:
            rows = program.consts[s.const + program.const_stride
                                  * np.arange(program.rounds)]
            if not ((rows == 0) | (rows == 1)).all():
                return False
        elif s.op not in (XOR, AND, ANDN):
            return False
    if not _clean_after_rounds(program)[0]:
        return False
    if rename_registers(program)[0].shape[0] > MAX_PACKED_STEPS:
        return False
    words = ppk.packed_smem_words(program.n, program.n_regs + 1,
                                  packed_sections(program)[-1])
    return (words + 32) * 4 <= ppk.PACKED_SMEM_BYTES  # and one staged row


def _const_bits(program: PlanProgram) -> np.ndarray:
    """Bit 0 of every constant row, 32 rows to a word (little-endian)."""
    n = program.n
    consts = (np.zeros((1, n), np.int32) if program.consts is None
              else program.consts)
    bits = np.zeros((consts.shape[0], -(-n // 32) * 32), np.uint8)
    bits[:, :n] = consts & 1
    return np.packbits(bits, axis=1, bitorder="little").view("<u4").view(
        np.int32)


def _packed_control(program: PlanProgram, rows: np.ndarray, idx_rows,
                    koff, kcnt, device) -> tuple:
    """The packed layout's step table (host int32, 8 a step) and control
    blob (on ``device``, with its constant-bits offset).

    Each renamed step becomes 8 ints that the kernel reads without a
    further lookup: (opcode, dst, a, b) with the registers as word
    offsets (register x (n + 1): a register has a zero pad row), then for
    a PERMUTE its plan's first row offset (plan row x n) and its selects,
    the const row, and the barrier flag.  The blob holds the plan rows as
    16-bit sources, n (the pad row) where a select has none, and the
    constant rows as bits.
    """
    n = program.n
    off_cbits, words = packed_sections(program)
    steps = np.zeros((rows.shape[0], 8), np.int64)
    steps[:, 0] = rows[:, 0]
    steps[:, 1:4] = rows[:, 1:4] * (n + 1)
    perm = rows[:, 0] == _OPCODE[PERMUTE]
    if perm.any():
        steps[perm, 4] = np.asarray(koff)[rows[perm, 4]] * n
        steps[perm, 5] = np.asarray(kcnt)[rows[perm, 4]]
    steps[:, 6] = rows[:, 5]
    steps[:, 7] = rows[:, 6]

    def section(t, n_words):
        t = t.reshape(-1)
        return torch.cat([t, torch.zeros(n_words - t.numel(),
                                         dtype=torch.int32, device=device)])

    if idx_rows:
        tbl = torch.stack(idx_rows)
        plan16 = torch.where((tbl >= 0) & (tbl < n), tbl, n).to(torch.int16)
    else:
        plan16 = torch.zeros((0,), dtype=torch.int16, device=device)
    plan16 = plan16.reshape(-1)
    plan16 = torch.cat([plan16, torch.zeros(plan16.numel() % 2,
                                            dtype=torch.int16,
                                            device=device)]).view(torch.int32)
    blob = torch.cat([
        section(plan16, off_cbits),
        section(torch.as_tensor(_const_bits(program), device=device),
                words - off_cbits)])
    return np.ascontiguousarray(steps, np.int32), blob.contiguous(), off_cbits


# The word layout's row walk (``word_tables``).  A row with more selects
# than HEAVY_SELECTS is shared by a group of lanes of a warp, each taking
# about SELECTS_A_LANE of them; a stretch of at least UNIFORM_ROWS rows
# with the same count needs no row pointers; gaps of fewer than GAP_ROWS
# rows between visited rows are visited too (fewer ranges); a program
# whose rounds x steps exceed UNROLL_STEPS keeps the renaming's period and
# visits every row.
HEAVY_SELECTS = 32
SELECTS_A_LANE = 8
UNIFORM_ROWS = 32
GAP_ROWS = 16
UNROLL_STEPS = 1 << 16
# Bits of a step's first word and of a range's flags (csrc/plan_program.cu).
WS_BARRIER, WS_XOR_FOLD, WS_WEIGHTED = 1 << 8, 1 << 9, 1 << 10
WR_RAGGED = 1 << 8
# The word layout's device tables, in ``build_control``'s dict.
WORD_TABLES = ("w_steps", "w_ranges", "w_rp", "w_cols", "w_wts")


def plan_csr(plan: xb.PermutePlan, n: int) -> tuple:
    """One plan's live selects in row order: (row pointer (n + 1,),
    sources, weights or None), DROP and out-of-range selects left out;
    weights as the VM reads them (int32)."""
    idx = plan.idx.cpu().numpy()
    valid = (idx >= 0) & (idx < n)
    rp = np.zeros(n + 1, np.int64)
    np.cumsum(valid.sum(1), out=rp[1:])
    w = (None if plan.weights is None else
         plan.weights.to(torch.int32).cpu().numpy()[valid])
    return rp, idx[valid].astype(np.int32), w


def _runs(mask: np.ndarray, gap: int = 0) -> list:
    """[lo, hi) runs of a bool row mask, runs fewer than ``gap`` rows
    apart joined."""
    m = np.zeros(mask.size + 2, bool)
    m[1:-1] = mask
    edges = np.flatnonzero(m[1:] != m[:-1])
    lo, hi = edges[::2], edges[1::2]
    if gap and lo.size > 1:
        keep = np.concatenate([[True], lo[1:] - hi[:-1] >= gap])
        lo, hi = lo[keep], np.concatenate([hi[:-1][keep[1:]], hi[-1:]])
    return list(zip(lo.tolist(), hi.tolist()))


def _split_run(cnt: np.ndarray, lo: int, hi: int) -> list:
    """One visited run of a PERMUTE's rows as ranges (lo, hi, G, uniform
    count or -1 for rows read through the row pointer): heavy rows (more
    than HEAVY_SELECTS selects) in runs of their own, shared by G lanes;
    light rows one a lane, a light run of one count, or a stretch of
    UNIFORM_ROWS or more rows of one count in it, without row
    pointers."""
    out = []
    c = cnt[lo:hi]
    heavy = c > HEAVY_SELECTS
    for u, v in _runs(heavy):
        g = -(-int(c[u:v].max()) // SELECTS_A_LANE)
        out.append((lo + u, lo + v, min(32, 1 << (g - 1).bit_length()), -1))
    for u, v in _runs(~heavy):
        cu = c[u:v]
        edges = np.flatnonzero(np.diff(cu)) + 1
        starts = np.concatenate([[0], edges])
        ends = np.concatenate([edges, [v - u]])
        at = 0
        for s, e in zip(starts.tolist(), ends.tolist()):
            if e - s < UNIFORM_ROWS and e - s < v - u:
                continue
            if s > at:
                out.append((lo + u + at, lo + u + s, 1, -1))
            out.append((lo + u + s, lo + u + e, 1, int(cu[s])))
            at = e
        if at < v - u:
            out.append((lo + u + at, lo + v, 1, -1))
    return sorted(out)


def _may_change(code: int, dst: int, a: int, b: int, k, nz) -> tuple:
    """An elementwise step's (rows whose result may be nonzero, rows it
    may change) from which rows of each register may be nonzero (``nz``)
    and its constant row ``k``: a row whose result is zero where the
    destination is zero, or that the step leaves as it is (in place, the
    other operand or the constant zero there), does not change."""
    op = OPS[code]
    if op in (XOR, ADD):
        res = nz[a] | nz[b]
    elif op == AND:
        res = nz[a] & nz[b]
    elif op == ANDN:
        res = nz[b].copy()
    elif op == ROTLV:
        res = nz[a].copy()
    elif op == XOR_CONST:
        res = nz[a] | (k != 0)
    else:  # EQ_CONST: a zero row equals a zero constant
        res = nz[a] | (k == 0)
    change = res | nz[dst]
    if dst == a and op in (XOR, ADD):
        change &= nz[b]
    elif dst == b and op in (XOR, ADD, ANDN):
        change &= nz[a]
    elif dst == a and op in (XOR_CONST, ROTLV):
        change &= k != 0
    return res, change


def word_tables(program: PlanProgram, rows: np.ndarray,
                period: int) -> dict:
    """The word layout's control, host numpy: each step walks only the
    rows it may change, each row only its live selects.

    Every plan's live selects go to one CSR (``plan_csr``: row pointer,
    sources, weights).  A forward pass over the renamed physical steps
    (``rename_registers``; every physical register starts zero but the
    input's) keeps, per physical register, the rows that may be nonzero,
    and gives each step the rows it must visit: for a PERMUTE, rows with a
    select of a possibly nonzero source row and rows of its destination
    not proven zero; for an elementwise step, the rows ``_may_change``
    names.  A row off the list already holds the step's result, so every
    register holds the program's values at every row after every step.
    The steps are unrolled over the rounds (each round's row lists its
    own, from that round's constant rows) up to UNROLL_STEPS and cut to
    warm-up rounds and one cycle (``_table_cycle``); past UNROLL_STEPS the
    table keeps the renaming's period and every step visits every row.
    The kernel adds a round's constant stride to each step's const row.

    A step is 3 int4: (opcode | flags, dst, a, b), (const row, offset and
    count of its ranges after the first, 0), its first range; a range is
    (lo, hi, G log2 | WR_RAGGED | lane offset << 16, base): rows [lo, hi),
    G lanes a row (a heavy run: each lane takes every G-th select, a warp
    shuffle reduces), read through the row pointer at ``base`` (ragged)
    or, for a uniform count c (bits 16 up), at sources ``base + (row -
    lo) * c``.  Barrier flags follow ``rename_registers``' rules, and a
    step with heavy rows (written by another lane than the row's owner)
    has a barrier before it and before the next step.  Returns the tables
    and the walk's counts a lane (row visits, select slots, live
    selects).  Host data only; the same for every state."""
    n, n_steps = program.n, rows.shape[0] // period
    unrolled = program.rounds * n_steps <= UNROLL_STEPS
    t_rounds = program.rounds if unrolled else period
    rps, cols, wts, cnts, rp_off, col_off = [], [], [], [], [], []
    at_rp = at_col = 0
    for plan in program.plans:
        rp, c, w = plan_csr(plan, n)
        rp_off.append(at_rp)
        col_off.append(at_col)
        rps.append(rp + at_col)
        cols.append(c)
        wts.append(np.ones_like(c) if w is None else w)
        cnts.append(np.diff(rp))
        at_rp += n + 1
        at_col += c.size
    weighted = [p.weights is not None for p in program.plans]
    consts = program.consts
    nz = np.zeros((program.n_regs + 1, n), bool)
    nz[0] = True
    every = np.ones(n, bool)
    splits: dict = {}
    table = []          # per table round: its steps, each with its ranges
    visits = slots = live = 0
    heavy_prev = False
    written, perm_reads = set(), set()
    for rnd in range(t_rounds):
        # the rounds this table round stands for
        times = 1 if unrolled else (program.rounds // period
                                    + (rnd < program.rounds % period))
        table.append([])
        for s in range(n_steps):
            code, dst, a, b, p, c, _ = rows[(rnd % period) * n_steps + s]
            permute = code == _OPCODE[PERMUTE]
            kc = c + rnd * program.const_stride   # this round's row
            if permute:
                rp_p = rps[p] - col_off[p]
                if unrolled:
                    hit = np.concatenate([[0], np.cumsum(nz[a][cols[p]])])
                    res = hit[rp_p[1:]] > hit[rp_p[:-1]]
                    change = res | nz[dst]
                else:
                    change = every
            elif unrolled:
                res, change = _may_change(
                    code, dst, a, b,
                    None if consts is None else consts[kc], nz)
            else:
                change = every
            runs = _runs(change, GAP_ROWS)
            if unrolled:
                walk = np.zeros(n, bool)
                for lo, hi in runs:
                    walk[lo:hi] = True
                nz[dst] = np.where(walk, res, nz[dst])
            out = []
            if permute:
                for lo, hi in runs:
                    key = (p, lo, hi)
                    if key not in splits:
                        splits[key] = _split_run(cnts[p], lo, hi)
                    out += splits[key]
                live += cols[p].size * times
            else:
                out = [(lo, hi, 1, 0) for lo, hi in runs]
            heavy = any(g > 1 for _, _, g, _ in out)
            enc, off = [], 0
            for lo, hi, g, cu in out:
                visits += (hi - lo) * times
                if not permute:
                    enc.append((lo, hi, 0, 0))
                    continue
                slots += int(rps[p][hi] - rps[p][lo]) * times
                if g > 1:
                    enc.append((lo, hi, (g.bit_length() - 1) | WR_RAGGED
                                | (off % 1024) << 16, rp_off[p]))
                    off += -(-(hi - lo) * g // 32) * 32
                elif cu < 0:
                    enc.append((lo, hi, WR_RAGGED, rp_off[p]))
                else:
                    enc.append((lo, hi, cu << 16, int(rps[p][lo])))
            need = (s == 0 or heavy or heavy_prev
                    or (permute and a in written) or dst in perm_reads)
            if need:
                written, perm_reads = set(), set()
            written.add(dst)
            if permute:
                perm_reads.add(a)
            heavy_prev = heavy
            flags = code | (WS_BARRIER if need else 0)
            if permute:
                flags |= ((WS_XOR_FOLD if program.plans[p].semiring is GF2
                           else 0) | (WS_WEIGHTED if weighted[p] else 0))
            table[-1].append(((flags, dst, a, b, c), tuple(enc)))
    # a period table repeats whole; an unrolled one may settle into a
    # cycle after a few rounds (ChaCha20: after its first)
    pre, cycle = _table_cycle(table) if unrolled else (0, t_rounds)
    steps, ranges = [], []
    for head, enc in (st for rnd in table[:pre + cycle] for st in rnd):
        steps.append(head + (len(ranges), max(len(enc) - 1, 0), 0)
                     + (enc[0] if enc else (0, 0, 0, 0)))
        ranges.extend(enc[1:])
    return {
        "w_steps": np.asarray(steps, np.int32).reshape(-1, 12),
        "w_ranges": np.asarray(ranges or [(0, 0, 0, 0)],
                               np.int32).reshape(-1, 4),
        "w_rp": np.concatenate(rps or [np.zeros(1, np.int64)]).astype(
            np.int32),
        "w_cols": np.concatenate(cols + [np.zeros(1, np.int32)]),
        "w_wts": (np.concatenate(wts + [np.zeros(1, np.int32)])
                  if any(weighted) else None),
        "w_rounds": pre + cycle, "w_cycle": cycle,
        "w_visits": visits, "w_slots": slots, "w_live": live,
    }


# Table rounds ``_table_cycle`` lets run before the repeating part.
_MAX_PRE_ROUNDS = 8


def _table_cycle(table: list) -> tuple:
    """(pre, cycle): the fewest table rounds such that round r >= pre +
    cycle equals round r - cycle (warm-up rounds, then a cycle; the
    kernel runs rounds pre + cycle on as rounds pre, pre + 1, ...), found
    from each round's content by the prefix function."""
    keys: dict = {}
    seq = [keys.setdefault(tuple(rnd), len(keys)) for rnd in table]
    best = (0, len(seq))
    for pre in range(min(_MAX_PRE_ROUNDS, len(seq)) + 1):
        tail = seq[pre:]
        if not tail:
            break
        fail = [0] * len(tail)
        for i in range(1, len(tail)):
            k = fail[i - 1]
            while k and tail[i] != tail[k]:
                k = fail[k - 1]
            fail[i] = k + (tail[i] == tail[k])
        cycle = len(tail) - fail[-1]
        if pre + cycle < sum(best):
            best = (pre, cycle)
    return best


def build_control(program: PlanProgram, device) -> dict:
    """The megakernel's operands for one program on one device.

    For the plain VM (the program's semantics): the step stream, the
    ragged flat plan table (every plan's select columns, one (n,) row per
    column) with per-plan offset/count/fold, the ragged weight rows
    (offset -1 = unweighted) and the constants table.  For the kernel:
    the renamed step table (``rename_registers``), the layout
    (``"packed"`` where ``bit_sliceable``, else ``"word"``), the word
    layout's row walk (``word_tables``, on the device: steps, ranges,
    CSR; and its counts a lane) and, for a bit-sliceable program, the
    packed layout's step table (host int32) and control blob.
    """
    from repro_torch.kernels import plan_program_kernel as ppk
    # The step-stream opcodes index the kernel's dispatch; the two
    # orderings must never drift apart.
    assert ppk.OPCODES == OPS, (
        f"kernel opcode table {ppk.OPCODES} drifted from the IR's op "
        f"order {OPS}")
    idx_rows, w_rows = [], []
    koff, kcnt, folds, woff = [], [], [], []
    for plan in program.plans:
        idx = plan.idx.to(device=device, dtype=torch.int32)
        koff.append(len(idx_rows))
        kcnt.append(idx.shape[1])
        idx_rows.extend(idx.T)
        folds.append(1 if _plan_fold(plan) == "xor" else 0)
        if plan.weights is None:
            woff.append(-1)
        else:
            woff.append(len(w_rows))
            w_rows.extend(plan.weights.to(device=device,
                                          dtype=torch.int32).T)

    def vec(vals, fill):
        return torch.tensor(vals or [fill], dtype=torch.int32, device=device)

    consts = (np.zeros((1, program.n), np.int32) if program.consts is None
              else program.consts)
    rows, period, out_reg = rename_registers(program)
    packed = bit_sliceable(program)
    psteps, blob, off_cbits = (
        _packed_control(program, rows, idx_rows, koff, kcnt, device)
        if packed else (None, None, 0))
    word = word_tables(program, rows, period)
    for k in WORD_TABLES:
        if word[k] is not None:
            word[k] = torch.as_tensor(word[k], device=device).contiguous()
    return word | {
        "steps": torch.as_tensor(encode_steps(program), device=device),
        "plan_tbl": (torch.stack(idx_rows).contiguous() if idx_rows else
                     torch.zeros((1, program.n), dtype=torch.int32,
                                 device=device)),
        "koff": vec(koff, 0), "kcnt": vec(kcnt, 0), "folds": vec(folds, 0),
        "w_flat": torch.stack(w_rows).contiguous() if w_rows else None,
        "woff": vec(woff, -1),
        "consts": torch.as_tensor(np.asarray(consts, np.int32),
                                  device=device).contiguous(),
        "n": program.n, "n_regs": program.n_regs, "rounds": program.rounds,
        "const_stride": program.const_stride,
        "phys_steps": torch.as_tensor(rows, device=device).contiguous(),
        "n_steps": rows.shape[0] // period, "period": period,
        "out_reg": out_reg, "n_phys": program.n_regs + 1,
        "layout": "packed" if packed else "word",
        "packed_steps": psteps, "blob": blob, "off_cbits": off_cbits,
        "blob_words": 0 if blob is None else blob.numel(),
    }


def control_for(program: PlanProgram, device) -> dict:
    """The program's cached control tables on ``device`` (built and sealed
    on a miss; a hit re-digests the program's control content, sampled,
    against the seal)."""
    key = (id(program), str(device))
    hit = _EXEC_CACHE.get(key)
    if hit is not None and hit[0] is program:
        _integrity.PROGRAM_GUARD.verify(
            key, digest_fn=lambda: _control_digest(program, hit[1]),
            evict=lambda: _EXEC_CACHE.pop(key, None))
        _EXEC_STATS["hits"] += 1
        _EXEC_CACHE.move_to_end(key)
        return hit[1]
    _EXEC_STATS["misses"] += 1
    ctl = build_control(program, device)
    _integrity.PROGRAM_GUARD.seal(key, digest=_control_digest(program, ctl))
    _EXEC_CACHE[key] = (program, ctl)
    while len(_EXEC_CACHE) > _EXEC_CACHE_CAPACITY:
        evicted_key, _ = _EXEC_CACHE.popitem(last=False)
        _integrity.PROGRAM_GUARD.drop(evicted_key)
    return ctl


def _run_megakernel(program: PlanProgram, x2: torch.Tensor) -> torch.Tensor:
    """One launch on a CUDA state, in the layout ``build_control`` chose;
    the plain VM on a CPU state or a fake one."""
    global _PROGRAM_LAUNCHES, _PASSES_AVOIDED
    from repro_torch.kernels import plan_program_kernel as ppk
    from repro_torch.kernels import ref

    if x2.dtype not in (torch.int32, torch.uint32):
        raise ValueError(f"the megakernel runs int32/uint32 states, got "
                         f"{x2.dtype}")
    with _abstract.concrete(*program.plans):
        ctl = control_for(program, x2.device)
    with _COUNT_LOCK:
        _PROGRAM_LAUNCHES += 1
        _PASSES_AVOIDED += program.passes
    # A fake state (the constant-time audit's abstract evaluation) has no
    # data pointer to launch on: it runs the same program's plain VM.
    if x2.is_cuda and not _abstract.is_fake(x2):
        return ppk.plan_program_cuda(x2.contiguous(), ctl)
    return ref.plan_program_vm(x2.contiguous(), *vm_operands(ctl),
                               n_regs=program.n_regs, rounds=program.rounds,
                               const_stride=program.const_stride)


def vm_operands(ctl: dict) -> tuple:
    """The plain VM's positional operands from a program's control."""
    return (ctl["steps"], ctl["plan_tbl"], ctl["koff"], ctl["kcnt"],
            ctl["folds"], ctl["w_flat"], ctl["woff"], ctl["consts"])


# ---------------------------------------------------------------------------
# Chained reference executor
# ---------------------------------------------------------------------------

def _rotlv_host(v: torch.Tensor, amt: torch.Tensor) -> torch.Tensor:
    """Per-row rotate-left of 32-bit words held as an int32 view."""
    u = v.to(torch.int64) & 0xFFFFFFFF
    a = (amt.to(torch.int64) & 0xFFFFFFFF)[:, None]
    left = torch.where(a < 32, (u << a.clamp(max=32)) & 0xFFFFFFFF,
                       torch.zeros_like(u))
    r = left | (u >> ((32 - a) & 31))
    return (((r + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _run_chained(program: PlanProgram, x2: torch.Tensor,
                 pass_backend: str) -> torch.Tensor:
    # uint32 states run as their int32 bit pattern: routing, XOR/AND/ANDN
    # and wrapping ADD are identical on the two, and apply_plan's integer
    # path accumulates in int32.
    unsigned = x2.dtype == torch.uint32
    v0 = x2.view(torch.int32) if unsigned else x2
    regs = [v0] + [torch.zeros_like(v0) for _ in range(program.n_regs - 1)]
    consts = (None if program.consts is None else
              torch.as_tensor(program.consts, device=x2.device))
    for r in range(program.rounds):
        off = r * program.const_stride
        for step in program.steps:
            a = regs[step.a]
            if step.op == PERMUTE:
                val = xb.apply_plan(program.plans[step.plan], a,
                                    backend=pass_backend)
            elif step.op == XOR:
                val = a ^ regs[step.b]
            elif step.op == AND:
                val = a & regs[step.b]
            elif step.op == ANDN:
                val = ~a & regs[step.b]
            elif step.op == ADD:
                val = a + regs[step.b]
            elif step.op == ROTLV:
                val = _rotlv_host(a, consts[step.const + off])
            else:
                row = consts[step.const + off].to(a.dtype)[:, None]
                if step.op == EQ_CONST:
                    val = (a == row).to(a.dtype)
                else:  # XOR_CONST
                    val = a ^ row
            regs[step.dst] = val
    return regs[0].view(torch.uint32) if unsigned else regs[0]


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def run_program(program: PlanProgram, x: torch.Tensor, *,
                backend: str = "megakernel",
                pass_backend: str = "einsum") -> torch.Tensor:
    """Execute a plan program over an ``(n,)`` or ``(n, D)`` payload.

    backend: 'megakernel' (one kernel launch; the plain VM on a CPU
    state) or 'chained' (one ``apply_plan`` per PERMUTE step on
    ``pass_backend``).  Returns register 0 after the last step, in the
    input's shape and dtype.
    """
    single = x.dim() == 1
    x2 = x[:, None] if single else x
    if x2.dim() != 2 or x2.shape[0] != program.n:
        raise ValueError(f"program {program.name!r} runs on ({program.n}, D) "
                         f"states, got payload shape {tuple(x.shape)}")
    if x2.dtype.is_floating_point or x2.dtype == torch.bool:
        raise ValueError(f"plan programs carry integer states, got "
                         f"{x2.dtype}")
    if program.uses_rotlv and x2.dtype != torch.uint32:
        raise ValueError(
            "ROTLV needs an unsigned payload (logical right shift); got "
            f"{x2.dtype} — bitcast ARX states to uint32 first")
    if backend == "megakernel":
        out2 = _run_megakernel(program, x2)
    elif backend == "chained":
        out2 = _run_chained(program, x2, pass_backend)
    else:
        raise ValueError(f"unknown program backend {backend!r}")
    return out2[:, 0] if single else out2


def program_from_numpy(name: str, n: int, steps, plans: Sequence[tuple],
                       consts, n_regs: int, rounds: int = 1,
                       const_stride: int = 0, device=None) -> PlanProgram:
    """Rebuild a program from its encoded step stream and numpy control.

    steps: (n_steps, 6) rows as ``encode_steps`` gives them; plans: one
    ``(idx, weights_or_None, semiring_name)`` per plan slot (gather form,
    n -> n); consts: (n_consts, n) or None.
    """
    dev = resolve(device)
    decoded = []
    for code, dst, a, b, p, c in np.asarray(steps, np.int32).tolist():
        op = OPS[code]
        decoded.append(Step(op, dst, a,
                            b=b if op in _BINARY_OPS else -1,
                            plan=p if op == PERMUTE else -1,
                            const=c if op in _CONST_OPS else -1))
    plan_objs = tuple(
        xb.plan_from_numpy(xb.GATHER, idx, n, n, weights=w,
                           semiring=sr_mod.get(sr_name), device=dev)
        for idx, w, sr_name in plans)
    consts_np = None if consts is None else np.asarray(consts, np.int32)
    return PlanProgram(name, n, tuple(decoded), plan_objs, consts_np, n_regs,
                       rounds, const_stride)
