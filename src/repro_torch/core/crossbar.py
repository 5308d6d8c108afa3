"""The one-hot crossbar: the universal executor of the unified datapath.

Port of ``repro.core.crossbar``.  Output ``o`` receives
``SUM_k w[o,k] * x[idx[o,k]]`` (gather form) or input ``i`` lands on
``idx[i,k]`` (scatter form), accumulated in the plan's semiring.

* ``PermutePlan`` — control information: gather or scatter form,
  multi-index selects with optional weights, a semiring.
* ``build_onehot`` / ``coverage`` — the materialised operator (reference,
  small sizes) and which outputs receive anything.
* ``CompiledPlan`` / ``compile_plan`` — the o-major schedule of occupied
  (output-tile, input-tile) pairs that the tile-skipping kernel walks,
  memoised in a 64-entry LRU keyed on plan identity plus a pinned cache
  for static plans.  Everything in PyTorch is concrete, so every
  schedule is compacted and static (the reference's traced schedules
  and ``trace_state_clean`` checks have no counterpart).
* ``apply_plan`` — execute the crossbar with merge / ``out_mask``
  semantics on one of the backends:
    - 'einsum':    the dense product.  Float payloads multiply a one-hot
      operator (float32 products, never TF32); integer payloads take an
      exact k-select gather-sum in int64, wrapped to int32 as an int32
      accumulation wraps (CUDA has no integer matmul).  Concrete
      unweighted k=1 gathers take the take fast path.
    - 'kernel':    the dense crossbar kernel (``kernels/ops.py``).
    - 'sparse':    the tile-skipping kernel over the compiled schedule.
    - 'auto':      the installed tuning table's measured winner for
      the plan's geometry (``set_tuning_table``, ``plan_geometry``),
      else the measured-density heuristic.
    - 'reference': the index oracle (the "separate datapath" world).

On a CUDA payload 'kernel' and 'sparse' launch their CUDA kernels (or
raise); on a CPU payload they run the kernels' plain versions.  Neither
has a gradient: with grad enabled and a payload or plan weights that
require grad they raise ``KernelLaunchError`` on every device (as does
'auto' when it resolves to one of them); 'einsum' differentiates.  Plans
over a GF(2^k) semiring run on 'einsum', 'kernel' and 'sparse' as their
GF(2) bit lift (``lift_gf2_k``, memoised in a sealed LRU): one crossbar
evaluation over width x the rows, payloads unpacked to bit rows around
it.  Scalar widths (2..31: AES's GF(2^8)) carry one int32 an element;
wide ones (GHASH's GF(2^128)) carry a trailing axis of byte limbs
(``_wide_unpack`` / ``_wide_pack``).  'reference' keeps direct field
arithmetic.

``compile_plan``'s schedule build and every ``apply_plan`` run inside
``obs`` spans (``compile_plan``, ``apply_plan``; host values only), and
the schedule caches' sizes are lazy gauges (``compile_cache_size``,
``compile_cache_pinned``), as in the reference.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch._device import no_tf32, resolve
from repro_torch.core import abstract as _abstract
from repro_torch.core import integrity as _integrity
from repro_torch.core import semiring as sr_mod
from repro_torch.core import transform as _t
from repro_torch.core.semiring import REAL, Semiring

GATHER = "gather"    # output-driven: idx[o, k] = source of output o
SCATTER = "scatter"  # input-driven:  idx[i, k] = destination of input i


@dataclasses.dataclass(eq=False)
class PermutePlan:
    """Control information for one crossbar evaluation.

    mode: GATHER or SCATTER.  idx: int32 (n_ctrl, k) selects (n_ctrl ==
    n_out in gather mode, n_in in scatter mode); entries outside the
    valid range drop.  weights: optional (n_ctrl, k) per-select scaling.
    semiring: the algebra the pass accumulates in (an interned
    singleton, part of every cache key).
    """

    mode: str
    idx: torch.Tensor
    n_in: int
    n_out: int
    weights: Optional[torch.Tensor] = None
    semiring: Semiring = REAL

    def __post_init__(self):
        if self.mode not in (GATHER, SCATTER):
            raise ValueError(f"bad mode {self.mode!r}")
        if not isinstance(self.semiring, Semiring):
            raise ValueError(f"bad semiring {self.semiring!r}; use the "
                             "core.semiring singletons")
        if self.idx.dim() == 1:
            self.idx = self.idx[:, None]
        if self.weights is not None and self.weights.dim() == 1:
            self.weights = self.weights[:, None]

    @property
    def k(self) -> int:
        return self.idx.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.idx.device

    @property
    def neutral_semiring(self) -> bool:
        """Pure routing (unweighted REAL) means the same in every
        semiring and adopts the other operand's algebra."""
        return self.weights is None and self.semiring is REAL


def gather_plan(src_idx: torch.Tensor, n_in: int, *, weights=None,
                semiring: Semiring = REAL) -> PermutePlan:
    """Output-driven plan: ``out[o] = sum_k w[o,k] * x[src_idx[o,k]]``."""
    return PermutePlan(GATHER, src_idx.to(torch.int32), n_in,
                       src_idx.shape[0], weights, semiring)


def scatter_plan(dest_idx: torch.Tensor, n_out: int, *, weights=None,
                 semiring: Semiring = REAL) -> PermutePlan:
    """Input-driven plan: input i lands at ``dest_idx[i,k]`` (OOB drops)."""
    return PermutePlan(SCATTER, dest_idx.to(torch.int32), dest_idx.shape[0],
                       n_out, weights, semiring)


def plan_from_numpy(mode: str, idx, n_in: int, n_out: int, weights=None,
                    semiring="real", device=None) -> PermutePlan:
    """A plan from numpy control arrays (e.g. another package's plan)."""
    dev = resolve(device)
    sr = sr_mod.get(semiring) if isinstance(semiring, str) else semiring
    # torch.tensor copies: the plan owns its control.
    idx_t = torch.tensor(np.asarray(idx, np.int32), device=dev)
    w_t = None if weights is None else torch.tensor(np.asarray(weights),
                                                    device=dev)
    return PermutePlan(mode, idx_t, n_in, n_out, w_t, sr)


def transpose_plan(plan: PermutePlan) -> PermutePlan:
    """The inverse-direction crossbar (operator transpose)."""
    mode = SCATTER if plan.mode == GATHER else GATHER
    return PermutePlan(mode, plan.idx, plan.n_out, plan.n_in, plan.weights,
                       plan.semiring)


def build_onehot(plan: PermutePlan, dtype=None) -> torch.Tensor:
    """Materialise the (n_out, n_in) operator ``P`` (reference / small)."""
    sr = plan.semiring
    if sr.limbs:
        raise ValueError(f"wide {sr.name} plans have no dense one-hot form")
    if dtype is None:
        dtype = torch.float32 if sr is REAL else sr.weight_dtype
    n_iota = plan.n_in if plan.mode == GATHER else plan.n_out
    iota = torch.arange(n_iota, dtype=torch.int32, device=plan.device)
    sel = plan.idx[:, :, None] == iota[None, None, :]
    w = (torch.ones(plan.idx.shape, dtype=dtype, device=plan.device)
         if plan.weights is None else plan.weights.to(dtype))
    if sr is REAL:
        p = torch.sum(sel.to(dtype) * w[:, :, None], dim=1)
    else:
        p = sr.reduce(sr.mul(w[:, :, None], sel.to(dtype)), dim=1)
    return p if plan.mode == GATHER else p.T


def coverage(plan: PermutePlan) -> torch.Tensor:
    """(n_out,) bool — which outputs receive at least one input.

    Unweighted on purpose: a zero-gate selection still covers its output.
    """
    if plan.mode == GATHER:
        valid = (plan.idx >= 0) & (plan.idx < plan.n_in)
        return torch.any(valid, dim=-1)
    valid = (plan.idx >= 0) & (plan.idx < plan.n_out)
    hits = torch.zeros((plan.n_out,), dtype=torch.int32, device=plan.device)
    hits.index_add_(0, plan.idx.clamp(0, max(plan.n_out - 1, 0)).reshape(-1),
                    valid.reshape(-1).to(torch.int32))
    return hits > 0


# ---------------------------------------------------------------------------
# Plan compilation: occupancy maps and active-tile schedules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class CompiledPlan:
    """The tile schedule of a plan under a (block_o, block_n) blocking.

    occupancy: (n_o_tiles, n_n_tiles) bool.  pair_o/pair_n: the occupied
    pairs first in o-major order, the inactive tail clamped onto the
    last active pair; active: slot validity; num_active: the count (a
    Python int — always static here).  run_o/run_ptr: the same schedule
    in CSR form, one entry per o-run, which the CUDA kernel's grid is
    built from.  idle_rows: the output rows of tiles with no active pair,
    which the CUDA kernel leaves unwritten (``_idle_rows``).
    """

    plan: PermutePlan
    block_o: int
    block_n: int
    n_o_tiles: int
    n_n_tiles: int
    occupancy: torch.Tensor
    pair_o: torch.Tensor
    pair_n: torch.Tensor
    active: torch.Tensor
    num_active: int
    run_o: torch.Tensor
    run_ptr: torch.Tensor
    idle_rows: torch.Tensor

    @property
    def n_pairs(self) -> int:
        return self.n_o_tiles * self.n_n_tiles

    @property
    def density(self) -> float:
        if self.n_pairs == 0:
            return 1.0
        return self.num_active / self.n_pairs

    @property
    def runs(self):
        return self.run_o, self.run_ptr


def _tile_occupancy(plan: PermutePlan, block_o: int,
                    block_n: int) -> torch.Tensor:
    to = -(-plan.n_out // block_o)
    tn = -(-plan.n_in // block_n)
    n_ctrl = plan.idx.shape[0]
    ctrl_tile = torch.arange(n_ctrl, dtype=torch.int32, device=plan.device)
    if plan.mode == GATHER:
        valid = (plan.idx >= 0) & (plan.idx < plan.n_in)
        o_t = (ctrl_tile // block_o)[:, None].expand(plan.idx.shape)
        n_t = plan.idx.clamp(0, max(plan.n_in - 1, 0)) // block_n
    else:
        valid = (plan.idx >= 0) & (plan.idx < plan.n_out)
        o_t = plan.idx.clamp(0, max(plan.n_out - 1, 0)) // block_o
        n_t = (ctrl_tile // block_n)[:, None].expand(plan.idx.shape)
    occ = torch.zeros((to, tn), dtype=torch.int32, device=plan.device)
    occ.index_put_((o_t.reshape(-1).long(), n_t.reshape(-1).long()),
                   valid.reshape(-1).to(torch.int32), accumulate=True)
    return occ > 0


def _compile_schedule(plan: PermutePlan, block_o: int, block_n: int):
    occ = _tile_occupancy(plan, block_o, block_n)
    tn = occ.shape[1]
    flat = occ.reshape(-1)
    if flat.numel() == 0:
        empty = torch.zeros((0,), dtype=torch.int32, device=plan.device)
        return occ, empty, empty, flat, 0
    # Stable sort on the negated flags: active pairs first, each group in
    # row-major (o-major) order.
    order = torch.argsort(torch.logical_not(flat).to(torch.int8),
                          stable=True).to(torch.int32)
    num = int(flat.sum())
    fill = order[max(num - 1, 0)] if num > 0 else torch.zeros(
        (), dtype=torch.int32, device=plan.device)
    slot = torch.arange(flat.shape[0], dtype=torch.int32, device=plan.device)
    sel = torch.where(slot < num, order, fill)
    return occ, sel // tn, sel % tn, slot < num, num


def _idle_rows(run_o: torch.Tensor, n_o_tiles: int, block_o: int,
               n_out: int) -> torch.Tensor:
    """(m,) int64 rows of the output tiles absent from run_o, with no host
    read: the idle tiles are the first n_o_tiles - len(run_o) of a stable
    sort on the scheduled flag.  Rows past n_out (a ragged last tile)
    repeat their tile's first row."""
    dev = run_o.device
    if run_o.shape[0] == n_o_tiles:     # the common case: no op launched
        return torch.empty(0, dtype=torch.int64, device=dev)
    sched = torch.zeros(n_o_tiles, dtype=torch.int8, device=dev)
    sched[run_o.long()] = 1
    tiles = torch.argsort(sched, stable=True)[:n_o_tiles - run_o.shape[0]]
    first = tiles[:, None] * block_o
    rows = first + torch.arange(block_o, device=dev)
    return torch.where(rows < n_out, rows, first).reshape(-1)


_COMPILE_CACHE: "OrderedDict[tuple, CompiledPlan]" = OrderedDict()
_COMPILE_CACHE_CAPACITY = 64
_COMPILE_CACHE_STATS = {"hits": 0, "misses": 0}
_PINNED_COMPILE: "dict[tuple, CompiledPlan]" = {}


def compile_cache_info() -> dict:
    return dict(_COMPILE_CACHE_STATS, size=len(_COMPILE_CACHE),
                capacity=_COMPILE_CACHE_CAPACITY, pinned=len(_PINNED_COMPILE))


# Cache occupancy as export-time gauges (read lazily at metrics dump).
_obs.metrics.gauge_fn("compile_cache_size", lambda: len(_COMPILE_CACHE))
_obs.metrics.gauge_fn("compile_cache_pinned", lambda: len(_PINNED_COMPILE))


def _schedule_parts(compiled: CompiledPlan) -> tuple:
    """Digest-relevant content of a cached schedule: everything the
    sparse kernel's launch geometry and tile routing derive from."""
    return (compiled.block_o, compiled.block_n, compiled.n_o_tiles,
            compiled.n_n_tiles, compiled.occupancy, compiled.pair_o,
            compiled.pair_n, compiled.active, compiled.num_active,
            compiled.run_o, compiled.run_ptr, compiled.idle_rows)


def clear_compile_cache() -> None:
    for key in list(_COMPILE_CACHE) + list(_PINNED_COMPILE):
        _integrity.SCHEDULE_GUARD.drop(key)
    _COMPILE_CACHE.clear()
    _PINNED_COMPILE.clear()
    _COMPILE_CACHE_STATS.update(hits=0, misses=0)


def unpin_plan(plan: PermutePlan) -> int:
    """Drop every pinned schedule built from this plan's arrays."""
    removed = 0
    for key, compiled in list(_PINNED_COMPILE.items()):
        if (compiled.plan.idx is plan.idx
                and compiled.plan.weights is plan.weights):
            del _PINNED_COMPILE[key]
            _integrity.SCHEDULE_GUARD.drop(key)
            removed += 1
    return removed


def compile_plan(plan: PermutePlan, *, block_o: int = 128,
                 block_n: int = 128, pin: bool = False) -> CompiledPlan:
    """Compile (or fetch) a plan's active-tile schedule.

    Memoised in an LRU keyed on the identities of the index and weight
    arrays (and the semiring); ``pin=True`` stores or promotes the entry
    into the never-evicted pinned cache that static plans rely on.
    Cached schedules are sealed and re-verified on sampled hits.
    """
    key = (plan.mode, plan.n_in, plan.n_out, plan.semiring.name, block_o,
           block_n, id(plan.idx),
           id(plan.weights) if plan.weights is not None else None)
    hit = _PINNED_COMPILE.get(key)
    in_lru = False
    if hit is None:
        hit = _COMPILE_CACHE.get(key)
        in_lru = hit is not None
    if (hit is not None and hit.plan.idx is plan.idx
            and hit.plan.weights is plan.weights
            and hit.plan.semiring is plan.semiring):
        _integrity.SCHEDULE_GUARD.verify(
            key, lambda: _schedule_parts(hit),
            evict=lambda: (_PINNED_COMPILE.pop(key, None),
                           _COMPILE_CACHE.pop(key, None)))
        _COMPILE_CACHE_STATS["hits"] += 1
        if in_lru:
            if pin:
                del _COMPILE_CACHE[key]
                _PINNED_COMPILE[key] = hit
            else:
                _COMPILE_CACHE.move_to_end(key)
        return hit
    _COMPILE_CACHE_STATS["misses"] += 1

    from repro_torch.kernels.ref import schedule_runs
    n_o_tiles = -(-plan.n_out // block_o)
    # The counts are host reads of the plan's control: real for a real
    # plan under the audit's fake mode, refused for a payload-derived one.
    with _obs.span("compile_plan", mode=plan.mode, n_out=plan.n_out,
                   n_in=plan.n_in, block_o=block_o, block_n=block_n,
                   pin=pin), _abstract.concrete(plan):
        occ, pair_o, pair_n, active, num = _compile_schedule(
            plan, block_o, block_n)
        run_o, run_ptr = schedule_runs(pair_o[:num])
        idle = _idle_rows(run_o, n_o_tiles, block_o, plan.n_out)
    compiled = CompiledPlan(plan, block_o, block_n, n_o_tiles,
                            -(-plan.n_in // block_n), occ, pair_o, pair_n,
                            active, num, run_o, run_ptr, idle)
    if _abstract.holds_fake(plan):
        return compiled
    _integrity.SCHEDULE_GUARD.seal(key, _schedule_parts(compiled))
    if pin:
        _PINNED_COMPILE[key] = compiled
    else:
        _COMPILE_CACHE[key] = compiled
        while len(_COMPILE_CACHE) > _COMPILE_CACHE_CAPACITY:
            evicted_key, _ = _COMPILE_CACHE.popitem(last=False)
            _integrity.SCHEDULE_GUARD.drop(evicted_key)
    return compiled


# ---------------------------------------------------------------------------
# apply_plan
# ---------------------------------------------------------------------------

# Pass counters: the one-pass property of the plan algebra is asserted
# against the total, the megakernel's zero-pass claim against the split
# by resolved backend ('auto' counts under the backend it picked).
_APPLY_CALLS = 0
_APPLY_CALLS_BY_BACKEND: "dict[str, int]" = {}
_COUNT_LOCK = threading.Lock()


def apply_call_count() -> int:
    with _COUNT_LOCK:
        return _APPLY_CALLS


def apply_calls_by_backend() -> dict:
    with _COUNT_LOCK:
        return dict(_APPLY_CALLS_BY_BACKEND)


def reset_apply_call_count() -> None:
    global _APPLY_CALLS
    with _COUNT_LOCK:
        _APPLY_CALLS = 0
        _APPLY_CALLS_BY_BACKEND.clear()


def _canon_2d(x: torch.Tensor):
    shp = tuple(x.shape)
    if x.dim() == 1:
        return x[:, None], shp
    return x.reshape(shp[0], -1), shp


# Below this occupied-tile fraction the tile-skipping kernel is chosen
# over the dense one; below AUTO_MIN_CELLS operator cells the einsum path
# is.  Both thresholds were set on a TPU and are not yet recalibrated
# for the H100.
AUTO_SPARSE_DENSITY = 0.25
AUTO_MIN_CELLS = 128 * 128


# Optional measured tuning table (core/tuning.py): when installed,
# backend='auto' prefers what the table has seen win for this plan
# geometry over the density prior below.  Module-level because the
# choice point is deep inside apply_plan; a caller that records
# ("apply_plan", plan_geometry(plan)) timings installs it.
_TUNING_TABLE = None
_VALID_AUTO_BACKENDS = frozenset({"einsum", "kernel", "sparse", "reference"})


def set_tuning_table(table) -> None:
    """Install (or clear, with None) the measured backend tuning table."""
    global _TUNING_TABLE
    _TUNING_TABLE = table


def get_tuning_table():
    return _TUNING_TABLE


def plan_geometry(plan: PermutePlan) -> tuple:
    """The tuning-table geometry key for a plan: everything that shapes
    backend-relative performance without looking at control values."""
    return (plan.mode, plan.n_out, plan.n_in, plan.k, plan.semiring.name)


def _choose_backend(plan: PermutePlan) -> str:
    """``backend='auto'``: the tuning table's measured winner for the
    plan's geometry when one is installed and has one, else the
    measured-density heuristic.

    The kernels only pay on the card: control on the CPU takes einsum
    (where the reference tests for a TPU, this tests for CUDA).
    """
    if _TUNING_TABLE is not None:
        measured = _TUNING_TABLE.best("apply_plan", plan_geometry(plan))
        if measured in _VALID_AUTO_BACKENDS:
            return measured
    if not plan.idx.is_cuda:
        return "einsum"
    if plan.n_out * plan.n_in <= AUTO_MIN_CELLS:
        return "einsum"
    compiled = compile_plan(plan)
    if compiled.num_active == 0 or compiled.density <= AUTO_SPARSE_DENSITY:
        return "sparse"
    return "kernel"


def apply_plan(plan: PermutePlan, x: torch.Tensor, *,
               merge: Optional[torch.Tensor] = None,
               backend: str = "einsum",
               out_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Execute the crossbar: ``out = P @ x`` with merge semantics.

    x: (n_in, ...) payload, on the plan's device.  merge: optional
    (n_out, ...) values for uncovered and masked-off outputs (default
    zeros).  out_mask: optional (n_out,) bool, the RVV v0 mask.
    backend: 'einsum' | 'kernel' | 'sparse' | 'auto' | 'reference'.
    Returns (n_out, ...) in x's dtype.
    """
    global _APPLY_CALLS
    with _COUNT_LOCK:
        _APPLY_CALLS += 1
    if x.device != plan.device:
        raise ValueError(f"payload on {x.device} but plan control on "
                         f"{plan.device}; build the plan on the payload's "
                         "device")
    x2, xshape = _canon_2d(x)
    out_trailing = xshape[1:]
    n_out = plan.n_out
    merge2 = None if merge is None else _canon_2d(merge)[0]

    requested = backend
    if backend == "auto":
        backend = _choose_backend(plan)
    if backend in ("kernel", "sparse") and torch.is_grad_enabled() and (
            x.requires_grad or (plan.weights is not None
                                and plan.weights.requires_grad)):
        # The kernels write a fresh buffer: their result has no autograd
        # history, and the gradient to the payload or the gates would be
        # dropped without a word.  The reference refuses to differentiate
        # its kernels too; train on 'einsum'.
        from repro_torch.kernels._build import KernelLaunchError
        raise KernelLaunchError(
            f"apply_plan backend {backend!r} (requested {requested!r}) has "
            "no gradient, and the payload or the plan's weights require "
            "grad; use backend='einsum' to differentiate, or run under "
            "torch.no_grad() / torch.inference_mode()")
    if backend in ("einsum", "kernel", "sparse", "reference"):
        with _COUNT_LOCK:
            _APPLY_CALLS_BY_BACKEND[backend] = (
                _APPLY_CALLS_BY_BACKEND.get(backend, 0) + 1)
    else:
        raise ValueError(f"unknown backend {backend!r}")

    from repro_torch.kernels import ops as _kops
    sr = plan.semiring
    if sr.integer_carrier and not _kops.is_integer_payload(x2):
        raise ValueError(
            f"semiring {sr.name!r} carries small integers; got payload "
            f"dtype {x2.dtype} — cast to an integer type first")

    need_cov = merge2 is not None or out_mask is not None
    cov = coverage(plan) if need_cov else None

    with _obs.span("apply_plan", backend=backend, requested=requested,
                   mode=plan.mode, n_out=plan.n_out, n_in=plan.n_in,
                   semiring=sr.name):
        if backend == "reference":
            out2 = _apply_reference(plan, x2)
        elif sr.limbs:
            # Wide GF(2^width): ONE lifted GF(2) crossbar evaluation over
            # width x n bit rows.
            out2 = _apply_gf2k_wide(plan, x2, backend)
        elif sr.is_gf2k:
            # The GF(2) bit lift on the chosen backend; the take lowering
            # substitutes only for einsum — an explicitly requested
            # kernel backend runs its kernel.
            fast = _take_fastpath(plan, x2) if backend == "einsum" else None
            out2 = fast if fast is not None else _apply_gf2k(plan, x2,
                                                            backend)
        elif backend == "kernel":
            out2 = _kops.crossbar_permute(plan, x2)
        elif backend == "sparse":
            # merge overwrites the unwritten rows below anyway
            out2 = _apply_sparse(plan, x2, pin_zeros=merge2 is None)
        else:
            out2 = _apply_einsum(plan, x2)

    if out_mask is not None:
        keep = out_mask.to(torch.bool)
        cov = cov & keep
        out2 = torch.where(keep[:, None], out2, torch.zeros_like(out2))
    if merge2 is not None:
        out2 = torch.where(cov[:, None], out2, merge2.to(out2.dtype))

    out = out2.reshape((n_out,) + out_trailing) if out_trailing \
        else out2[:, 0]
    return out.to(x.dtype)


def _apply_sparse(plan: PermutePlan, x2: torch.Tensor, *,
                  pin_zeros: bool) -> torch.Tensor:
    """The tile-skipping kernel over the plan's compiled schedule.

    The kernel writes every row of the schedule's output tiles (the
    uncovered ones as zeros); rows of the other tiles hold whatever the
    buffer held.  ``pin_zeros`` pins those to the zeros every other
    backend produces.
    """
    from repro_torch.kernels import ops as _kops
    # before the schedule is compiled: the wrapper refuses too, later
    _kops.refuse_complex(x2, "sparse crossbar kernel")
    compiled = compile_plan(plan)
    out2 = _kops.crossbar_permute_sparse(plan, x2, compiled=compiled)
    if pin_zeros and compiled.run_o.shape[0] < compiled.n_o_tiles:
        out2.index_fill_(0, compiled.idle_rows, 0)
    return out2


# The take lowering of a concrete, unweighted, single-select gather (a
# pure row routing; exact in every semiring).
EINSUM_TAKE_FASTPATH = True


def _take_fastpath(plan: PermutePlan, x2: torch.Tensor):
    if not (EINSUM_TAKE_FASTPATH and plan.mode == GATHER and plan.k == 1
            and plan.weights is None):
        return None
    src = plan.idx[:, 0]
    valid = (src >= 0) & (src < plan.n_in)
    picked = x2[src.clamp(0, max(plan.n_in - 1, 0)).long()]
    if plan.semiring.carrier_mask is not None:
        picked = picked.to(torch.int32) & plan.semiring.carrier_mask
    picked = torch.where(valid[:, None], picked, torch.zeros_like(picked))
    return picked.to(x2.dtype)


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _int_select_sum(plan: PermutePlan, x2: torch.Tensor) -> torch.Tensor:
    """Exact integer crossbar: k-select gather-sum in int64, wrapped to
    int32 — what an int32 one-hot contraction computes."""
    xi = x2.to(torch.int64)
    w = None if plan.weights is None else plan.weights.to(torch.int32).to(
        torch.int64)
    if plan.mode == GATHER:
        acc = torch.zeros((plan.n_out, x2.shape[1]), dtype=torch.int64,
                          device=x2.device)
        for j in range(plan.k):
            src = plan.idx[:, j]
            valid = ((src >= 0) & (src < plan.n_in))[:, None]
            vals = xi[src.clamp(0, max(plan.n_in - 1, 0)).long()]
            if w is not None:
                vals = vals * w[:, j:j + 1]
            acc = acc + torch.where(valid, vals, torch.zeros_like(vals))
        return _wrap_int32(acc)
    acc = torch.zeros((plan.n_out, x2.shape[1]), dtype=torch.int64,
                      device=x2.device)
    for j in range(plan.k):
        dest = plan.idx[:, j]
        valid = ((dest >= 0) & (dest < plan.n_out))[:, None]
        vals = xi if w is None else xi * w[:, j:j + 1]
        acc.index_add_(0, dest.clamp(0, max(plan.n_out - 1, 0)).long(),
                       torch.where(valid, vals, torch.zeros_like(vals)))
    return _wrap_int32(acc)


def _apply_einsum(plan: PermutePlan, x2: torch.Tensor) -> torch.Tensor:
    """The dense product.  REAL float payloads: float32 contraction of the
    one-hot operator (exact for unweighted plans).  Integer payloads:
    exact integer sum; GF2 folds it mod 2."""
    from repro_torch.kernels.ops import is_integer_payload
    fast = _take_fastpath(plan, x2)
    if fast is not None:
        return fast
    if is_integer_payload(x2):
        out = _int_select_sum(plan, x2)
        if plan.semiring.mod2_fold:
            out = out & 1
        return out.to(x2.dtype)
    p = build_onehot(plan, dtype=x2.dtype)
    with no_tf32():
        return torch.matmul(p, x2).to(x2.dtype)


def _apply_reference(plan: PermutePlan, x2: torch.Tensor) -> torch.Tensor:
    """Index oracle, independent of the matmul machinery: REAL sums in
    float32; GF2 gathers XOR-accumulate semiring products and GF2
    scatters scatter-add bit planes and fold mod 2."""
    k, w, sr = plan.k, plan.weights, plan.semiring
    if sr.limbs:
        return _apply_gf2k_wide_reference(plan, x2)
    dev = x2.device
    n_in_c = max(plan.n_in - 1, 0)
    n_out_c = max(plan.n_out - 1, 0)
    if sr is REAL:
        acc = torch.zeros((plan.n_out, x2.shape[1]), dtype=torch.float32,
                          device=dev)
        xf = x2.to(torch.float32)
        for j in range(k):
            wj = 1.0 if w is None else w[:, j].to(torch.float32)[:, None]
            if plan.mode == GATHER:
                src = plan.idx[:, j]
                valid = ((src >= 0) & (src < plan.n_in))[:, None]
                vals = xf[src.clamp(0, n_in_c).long()] * wj
                acc = acc + torch.where(valid, vals, torch.zeros_like(vals))
            else:
                dest = plan.idx[:, j]
                valid = ((dest >= 0) & (dest < plan.n_out))[:, None]
                contrib = xf * wj
                acc.index_add_(0, dest.clamp(0, n_out_c).long(),
                               torch.where(valid, contrib,
                                           torch.zeros_like(contrib)))
        return acc.to(x2.dtype)
    cmask = sr.carrier_mask
    xi = x2.to(torch.int32) & cmask
    n_ctrl = plan.idx.shape[0]
    if plan.mode == GATHER:
        acc = torch.zeros((plan.n_out, x2.shape[1]), dtype=torch.int32,
                          device=dev)
        for j in range(k):
            src = plan.idx[:, j]
            valid = ((src >= 0) & (src < plan.n_in))[:, None]
            vals = xi[src.clamp(0, n_in_c).long()]
            wj = (torch.ones((n_ctrl, 1), dtype=torch.int32, device=dev)
                  if w is None else w[:, j].to(torch.int32)[:, None] & cmask)
            prod = sr.mul(wj, vals)
            acc = acc ^ torch.where(valid, prod, torch.zeros_like(prod))
        return acc.to(x2.dtype)
    nbits = max(sr.width, 1)
    shifts = torch.arange(nbits, dtype=torch.int32, device=dev)
    acc = torch.zeros((plan.n_out, x2.shape[1], nbits), dtype=torch.int32,
                      device=dev)
    for j in range(k):
        dest = plan.idx[:, j]
        valid = ((dest >= 0) & (dest < plan.n_out))[:, None]
        wj = (torch.ones((n_ctrl, 1), dtype=torch.int32, device=dev)
              if w is None else w[:, j].to(torch.int32)[:, None] & cmask)
        contrib = torch.where(valid, sr.mul(wj, xi), torch.zeros_like(xi))
        bitplanes = (contrib[:, :, None] >> shifts) & 1
        acc.index_add_(0, dest.clamp(0, n_out_c).long(), bitplanes)
    out = torch.sum((acc & 1) << shifts, dim=-1)
    return out.to(x2.dtype)


# ---------------------------------------------------------------------------
# GF(2^k) execution: the GF(2) bit lift
# ---------------------------------------------------------------------------
#
# Multiplication by a constant is GF(2)-linear, so a GF(2^width)-weighted
# plan over n element rows is exactly an unweighted GF2 plan over
# width·n bit rows: each select (o <- i, weight w) becomes, for output
# bit b, the selects {width·i + j : bit b of w·x^j == 1} — up to width
# bit selects per element select, DROP elsewhere.  Lifts are memoised on
# the source plan's tensor identities (as compiled schedules are), so
# the lifted plan and its schedule stay cache-stable across calls; each
# cached lift is sealed and re-verified on sampled hits by LIFT_GUARD.

_LIFT_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_LIFT_CACHE_CAPACITY = 32
_LIFT_STATS = {"hits": 0, "misses": 0}


def lift_cache_info() -> dict:
    return dict(_LIFT_STATS, size=len(_LIFT_CACHE),
                capacity=_LIFT_CACHE_CAPACITY)


def clear_lift_cache() -> None:
    for key in list(_LIFT_CACHE):
        _integrity.LIFT_GUARD.drop(key)
    _LIFT_CACHE.clear()
    _LIFT_STATS.update(hits=0, misses=0)


def _lift(plan: PermutePlan) -> PermutePlan:
    """``lift_gf2_k``'s construction (uncached)."""
    sr = plan.semiring
    width = sr.width
    idx = plan.idx                                      # (n_ctrl, k)
    dev = idx.device
    bound = plan.n_in if plan.mode == GATHER else plan.n_out
    valid = (idx >= 0) & (idx < bound)
    n_tiles = sr.limbs if sr.limbs else (width + 7) // 8
    if plan.weights is None:
        limbs = [torch.full(idx.shape, 1 if t == 0 else 0,
                            dtype=torch.int64, device=dev)
                 for t in range(n_tiles)]
    elif sr.limbs:
        w = plan.weights
        if w.dim() != 3 or tuple(w.shape) != tuple(idx.shape) + (sr.limbs,):
            raise ValueError(
                f"wide {sr.name} weights must be shaped "
                f"{tuple(idx.shape) + (sr.limbs,)} (idx + limb axis), got "
                f"{tuple(w.shape)}")
        limbs = [w[..., t].to(torch.int64) & 0xFF for t in range(n_tiles)]
    else:
        w = plan.weights.to(torch.int64) & sr.carrier_mask
        limbs = [(w >> (8 * t)) & 0xFF for t in range(n_tiles)]
    table = torch.as_tensor(sr_mod.gf2k_tile_table(width, sr.poly),
                            device=dev)
    m = None                                   # (n_ctrl, k, width b, width j)
    for t in range(n_tiles):
        mt = table[limbs[t]][..., 8 * t: 8 * t + width]
        m = mt if m is None else m ^ mt
    keep = valid[:, :, None, None] & (m != 0)
    safe = idx.clamp(0, max(bound - 1, 0))
    lanes = torch.arange(width, dtype=torch.int32, device=dev)
    if plan.mode == GATHER:
        # out bit width·o+b selects in bits {width·i+j : M[b,j]=1}.
        src = (width * safe)[:, :, None, None] + lanes[None, None, None, :]
        bit_idx = torch.where(keep, src, _t.DROP)       # (n_out, k, b, j)
        bit_idx = bit_idx.permute(0, 2, 1, 3).reshape(
            width * plan.n_out, width * plan.k)
        lifted = gather_plan(bit_idx, width * plan.n_in, semiring=sr_mod.GF2)
    else:
        # in bit width·i+j lands on out bits {width·o+b : M[b,j]=1}.
        dst = (width * safe)[:, :, None, None] + lanes[None, None, :, None]
        bit_idx = torch.where(keep, dst, _t.DROP)       # (n_in, k, b, j)
        bit_idx = bit_idx.permute(0, 3, 1, 2).reshape(
            width * plan.n_in, width * plan.k)
        lifted = scatter_plan(bit_idx, width * plan.n_out,
                              semiring=sr_mod.GF2)
    return lifted


def lift_gf2_k(plan: PermutePlan) -> PermutePlan:
    """The GF(2) bit-level plan equivalent to a GF(2^width) plan.

    Each select ``(o <- i, weight w)`` becomes, for output bit ``b``, the
    selects ``{width·i + j : M_w[b, j] = 1}``, ``M_w`` the constant's bit
    matrix assembled from ``semiring.gf2k_tile_table`` (``M_w[b, j] =
    XOR_t E[limb_t, b, j + 8t]``).  The lift keeps the plan's mode: a
    scatter lifts to a scatter (input bit ``width·i+j`` lands on output
    bits ``{width·o+b : M_w[b,j]=1}``), which accumulates colliding
    destinations exactly (XOR is per-bit parity).  Wide widths read the
    limbs from the weights' trailing axis, (n_ctrl, k, width // 8).
    """
    sr = plan.semiring
    if not sr.is_gf2k:
        raise ValueError(f"lift_gf2_k needs a GF(2^k) plan (width >= 2), "
                         f"got {sr.name!r}")
    width = sr.width
    # The semiring name is part of the key: two plans sharing the same
    # tensors under different widths must never collide.
    key = (plan.mode, plan.n_in, plan.n_out, sr.name, id(plan.idx),
           id(plan.weights) if plan.weights is not None else None)
    hit = _LIFT_CACHE.get(key)
    if hit is not None and hit[1] is plan.idx and hit[2] is plan.weights:
        # The key names the source tensors, so a flipped bit in the
        # lifted idx keeps hitting this entry: the sampled digest check
        # is what catches it.
        lifted_hit = hit[0]
        _integrity.LIFT_GUARD.verify(
            key, lambda: (lifted_hit.idx, lifted_hit.weights),
            evict=lambda: _LIFT_CACHE.pop(key, None))
        _LIFT_CACHE.move_to_end(key)
        _LIFT_STATS["hits"] += 1
        return lifted_hit
    _LIFT_STATS["misses"] += 1
    with _abstract.concrete(plan):
        lifted = _lift(plan)
    if _abstract.holds_fake(lifted):    # a payload-derived plan under audit
        return lifted
    _integrity.LIFT_GUARD.seal(key, (lifted.idx, lifted.weights))
    _LIFT_CACHE[key] = (lifted, plan.idx, plan.weights)
    while len(_LIFT_CACHE) > _LIFT_CACHE_CAPACITY:
        evicted_key, _ = _LIFT_CACHE.popitem(last=False)
        _integrity.LIFT_GUARD.drop(evicted_key)
    return lifted


def lift_gf2_8(plan: PermutePlan) -> PermutePlan:
    """The GF(2^8) entry point: the width-8 instance of ``lift_gf2_k``."""
    if plan.semiring is not sr_mod.GF2_8:
        raise ValueError(f"lift_gf2_8 needs a GF2_8 plan, got "
                         f"{plan.semiring.name!r}")
    return lift_gf2_k(plan)


def _run_lifted(lifted: PermutePlan, bits: torch.Tensor,
                backend: str) -> torch.Tensor:
    """Execute a lifted GF(2) bit plan on the chosen backend; the
    tile-skipping kernel's unwritten rows are pinned to zero from the
    lifted plan's own schedule."""
    if backend == "einsum":
        return _apply_einsum(lifted, bits)
    if backend == "kernel":
        from repro_torch.kernels import ops as _kops
        return _kops.crossbar_permute(lifted, bits)
    if backend == "sparse":
        return _apply_sparse(lifted, bits, pin_zeros=True)
    raise ValueError(f"no GF(2^k) path for backend {backend!r}")


def _apply_gf2k(plan: PermutePlan, x2: torch.Tensor,
                backend: str) -> torch.Tensor:
    """Unpack elements to LSB-first bit rows, run the lifted GF2 plan,
    pack back."""
    width = plan.semiring.width
    lifted = lift_gf2_k(plan)
    shifts = torch.arange(width, dtype=torch.int32, device=x2.device)
    bits = (x2.to(torch.int32)[:, None, :] >> shifts[None, :, None]) & 1
    bits = bits.reshape(width * plan.n_in, x2.shape[1])
    out_bits = _run_lifted(lifted, bits, backend)
    out_bits = out_bits.to(torch.int32).reshape(plan.n_out, width, -1)
    out = torch.sum(out_bits << shifts[None, :, None], dim=1)
    return out.to(x2.dtype)


def _wide_unpack(x2: torch.Tensor, n: int, limbs: int) -> torch.Tensor:
    """(n, D·L) canonical payload -> (width·n, D) bit rows.  The trailing
    payload axis is the limb axis (length L, fastest-varying), so bit row
    ``width·i + 8r + b`` is bit ``b`` of limb ``r`` of element ``i``."""
    d = x2.shape[1] // limbs
    x3 = x2.to(torch.int32).reshape(n, d, limbs)
    shifts = torch.arange(8, dtype=torch.int32, device=x2.device)
    bits = (x3.permute(0, 2, 1)[:, :, None, :]
            >> shifts[None, None, :, None]) & 1           # (n, L, 8, D)
    return bits.reshape(8 * limbs * n, d)


def _wide_pack(bits: torch.Tensor, n_out: int, limbs: int,
               dtype) -> torch.Tensor:
    """(width·n_out, D) bit rows -> (n_out, D·L) canonical payload."""
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    b4 = bits.to(torch.int32).reshape(n_out, limbs, 8, -1)
    packed = torch.sum(b4 << shifts[None, None, :, None], dim=2)
    return packed.permute(0, 2, 1).reshape(n_out, -1).to(dtype)


def _apply_gf2k_wide(plan: PermutePlan, x2: torch.Tensor,
                     backend: str) -> torch.Tensor:
    """Wide (limbed) GF(2^width): elements ride as trailing byte-limb
    axes; one lifted GF(2) crossbar evaluation over width·n bit rows."""
    sr = plan.semiring
    if x2.shape[1] % sr.limbs:
        raise ValueError(
            f"wide {sr.name} payloads need a trailing limb axis of "
            f"{sr.limbs}; flattened payload width {x2.shape[1]} is not "
            "divisible by it")
    bits = _wide_unpack(x2, plan.n_in, sr.limbs)
    out_bits = _run_lifted(lift_gf2_k(plan), bits, backend)
    return _wide_pack(out_bits, plan.n_out, sr.limbs, x2.dtype)


def _apply_gf2k_wide_reference(plan: PermutePlan,
                               x2: torch.Tensor) -> torch.Tensor:
    """Direct limbed-arithmetic oracle for wide gather plans (no lift
    involved); wide scatters run the lifted plan's reference path (a
    per-bit parity scatter-add, itself independent of the lift's
    backends)."""
    sr = plan.semiring
    limbs = sr.limbs
    if plan.mode != GATHER:
        bits = _wide_unpack(x2, plan.n_in, limbs)
        out_bits = _apply_reference(lift_gf2_k(plan), bits)
        return _wide_pack(out_bits, plan.n_out, limbs, x2.dtype)
    d = x2.shape[1] // limbs
    x3 = x2.to(torch.int32).reshape(plan.n_in, d, limbs) & 0xFF
    acc = torch.zeros((plan.n_out, d, limbs), dtype=torch.int32,
                      device=x2.device)
    for j in range(plan.k):
        src = plan.idx[:, j]
        valid = (src >= 0) & (src < plan.n_in)
        vals = x3[src.clamp(0, max(plan.n_in - 1, 0)).long()]
        if plan.weights is None:
            prod = vals
        else:
            wj = plan.weights[:, j].to(torch.int32) & 0xFF   # (n_out, L)
            prod = sr.mul(wj[:, None, :], vals)
        acc = acc ^ torch.where(valid[:, None, None], prod,
                                torch.zeros_like(prod))
    return acc.reshape(plan.n_out, -1).to(x2.dtype)


# ---------------------------------------------------------------------------
# Plan constructors for the three RVV instruction classes (Sec. II-A)
# ---------------------------------------------------------------------------

def vrgather_plan(src_idx: torch.Tensor, n_in: int) -> PermutePlan:
    """Output-driven: per-output source indices straight to the crossbar."""
    return gather_plan(src_idx, n_in)


def vcompress_plan(mask: torch.Tensor) -> PermutePlan:
    """Input-driven: mask bits -> bijective destinations -> crossbar."""
    dest = _t.compress_destinations(mask)
    return scatter_plan(dest, mask.shape[-1])


def vslide_plan(n: int, offset, *, up: bool, device=None) -> PermutePlan:
    """Input-driven, degenerate transform: index +- offset."""
    if device is None and isinstance(offset, torch.Tensor):
        device = offset.device
    dest = _t.slide_destinations(n, offset, up=up, device=resolve(device))
    return scatter_plan(dest, n)
