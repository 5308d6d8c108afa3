"""Plan algebra: compose, transpose and batch permutations.

Port of ``repro.core.plan_algebra``.  The one-hot crossbar operator is
closed under composition (``compose(p2, p1)`` is ``P2 @ P1``, so a K-deep
chain is one crossbar pass), transposition (the gather/scatter duality)
and direct sums (``block_diag`` / ``batch``: one block-diagonal plan of
tile occupancy 1/B instead of B passes).  Everything is computed on
control information alone.

Composition works in gather-normal form (``to_gather``); scatter plans
normalise exactly when output-injective, which every control transform
guarantees.  ``PlanExpr`` is the lazy front-end behind
``core.permute.lazy``: the RVV ops append symbolic nodes and ``apply()``
lowers the whole chain to exactly one ``apply_plan`` call.

Constructions are memoised on the identities of their input tensors, so
a rebuilt composed/batched plan is the *same* object and the schedule
cache keeps hitting.  ``shard_restrict`` cuts the (output-window,
input-window) block that mesh-sharded execution (``dist.mesh_exec``)
runs on one shard.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import abstract as _abstract
from repro_torch.core import crossbar as xb
from repro_torch.core import semiring as sr_mod
from repro_torch.core import transform as _t
from repro_torch.core.semiring import REAL, Semiring

DROP = _t.DROP


def _join(p2: xb.PermutePlan, p1: xb.PermutePlan) -> Semiring:
    return sr_mod.join(p2.semiring, p1.semiring,
                       neutral1=p2.neutral_semiring,
                       neutral2=p1.neutral_semiring)


_PLAN_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_PLAN_CACHE_CAPACITY = 128
_PLAN_CACHE_STATS = {"hits": 0, "misses": 0}


def plan_cache_info() -> dict:
    return dict(_PLAN_CACHE_STATS, size=len(_PLAN_CACHE),
                capacity=_PLAN_CACHE_CAPACITY)


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    _PLAN_CACHE_STATS.update(hits=0, misses=0)


def _memo(op: str, operands: tuple, static: tuple, build):
    """Memoised construction keyed on operand identity + static args.
    The entry holds strong references to its operands, so their ids
    cannot be recycled while it lives."""
    key = (op, static, tuple(id(a) for a in operands))
    hit = _PLAN_CACHE.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[1], operands)):
        _PLAN_CACHE.move_to_end(key)
        _PLAN_CACHE_STATS["hits"] += 1
        return hit[0]
    _PLAN_CACHE_STATS["misses"] += 1
    with _abstract.concrete(*operands):
        plan = build()
    if _abstract.holds_fake(plan):      # built from a payload under audit
        return plan
    _PLAN_CACHE[key] = (plan, operands)
    while len(_PLAN_CACHE) > _PLAN_CACHE_CAPACITY:
        _PLAN_CACHE.popitem(last=False)
    return plan


def to_gather(plan: xb.PermutePlan) -> xb.PermutePlan:
    """Rewrite a plan in gather-normal form (per-output sources).

    Exact for output-injective scatters; outputs nothing routes to
    become DROP rows.
    """
    if plan.mode == xb.GATHER:
        return plan

    def build():
        idx, n_out = plan.idx, plan.n_out
        dev = idx.device
        valid = (idx >= 0) & (idx < n_out)
        safe = idx.clamp(0, max(n_out - 1, 0)).reshape(-1).long()
        n_in, k = idx.shape
        src_of = torch.arange(n_in, dtype=torch.int32,
                              device=dev)[:, None].expand(n_in, k)
        hits = torch.zeros((n_out,), dtype=torch.int32, device=dev)
        hits.index_add_(0, safe, valid.reshape(-1).to(torch.int32))
        src = torch.zeros((n_out,), dtype=torch.int32, device=dev)
        src.index_add_(0, safe, torch.where(
            valid, src_of, torch.zeros_like(src_of)).reshape(-1))
        src = torch.where(hits > 0, src, DROP).to(torch.int32)
        weights = None
        if plan.weights is not None:
            w = torch.zeros((n_out,), dtype=plan.weights.dtype, device=dev)
            w.index_add_(0, safe, torch.where(
                valid, plan.weights,
                torch.zeros_like(plan.weights)).reshape(-1))
            weights = w[:, None]
        return xb.gather_plan(src, plan.n_in, weights=weights,
                              semiring=plan.semiring)

    return _memo("to_gather", (plan.idx, plan.weights),
                 (plan.n_in, plan.n_out, plan.semiring.name), build)


def with_weights(plan: xb.PermutePlan, weights, *,
                 semiring: Optional[Semiring] = None) -> xb.PermutePlan:
    """Same routing, new per-select weights."""
    w = torch.as_tensor(weights, device=plan.device)
    if w.dim() == 1:
        w = w[:, None]
    return xb.PermutePlan(plan.mode, plan.idx, plan.n_in, plan.n_out, w,
                          semiring or plan.semiring)


def with_semiring(plan: xb.PermutePlan, semiring: Semiring) -> xb.PermutePlan:
    """Same routing and weights, different accumulation algebra."""
    return xb.PermutePlan(plan.mode, plan.idx, plan.n_in, plan.n_out,
                          plan.weights, semiring)


def transpose(plan: xb.PermutePlan) -> xb.PermutePlan:
    """Gather/scatter duality; shares the idx tensor."""
    return xb.transpose_plan(plan)


def identity_plan(n: int, device=None) -> xb.PermutePlan:
    """The unit of composition: gather-of-iota."""
    from repro_torch._device import resolve
    return xb.gather_plan(torch.arange(n, dtype=torch.int32,
                                       device=resolve(device)), n)


def is_identity(plan: xb.PermutePlan) -> bool:
    """True iff the plan is provably the identity."""
    if plan.n_in != plan.n_out or plan.k != 1:
        return False
    if plan.weights is not None and not bool((plan.weights == 1).all()):
        return False
    g = to_gather(plan)
    iota = torch.arange(plan.n_in, dtype=torch.int32, device=plan.device)
    return bool(torch.equal(g.idx[:, 0], iota))


def compose(p2: xb.PermutePlan, p1: xb.PermutePlan) -> xb.PermutePlan:
    """Operator product: ``apply(compose(p2, p1), x) == apply(p2,
    apply(p1, x))``.

    Selects chain by index lookup (``idx[o, (a, b)] = g1.idx[g2.idx[o,
    a], b]``), weights multiply in the joined semiring, DROP propagates;
    the result has ``k2 * k1`` selects.
    """
    if p1.n_out != p2.n_in:
        raise ValueError(
            f"compose: p1 produces {p1.n_out} elements but p2 consumes "
            f"{p2.n_in}")
    sr = _join(p2, p1)

    def build():
        if is_identity(p1):
            return p2 if p2.semiring is sr else with_semiring(p2, sr)
        if is_identity(p2):
            return p1 if p1.semiring is sr else with_semiring(p1, sr)
        g2 = to_gather(p2)
        g1 = to_gather(p1)
        mid = p1.n_out
        outer_valid = (g2.idx >= 0) & (g2.idx < mid)
        safe = g2.idx.clamp(0, max(mid - 1, 0)).long()
        inner = g1.idx[safe]                                # (n_out, k2, k1)
        idx = torch.where(outer_valid[:, :, None], inner, DROP)
        idx = idx.reshape(p2.n_out, g2.k * g1.k).to(torch.int32)
        weights = None
        if g2.weights is not None or g1.weights is not None:
            wdt = sr.weight_dtype
            w2 = (sr.ones(g2.idx.shape, device=g2.device)
                  if g2.weights is None else g2.weights.to(wdt))
            w1 = (sr.ones((mid, g1.k), device=g1.device)
                  if g1.weights is None else g1.weights.to(wdt))
            w = sr.mul(w2[:, :, None], w1[safe])
            weights = w.reshape(p2.n_out, g2.k * g1.k)
        return xb.gather_plan(idx, p1.n_in, weights=weights, semiring=sr)

    return _memo("compose", (p2.idx, p2.weights, p1.idx, p1.weights),
                 (p2.mode, p2.n_in, p2.n_out, p2.semiring.name,
                  p1.mode, p1.n_in, p1.n_out, p1.semiring.name), build)


def compose_all(plans: Sequence[xb.PermutePlan], *,
                n: Optional[int] = None) -> xb.PermutePlan:
    """Fold a pipeline [first, ..., last] into one plan; the empty
    pipeline needs ``n`` and gives the identity."""
    plans = list(plans)
    if not plans:
        if n is None:
            raise ValueError(
                "compose_all: empty pipeline has no inferable length; "
                "pass n=<crossbar length> to get the identity plan")
        return identity_plan(n)
    if n is not None and plans[0].n_in != n:
        raise ValueError(
            f"compose_all: first plan consumes {plans[0].n_in} elements "
            f"but n={n} was declared")
    fused = plans[0]
    for p in plans[1:]:
        fused = compose(p, fused)
    return fused


def compact_selects(plan: xb.PermutePlan) -> xb.PermutePlan:
    """Pack each row's valid selects to the front; trim all-DROP columns."""
    g = to_gather(plan)

    def build():
        idx = g.idx.cpu().numpy()
        valid = (idx >= 0) & (idx < g.n_in)
        order = np.argsort(~valid, axis=1, kind="stable")
        idx2 = np.where(np.take_along_axis(valid, order, axis=1),
                        np.take_along_axis(idx, order, axis=1), DROP)
        k_new = max(1, int(valid.sum(axis=1).max(initial=0)))
        weights = None
        if g.weights is not None:
            w = g.weights.cpu().numpy()
            weights = torch.as_tensor(
                np.take_along_axis(w, order, axis=1)[:, :k_new],
                device=g.device)
        return xb.gather_plan(
            torch.as_tensor(idx2[:, :k_new].astype(np.int32),
                            device=g.device),
            g.n_in, weights=weights, semiring=g.semiring)

    return _memo("compact_selects", (g.idx, g.weights),
                 (g.n_in, g.n_out, g.semiring.name), build)


def block_diag(plans: Sequence[xb.PermutePlan]) -> xb.PermutePlan:
    """Direct sum of plans: one crossbar over the concatenated axes."""
    plans = list(plans)
    if not plans:
        raise ValueError(
            "block_diag: empty plan list has no well-defined geometry; "
            "the direct sum needs at least one plan")
    gs = [to_gather(p) for p in plans]
    kmax = max(g.k for g in gs)
    sr, neutral_so_far = REAL, True
    for g in gs:
        sr = sr_mod.join(sr, g.semiring, neutral1=neutral_so_far,
                         neutral2=g.neutral_semiring)
        neutral_so_far = neutral_so_far and g.neutral_semiring

    def build():
        rows, ws = [], []
        weighted = any(g.weights is not None for g in gs)
        off = 0
        for g in gs:
            valid = (g.idx >= 0) & (g.idx < g.n_in)
            idx = torch.where(valid, g.idx + off, DROP)
            if g.k < kmax:
                idx = torch.nn.functional.pad(idx, (0, kmax - g.k),
                                              value=DROP)
            rows.append(idx)
            if weighted:
                w = (sr.ones(g.idx.shape, device=g.device)
                     if g.weights is None else g.weights.to(sr.weight_dtype))
                if g.k < kmax:
                    w = torch.nn.functional.pad(w, (0, kmax - g.k))
                ws.append(w)
            off += g.n_in
        idx = torch.cat(rows, dim=0).to(torch.int32)
        weights = torch.cat(ws, dim=0) if weighted else None
        return xb.gather_plan(idx, off, weights=weights, semiring=sr)

    operands = tuple(g.idx for g in gs) + tuple(g.weights for g in gs)
    static = tuple((g.n_in, g.n_out, g.semiring.name) for g in gs)
    return _memo("block_diag", operands, static, build)


def batch(plan: xb.PermutePlan, b: int) -> xb.PermutePlan:
    """``block_diag([plan] * b)``, vectorised."""
    g = to_gather(plan)

    def build():
        valid = (g.idx >= 0) & (g.idx < g.n_in)
        offs = (torch.arange(b, dtype=torch.int32, device=g.device)
                * g.n_in)[:, None, None]
        idx = torch.where(valid[None], g.idx[None] + offs, DROP)
        idx = idx.reshape(b * g.n_out, g.k).to(torch.int32)
        weights = None if g.weights is None else g.weights.repeat(b, 1)
        return xb.gather_plan(idx, b * g.n_in, weights=weights,
                              semiring=g.semiring)

    return _memo("batch", (g.idx, g.weights),
                 (b, g.n_in, g.n_out, g.semiring.name), build)


def shard_restrict(plan: xb.PermutePlan, out_window: tuple,
                   in_window: tuple) -> xb.PermutePlan:
    """Restrict a plan to an (output-window, input-window) sub-operator.

    ``out_window`` / ``in_window`` are ``(start, size)`` half-open ranges
    on the gather-normal axes.  The result is the ``size_out x size_in``
    block of the operator in *local* coordinates: selects whose source
    falls outside the input window become DROP (their contribution
    belongs to another block), the others are rebased by the window
    start, and weights ride along unchanged.  Summing the blocks of a
    full tiling over the plan's semiring gives back the original
    operator — the identity mesh-sharded execution relies on.
    """
    g = to_gather(plan)
    o0, o_sz = out_window
    i0, i_sz = in_window
    if o0 < 0 or o_sz <= 0 or o0 + o_sz > g.n_out:
        raise ValueError(
            f"shard_restrict: output window ({o0}, {o_sz}) out of range "
            f"for n_out={g.n_out}")
    if i0 < 0 or i_sz <= 0 or i0 + i_sz > g.n_in:
        raise ValueError(
            f"shard_restrict: input window ({i0}, {i_sz}) out of range "
            f"for n_in={g.n_in}")

    def build():
        idx = g.idx[o0:o0 + o_sz]
        inside = (idx >= i0) & (idx < i0 + i_sz)
        local = torch.where(inside, idx - i0, DROP).to(torch.int32)
        weights = None if g.weights is None else g.weights[o0:o0 + o_sz]
        return xb.gather_plan(local, i_sz, weights=weights,
                              semiring=g.semiring)

    return _memo("shard_restrict", (g.idx, g.weights),
                 (o0, o_sz, i0, i_sz, g.n_in, g.n_out, g.semiring.name),
                 build)


def batched_gather_plan(idx: torch.Tensor, n_in: int, *, weights=None,
                        semiring: Semiring = REAL) -> xb.PermutePlan:
    """Distinct per-row gathers (B, n_out[, k]) -> one block-diagonal plan."""
    b, n_out = idx.shape[:2]
    k = idx.shape[2] if idx.dim() == 3 else 1

    def build():
        idx3 = idx if idx.dim() == 3 else idx[:, :, None]
        valid = (idx3 >= 0) & (idx3 < n_in)
        offs = (torch.arange(b, dtype=torch.int32, device=idx.device)
                * n_in)[:, None, None]
        flat = torch.where(valid, idx3.to(torch.int32) + offs, DROP)
        w = None if weights is None else weights.reshape(b * n_out, k)
        return xb.gather_plan(flat.reshape(b * n_out, k), b * n_in,
                              weights=w, semiring=semiring)

    return _memo("batched_gather", (idx, weights), (n_in, semiring.name),
                 build)


def batched_scatter_plan(dest: torch.Tensor, n_out: int, *, weights=None,
                         semiring: Semiring = REAL) -> xb.PermutePlan:
    """Distinct per-row scatters (B, n_in[, k]) -> one block-diagonal plan."""
    b, n_in = dest.shape[:2]
    k = dest.shape[2] if dest.dim() == 3 else 1

    def build():
        dest3 = dest if dest.dim() == 3 else dest[:, :, None]
        valid = (dest3 >= 0) & (dest3 < n_out)
        offs = (torch.arange(b, dtype=torch.int32, device=dest.device)
                * n_out)[:, None, None]
        flat = torch.where(valid, dest3.to(torch.int32) + offs, DROP)
        w = None if weights is None else weights.reshape(b * n_in, k)
        return xb.scatter_plan(flat.reshape(b * n_in, k), b * n_out,
                               weights=w, semiring=semiring)

    return _memo("batched_scatter", (dest, weights), (n_out, semiring.name),
                 build)


# ---------------------------------------------------------------------------
# Lazy expression front-end
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LazyOp:
    """One symbolic permutation node of a PlanExpr chain.

    kind: 'gather' | 'compress' | 'expand' | 'slide' | 'plan'.  mask:
    gather/slide — the v0 destination mask; compress/expand — the
    element mask that is the control information.
    """

    kind: str
    n: int
    idx: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    offset: Any = None
    up: bool = True
    tail: str = "zero"
    plan: Optional[xb.PermutePlan] = None
    device: Optional[torch.device] = None

    @property
    def n_out(self) -> int:
        if self.kind == "gather":
            return self.idx.shape[0]
        if self.kind == "plan":
            return self.plan.n_out
        return self.n

    def lower(self) -> xb.PermutePlan:
        """Gather-normal plan with destination masking folded in."""
        if self.kind == "gather":
            plan = to_gather(xb.gather_plan(self.idx.to(torch.int32),
                                            self.n))
            out_mask = self.mask
        elif self.kind == "compress":
            plan = to_gather(xb.vcompress_plan(self.mask))
            if self.tail == "bijective":
                out_mask = None
            else:
                k = _t.compress_keep_count(self.mask)
                out_mask = torch.arange(self.n, dtype=torch.int32,
                                        device=self.mask.device) < k
        elif self.kind == "expand":
            plan = to_gather(xb.transpose_plan(xb.vcompress_plan(self.mask)))
            out_mask = self.mask
        elif self.kind == "slide":
            plan = to_gather(xb.vslide_plan(self.n, self.offset, up=self.up,
                                            device=self.device))
            out_mask = self.mask
        elif self.kind == "plan":
            plan = to_gather(self.plan)
            out_mask = self.mask
        else:
            raise ValueError(f"unknown lazy op kind {self.kind!r}")
        if out_mask is not None:
            keep = out_mask.to(torch.bool)[:, None]
            plan = xb.gather_plan(torch.where(keep, plan.idx, DROP),
                                  plan.n_in, weights=plan.weights,
                                  semiring=plan.semiring)
        return plan


def _offset_sum(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.as_tensor(a, dtype=torch.int32) + torch.as_tensor(
            b, dtype=torch.int32)
    return int(a) + int(b)


def _simplify_ops(ops: list) -> list:
    """Peephole rewrites: same-direction unmasked slide∘slide folds into
    one summed-offset slide; unmasked gather-of-iota is eliminated."""
    out: list = []
    for op in ops:
        if (op.kind == "gather" and op.mask is None
                and op.idx.shape[0] == op.n
                and bool(torch.equal(op.idx.to(torch.int64), torch.arange(
                    op.n, device=op.idx.device)))):
            continue
        prev = out[-1] if out else None
        if (prev is not None and op.kind == "slide" and prev.kind == "slide"
                and op.up == prev.up and op.mask is None
                and prev.mask is None):
            out[-1] = dataclasses.replace(
                prev, offset=_offset_sum(prev.offset, op.offset))
            continue
        out.append(op)
    return out


class PlanExpr:
    """A payload plus a pending chain of symbolic permutation ops.

    ``apply()`` fuses the chain — simplification, then a left fold of
    ``compose`` — into one plan and makes exactly one ``apply_plan``
    call, whatever the chain's depth.
    """

    def __init__(self, x: torch.Tensor, ops: Sequence[LazyOp] = (),
                 group: int = 1, backend: Optional[str] = None):
        self.x = x
        self.ops = list(ops)
        self.group = group
        self.backend = backend

    @property
    def _n0(self) -> int:
        n = self.x.shape[0]
        if n % self.group:
            raise ValueError(f"group {self.group} does not divide N={n}")
        return n // self.group

    @property
    def n_current(self) -> int:
        return self.ops[-1].n_out if self.ops else self._n0

    def then(self, op: LazyOp, *, group: int = 1,
             backend: str = "einsum") -> "PlanExpr":
        if self.ops and group != self.group:
            raise ValueError(
                f"lazy chain grouped by {self.group} cannot take an op "
                f"with group={group}; evaluate first")
        hint = self.backend
        if backend != "einsum":
            if hint is not None and hint != backend:
                raise ValueError(
                    f"lazy chain already requested backend {hint!r}; a "
                    f"fused chain runs on one backend (got {backend!r})")
            hint = backend
        g = group if not self.ops else self.group
        expr = PlanExpr(self.x, self.ops, g, hint)
        op = dataclasses.replace(op, n=expr.n_current, device=self.x.device)
        if op.kind == "gather" and op.idx.dim() != 1:
            raise ValueError("lazy vrgather needs a 1-D index vector")
        expr.ops.append(op)
        return expr

    def plan(self) -> xb.PermutePlan:
        """The fused plan of the whole chain (identity if empty)."""
        ops = _simplify_ops(self.ops)
        if not ops:
            return identity_plan(self._n0, device=self.x.device)
        return compose_all([op.lower() for op in ops])

    def apply(self, *, backend: Optional[str] = None) -> torch.Tensor:
        """Evaluate the chain with a single crossbar pass."""
        backend = backend or self.backend or "einsum"
        g = self.group
        shape = tuple(self.x.shape)
        xg = self.x.reshape(shape[0] // g, -1) if g > 1 or self.x.dim() > 1 \
            else self.x
        plan = self.plan()
        out = xb.apply_plan(plan, xg, backend=backend)
        return out.reshape((plan.n_out * g,) + shape[1:])
