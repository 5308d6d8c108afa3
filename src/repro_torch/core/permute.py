"""RVV-semantics permutation API on the unified crossbar.

Port of ``repro.core.permute``: ``vrgather`` (output-driven),
``vcompress``, ``vexpand`` and ``vslideup``/``vslidedown`` (input-driven
after the control transform) all build a ``PermutePlan`` and execute it
through ``crossbar.apply_plan``.  A ``lazy(x)`` payload makes the same
ops symbolic, and the whole chain lowers to one fused plan and one
crossbar pass at ``.apply()``.  ``vslide1up``/``vslide1down`` are the
pad-shift fast path outside the datapath; ``vmerge`` is the v0 select.
Plans are built on the payload's device.
"""

from __future__ import annotations

import torch

from repro_torch._device import no_tf32
from repro_torch.core import crossbar as xb
from repro_torch.core import plan_algebra as pa
from repro_torch.core import transform as _t


def lazy(x: torch.Tensor) -> pa.PlanExpr:
    """Wrap a payload for lazy fusion:
    ``P.vslideup(P.vcompress(P.lazy(x), mask), 3).apply()``."""
    return pa.PlanExpr(x)


def _flush(expr: pa.PlanExpr) -> torch.Tensor:
    return expr.apply()


def _group(x: torch.Tensor, g: int):
    shape = tuple(x.shape)
    if shape[0] % g:
        raise ValueError(f"group {g} does not divide N={shape[0]}")
    return x.reshape(shape[0] // g, -1), shape


def vrgather(x, idx, *, mask=None, merge=None, group: int = 1,
             backend: str = "einsum"):
    """Output-driven gather: ``out[o] = x[idx[o]]`` (OOB index -> 0)."""
    if isinstance(x, pa.PlanExpr):
        if merge is not None:
            return pa.PlanExpr(vrgather(_flush(x), idx, mask=mask,
                                        merge=merge, group=group,
                                        backend=backend))
        return x.then(pa.LazyOp("gather", 0, idx=idx.to(torch.int32),
                                mask=mask), group=group, backend=backend)
    xg, shape = _group(x, group)
    plan = xb.vrgather_plan(idx.to(torch.int32), xg.shape[0])
    mg = _group(merge, group)[0] if merge is not None else None
    out = xb.apply_plan(plan, xg, merge=mg, out_mask=mask, backend=backend)
    return out.reshape((plan.n_out * group,) + shape[1:])


def vcompress(x, mask, *, tail: str = "zero", merge=None, group: int = 1,
              backend: str = "einsum"):
    """Selected elements packed to the front; the tail is 'bijective'
    (unselected elements, order kept), 'zero', or 'keep' (merge)."""
    if isinstance(x, pa.PlanExpr):
        if tail == "keep":
            return pa.PlanExpr(vcompress(_flush(x), mask, tail=tail,
                                         merge=merge, group=group,
                                         backend=backend))
        if tail not in ("zero", "bijective"):
            raise ValueError(f"unknown tail policy {tail!r}")
        return x.then(pa.LazyOp("compress", 0, mask=mask, tail=tail),
                      group=group, backend=backend)
    xg, shape = _group(x, group)
    n = xg.shape[0]
    plan = xb.vcompress_plan(mask)
    if tail == "bijective":
        out_mask = None
    elif tail in ("zero", "keep"):
        k = _t.compress_keep_count(mask)
        out_mask = torch.arange(n, dtype=torch.int32, device=x.device) < k
    else:
        raise ValueError(f"unknown tail policy {tail!r}")
    mg = _group(merge, group)[0] if (merge is not None and tail == "keep") \
        else None
    out = xb.apply_plan(plan, xg, merge=mg, out_mask=out_mask,
                        backend=backend)
    return out.reshape(shape)


def vexpand(x, mask, *, merge=None, group: int = 1, backend: str = "einsum"):
    """Inverse compress: front elements scattered back to mask=1 slots."""
    if isinstance(x, pa.PlanExpr):
        if merge is not None:
            return pa.PlanExpr(vexpand(_flush(x), mask, merge=merge,
                                       group=group, backend=backend))
        return x.then(pa.LazyOp("expand", 0, mask=mask), group=group,
                      backend=backend)
    xg, shape = _group(x, group)
    plan = xb.transpose_plan(xb.vcompress_plan(mask))
    mg = _group(merge, group)[0] if merge is not None else None
    out = xb.apply_plan(plan, xg, merge=mg, out_mask=mask.to(torch.bool),
                        backend=backend)
    return out.reshape(shape)


def _slide(x, offset, up, mask, merge, group, backend):
    if isinstance(x, pa.PlanExpr):
        if merge is not None:
            return pa.PlanExpr(_slide(_flush(x), offset, up, mask, merge,
                                      group, backend))
        return x.then(pa.LazyOp("slide", 0, offset=offset, up=up, mask=mask),
                      group=group, backend=backend)
    xg, shape = _group(x, group)
    plan = xb.vslide_plan(xg.shape[0], offset, up=up, device=x.device)
    mg = _group(merge, group)[0] if merge is not None else None
    out = xb.apply_plan(plan, xg, merge=mg, out_mask=mask, backend=backend)
    return out.reshape(shape)


def vslideup(x, offset, *, mask=None, merge=None, group: int = 1,
             backend: str = "einsum"):
    """``out[i+offset] = x[i]``; out[:offset] undisturbed (merge)."""
    return _slide(x, offset, True, mask, merge, group, backend)


def vslidedown(x, offset, *, mask=None, merge=None, group: int = 1,
               backend: str = "einsum"):
    """``out[i] = x[i+offset]``; reads past the end give zero."""
    return _slide(x, offset, False, mask, merge, group, backend)


def vslide1up(x: torch.Tensor, scalar=0) -> torch.Tensor:
    """Single-position slide — the pad-shift path outside the crossbar."""
    fill = torch.full_like(x[:1], scalar)
    return torch.cat([fill, x[:-1]], dim=0)


def vslide1down(x: torch.Tensor, scalar=0) -> torch.Tensor:
    fill = torch.full_like(x[:1], scalar)
    return torch.cat([x[1:], fill], dim=0)


def vmerge(on_true, on_false, mask) -> torch.Tensor:
    """RVV vmerge: per-element select by the v0 mask."""
    m = mask.to(torch.bool)
    m = m.reshape(tuple(m.shape) + (1,) * (on_true.dim() - m.dim()))
    return torch.where(m, on_true, on_false)


def batched(fn, *, in_axes=0):
    """Lift a permutation op over a leading batch axis: the batch
    dimension written out as a loop, results stacked.  ``in_axes`` is 0
    (every argument batched) or a tuple with 0/None per argument."""

    def run(*args):
        axes = in_axes if isinstance(in_axes, (tuple, list)) \
            else (in_axes,) * len(args)
        b = next(a.shape[0] for a, ax in zip(args, axes) if ax == 0)
        outs = [fn(*[a[i] if ax == 0 else a for a, ax in zip(args, axes)])
                for i in range(b)]
        return torch.stack(outs)

    return run


def _block_diag_dense(dest: torch.Tensor, x3: torch.Tensor) -> torch.Tensor:
    """One batched contraction over the diagonal blocks only:
    ``out[b, o] = sum_i [dest[b, i] == o] * x3[b, i]``.  Integer payloads
    contract in float64 (exact: each output row sums one value)."""
    n = dest.shape[-1]
    iota = torch.arange(n, dtype=torch.int32, device=dest.device)
    onehot = dest[:, None, :] == iota[None, :, None]          # (B, out, in)
    if not x3.dtype.is_floating_point:
        out = torch.einsum("boi,bid->bod", onehot.to(torch.float64),
                           x3.to(torch.float64))
        return out.to(torch.int64).to(x3.dtype)
    with no_tf32():
        out = torch.einsum("boi,bid->bod", onehot.to(x3.dtype), x3)
    return out.to(x3.dtype)


def vcompress_batched(x, mask, *, tail: str = "zero", group: int = 1,
                      backend: str = "auto"):
    """Per-row vcompress over a batch as ONE block-diagonal crossbar.

    x: (B, N, ...); mask: (B, N//group).  'sparse'/'kernel'/'reference'
    run the flattened block-diagonal plan through ``apply_plan``;
    'einsum' contracts the diagonal blocks only; 'auto' takes the
    flattened plan when the density heuristic picks the sparse kernel
    (control on a CUDA device), else the batched-dense contraction.
    """
    if backend not in ("auto", "einsum", "sparse", "kernel", "reference"):
        raise ValueError(f"unknown backend {backend!r}")
    b, n = x.shape[0], x.shape[1]
    if n % group:
        raise ValueError(f"group {group} does not divide N={n}")
    ng = n // group
    dest = _t.compress_destinations(mask)
    if tail == "bijective":
        row_mask = None
    elif tail == "zero":
        k = _t.compress_keep_count(mask)
        row_mask = torch.arange(ng, dtype=torch.int32,
                                device=mask.device)[None, :] < k[:, None]
    else:
        raise ValueError(f"unsupported batched tail policy {tail!r}")

    flat = backend in ("sparse", "kernel", "reference")
    if backend == "auto" and dest.is_cuda:
        plan = pa.batched_scatter_plan(dest, ng)
        if xb._choose_backend(plan) == "sparse":
            backend, flat = "sparse", True
    if flat:
        plan = pa.batched_scatter_plan(dest, ng)
        out = xb.apply_plan(
            plan, x.reshape(b * ng, -1),
            out_mask=None if row_mask is None else row_mask.reshape(b * ng),
            backend=backend)
        return out.reshape(x.shape)
    out3 = _block_diag_dense(dest, x.reshape(b, ng, -1))
    if row_mask is not None:
        out3 = torch.where(row_mask[:, :, None], out3,
                           torch.zeros_like(out3))
    return out3.reshape(x.shape)
