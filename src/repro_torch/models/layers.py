"""Shared model building blocks (functional: init dicts + apply fns).

Port of ``repro.models.layers``.  Conventions, as in the reference:

* parameters are nested dicts of tensors, each weight in the
  reference's ``(d_in, d_out)`` layout;
* weights are stored in ``param_dtype`` (float32 master) and cast to
  ``compute_dtype`` at use;
* a product the reference accumulates in float32 and then casts to the
  compute dtype runs in the compute dtype here (one rounding of a
  float32 accumulation either way); a product whose float32 result the
  reference keeps (attention scores, logits, the expert gate) runs in
  float32 on operands rounded to the compute dtype (``einsum_f32``).

The initialisers draw from a ``torch.Generator`` on the device their
caller resolved (``moe.lm_init``), which every one of them requires;
they do not reproduce the reference's ``jax.random`` bits (weights are
carried across with ``models.params.params_from_numpy``).

Under the sharded executor's model-axis group (``dist.annotate``) every
family holds activations and parameter blocks as ``Parts``; the
functions here then compute each rank's share: a norm rank by rank (an
RMSNorm over a split last dimension, Mamba2's gated norm, from the
ranks' float32 sums of squares all-reduced over "model"), the MLP on
its d_ff block (wi / wg by their column blocks, wo by its d_ff rows:
float32 partial sums, reduce-scattered into the carry and rounded once;
in a decode step by its columns on the gathered activation, every
product one device's), the embedding (a frontend prefix joined to it)
and the head on the rank's vocabulary rows, and the cross-entropy
reduced over the vocabulary split (a max and a sum of exponentials
across ranks, the label's logit from the rank that holds it).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import no_tf32
from repro_torch.dist import annotate as ann
from repro_torch.dist.annotate import Parts, annotate

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name (``"float32"`` / ``"bfloat16"``) as a torch
    dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``einsum`` in the operands' dtype; float32 products stay float32
    whatever the process-wide TF32 setting (``no_tf32``)."""
    with no_tf32():
        return torch.einsum(eq, *operands)


def einsum_f32(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``einsum`` with a float32 result: the reference's
    ``preferred_element_type=float32`` over compute-dtype operands
    (bf16 widens to float32 exactly; float32 products, never TF32)."""
    return einsum(eq, *(o.to(torch.float32) for o in operands))


# -- initialisers --------------------------------------------------------------

def truncated_normal(gen: torch.Generator, shape, scale: float,
                     device) -> torch.Tensor:
    """Normal draws truncated to two standard deviations, times scale."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale)


def dense_init(gen, d_in, d_out, *, device, bias=False, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": truncated_normal(gen, (d_in, d_out), scale, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
    return p


def norm_init(d, kind, device):
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def embed_init(gen, vocab, d, device, scale=0.02):
    return {"table": truncated_normal(gen, (vocab, d), scale, device)}


# -- apply ---------------------------------------------------------------------

def dense(p, x, compute_dtype=torch.bfloat16):
    """``x @ w (+ b)`` in the compute dtype."""
    w = p["w"].to(compute_dtype)
    xc = x.to(compute_dtype)
    if "b" in p:   # the bias joins the float32 accumulation
        y = einsum_f32("...d,df->...f", xc, w) + p["b"].to(torch.float32)
        return y.to(compute_dtype)
    with no_tf32():
        return torch.matmul(xc, w)


def apply_norm(p, x, kind="rmsnorm", eps=1e-6):
    if isinstance(x, Parts):
        if x.dim == len(x.shape) - 1 and kind == "rmsnorm":
            return _rms_norm_split(p, x, eps)
        if x.dim in (ann.SUM, len(x.shape) - 1):
            raise ValueError(f"a {kind} over {x}")
        return x.g.map(lambda pr, xr: apply_norm(pr, xr, kind, eps), p, x,
                       dim=x.dim)
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def _rms_norm_split(p, x, eps):
    """An RMSNorm over a last dimension split over "model" (Mamba2's
    gated norm over its heads' blocks of d_inner): each rank's float32
    sum of squares, summed over "model" (an all-reduce), then each rank
    scales its block by its block of the scale (whole, or its block
    already)."""
    g = x.g
    d = x.shape[-1]
    f32 = torch.float32
    ss = g.map(lambda t: torch.sum(torch.square(t.to(f32)), dim=-1,
                                   keepdim=True), x, dim=ann.SUM)
    ss = annotate(ss, "batch")

    def scale(r, pr, xr, sr):
        sc = pr["scale"]
        if sc.shape[0] == d:
            sc = sc[slice(*g.block(d, r))]
        return (xr.to(f32) * torch.rsqrt(sr / d + eps) * sc).to(xr.dtype)
    return g.map(scale, p, x, ss, rank=True, dim=x.dim)


def embed_lookup(p, tokens, compute_dtype=torch.bfloat16, *, prefix=None):
    """Table row gather (rows gathered, then cast: the same values as
    casting the whole table first); ``prefix`` (B, F, D), a frontend's
    embeddings, is joined ahead of the rows along the sequence.  Split
    over "model": each rank gathers the rows of its vocabulary block
    (zeros for the others'), the prefix joined to rank 0's part (zeros
    to the others': the ranks' sum is the joined sequence), and the
    ranks' sum is placed as the layer stack's carry."""
    if isinstance(tokens, Parts):
        return _embed_split(p["table"], tokens, compute_dtype, prefix)
    x = p["table"][tokens.long()].to(compute_dtype)
    if prefix is not None:
        x = torch.cat([prefix.to(compute_dtype), x], dim=1)
    return x


def _embed_split(table, tokens, dtype, prefix):
    g = tokens.g
    if table.dim is None:
        x = g.map(lambda t, tok: t[tok.long()].to(dtype), table, tokens)
    else:
        def part(r, t, tok):
            n = t.shape[0]
            local = tok.long() - r * n
            inside = ((local >= 0) & (local < n))[..., None]
            return t[local.clamp(0, n - 1)].to(dtype) * inside.to(dtype)
        x = g.map(part, table, tokens, dim=ann.SUM, rank=True)
    if prefix is not None:
        def join(r, pre, xr):
            pre = pre.to(dtype)
            if x.dim == ann.SUM and r != 0:
                pre = torch.zeros_like(pre)
            return torch.cat([pre, xr], dim=1)
        x = g.map(join, prefix, x, rank=True, dim=x.dim)
    return annotate(x, "batch", "tp", None)


def logits_projection(p, x, compute_dtype=torch.bfloat16):
    """``x @ table^T`` -> (..., vocab), float32; split over "model", the
    vocabulary stays split (each rank's rows of the table)."""
    if isinstance(x, Parts):
        g = x.g
        x = annotate(x, "batch")
        table = p["table"]
        out = g.map(lambda t, xr: logits_projection({"table": t}, xr,
                                                    compute_dtype),
                    table, x,
                    dim=None if table.dim is None else len(x.shape) - 1)
        return annotate(out, "batch", *([None] * (len(x.shape) - 2)), "tp")
    return einsum_f32("...d,vd->...v", x.to(compute_dtype),
                      p["table"].to(compute_dtype))


def split_dense(w, x, dtype, *, cols=None):
    """``dense(w, x)`` for ``Parts`` ``x`` (replicated) and ``w`` (its
    column blocks, or whole): a ``Parts`` split on the last dimension
    (replicated when ``w`` is whole).  A block of several spans (Mamba2's
    ``in_proj``) gives ``cols = (width, spans)``: the whole width and
    ``spans(r)``, rank r's columns as (start, stop) spans.

    Where each row is one position (a decode step), a rank's block runs
    at the whole matrix's shape, in place among zeros, and its columns
    are kept: at a decode window's few rows cuBLAS picks its algorithm by
    the product's width, and a narrower product is not bit-equal to one
    device's (NVIDIA H100: Mixtral's 6144 x 6144 wq at 2 rows differs at
    0.16 % of its entries when cut in half, at none at the whole width),
    while at the many rows of training and prefill a column block is
    bit-equal (``tests/torch_split_numerics.py``).  A decode step then
    equals one device's, at the cost of reading the zeros: on a seeded
    Mixtral-8x22B of 5 layers the narrow products put decode's logit
    rows 1.070e-2 off one device's in L2 (NVIDIA H100 80GB HBM3), where
    ``chip_smoke.py`` holds the sharded decode to 1e-2."""
    g = x.g
    if w["w"].dim is None:
        return g.map(lambda wr, xr: dense(wr, xr, dtype), w, x)

    def part(r, wr, xr):
        if xr.shape[-2] != 1:
            return dense(wr, xr, dtype)
        n = wr["w"].shape[-1]
        width, spans = cols or (n * g.k, lambda r: [(r * n, (r + 1) * n)])
        idx = torch.cat([torch.arange(lo, hi, device=xr.device)
                         for lo, hi in spans(r)])

        def among_zeros(t):
            out = t.new_zeros(t.shape[:-1] + (width,))
            out[..., idx] = t
            return out
        whole = {k: among_zeros(v.to(dtype) if k == "w" else v)
                 for k, v in wr.items()}
        return dense(whole, xr, dtype).index_select(-1, idx)
    return g.map(part, w, x, rank=True, dim=len(x.shape) - 1)


def _widen(t, r, k, dim=-1):
    """``t``, rank r's block of k along ``dim`` (the last by default), in
    place among zeros of the whole extent."""
    shape = list(t.shape)
    n = shape[dim]
    shape[dim] = n * k
    out = t.new_zeros(shape)
    out.narrow(dim, r * n, n).copy_(t)
    return out


def each(fn, x, *args):
    """``fn(x, *args)``; rank by rank where ``x`` is a replicated
    ``Parts`` (a window's batch rows on every rank of its row)."""
    if isinstance(x, Parts):
        if x.dim is not None:
            raise ValueError(f"{x} is not replicated")
        return x.g.map(fn, x, *args)
    return fn(x, *args)


def gathered(x):
    """A value as one tensor: a ``Parts`` gathered over "model" (its
    first running rank's copy); a tensor as it is."""
    if isinstance(x, Parts):
        return x.g.one(annotate(x, "batch"))
    return x


def assign(dst, src) -> None:
    """``dst.copy_(src)``, rank by rank for ``Parts`` placed alike."""
    if not isinstance(dst, Parts):
        dst.copy_(src)
        return
    if src.dim != dst.dim:
        raise ValueError(f"writing {src} into {dst}: place them alike")
    for r, t in dst.t.items():
        t.copy_(src.t[r])


def cast(x, dtype):
    """``x.to(dtype)``, rank by rank for ``Parts``."""
    if isinstance(x, Parts):
        return x.g.map(lambda t: t.to(dtype), x, dim=x.dim)
    return x.to(dtype)


# -- rotary position embedding -------------------------------------------------

def rope_freqs(hd_rot: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd_rot, 2, dtype=torch.float32,
                        device=device) / hd_rot
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, *, theta: float, rotary_pct: float = 1.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    hd_rot = int(hd * rotary_pct)
    hd_rot -= hd_rot % 2
    if hd_rot == 0:
        return x
    freqs = rope_freqs(hd_rot, theta, x.device)            # (hd_rot/2,)
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xr, xp = x[..., :hd_rot], x[..., hd_rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


# -- MLPs ----------------------------------------------------------------------

def mlp_init(gen, d, f, *, act="swiglu", device):
    if act == "swiglu":
        return {"wi": dense_init(gen, d, f, device=device),
                "wg": dense_init(gen, d, f, device=device),
                "wo": dense_init(gen, f, d, device=device)}
    return {"wi": dense_init(gen, d, f, device=device),
            "wo": dense_init(gen, f, d, device=device)}


def mlp_apply(p, x, *, act="swiglu", compute_dtype=torch.bfloat16):
    """SwiGLU or GELU MLP; the activation runs in float32.  GELU is the
    tanh approximation, ``jax.nn.gelu``'s default.  Split over "model":
    wi / wg by d_ff columns, wo by d_ff rows (``project_out``)."""
    if isinstance(x, Parts):
        return _mlp_split(p, x, act, compute_dtype)
    f32 = torch.float32
    if act == "swiglu":
        h = torch.nn.functional.silu(dense(p["wg"], x, compute_dtype).to(f32))
        h = h * dense(p["wi"], x, compute_dtype).to(f32)
        return dense(p["wo"], h.to(compute_dtype), compute_dtype)
    h = torch.nn.functional.gelu(dense(p["wi"], x, compute_dtype).to(f32),
                                 approximate="tanh")
    return dense(p["wo"], h.to(compute_dtype), compute_dtype)


def _mlp_split(p, x, act, dtype):
    g = x.g
    f32 = torch.float32
    x = annotate(x, "batch")                     # the sequence gathered
    hi = cast(split_dense(p["wi"], x, dtype), f32)
    if act == "swiglu":
        hg = cast(split_dense(p["wg"], x, dtype), f32)
        h = g.map(lambda a, b: torch.nn.functional.silu(a) * b, hg, hi,
                  dim=hi.dim)
    else:
        h = g.map(lambda a: torch.nn.functional.gelu(a, approximate="tanh"),
                  hi, dim=hi.dim)
    h = annotate(h, "batch", *([None] * (len(h.shape) - 2)), "tp")
    return project_out(p["wo"], cast(h, dtype), dtype)


def project_out(wo, h, dtype):
    """An output projection split over "model", placed as the carry
    (split on the sequence where it divides).  By wo's rows: each rank's
    block of ``h``'s last dimension (split there already, or cut from a
    replicated ``h``) times its row block of wo, a float32 partial sum;
    the partials reduce-scattered and rounded to ``dtype`` once, as the
    reference's float32 product is partitioned over its contraction.
    A decode step's wo comes by its columns (``sharding.compute_block``):
    ``h`` gathered whole, times the column block (``split_dense``).
    With wo whole (its rows do not divide the axis) every rank computes
    the whole product."""
    g = h.g
    if wo["w"].dim != 0:
        y = split_dense(wo, annotate(h, "batch"), dtype)
        return annotate(y, "batch", "tp", None)
    h = ann.reshard(h, len(h.shape) - 1)
    y = g.map(lambda wr, hr: einsum_f32("...f,fd->...d", hr.to(dtype),
                                        wr["w"].to(dtype)),
              wo, h, dim=ann.SUM)
    return cast(annotate(y, "batch", "tp", None), dtype)


# -- layer stacks --------------------------------------------------------------

def stack_layer_params(init_fn, gen, n_layers):
    """``n_layers`` layers of one structure, drawn in turn from ``gen``:
    the port's list of per-layer dicts (the reference stacks them on a
    leading L axis)."""
    return [init_fn(gen) for _ in range(n_layers)]


def scan(cfg, body, carry, xs):
    """``lax.scan`` over a layer stack: ``body(carry, xs[i]) -> (carry,
    y)`` for each i in turn; returns (carry, [y, ...]).

    With ``cfg.remat == "full"`` and grad enabled, each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): only its inputs are kept
    and its forward runs again in the backward pass — the reference's
    per-layer ``jax.checkpoint``.  ``xs[i]`` is read inside the
    checkpointed body, so a stack whose items are made when read (the
    sharded executor's per-layer gather, ``dist.spmd``) makes layer i
    again for the recompute and keeps none of it between the passes.
    ``cfg.scan_unroll`` has nothing to unroll here.
    """
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    ys = []
    for i in range(len(xs)):
        if remat:
            carry, y = checkpoint(_item_body, body, carry, xs, i,
                                  use_reentrant=False)
        else:
            carry, y = body(carry, xs[i])
        ys.append(y)
    return carry, ys


def _item_body(body, carry, xs, i):
    return body(carry, xs[i])


# -- loss ----------------------------------------------------------------------

def cross_entropy(logits, labels, *, mask=None):
    """Token-level CE with an optional validity mask; logits (..., V).

    The gold logit is picked with a gather (``take_along_dim``), never a
    one-hot contraction: a (B, S, V) float32 one-hot is far larger than
    the logits at a 150k vocabulary.
    """
    if isinstance(logits, Parts):
        return _cross_entropy_split(logits, labels, mask)
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(),
                                dim=-1)[..., 0]
    nll = lse - gold
    if mask is not None:
        m = mask.to(torch.float32)
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)


def _cross_entropy_split(logits, labels, mask):
    """``cross_entropy`` of vocabulary-split (or replicated) logits on
    every rank; returns the first running rank's value."""
    g = logits.g
    if logits.dim is None:
        out = g.map(lambda lg, y, m: cross_entropy(lg, y, mask=m), logits,
                    labels, mask)
        return g.one(out)
    f32 = torch.float32
    lf = cast(logits, f32)
    mx = ann.all_reduce_max(g.map(lambda lg: lg.amax(-1), lf, dim=ann.SUM))
    se = g.map(lambda lg, m: torch.sum(torch.exp(lg - m[..., None]), -1),
               lf, mx, dim=ann.SUM)
    se = annotate(se, "batch")

    def pick(r, lg, y):
        n = lg.shape[-1]
        local = y.long() - r * n
        inside = (local >= 0) & (local < n)
        v = torch.take_along_dim(lg, local.clamp(0, n - 1)[..., None],
                                 dim=-1)[..., 0]
        return torch.where(inside, v, 0.0)
    gold = annotate(g.map(pick, lf, labels, dim=ann.SUM, rank=True), "batch")

    def mean(m, s, gd, msk):
        nll = m + torch.log(s) - gd
        if msk is not None:
            w = msk.to(f32)
            return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
        return torch.mean(nll)
    return g.one(g.map(mean, mx, se, gold, mask))
