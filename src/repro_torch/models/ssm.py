"""Mamba2 (SSD, structured state-space duality) blocks for zamba2.

Port of ``repro.models.ssm``.  State recurrence per head h (P = head
dim, N = state size):

    h_t = a_t * h_{t-1} + dt_t * x_t (x) B_t          a_t = exp(-dt_t e^{A_h})
    y_t = h_t C_t + D_h * x_t

with a scalar decay per head, dt from a softplus, and a width-4 causal
depthwise conv on the (x, B, C) streams.  The sequence runs in chunks of
``cfg.attn_chunk`` (the whole sequence when that does not divide it),
each chunk all-parallel in float32 (the SSD block decomposition), the
(B, H, P, N) float32 state carried from chunk to chunk by a plain loop.
Decode is the same code on one token (``chunk=1``).  Plain PyTorch
(matmul and einsum): the reference has no kernel here.

Under the sharded executor's model-axis group (``dist.annotate``) a
layer splits by SSM heads, as the reference's annotations split it:
each rank its heads' z, x and dt (its block of ``in_proj``'s columns,
several spans), B and C on every rank, the scan and the state on its
heads, the gated norm from the ranks' sums of squares, ``out_proj`` by
its heads' rows (``_mamba2_split``); a decode step moves the state from
the cache's P block to the heads' and back (``mamba2_decode``).  Where
the heads do not divide the axis, every rank runs the whole layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch._device import resolve
from repro_torch.dist import annotate as ann
from repro_torch.dist import sharding as shd
from repro_torch.dist.annotate import Parts, annotate
from repro_torch.models import layers as L


def geometry(cfg):
    """(d_inner, heads, head dim P, state size N)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    p = cfg.ssm_head_dim
    return d_inner, d_inner // p, p, cfg.ssm_state


def mamba2_init(gen, cfg, device):
    d = cfg.d_model
    d_inner, h, p, n = geometry(cfg)
    conv_ch = d_inner + 2 * n  # x, B, C share the conv
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # in_proj -> [z, x, B, C, dt]
        "in_proj": L.dense_init(gen, d, 2 * d_inner + 2 * n + h,
                                device=device),
        "conv_w": L.truncated_normal(gen, (cfg.conv_width, conv_ch),
                                     1.0 / cfg.conv_width, device),
        "conv_b": torch.zeros((conv_ch,), **f32),
        "A_log": torch.zeros((h,), **f32),      # a = exp(-dt * e^{A_log})
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "norm": L.norm_init(d_inner, "rmsnorm", device),   # gated RMSNorm
        "out_proj": L.dense_init(gen, d_inner, d, device=device),
    }


def _split_proj(proj, cfg):
    """[z | x, B, C | dt] (``jnp.split`` at indices d_inner and
    2 d_inner + 2N; ``torch.split`` takes the sizes)."""
    d_inner, h, _, n = geometry(cfg)
    return torch.split(proj, [d_inner, d_inner + 2 * n, h], dim=-1)


def _causal_conv(xbc, w, b, *, edge=None):
    """Depthwise causal conv of width W.  xbc (B, S, C); edge (B, W-1, C),
    the carried inputs before position 0.  Returns (y (B, S, C), the new
    edge (B, W-1, C))."""
    width = w.shape[0]
    s = xbc.shape[1]
    if edge is None:
        edge = xbc.new_zeros((xbc.shape[0], width - 1, xbc.shape[-1]))
    xpad = torch.cat([edge.to(xbc.dtype), xbc], dim=1)
    # sum_k w[k] * x[t - (W-1) + k]: a stack of one-position slides
    y = sum(xpad[:, k:k + s] * w[k].to(xbc.dtype) for k in range(width))
    y = F.silu(y.to(torch.float32) + b).to(xbc.dtype)
    return y, xpad[:, s:]


def _ssd_chunk(xh, bt, ct, la, dt, state):
    """One SSD chunk.  xh (B, C, H, P); bt, ct (B, C, N); la, dt
    (B, C, H); state (B, H, P, N) -> (y (B, C, H, P), new state)."""
    xf = xh.to(torch.float32)
    bf, cf = bt.to(torch.float32), ct.to(torch.float32)
    lp = torch.cumsum(la, dim=1)                          # (B, C, H) inclusive
    # state term: y_t += exp(lp_t) * (h_prev @ C_t)
    y = L.einsum("bhpn,bcn->bchp", state, cf) * torch.exp(lp)[..., None]
    # intra: y_t += sum_{j<=t} exp(lp_t - lp_j) dt_j (B_j . C_t) x_j
    c = xh.shape[1]
    dec = lp[:, :, None, :] - lp[:, None, :, :]           # (B, C_t, C_j, H)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xh.device))
    # The reference multiplies exp(dec) by the mask; above the diagonal
    # dec >= 0, so a chunk whose summed decay passes ~88 gives inf * 0
    # there.  Masking before the exp gives the same values wherever the
    # reference's are finite, and zeros where it would give NaN.
    gate = torch.exp(torch.where(tri[None, :, :, None], dec,
                                 float("-inf")))
    bc = L.einsum("bcn,bjn->bcj", cf, bf)                 # (B, C_t, C_j)
    w = gate * bc[..., None] * dt[:, None, :, :]          # (B, C_t, C_j, H)
    y = y + L.einsum("bcjh,bjhp->bchp", w, xf)
    # state: h_new = exp(lp_C) h_prev + sum_j exp(lp_C - lp_j) dt_j x_j (x) B_j
    lp_last = lp[:, -1:, :]                               # (B, 1, H)
    carry = torch.exp(lp_last - lp) * dt                  # (B, C, H)
    new_state = (state * torch.exp(lp_last[:, 0])[..., None, None]
                 + L.einsum("bch,bchp,bcn->bhpn", carry, xf, bf))
    return y, new_state


def _heads(xs, bt, ct, dt_raw, a_log, dt_bias, d_skip, state, pp, chunk):
    """The SSD scan of a run of heads: xs (B, S, Hr P), bt, ct (B, S, N),
    dt_raw (B, S, Hr) and the heads' vectors; state (B, Hr, P, N) or
    None (zeros).  Returns (y (B, S, Hr P) float32, the new state)."""
    b, s = xs.shape[:2]
    # jax.nn.softplus has no threshold; F.softplus returns its input above
    # 20, where log1p(exp(x)) - x < 2.1e-9, under float32's spacing there
    # (1.9e-6): the same float32 values.
    dt = F.softplus(dt_raw.to(torch.float32) + dt_bias)        # (B, S, Hr)
    la = -dt * torch.exp(a_log)                                # log a_t
    xh = xs.reshape(b, s, -1, pp)
    if state is None:
        state = torch.zeros((b, xh.shape[2], pp, bt.shape[-1]),
                            dtype=torch.float32, device=xs.device)
    ys = []
    for off in range(0, s, chunk):
        part = slice(off, off + chunk)
        y_c, state = _ssd_chunk(xh[:, part], bt[:, part], ct[:, part],
                                la[:, part], dt[:, part], state)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)
    y = y + xh.to(torch.float32) * d_skip[None, None, :, None]
    return y.reshape(b, s, -1), state


def _gate(y, z):
    """The gated RMSNorm's gate: y times silu(z) (float32, cast back)."""
    return y * F.silu(z.to(torch.float32)).to(y.dtype)


def mamba2_apply(p, x, cfg, *, state=None, conv_edge=None, chunk=None):
    """x (B, S, D) -> (out (B, S, D), (new state, new conv edge)).  Split
    over "model" when ``x`` is a ``Parts`` (``_mamba2_split``)."""
    s = x.shape[1]
    chunk = chunk or min(cfg.attn_chunk, s)
    if s % chunk:
        chunk = s
    if isinstance(x, Parts):
        return _mamba2_split(p, x, cfg, state, conv_edge, chunk)
    d_inner, _, pp, n = geometry(cfg)

    proj = L.dense(p["in_proj"], x, x.dtype)
    z, xbc, dt_raw = _split_proj(proj, cfg)
    xbc, new_edge = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 edge=conv_edge)
    xs, bt, ct = torch.split(xbc, [d_inner, n, n], dim=-1)
    y, state = _heads(xs, bt, ct, dt_raw, p["A_log"], p["dt_bias"], p["D"],
                      state, pp, chunk)
    y = y.to(x.dtype)

    # gated RMSNorm, then the out-projection
    y = _gate(L.apply_norm(p["norm"], y, "rmsnorm"), z)
    return L.dense(p["out_proj"], y, x.dtype), (state, new_edge)


def _mamba2_split(p, x, cfg, state, conv_edge, chunk):
    """``mamba2_apply`` split over "model" by SSM heads, as the
    reference's annotations split it (``xh``, ``dt``, ``la`` and the
    state over "tp"; B and C replicated).  The input is gathered over
    the sequence; rank r's block of ``in_proj`` (``sharding.
    compute_block``: its heads' columns of z, x and dt, B and C whole)
    gives its z, x, dt and every rank's B and C; the conv runs on its x
    channels and B and C; the SSD scan on its heads, the state (B, H/k,
    P, N); the gated norm over d_inner from the ranks' sums of squares;
    ``out_proj`` by its heads' rows (float32 partial sums
    reduce-scattered into the carry), a decode step's by its columns on
    y gathered (``layers.project_out``).  ``state`` is placed by heads
    (dim 1) and ``conv_edge`` (B, W-1, C) replicated; the new state comes
    back by heads, the new edge replicated (None without an edge: the
    training path keeps none).  Where the heads do not divide the axis
    every rank runs the whole layer on the gathered input."""
    g = x.g
    d_inner, h, pp, n = geometry(cfg)
    dtype = x.dtype
    x = annotate(x, "batch")                     # the sequence gathered
    if h % g.k:
        def whole(pr, xr, st, ed):
            out, (st, ed) = mamba2_apply(pr, xr, cfg, state=st,
                                         conv_edge=ed, chunk=chunk)
            return out, st, ed
        out, state, edge = g.map(whole, p, x, state, conv_edge,
                                 dim=(None, None, None))
        return annotate(out, "batch", "tp", None), (state, edge)
    hk, dk = h // g.k, d_inner // g.k
    width = 2 * d_inner + 2 * n + h

    def spans(r):
        return shd.spans(shd.compute_block(
            ("mamba", "in_proj", "w"), (cfg.d_model, width), g.k, r,
            ssm=(d_inner, h, n))[1])
    # a decode step's block runs in place among zeros of the whole width
    # (``layers.split_dense``)
    proj = L.split_dense(p["in_proj"], x, dtype, cols=(width, spans))
    z, xs, bc, dt_raw = g.map(
        lambda t: tuple(torch.split(t, [dk, dk, 2 * n, hk], dim=-1)), proj,
        dim=(2, 2, None, 2))

    def conv(r, xr, bcr, wr, br, er):
        if er is not None:                       # the rank's channels
            er = torch.cat([er[..., r * dk:(r + 1) * dk],
                            er[..., d_inner:]], dim=-1)
        y, e = _causal_conv(torch.cat([xr, bcr], dim=-1), wr, br, edge=er)
        return (y[..., :dk], y[..., dk:dk + n], y[..., dk + n:],
                e[..., :dk], e[..., dk:])
    xs, bt, ct, ex, ebc = g.map(conv, xs, bc, p["conv_w"], p["conv_b"],
                                conv_edge, rank=True,
                                dim=(2, None, None, 2, None))

    def heads(r, xr, btr, ctr, dtr, pr, st):
        vec = (pr["A_log"], pr["dt_bias"], pr["D"])
        if xr.shape[1] == 1:
            # a decode step: the heads in place among zeros of all H, as
            # ``layers.split_dense`` runs a decode product, so that the
            # scan's batched products take one device's shapes and give
            # its values (a rank's H/k heads alone do not, on the card)
            if st is not None:
                st = L._widen(st, r, g.k, dim=1)
            y, st = _heads(L._widen(xr, r, g.k), btr, ctr,
                           L._widen(dtr, r, g.k), *vec, st, pp, chunk)
            return (y.narrow(-1, r * dk, dk).to(dtype),
                    st.narrow(1, r * hk, hk))
        mine = slice(r * hk, (r + 1) * hk)
        y, st = _heads(xr, btr, ctr, dtr, *(v[mine] for v in vec), st, pp,
                       chunk)
        return y.to(dtype), st
    y, state = g.map(heads, xs, bt, ct, dt_raw, p, state, rank=True,
                     dim=(2, 1))
    y = g.map(_gate, L.apply_norm(p["norm"], y, "rmsnorm"), z, dim=2)
    edge = None
    if conv_edge is not None:                    # the x channels gathered
        edge = g.map(lambda a, b: torch.cat([a, b], dim=-1),
                     annotate(ex, "batch"), ebc)
    return L.project_out(p["out_proj"], y, dtype), (state, edge)


def init_state(cfg, batch, device=None):
    """One layer's decode state, float32: {"ssm" (B, H, P, N), "conv"
    (B, W-1, C)}, on ``device`` (the card by default)."""
    device = resolve(device)
    d_inner, h, p, n = geometry(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"ssm": torch.zeros((batch, h, p, n), **f32),
            "conv": torch.zeros((batch, cfg.conv_width - 1, d_inner + 2 * n),
                                **f32)}


def mamba2_decode(p, x1, cache, cfg):
    """One token.  x1 (B, 1, D) -> (out, new state): O(1) in sequence
    length.  ``cache`` is read, never written.  Split over "model" (a
    ``Parts`` ``x1``, ``cache`` placed as the cache's sharding holds it:
    the state's P block, the edge's channel block), the state moves to
    the heads' placement (an all-to-all over "model", the reference's
    ``annotate(state, "batch", "tp", None, None)`` on a P-sharded cache)
    and back, the edge is gathered, and the new state and edge come back
    in the cache's placement."""
    if isinstance(x1, Parts):
        heads = 1 if geometry(cfg)[1] % x1.g.k == 0 else None
        out, (state, edge) = mamba2_apply(
            p, x1, cfg, state=ann.reshard(cache["ssm"], heads),
            conv_edge=L.cast(annotate(cache["conv"], "batch"), x1.dtype),
            chunk=1)
        return out, {"ssm": ann.reshard(state, cache["ssm"].dim),
                     "conv": ann.reshard(L.cast(edge, torch.float32),
                                         cache["conv"].dim)}
    out, (state, edge) = mamba2_apply(
        p, x1, cfg, state=cache["ssm"],
        conv_edge=cache["conv"].to(x1.dtype), chunk=1)
    return out, {"ssm": state, "conv": edge.to(torch.float32)}
