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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch._device import resolve
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


def mamba2_apply(p, x, cfg, *, state=None, conv_edge=None, chunk=None):
    """x (B, S, D) -> (out (B, S, D), (new state, new conv edge))."""
    b, s, _ = x.shape
    d_inner, h, pp, n = geometry(cfg)
    chunk = chunk or min(cfg.attn_chunk, s)
    if s % chunk:
        chunk = s

    proj = L.dense(p["in_proj"], x, x.dtype)
    z, xbc, dt_raw = _split_proj(proj, cfg)
    xbc, new_edge = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 edge=conv_edge)
    xs, bt, ct = torch.split(xbc, [d_inner, n, n], dim=-1)
    # jax.nn.softplus has no threshold; F.softplus returns its input above
    # 20, where log1p(exp(x)) - x < 2.1e-9, under float32's spacing there
    # (1.9e-6): the same float32 values.
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])   # (B, S, H)
    la = -dt * torch.exp(p["A_log"])                           # log a_t
    xh = xs.reshape(b, s, h, pp)
    if state is None:
        state = torch.zeros((b, h, pp, n), dtype=torch.float32,
                            device=x.device)
    ys = []
    for off in range(0, s, chunk):
        part = slice(off, off + chunk)
        y_c, state = _ssd_chunk(xh[:, part], bt[:, part], ct[:, part],
                                la[:, part], dt[:, part], state)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)
    y = y + xh.to(torch.float32) * p["D"][None, None, :, None]
    y = y.reshape(b, s, d_inner).to(x.dtype)

    # gated RMSNorm, then the out-projection
    y = L.apply_norm(p["norm"], y, "rmsnorm")
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    return L.dense(p["out_proj"], y, x.dtype), (state, new_edge)


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
    length.  ``cache`` is read, never written."""
    out, (state, edge) = mamba2_apply(
        p, x1, cfg, state=cache["ssm"],
        conv_edge=cache["conv"].to(x1.dtype), chunk=1)
    return out, {"ssm": state, "conv": edge.to(torch.float32)}
