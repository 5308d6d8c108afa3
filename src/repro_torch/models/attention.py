"""GQA attention: chunked prefill path + cached decode path.

Port of ``repro.models.attention``, written out as matmul, mask and
softmax the way the reference writes it (plain model code, not a
kernel).  Prefill processes queries in chunks of ``cfg.attn_chunk``,
bounding the transient to (B, H, chunk, S); sliding-window attention
uses the same path with a window mask.  Decode keeps either a full cache
(B, S_max, KV, hd) written at ``pos`` or, for SWA, a ring cache (B, W,
KV, hd) written at ``pos % W``.  The decode path updates the cache
tensors it is given in place (the reference returns new arrays).
"""

from __future__ import annotations

import math

import torch

from repro_torch._device import resolve
from repro_torch.core.sequence import sliding_window_mask
from repro_torch.dist.annotate import active_mesh as _ann_active
from repro_torch.dist.annotate import annotate
from repro_torch.models import layers as L

_MASKED = -1e30


def annotate_grouped_q(qh):
    """Annotate a grouped-decode query (B, C, KV, rep, hd) to mirror the
    KV cache's sharding rule: kv-heads over 'model' when divisible, else
    head_dim, else batch only (the reference's rule; the port's
    ``annotate`` returns its input unchanged)."""
    mesh = _ann_active()
    if mesh is None:
        return qh
    model_sz = mesh.shape.get("model", 1)
    b, c, kv, rep, hd = qh.shape
    if kv % model_sz == 0:
        return annotate(qh, "batch", None, "tp", None, None)
    if hd % model_sz == 0:
        return annotate(qh, "batch", None, None, None, "tp")
    return annotate(qh, "batch")


def _repeat_kv(k, rep):
    """(B, S, KV, hd) -> (B, S, KV*rep, hd), head h = kv * rep + r."""
    if rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, rep, hd).reshape(
        b, s, kv * rep, hd)


def attn_init(gen, cfg, device):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    return {
        "wq": L.dense_init(gen, d, h * hd, bias=cfg.qkv_bias, device=device),
        "wk": L.dense_init(gen, d, kv * hd, bias=cfg.qkv_bias, device=device),
        "wv": L.dense_init(gen, d, kv * hd, bias=cfg.qkv_bias, device=device),
        "wo": L.dense_init(gen, h * hd, d, device=device),
    }


def _project_qkv(p, x, cfg, positions, dtype):
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = L.dense(p["wq"], x, dtype).reshape(b, s, h, hd)
    k = L.dense(p["wk"], x, dtype).reshape(b, s, kv, hd)
    v = L.dense(p["wv"], x, dtype).reshape(b, s, kv, hd)
    q = L.apply_rope(q, positions, theta=cfg.rope_theta,
                     rotary_pct=cfg.rotary_pct)
    k = L.apply_rope(k, positions, theta=cfg.rope_theta,
                     rotary_pct=cfg.rotary_pct)
    return q, k, v


def _sdpa_chunk(q_c, k, v, mask, cfg):
    """One query chunk against full K/V.  q_c (B, C, H, hd); k, v
    (B, S, KV, hd); mask (C, S) bool.  Returns (B, C, H*hd)."""
    rep = cfg.num_heads // cfg.num_kv_heads
    b, c, h, hd = q_c.shape
    k = _repeat_kv(k, rep)
    v = _repeat_kv(v, rep)
    scores = L.einsum_f32("bchd,bshd->bhcs", q_c, k) / math.sqrt(hd)
    scores = torch.where(mask[None, None], scores, _MASKED)
    probs = torch.softmax(scores, dim=-1)
    out = L.einsum_f32("bhcs,bshd->bchd", probs.to(q_c.dtype), v)
    return out.reshape(b, c, h * hd).to(q_c.dtype)


def attn_apply(p, x, cfg, *, positions=None, causal=True):
    """Training / prefill attention.  x (B, S, D) -> (B, S, D).  Causal
    (with the config's sliding window) by default; ``causal=False`` is
    the encoder's: every query sees every key."""
    dtype = x.dtype
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    q, k, v = _project_qkv(p, x, cfg, positions, dtype)
    chunk = min(cfg.attn_chunk, s)
    if s % chunk:
        chunk = s  # one chunk for ragged lengths
    outs = []
    for off in range(0, s, chunk):
        if causal:
            m = sliding_window_mask(chunk, s, cfg.sliding_window,
                                    q_offset=off, device=x.device)
        else:
            m = torch.ones((chunk, s), dtype=torch.bool, device=x.device)
        outs.append(_sdpa_chunk(q[:, off:off + chunk], k, v, m, cfg))
    return L.dense(p["wo"], torch.cat(outs, dim=1), dtype)


def cross_attn_apply(p, x, kv_src, cfg, *, positions=None):
    """Encoder-decoder cross attention: queries from ``x`` (B, S, D),
    keys and values from ``kv_src`` (B, F, D); no mask and no rope."""
    dtype = x.dtype
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = L.dense(p["wq"], x, dtype).reshape(b, s, h, hd)
    k = L.dense(p["wk"], kv_src, dtype).reshape(b, -1, kv, hd)
    v = L.dense(p["wv"], kv_src, dtype).reshape(b, -1, kv, hd)
    m = torch.ones((s, k.shape[1]), dtype=torch.bool, device=x.device)
    return L.dense(p["wo"], _sdpa_chunk(q, k, v, m, cfg), dtype)


# -- decode path ---------------------------------------------------------------

def init_cache(cfg, batch, max_seq, dtype=torch.bfloat16, device=None):
    """Per-layer KV cache on ``device`` (the card by default); SWA
    configs get a ring buffer of window size."""
    device = resolve(device)
    w = cfg.sliding_window if cfg.sliding_window > 0 else max_seq
    w = min(w, max_seq)
    shape = (batch, w, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attn_apply(p, x1, cache, pos: int, cfg):
    """One-token decode.  x1 (B, 1, D); pos the current index (all slots
    in lockstep).  Writes K/V at ring slot ``pos % W`` of ``cache`` in
    place and returns (out (B, 1, D), cache)."""
    dtype = x1.dtype
    b = x1.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x1.device)
    q, k1, v1 = _project_qkv(p, x1, cfg, positions, dtype)

    w = cache["k"].shape[1]
    slot = pos % w
    cache["k"][:, slot] = k1[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v1[:, 0].to(cache["v"].dtype)

    # Grouped (KV, rep) form, as the reference's decode keeps it.
    rep = h // kv
    qh = annotate_grouped_q(q.reshape(b, 1, kv, rep, hd))
    scores = L.einsum_f32("bckrh,bskh->bkrcs", qh, cache["k"]) / math.sqrt(hd)
    written = w if pos + 1 >= w else pos + 1
    valid = torch.arange(w, device=x1.device) < written
    scores = torch.where(valid, scores, _MASKED)
    probs = torch.softmax(scores, dim=-1)
    out = L.einsum_f32("bkrcs,bskh->bckrh", probs.to(dtype), cache["v"])
    out = out.reshape(b, 1, h * hd).to(dtype)
    return L.dense(p["wo"], out, dtype), cache
