"""GQA attention: chunked prefill path + cached decode path.

Port of ``repro.models.attention``, written out as matmul, mask and
softmax the way the reference writes it (plain model code, not a
kernel).  Prefill processes queries in chunks of ``cfg.attn_chunk``,
bounding the transient to (B, H, chunk, S); sliding-window attention
uses the same path with a window mask.  Decode keeps either a full cache
(B, S_max, KV, hd) written at ``pos`` or, for SWA, a ring cache (B, W,
KV, hd) written at ``pos % W``.  The decode path updates the cache
tensors it is given in place (the reference returns new arrays).

Under the sharded executor's model-axis group (``dist.annotate``) each
rank computes its share, as the reference's annotations split it:

* training and prefill: the heads over "model" (wq / wk / wv by their
  column blocks, wo by the rows of the rank's heads, its float32
  partial sums reduce-scattered into the carry's placement); where the
  head count does not divide the axis, the keys instead
  (context-parallel: every rank all heads against its block of keys,
  the softmax joined from the ranks' maxima and sums, the partial
  outputs reduce-scattered onto wo's row blocks).  Cross attention
  splits the same way, its keys and values projected from the encoder
  states gathered over "model" (the keys' split is then the frames');
* decode: each rank reads the block of the cache its index holds — kv
  heads when they divide the axis, else head_dim (the partial scores
  summed over "model"), else all of it — so cache rows never cross
  "model" (``read_split``; the encoder-decoder's primed cross caches
  alike).
"""

from __future__ import annotations

import math

import torch

from repro_torch._device import resolve
from repro_torch.core.sequence import sliding_window_mask
from repro_torch.dist import annotate as ann
from repro_torch.dist.annotate import Parts
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


def _sdpa_chunk(q_c, k, v, mask, cfg, rep=None):
    """One query chunk against full K/V.  q_c (B, C, H, hd); k, v
    (B, S, KV, hd), each kv head serving ``rep`` query heads (the
    config's H / KV by default); mask (C, S) bool.  Returns (B, C,
    H*hd)."""
    rep = cfg.num_heads // cfg.num_kv_heads if rep is None else rep
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
    if isinstance(x, Parts):
        return _attn_split(p, x, cfg, positions, causal)
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


def _project(g, w, x, dtype, heads, hd):
    """A column-block projection gathered over "model" into whole heads:
    (B, S, heads, hd), replicated."""
    y = annotate(L.split_dense(w, x, dtype), "batch")
    return g.map(lambda t: t.reshape(t.shape[0], t.shape[1], heads, hd), y)


def _rope(g, t, positions, cfg):
    return g.map(lambda tr, pos: L.apply_rope(
        tr, pos, theta=cfg.rope_theta, rotary_pct=cfg.rotary_pct), t,
        positions, dim=t.dim)


def _attn_split(p, x, cfg, positions, causal, kv_src=None):
    """``attn_apply`` split over "model"; with ``kv_src`` (the encoder
    states, cross attention) the keys and values come from it, with no
    rope and no mask, the queries in one chunk as ``cross_attn_apply``
    takes them."""
    g = x.g
    k_ = g.k
    x = annotate(x, "batch")                     # the sequence gathered
    src = x if kv_src is None else annotate(kv_src, "batch")
    b, s, _ = x.shape
    f = src.shape[1]
    dtype = x.first().dtype
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    rep = h // kv
    dev = x.first().device
    if kv_src is None:
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=dev)[None]
        pos = g.map(lambda t: positions.to(t.device), x)
        rope = lambda t, at: _rope(g, t, at, cfg)
    else:
        pos, rope = None, lambda t, at: t
    chunk = min(cfg.attn_chunk, s) if kv_src is None else s
    if s % chunk:
        chunk = s  # one chunk for ragged lengths

    def masks(lo, hi, off, device):
        """Query chunk ``off``'s mask against keys [lo, hi)."""
        if causal:
            m = sliding_window_mask(chunk, s, cfg.sliding_window,
                                    q_offset=off, device=device)
        else:
            m = torch.ones((chunk, f), dtype=torch.bool, device=device)
        return m[:, lo:hi]

    if h % k_ == 0:
        # heads over "model": rank r computes heads [r H/k, (r+1) H/k)
        q = L.split_dense(p["wq"], x, dtype)
        q = rope(g.map(lambda t: t.reshape(b, s, h // k_, hd), q, dim=2),
                 pos)
        if kv % k_ == 0:
            def kv_heads(name):
                t = L.split_dense(p[name], src, dtype)
                return g.map(lambda tr: tr.reshape(b, f, kv // k_, hd), t,
                             dim=2)
            kk, vv, rep_r = kv_heads("wk"), kv_heads("wv"), rep
        else:
            # each rank's heads' kv heads, from the gathered projections
            def serving(r, t):
                idx = torch.arange(r * (h // k_), (r + 1) * (h // k_),
                                   device=t.device) // rep
                return t.index_select(2, idx)
            kk = g.map(serving, _project(g, p["wk"], src, dtype, kv, hd),
                       rank=True, dim=2)
            vv = g.map(serving, _project(g, p["wv"], src, dtype, kv, hd),
                       rank=True, dim=2)
            rep_r = 1
        kk = rope(kk, pos)

        def heads(qr, kr, vr):
            outs = [_sdpa_chunk(qr[:, off:off + chunk], kr, vr,
                                masks(0, f, off, qr.device), cfg, rep_r)
                    for off in range(0, s, chunk)]
            return torch.cat(outs, dim=1)
        out = g.map(heads, q, kk, vv, dim=2)
        return L.project_out(p["wo"], out, dtype)
    return _attn_keys(g, p, x, src, pos, rope, masks, chunk, cfg, dtype)


def _attn_keys(g, p, x, src, pos, rope, masks, chunk, cfg, dtype):
    """Context-parallel attention (the head count does not divide the
    axis): every rank all heads against its block of keys (of ``src``'s
    positions: the sequence, or the encoder's frames), the softmax joined
    from the ranks' maxima and sums."""
    b, s, _ = x.shape
    f = src.shape[1]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    rep = h // kv
    q = rope(_project(g, p["wq"], x, dtype, h, hd), pos)
    k_split = f % g.k == 0
    part = ann.SUM if k_split else None
    span = (lambda r: g.block(f, r)) if k_split else (lambda r: (0, f))

    def keys(name):
        t = L.split_dense(p[name], src, dtype)
        t = annotate(t, "batch", "tp" if k_split else None, None)
        return g.map(lambda tr: tr.reshape(b, tr.shape[1], kv, hd), t,
                     dim=t.dim)
    kk, vv = keys("wk"), keys("wv")
    if pos is not None:
        kk = rope(kk, g.map(lambda r, pr: pr[:, slice(*span(r))], pos,
                            rank=True))
    outs = []
    for off in range(0, s, chunk):
        scores = g.map(lambda r, qr, kr: torch.where(
            masks(*span(r), off, qr.device)[None, None],
            L.einsum_f32("bchd,bshd->bhcs", qr[:, off:off + chunk],
                         _repeat_kv(kr, rep)) / math.sqrt(hd), _MASKED),
            q, kk, rank=True, dim=part)
        mx = ann.all_reduce_max(g.map(lambda t: t.amax(-1), scores,
                                      dim=part))
        e = g.map(lambda t, m: torch.exp(t - m[..., None]), scores, mx,
                  dim=part)
        tot = annotate(g.map(lambda t: t.sum(-1), e, dim=part), "batch")
        outs.append(g.map(lambda t, z, vr: L.einsum_f32(
            "bhcs,bshd->bchd", (t / z[..., None]).to(dtype),
            _repeat_kv(vr, rep)), e, tot, vv, dim=part))
    out = g.map(lambda *o: torch.cat(o, dim=1).reshape(b, s, h * hd),
                *outs, dim=part)
    # the partial outputs summed into each rank's wo row block (heads x
    # head_dim; replicated where it does not divide)
    out = annotate(out, "batch", None, "tp")
    return L.project_out(p["wo"], L.cast(out, dtype), dtype)


def cross_attn_apply(p, x, kv_src, cfg, *, positions=None):
    """Encoder-decoder cross attention: queries from ``x`` (B, S, D),
    keys and values from ``kv_src`` (B, F, D); no mask and no rope.
    Split over "model" (``x`` and ``kv_src`` ``Parts``), as
    self-attention splits: heads, or the encoder's frames where the
    heads do not divide the axis."""
    if isinstance(x, Parts):
        return _attn_split(p, x, cfg, None, False, kv_src=kv_src)
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
    if isinstance(x1, Parts):
        return _decode_attn_split(p, x1, cache, pos, cfg), cache
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


def _decode_attn_split(p, x1, cache, pos, cfg):
    """``decode_attn_apply`` split over "model": the projections'
    column blocks gathered into whole heads (a token's worth), each rank
    writing and reading its block of the cache (``read_split``)."""
    g = x1.g
    x1 = annotate(x1, "batch")
    dtype = x1.first().dtype
    b = x1.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    positions = g.map(lambda t: torch.full((b, 1), pos, dtype=torch.int32,
                                           device=t.device), x1)
    q = _rope(g, _project(g, p["wq"], x1, dtype, h, hd), positions, cfg)
    k1 = _rope(g, _project(g, p["wk"], x1, dtype, kv, hd), positions, cfg)
    v1 = _project(g, p["wv"], x1, dtype, kv, hd)
    w = cache["k"].first().shape[1]
    split = cache["k"].dim
    row = None if split is None else split - 1    # in a token's (B, KV, hd)
    for r in g.run:                    # each rank writes its block
        for c, t in ((cache["k"], k1), (cache["v"], v1)):
            c.t[r][:, pos % w] = _mine(g, r, t.t[r][:, 0], row).to(
                c.t[r].dtype)
    o = read_split(g, q, cache["k"], cache["v"], cfg, dtype,
                   written=w if pos + 1 >= w else pos + 1)
    return L.project_out(p["wo"], o, dtype)


def _mine(g, r, t, d):
    """Rank r's block of t's dimension d (all of t where d is None)."""
    if d is None:
        return t
    lo, hi = g.block(t.shape[d], r)
    return t.narrow(d, lo, hi - lo)


def read_split(g, q, ck, cv, cfg, dtype, *, written=None):
    """One query token q (B, 1, H, hd), replicated over the group,
    against each rank's block of a cache layer ``ck`` / ``cv`` (B, W, KV,
    hd) ``Parts``: ``ck.dim`` is the dimension it splits, 2 (kv heads) or
    3 (head_dim, the partial scores summed over "model"), None when
    whole; ``written`` counts the valid slots (None: all).  Returns the
    attention output (B, 1, H hd), split on its last dimension by kv
    heads, else replicated."""
    b = q.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    rep = h // kv
    split = ck.dim                         # 2: kv heads, 3: head_dim
    grouped = {None: None, 2: 2, 3: 4}[split]     # in (B, 1, KV, rep, hd)
    w = ck.first().shape[1]

    def attend(r, qr, ckr):
        qh = _mine(g, r, qr.reshape(b, 1, kv, rep, hd), grouped)
        return L.einsum_f32("bckrh,bskh->bkrcs", qh, ckr)

    scores = g.map(attend, q, ck, rank=True,
                   dim={None: None, 2: 1, 3: ann.SUM}[split])
    if split == 3:
        scores = annotate(scores, "batch")  # the head_dim partials summed

    def out(sc, cvr):
        sc = sc / math.sqrt(hd)
        if written is not None:
            valid = torch.arange(w, device=sc.device) < written
            sc = torch.where(valid, sc, _MASKED)
        probs = torch.softmax(sc, dim=-1)
        o = L.einsum_f32("bkrcs,bskh->bckrh", probs.to(dtype), cvr)
        return o.to(dtype)
    o = g.map(out, scores, cv, dim=grouped)
    if split == 3:
        o = annotate(o, "batch")           # the head_dim blocks gathered
    return g.map(lambda t: t.reshape(b, 1, t.shape[2] * rep * hd), o,
                 dim=None if o.dim is None else 2)
