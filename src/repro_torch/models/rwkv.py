"""RWKV6 "Finch" (arXiv:2404.05892): an attention-free LM with a
data-dependent decay (rwkv6-7b: 32 layers, d_model 4096, d_ff 14336,
vocab 65536).

Port of ``repro.models.rwkv``.  Each layer is a time mix (the WKV
linear-attention recurrence) and a channel mix, each after a LayerNorm
and a one-position token shift (``core.sequence.token_shift``: the
pad-shift, outside the crossbar, as the paper's Sec. IV advises).

The recurrence, per head (N = head dim):

    S_t   = diag(w_t) S_{t-1} + k_t^T v_t
    out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with w_t in (0, 1)^N from a LoRA of the input and u the per-head bonus.
It runs in chunks of 16 positions (the whole sequence when 16 does not
divide it), each chunk all-parallel in float32 in the reference's closed
form (lw = log w, lp its inclusive cumsum):

    out_t = (r_t . exp(lp_{t-1})) S_prev
          + sum_{j<t} (r_t . exp(lp_{t-1} - lp_j)) k_j  v_j
          + (r_t . u . k_t) v_t
    S_new = diag(exp(lp_{C-1})) S_prev
          + sum_j (exp(lp_{C-1} - lp_j) . k_j)^T v_j

with the (B, H, N, N) float32 state carried from chunk to chunk by a
plain loop.  Decode is the same recurrence on one token (``chunk=1``,
``_wkv_step``), its sums over N and its LoRA products (``_lora``) in
float64, rounded once: values that do not depend on how many rows or
heads run together.  Plain PyTorch (matmul and einsum): the reference
has no kernel here.

Under the sharded executor's model-axis group (``dist.annotate``) a
layer splits as the reference's annotations split it: the carry is
placed sequence-parallel at each layer's start; the time mix by heads
(``_time_mix_split``: the input gathered over the sequence, the shift,
the ddlerp and the decay LoRA whole on every rank, each rank its heads'
r, k, v and gate, the recurrence, its state and the per-head group norm
on its heads, wo by its heads' rows); the channel mix by d_ff
(``_channel_mix_split``: wk by columns, wv by rows, the receptance gate
by columns moved to the carry's placement).  A decode step moves each
WKV state from the cache's key-row block to the heads' and back
(``block_decode``).  Where the heads do not divide the axis, every rank
runs the whole time mix.

Layers are a list of per-layer dicts (``blocks``); the stack runs
through ``layers.scan``, which honours ``cfg.remat`` per layer, as the
reference checkpoints each layer.  Decode caches are stacked on a
leading layer axis and updated in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch._device import resolve
from repro_torch.core.sequence import token_shift
from repro_torch.dist import annotate as ann
from repro_torch.dist import sharding as shd
from repro_torch.dist.annotate import Parts, annotate
from repro_torch.models import layers as L

LORA_MIX = 32     # TIME_MIX_EXTRA_DIM
LORA_DECAY = 64   # TIME_DECAY_EXTRA_DIM
WKV_CHUNK = 16


def _head_geometry(cfg):
    """(H, N): RWKV6 fixes the head size at 64; reduced configs take what
    divides d_model (``sharding.rwkv_heads``)."""
    return shd.rwkv_heads(cfg.d_model)


def time_mix_init(gen, cfg, device):
    d = cfg.d_model
    h, n = _head_geometry(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "maa_x": torch.zeros((d,), **f32),
        "maa_rkvwg": torch.zeros((5, d), **f32),   # r, k, v, w, g stacked
        "maa_w1": L.truncated_normal(gen, (d, 5 * LORA_MIX), 0.01, device),
        "maa_w2": L.truncated_normal(gen, (5, LORA_MIX, d), 0.01, device),
        "decay": torch.full((d,), -4.0, **f32),     # w ~ exp(-exp(-4))
        "decay_w1": L.truncated_normal(gen, (d, LORA_DECAY), 0.01, device),
        "decay_w2": L.truncated_normal(gen, (LORA_DECAY, d), 0.01, device),
        "bonus": L.truncated_normal(gen, (h, n), 0.1, device),   # u
        "wr": L.dense_init(gen, d, d, device=device),
        "wk": L.dense_init(gen, d, d, device=device),
        "wv": L.dense_init(gen, d, d, device=device),
        "wg": L.dense_init(gen, d, d, device=device),
        "wo": L.dense_init(gen, d, d, device=device),
        "ln_x": L.norm_init(d, "layernorm", device),   # per-head group norm
    }


def channel_mix_init(gen, cfg, device):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "maa_k": torch.zeros((d,), dtype=torch.float32, device=device),
        "maa_r": torch.zeros((d,), dtype=torch.float32, device=device),
        "wk": L.dense_init(gen, d, f, device=device),
        "wv": L.dense_init(gen, f, d, device=device),
        "wr": L.dense_init(gen, d, d, device=device),
    }


def block_init(gen, cfg, device):
    return {
        "ln1": L.norm_init(cfg.d_model, "layernorm", device),
        "tmix": time_mix_init(gen, cfg, device),
        "ln2": L.norm_init(cfg.d_model, "layernorm", device),
        "cmix": channel_mix_init(gen, cfg, device),
    }


def _shift(x, x_prev):
    """The previous position's input at every position: ``x_prev`` (the
    carried last input, B x 1 x D) at position 0 when given, else 0.  A
    new tensor; neither ``x`` nor ``x_prev`` is written."""
    if x_prev is None:
        return token_shift(x, dim=1)
    return torch.cat([x_prev[:, :1].to(x.dtype), x[:, :-1]], dim=1)


def _lora(eq, x, w):
    """A LoRA product, ``einsum(eq, x, w)`` with a float32 result, x (B,
    S, ...).  On one position a row (a decode step) its sums run in
    float64 (each product of two float32 values exact there) and are
    rounded once: the same value whichever rows run together.  cuBLAS's
    float32 products sum in an order that depends on the rows (NVIDIA
    H100: the ddlerp's (rows x 4096) x (4096 x 160) product differs at
    86 % of its entries between a window's 2 rows and one device's 4;
    ``tests/torch_split_numerics.py lora``), and a bf16 decode carries
    the rare bf16 rounding that this flips to 1e-2 of its logit rows."""
    if x.shape[1] != 1:
        return L.einsum(eq, x.to(torch.float32), w)
    f64 = torch.float64
    return L.einsum(eq, x.to(f64), w.to(f64)).to(torch.float32)


def _ddlerp(p, x, sx):
    """Finch's data-dependent token-shift interpolation.  x (B, S, D),
    sx = shifted(x) - x.  Returns the five mixed streams (r, k, v, w, g)
    stacked, (5, B, S, D) in x's dtype; the LoRA runs in float32
    (``_lora``)."""
    base = x + sx * p["maa_x"]            # float32, as the reference promotes
    lora = torch.tanh(_lora("bsd,de->bse", base,
                            p["maa_w1"].reshape(x.shape[-1], -1)))
    lora = lora.reshape(lora.shape[:-1] + (5, LORA_MIX))
    dyn = _lora("bsme,med->mbsd", lora, p["maa_w2"])      # (5, B, S, D)
    mix = p["maa_rkvwg"][:, None, None, :] + dyn
    return x[None] + sx[None] * mix.to(x.dtype)


def _decay_logw(p, xw):
    """The data-dependent log decay, lw = -exp(decay + tanh(xw w1) w2),
    in float32.  The clip at 1.5 bounds |lw| by e^1.5 ~= 4.48, so the
    chunk form's exp(-lp) stays finite in float32 over 16 positions
    (16 x 4.48 = 71.7 < 88)."""
    dyn = _lora("bsk,kd->bsd",
                torch.tanh(_lora("bsd,dk->bsk", xw, p["decay_w1"])),
                p["decay_w2"])
    return -torch.exp(torch.clamp(p["decay"] + dyn, -8.0, 1.5))


def _wkv_chunk(r, k, v, lw, u, state):
    """One chunk of the WKV recurrence, all positions at once.  r, k, v,
    lw (B, C, H, N); u (H, N); state (B, H, N, N) [key x value].
    Returns (out (B, C, H, N), new state), float32."""
    rf, kf, vf = (t.to(torch.float32) for t in (r, k, v))
    lp = torch.cumsum(lw, dim=1)                     # inclusive
    lp_prev = lp - lw                                # exclusive
    r_eff = rf * torch.exp(lp_prev)
    out = L.einsum("bchk,bhkv->bchv", r_eff, state)
    # scores[t, j] = (r_t e^{lp_{t-1}}) . (k_j e^{-lp_j}), j < t only
    k_eff = kf * torch.exp(-lp)
    scores = L.einsum("bchn,bjhn->bhcj", r_eff, k_eff)
    c = r.shape[1]
    tri = torch.tril(torch.ones((c, c), dtype=torch.float32,
                                device=r.device), diagonal=-1)
    scores = scores * tri[None, None]
    out = out + L.einsum("bhcj,bjhv->bchv", scores, vf)
    # the current token's bonus: (r_t . u . k_t) v_t
    bonus = L.einsum("bchn,bchn->bch", rf * u[None, None], kf)
    out = out + bonus[..., None] * vf
    lp_last = lp[:, -1:]                             # (B, 1, H, N)
    k_carry = kf * torch.exp(lp_last - lp)           # decay from j to the end
    new_state = (state * torch.exp(lp_last[:, 0])[..., None]
                 + L.einsum("bjhk,bjhv->bhkv", k_carry, vf))
    return out, new_state


def _wkv_step(r, k, v, lw, u, state):
    """``_wkv_chunk`` on one position (a decode step): with lp_{t-1} = 0
    and no earlier position in the chunk,

        out   = r S_prev + (r . u . k) v
        S_new = diag(w) S_prev + k^T v

    with the two sums over N taken in float64 (each product of two
    float32 values exact there) and rounded to float32 once: the same
    float32 value in whatever order the sum runs.  The chunk form's
    batched products sum in an order that depends on how many rows and
    heads they run (NVIDIA H100, RWKV6-7B's 64 heads: a window's 2 rows
    of one device's 4 differ at 18 % of the outputs, 2 rows of 32 heads
    at 75 %; ``tests/torch_split_numerics.py wkv``), and a bf16 decode
    carries such a float32 difference to 3e-2 of its logit rows over 4
    layers; so a window's rows and a rank's heads step as one device's
    do."""
    f64 = torch.float64
    rf, kf, vf = (t[:, 0].to(torch.float32) for t in (r, k, v))
    prev = torch.sum(state.to(f64) * rf.to(f64)[..., :, None], dim=-2)
    bonus = torch.sum((rf * u).to(f64) * kf.to(f64), dim=-1)
    out = prev.to(torch.float32) + bonus.to(torch.float32)[..., None] * vf
    new_state = (state * torch.exp(lw[:, 0])[..., None]
                 + kf[..., :, None] * vf[..., None, :])
    return out[:, None], new_state


def _heads(r, k, v, lw, u, state, chunk):
    """The WKV recurrence of a run of heads in chunks of ``chunk``
    (``_wkv_step`` for chunks of one): r, k, v, lw (B, S, Hr, N); u (Hr,
    N); state (B, Hr, N, N) or None (zeros).  Returns (out (B, S, Hr, N)
    float32, the new state)."""
    b, s, h, n = r.shape
    if state is None:
        state = torch.zeros((b, h, n, n), dtype=torch.float32,
                            device=r.device)
    step = _wkv_step if chunk == 1 else _wkv_chunk
    outs = []
    for off in range(0, s, chunk):
        part = slice(off, off + chunk)
        out_c, state = step(r[:, part], k[:, part], v[:, part], lw[:, part],
                            u, state)
        outs.append(out_c)
    return torch.cat(outs, dim=1), state


def _norm_gate(out, g, ln_x, dtype):
    """The per-head group norm (population variance, eps 1e-5) of ``out``
    (B, S, Hr, N) float32 with ``ln_x``'s scale and bias of its Hr N
    channels, then the gate silu(g) (g (B, S, Hr N)), in ``dtype``."""
    b, s = out.shape[:2]
    mu = torch.mean(out, dim=-1, keepdim=True)
    var = torch.var(out, dim=-1, keepdim=True, correction=0)
    out = ((out - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, -1)
    out = out * ln_x["scale"] + ln_x["bias"]
    return out.to(dtype) * F.silu(g.to(torch.float32)).to(dtype)


def time_mix_apply(p, x, cfg, *, state=None, x_prev=None, chunk=None):
    """x (B, S, D) -> (out (B, S, D), (last input (B, 1, D), new state)).
    ``state`` (B, H, N, N) and ``x_prev`` (B, 1, D) carry decode context;
    neither is written.  Split over "model" when ``x`` is a ``Parts``
    (``_time_mix_split``)."""
    b, s, _ = x.shape
    h, n = _head_geometry(cfg)
    chunk = chunk or min(WKV_CHUNK, s)
    if s % chunk:
        chunk = s
    if isinstance(x, Parts):
        return _time_mix_split(p, x, cfg, state, x_prev, chunk)

    sx = _shift(x, x_prev) - x
    xr, xk, xv, xw, xg = _ddlerp(p, x, sx)
    r = L.dense(p["wr"], xr, x.dtype).reshape(b, s, h, n)
    k = L.dense(p["wk"], xk, x.dtype).reshape(b, s, h, n)
    v = L.dense(p["wv"], xv, x.dtype).reshape(b, s, h, n)
    g = L.dense(p["wg"], xg, x.dtype)
    lw = _decay_logw(p, xw).reshape(b, s, h, n)
    out, state = _heads(r, k, v, lw, p["bonus"], state, chunk)
    out = _norm_gate(out, g, p["ln_x"], x.dtype)
    return L.dense(p["wo"], out, x.dtype), (x[:, -1:], state)


def _time_mix_split(p, x, cfg, state, x_prev, chunk):
    """``time_mix_apply`` split over "model" by heads, as the reference's
    annotations split it (r, k, v and the log decay by heads, the state
    (B, H, N, N) by heads).  The input is gathered over the sequence
    (the shift reads the previous position, which a sequence-split
    carry holds on another rank); the ddlerp and the decay LoRA run
    whole on every rank; rank r takes its heads' r, k, v and gate (its
    column blocks of wr / wk / wv / wg, ``layers.split_dense``) and its
    heads' slice of the log decay, the bonus, ``ln_x`` and the state;
    the recurrence and the group norm (per head: no move) run on its
    heads, and wo goes by its heads' rows (``layers.project_out``).
    ``state`` is placed by heads (dim 1) and ``x_prev`` replicated; the
    new state comes back by heads, the last input replicated.  Where the
    heads do not divide the axis every rank runs the whole time mix on
    the gathered input."""
    g = x.g
    h, n = _head_geometry(cfg)
    dtype = x.dtype
    x = annotate(x, "batch")                     # the sequence gathered
    if h % g.k:
        def whole(pr, xr, st, xp):
            out, (last, st) = time_mix_apply(pr, xr, cfg, state=st,
                                             x_prev=xp, chunk=chunk)
            return out, last, st
        out, last, state = g.map(whole, p, x, state, x_prev,
                                 dim=(None, None, None))
        return annotate(out, "batch", "tp", None), (last, state)
    hk = h // g.k
    dk = hk * n

    def mix(pr, xr, xp):
        return tuple(_ddlerp(pr, xr, _shift(xr, xp) - xr))
    xr, xk, xv, xw, xg = g.map(mix, p, x, x_prev)
    r, k, v, gate = (L.split_dense(p[name], t, dtype) for name, t in
                     (("wr", xr), ("wk", xk), ("wv", xv), ("wg", xg)))
    lw = g.map(_decay_logw, p, xw)               # whole on every rank

    def heads(rank, rr, kr, vr, lwr, gr, pr, st):
        mine = slice(rank * dk, (rank + 1) * dk)
        shape = rr.shape[:2] + (hk, n)
        out, st = _heads(rr.reshape(shape), kr.reshape(shape),
                         vr.reshape(shape), lwr[..., mine].reshape(shape),
                         pr["bonus"][rank * hk:(rank + 1) * hk], st, chunk)
        ln_x = {name: t[mine] for name, t in pr["ln_x"].items()}
        return _norm_gate(out, gr, ln_x, dtype), st
    out, state = g.map(heads, r, k, v, lw, gate, p, state, rank=True,
                       dim=(2, 1))
    return L.project_out(p["wo"], out, dtype), (x[:, -1:], state)


def channel_mix_apply(p, x, cfg, *, x_prev=None):
    """RWKV's channel mix: k = relu(Wk xk)^2; out = sigmoid(Wr xr) * Wv k.
    Returns (out, last input (B, 1, D)).  Split over "model" when ``x``
    is a ``Parts`` (``_channel_mix_split``)."""
    if isinstance(x, Parts):
        return _channel_mix_split(p, x, x_prev)
    xk, xr = _cmix_inputs(p, x, x_prev)
    k = L.dense(p["wk"], xk, x.dtype)
    k = torch.square(torch.relu(k.to(torch.float32))).to(x.dtype)
    r = torch.sigmoid(L.dense(p["wr"], xr, x.dtype).to(torch.float32))
    return r.to(x.dtype) * L.dense(p["wv"], k, x.dtype), x[:, -1:]


def _cmix_inputs(p, x, x_prev):
    """The channel mix's shifted inputs (xk, xr)."""
    sx = _shift(x, x_prev) - x
    return (x + sx * p["maa_k"].to(x.dtype), x + sx * p["maa_r"].to(x.dtype))


def _channel_mix_split(p, x, x_prev):
    """``channel_mix_apply`` split over "model" by d_ff: the input
    gathered over the sequence and shifted on every rank; wk by its
    d_ff columns, relu², wv by its d_ff rows (float32 partial sums
    reduce-scattered into the carry, ``layers.project_out``).  The
    receptance gate multiplies that sum, so it meets it on the carry's
    rows: wr by its columns, the gate moved to the carry's placement
    (an all-to-all over "model"; gathered in a decode step, whose carry
    of one position is replicated), so that no rank needs wr whole.
    ``x_prev`` is replicated."""
    g = x.g
    dtype = x.dtype
    x = annotate(x, "batch")                     # the sequence gathered
    xk, xr = g.map(_cmix_inputs, p, x, x_prev)
    k = L.split_dense(p["wk"], xk, dtype)
    k = g.map(lambda t: torch.square(torch.relu(t.to(torch.float32)))
              .to(dtype), k, dim=k.dim)
    kv = L.project_out(p["wv"], k, dtype)
    r = L.split_dense(p["wr"], xr, dtype)
    r = g.map(lambda t: torch.sigmoid(t.to(torch.float32)).to(dtype), r,
              dim=r.dim)
    r = annotate(r, "batch", "tp", None)         # the carry's placement
    return g.map(torch.mul, r, kv, dim=kv.dim), x[:, -1:]


def block_apply(p, x, cfg):
    h, _ = time_mix_apply(p["tmix"], L.apply_norm(p["ln1"], x, "layernorm"),
                          cfg)
    x = x + h
    h, _ = channel_mix_apply(p["cmix"], L.apply_norm(p["ln2"], x, "layernorm"),
                             cfg)
    return x + h


def lm_init(gen, cfg, device=None):
    """Seeded random parameters, drawn from ``gen`` on ``device`` (the
    card by default; ``gen`` must live on the same device)."""
    device = resolve(device)
    params = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device),
        "ln0": L.norm_init(cfg.d_model, "layernorm", device),
        "blocks": L.stack_layer_params(
            lambda g: block_init(g, cfg, device), gen, cfg.num_layers),
        "final_norm": L.norm_init(cfg.d_model, "layernorm", device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                         device)
    return params


def lm_hidden(params, tokens, cfg):
    """tokens (B, S) -> final hidden states (B, S, D)."""
    x = L.embed_lookup(params["embed"], tokens, L.dtype_of(cfg.compute_dtype))
    x = L.apply_norm(params["ln0"], x, "layernorm")

    def body(h, layer_params):
        h = annotate(h, "batch", "tp", None)     # sequence-parallel carry
        return block_apply(layer_params, h, cfg), None

    x, _ = L.scan(cfg, body, x, params["blocks"])
    return L.apply_norm(params["final_norm"], x, "layernorm")


def lm_logits(params, hidden):
    """Hidden states -> float32 logits over the padded vocabulary."""
    head = params.get("lm_head", params["embed"])
    return L.logits_projection(head, hidden, hidden.dtype)


def lm_loss(params, batch, cfg):
    """Next-token CE.  batch: {tokens (B, S), [loss_mask]}."""
    tokens = batch["tokens"]
    logits = lm_logits(params, lm_hidden(params, tokens, cfg))
    loss = L.cross_entropy(logits[:, :-1], tokens[:, 1:],
                           mask=batch.get("loss_mask"))
    return loss, {"loss": loss}


# -- serving -------------------------------------------------------------------

def init_caches(cfg, batch, max_seq, dtype=torch.bfloat16, device=None):
    """The recurrent state of every layer, float32 whatever ``dtype`` and
    O(1) in sequence length: {"tmix_x" (L, B, 1, D), "wkv" (L, B, H, N,
    N), "cmix_x" (L, B, 1, D)} on ``device`` (the card by default)."""
    device = resolve(device)
    h, n = _head_geometry(cfg)
    nl, d = cfg.num_layers, cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"tmix_x": torch.zeros((nl, batch, 1, d), **f32),
            "wkv": torch.zeros((nl, batch, h, n, n), **f32),
            "cmix_x": torch.zeros((nl, batch, 1, d), **f32)}


def block_decode(p, x1, cache, cfg):
    """One layer, one token.  Returns (x1, the layer's new state); the
    state ``cache`` is read, never written.  Split over "model" (a
    ``Parts`` ``x1``, ``cache`` placed as the cache's sharding holds it:
    the WKV state's key-row block, the token-shift inputs' d_model
    block), the state moves to the heads' placement (an all-to-all over
    "model", the reference's ``annotate(state, "batch", "tp", None,
    None)`` on a cache split by key rows) and back, the shift inputs are
    gathered, and the new state comes back in the cache's placement."""
    f32 = torch.float32
    split = isinstance(x1, Parts)
    if split:
        heads = 1 if _head_geometry(cfg)[0] % x1.g.k == 0 else None
        state = ann.reshard(cache["wkv"], heads)
        x_prev = {name: annotate(cache[name], "batch")
                  for name in ("tmix_x", "cmix_x")}
    else:
        state, x_prev = cache["wkv"], cache
    xn = L.apply_norm(p["ln1"], x1, "layernorm")
    h, (last_x, wkv) = time_mix_apply(p["tmix"], xn, cfg, state=state,
                                      x_prev=x_prev["tmix_x"], chunk=1)
    x1 = x1 + h
    xn = L.apply_norm(p["ln2"], x1, "layernorm")
    h, last_c = channel_mix_apply(p["cmix"], xn, cfg,
                                  x_prev=x_prev["cmix_x"])
    new = {"tmix_x": L.cast(last_x, f32), "wkv": wkv,
           "cmix_x": L.cast(last_c, f32)}
    if split:
        new = {name: ann.reshard(t, cache[name].dim)
               for name, t in new.items()}
    return x1 + h, new


def decode_step(params, tokens1, caches, pos, cfg):
    """One token for every slot.  tokens1 (B, 1); caches from
    ``init_caches`` (updated in place).  ``pos`` is unused: the state has
    no positions.  Returns (logits (B, 1, V), caches)."""
    del pos
    x = L.embed_lookup(params["embed"], tokens1,
                       L.dtype_of(cfg.compute_dtype))
    x = L.apply_norm(params["ln0"], x, "layernorm")
    for i, blk in enumerate(params["blocks"]):
        layer = {name: c[i] for name, c in caches.items()}
        x, new = block_decode(blk, x, layer, cfg)
        for name, t in new.items():
            L.assign(layer[name], t)
    x = L.apply_norm(params["final_norm"], x, "layernorm")
    return L.gathered(lm_logits(params, x)), caches
