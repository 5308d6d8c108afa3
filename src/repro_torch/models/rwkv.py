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
plain loop.  Decode is the same code on one token (``chunk=1``).  Plain
PyTorch (matmul and einsum): the reference has no kernel here.

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
from repro_torch.models import layers as L

LORA_MIX = 32     # TIME_MIX_EXTRA_DIM
LORA_DECAY = 64   # TIME_DECAY_EXTRA_DIM
WKV_CHUNK = 16


def _head_geometry(cfg):
    """(H, N): RWKV6 fixes the head size at 64; reduced configs take what
    divides d_model."""
    n = min(64, cfg.d_model)
    while cfg.d_model % n:
        n //= 2
    return cfg.d_model // n, n


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


def _ddlerp(p, x, sx):
    """Finch's data-dependent token-shift interpolation.  x (B, S, D),
    sx = shifted(x) - x.  Returns the five mixed streams (r, k, v, w, g)
    stacked, (5, B, S, D) in x's dtype; the LoRA runs in float32."""
    base = x + sx * p["maa_x"]            # float32, as the reference promotes
    lora = torch.tanh(L.einsum("bsd,de->bse", base.to(torch.float32),
                               p["maa_w1"].reshape(x.shape[-1], -1)))
    lora = lora.reshape(lora.shape[:-1] + (5, LORA_MIX))
    dyn = L.einsum("bsme,med->mbsd", lora, p["maa_w2"])   # (5, B, S, D)
    mix = p["maa_rkvwg"][:, None, None, :] + dyn
    return x[None] + sx[None] * mix.to(x.dtype)


def _decay_logw(p, xw):
    """The data-dependent log decay, lw = -exp(decay + tanh(xw w1) w2),
    in float32.  The clip at 1.5 bounds |lw| by e^1.5 ~= 4.48, so the
    chunk form's exp(-lp) stays finite in float32 over 16 positions
    (16 x 4.48 = 71.7 < 88)."""
    dyn = L.einsum("bsk,kd->bsd",
                   torch.tanh(L.einsum("bsd,dk->bsk", xw.to(torch.float32),
                                       p["decay_w1"])),
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


def time_mix_apply(p, x, cfg, *, state=None, x_prev=None, chunk=None):
    """x (B, S, D) -> (out (B, S, D), (last input (B, 1, D), new state)).
    ``state`` (B, H, N, N) and ``x_prev`` (B, 1, D) carry decode context;
    neither is written."""
    b, s, d = x.shape
    h, n = _head_geometry(cfg)
    chunk = chunk or min(WKV_CHUNK, s)
    if s % chunk:
        chunk = s

    sx = _shift(x, x_prev) - x
    xr, xk, xv, xw, xg = _ddlerp(p, x, sx)
    r = L.dense(p["wr"], xr, x.dtype).reshape(b, s, h, n)
    k = L.dense(p["wk"], xk, x.dtype).reshape(b, s, h, n)
    v = L.dense(p["wv"], xv, x.dtype).reshape(b, s, h, n)
    g = L.dense(p["wg"], xg, x.dtype)
    lw = _decay_logw(p, xw).reshape(b, s, h, n)

    if state is None:
        state = torch.zeros((b, h, n, n), dtype=torch.float32,
                            device=x.device)
    outs = []
    for off in range(0, s, chunk):
        part = slice(off, off + chunk)
        out_c, state = _wkv_chunk(r[:, part], k[:, part], v[:, part],
                                  lw[:, part], p["bonus"], state)
        outs.append(out_c)
    out = torch.cat(outs, dim=1)                     # (B, S, H, N) float32

    # per-head group norm (population variance, eps 1e-5), then the gate
    mu = torch.mean(out, dim=-1, keepdim=True)
    var = torch.var(out, dim=-1, keepdim=True, correction=0)
    out = ((out - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, d)
    out = out * p["ln_x"]["scale"] + p["ln_x"]["bias"]
    out = out.to(x.dtype) * F.silu(g.to(torch.float32)).to(x.dtype)
    return L.dense(p["wo"], out, x.dtype), (x[:, -1:], state)


def channel_mix_apply(p, x, cfg, *, x_prev=None):
    """RWKV's channel mix: k = relu(Wk xk)^2; out = sigmoid(Wr xr) * Wv k.
    Returns (out, last input (B, 1, D))."""
    sx = _shift(x, x_prev) - x
    xk = x + sx * p["maa_k"].to(x.dtype)
    xr = x + sx * p["maa_r"].to(x.dtype)
    k = L.dense(p["wk"], xk, x.dtype)
    k = torch.square(torch.relu(k.to(torch.float32))).to(x.dtype)
    r = torch.sigmoid(L.dense(p["wr"], xr, x.dtype).to(torch.float32))
    return r.to(x.dtype) * L.dense(p["wv"], k, x.dtype), x[:, -1:]


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
    state ``cache`` is read, never written."""
    xn = L.apply_norm(p["ln1"], x1, "layernorm")
    h, (last_x, wkv) = time_mix_apply(p["tmix"], xn, cfg, state=cache["wkv"],
                                      x_prev=cache["tmix_x"], chunk=1)
    x1 = x1 + h
    xn = L.apply_norm(p["ln2"], x1, "layernorm")
    h, last_c = channel_mix_apply(p["cmix"], xn, cfg, x_prev=cache["cmix_x"])
    new = {"tmix_x": last_x.to(torch.float32), "wkv": wkv,
           "cmix_x": last_c.to(torch.float32)}
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
            layer[name].copy_(t)
    x = L.apply_norm(params["final_norm"], x, "layernorm")
    return lm_logits(params, x), caches
