"""SeamlessM4T-large-v2 (arXiv:2308.11596) text path: a speech/text
encoder and an autoregressive text decoder with cross-attention.

Port of ``repro.models.encdec``.  The modality frontend is a stub: the
batch carries precomputed speech frame embeddings (B, F, d_model).  This
module holds the encoder over those frames and the decoder (self-attn +
cross-attn + MLP).

* Pad frames are compressed out before encoding, the whole batch in ONE
  block-diagonal crossbar pass (``core.permute.vcompress_batched``).
* Decode-time cross-attention K/V are computed once from the encoder
  states (``prime_cross``) and read at every step.
* Teacher forcing uses ``sequence.shift_right``.

Layers are per-layer lists (``enc_blocks``, ``dec_blocks``); the stacks
run through ``layers.scan``, which honours ``cfg.remat``.  Decode writes
the self-attention caches in place.

Under the sharded executor's model-axis group both stacks carry their
sequence split over "model" (the reference's sequence-parallel carry,
the encoder's over the frames), and each layer's products split as
``attention`` and ``layers`` split them: cross attention by heads (or
by frames), its keys and values from the encoder states gathered over
"model".  In decode each rank reads its block of the self and the
cross caches (``attention.read_split``); ``prime_cross`` makes each
rank's block of the cross K/V on a group.
"""

from __future__ import annotations

import math

import torch

from repro_torch._device import resolve
from repro_torch.core import permute as P
from repro_torch.core.sequence import shift_right
from repro_torch.dist.annotate import Parts, annotate
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

# -- encoder -------------------------------------------------------------------


def enc_block_init(gen, cfg, device):
    return {
        "ln1": L.norm_init(cfg.d_model, cfg.norm, device),
        "attn": A.attn_init(gen, cfg, device),
        "ln2": L.norm_init(cfg.d_model, cfg.norm, device),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, act=cfg.act,
                          device=device),
    }


def enc_block_apply(p, x, cfg):
    h = A.attn_apply(p["attn"], L.apply_norm(p["ln1"], x, cfg.norm), cfg,
                     causal=False)
    x = x + h
    h = L.mlp_apply(p["mlp"], L.apply_norm(p["ln2"], x, cfg.norm),
                    act=cfg.act, compute_dtype=x.dtype)
    return x + h


def encode(params, frames, cfg, *, frame_valid=None):
    """frames (B, F, D) precomputed embeddings -> encoder states (B, F, D);
    with ``frame_valid`` (B, F) the valid frames are front-packed first
    and the pad slots zeroed."""
    x = L.cast(frames, L.dtype_of(cfg.compute_dtype))
    if frame_valid is not None:
        x = L.each(lambda t, m: P.vcompress_batched(t, m, tail="zero",
                                                    backend="auto"),
                   x, frame_valid)

    def body(h, blk):
        h = annotate(h, "batch", "tp", None)  # sequence-parallel carry
        return enc_block_apply(blk, h, cfg), None

    x, _ = L.scan(cfg, body, x, params["enc_blocks"])
    return L.apply_norm(params["enc_norm"], x, cfg.norm)


# -- decoder -------------------------------------------------------------------

def dec_block_init(gen, cfg, device):
    return {
        "ln1": L.norm_init(cfg.d_model, cfg.norm, device),
        "self_attn": A.attn_init(gen, cfg, device),
        "lnx": L.norm_init(cfg.d_model, cfg.norm, device),
        "cross_attn": A.attn_init(gen, cfg, device),
        "ln2": L.norm_init(cfg.d_model, cfg.norm, device),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, act=cfg.act,
                          device=device),
    }


def dec_block_apply(p, x, enc_out, cfg):
    h = A.attn_apply(p["self_attn"], L.apply_norm(p["ln1"], x, cfg.norm),
                     cfg)
    x = x + h
    h = A.cross_attn_apply(p["cross_attn"],
                           L.apply_norm(p["lnx"], x, cfg.norm), enc_out, cfg)
    x = x + h
    h = L.mlp_apply(p["mlp"], L.apply_norm(p["ln2"], x, cfg.norm),
                    act=cfg.act, compute_dtype=x.dtype)
    return x + h


def lm_init(gen, cfg, device=None):
    """Seeded random parameters, drawn from ``gen`` on ``device`` (the
    card by default; ``gen`` must live on the same device)."""
    device = resolve(device)
    return {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device),
        "enc_blocks": L.stack_layer_params(
            lambda g: enc_block_init(g, cfg, device), gen,
            cfg.encoder_layers),
        "enc_norm": L.norm_init(cfg.d_model, cfg.norm, device),
        "dec_blocks": L.stack_layer_params(
            lambda g: dec_block_init(g, cfg, device), gen, cfg.num_layers),
        "final_norm": L.norm_init(cfg.d_model, cfg.norm, device),
        "lm_head": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device),
    }


def decode_hidden(params, tokens, enc_out, cfg):
    """The teacher-forced decoder: targets (B, S) -> final hidden states
    (B, S, D), input token t being target t-1 (BOS = 0 at t = 0)."""
    inp = L.each(lambda t: shift_right(t, dim=-1, fill=0), tokens)
    x = L.embed_lookup(params["embed"], inp, L.dtype_of(cfg.compute_dtype))

    def body(h, blk):
        h = annotate(h, "batch", "tp", None)  # sequence-parallel carry
        return dec_block_apply(blk, h, enc_out, cfg), None

    x, _ = L.scan(cfg, body, x, params["dec_blocks"])
    return L.apply_norm(params["final_norm"], x, cfg.norm)


def lm_loss(params, batch, cfg):
    """batch: frontend_embeds (B, F, D) frames, tokens (B, S) targets,
    optional frame_valid (B, F) and loss_mask (B, S)."""
    tokens = batch["tokens"]
    enc_out = encode(params, batch["frontend_embeds"], cfg,
                     frame_valid=batch.get("frame_valid"))
    x = decode_hidden(params, tokens, enc_out, cfg)
    logits = L.logits_projection(params["lm_head"], x, x.dtype)
    loss = L.cross_entropy(logits, tokens, mask=batch.get("loss_mask"))
    return loss, {"loss": loss}


# -- serving -------------------------------------------------------------------

def init_caches(cfg, batch, max_seq, dtype=torch.bfloat16, device=None):
    """Self-attention KV of every decoder layer, {"self": {"k", "v"}} of
    shape (L, B, W, KV, hd) (cross K/V come from ``prime_cross``)."""
    return {"self": T.init_caches(cfg, batch, max_seq, dtype, device)}


def prime_cross(params, enc_out, cfg, dtype=torch.bfloat16):
    """Every decoder layer's cross-attention K/V from the encoder states:
    {"k", "v"} of shape (L, B, F, KV, hd).  On a model-axis group
    (``enc_out`` ``Parts``), each rank's block of them, as
    ``sharding.cache_shardings`` places the caches: its kv heads (wk's
    and wv's column blocks) where they divide the axis, else its
    head_dim block of every kv head (cut from the whole projection),
    else all of it."""
    if isinstance(enc_out, Parts):
        return _prime_cross_split(params, enc_out, cfg, dtype)
    b, f, _ = enc_out.shape
    kv, hd = cfg.num_kv_heads, cfg.hd
    compute = L.dtype_of(cfg.compute_dtype)
    ks, vs = [], []
    for blk in params["dec_blocks"]:
        p = blk["cross_attn"]
        ks.append(L.dense(p["wk"], enc_out, compute).reshape(b, f, kv, hd))
        vs.append(L.dense(p["wv"], enc_out, compute).reshape(b, f, kv, hd))
    return {"k": torch.stack(ks).to(dtype), "v": torch.stack(vs).to(dtype)}


def _prime_cross_split(params, enc_out, cfg, dtype):
    g = enc_out.g
    enc = annotate(enc_out, "batch")
    b, f, _ = enc.shape
    kv, hd = cfg.num_kv_heads, cfg.hd
    compute = L.dtype_of(cfg.compute_dtype)
    # the split dimension of a layer's (B, F, KV, hd) block: the caches'
    # rule (``sharding.cache_shardings``)
    split = 2 if kv % g.k == 0 else 3 if hd % g.k == 0 else None

    def project(w):
        if split == 2:
            t = L.split_dense(w, enc, compute)
            return g.map(lambda tr: tr.reshape(b, f, kv // g.k, hd), t,
                         dim=2)
        t = A._project(g, w, enc, compute, kv, hd)
        return g.map(lambda r, tr: A._mine(g, r, tr, split), t, rank=True,
                     dim=split)

    def stacked(name):
        layers = [project(blk["cross_attn"][name])
                  for blk in params["dec_blocks"]]
        return g.map(lambda *ts: torch.stack(ts).to(dtype), *layers,
                     dim=None if split is None else split + 1)
    return {"k": stacked("wk"), "v": stacked("wv")}


def _cross_decode(p, x1, ck, cv, cfg):
    """One query token against a layer's primed cross K/V (B, F, KV, hd),
    in the grouped (KV, rep) form; split over "model", each rank against
    its block of them (``attention.read_split``)."""
    if isinstance(x1, Parts):
        g = x1.g
        x1 = annotate(x1, "batch")
        dtype = x1.first().dtype
        q = A._project(g, p["wq"], x1, dtype, cfg.num_heads, cfg.hd)
        return L.project_out(p["wo"], A.read_split(g, q, ck, cv, cfg, dtype),
                             dtype)
    b = x1.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = L.dense(p["wq"], x1, x1.dtype).reshape(b, 1, h, hd)
    qh = A.annotate_grouped_q(q.reshape(b, 1, kv, h // kv, hd))
    scores = L.einsum_f32("bckrh,bskh->bkrcs", qh, ck) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1)
    o = L.einsum_f32("bkrcs,bskh->bckrh", probs.to(x1.dtype), cv)
    return L.dense(p["wo"], o.reshape(b, 1, h * hd).to(x1.dtype), x1.dtype)


def decode_step(params, tokens1, caches, pos, cfg, *, cross):
    """One decoder token for every slot.  tokens1 (B, 1); caches from
    ``init_caches`` (updated in place); cross = ``prime_cross(...)``.
    Returns (logits (B, 1, V), {"self": caches})."""
    x = L.embed_lookup(params["embed"], tokens1,
                       L.dtype_of(cfg.compute_dtype))
    self_caches = caches["self"]
    for i, blk in enumerate(params["dec_blocks"]):
        layer_cache = {name: c[i] for name, c in self_caches.items()}
        hh, _ = A.decode_attn_apply(
            blk["self_attn"], L.apply_norm(blk["ln1"], x, cfg.norm),
            layer_cache, pos, cfg)
        x = x + hh
        hh = _cross_decode(blk["cross_attn"],
                           L.apply_norm(blk["lnx"], x, cfg.norm),
                           cross["k"][i], cross["v"][i], cfg)
        x = x + hh
        hh = L.mlp_apply(blk["mlp"], L.apply_norm(blk["ln2"], x, cfg.norm),
                         act=cfg.act, compute_dtype=x.dtype)
        x = x + hh
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    logits = L.logits_projection(params["lm_head"], x, x.dtype)
    return L.gathered(logits), {"self": self_caches}
