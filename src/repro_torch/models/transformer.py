"""Dense decoder-only transformer LM (qwen1.5 / starcoder2 / stablelm /
minicpm families); its logits head and decode caches also serve the MoE
family.

Port of ``repro.models.transformer``.  Parameters are nested dicts with
``blocks`` a list of per-layer dicts (the reference stacks them on a
leading L axis for ``lax.scan``); the training stack runs through
``layers.scan``, which honours ``cfg.remat``.  Decode updates the
stacked caches in place.  Under the sharded executor's model-axis group
the layer stack's carry is split on the sequence over "model" (the
reference's sequence-parallel carry), and each layer's products as
``attention`` and ``layers`` split them; a frontend prefix (the vlm
family's patches) joins the embeddings before the carry is placed
(``layers.embed_lookup``), and the vocabulary-split logits are sliced
rank by rank.
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve
from repro_torch.dist.annotate import annotate
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def block_init(gen, cfg, device):
    return {
        "ln1": L.norm_init(cfg.d_model, cfg.norm, device),
        "attn": A.attn_init(gen, cfg, device),
        "ln2": L.norm_init(cfg.d_model, cfg.norm, device),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, act=cfg.act,
                          device=device),
    }


def block_apply(p, x, cfg, *, positions=None):
    h = A.attn_apply(p["attn"], L.apply_norm(p["ln1"], x, cfg.norm), cfg,
                     positions=positions)
    x = x + h
    h = L.mlp_apply(p["mlp"], L.apply_norm(p["ln2"], x, cfg.norm),
                    act=cfg.act, compute_dtype=x.dtype)
    return x + h


def block_decode(p, x1, cache, pos, cfg):
    h, cache = A.decode_attn_apply(p["attn"],
                                   L.apply_norm(p["ln1"], x1, cfg.norm),
                                   cache, pos, cfg)
    x1 = x1 + h
    h = L.mlp_apply(p["mlp"], L.apply_norm(p["ln2"], x1, cfg.norm),
                    act=cfg.act, compute_dtype=x1.dtype)
    return x1 + h, cache


def lm_init(gen, cfg, device=None):
    """Seeded random parameters, drawn from ``gen`` on ``device`` (the
    card by default; ``gen`` must live on the same device)."""
    device = resolve(device)
    params = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device),
        "blocks": L.stack_layer_params(
            lambda g: block_init(g, cfg, device), gen, cfg.num_layers),
        "final_norm": L.norm_init(cfg.d_model, cfg.norm, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                         device)
    return params


def _run_stack(blocks, x, cfg, *, positions=None):
    def body(h, layer_params):
        # Megatron-style sequence parallelism: the residual carry shards
        # its sequence over 'model'
        h = annotate(h, "batch", "tp", None)
        return block_apply(layer_params, h, cfg, positions=positions), None

    x, _ = L.scan(cfg, body, x, blocks)
    return x


def lm_hidden(params, tokens, cfg, *, extra_embeds=None):
    """Token (and optional frontend) embeddings -> final hidden states."""
    x = L.embed_lookup(params["embed"], tokens,
                       L.dtype_of(cfg.compute_dtype), prefix=extra_embeds)
    x = _run_stack(params["blocks"], x, cfg)
    return L.apply_norm(params["final_norm"], x, cfg.norm)


def lm_logits(params, hidden, cfg):
    """Hidden states -> float32 logits over the padded vocabulary (the
    untied head, or the embedding table when tied)."""
    head = params.get("lm_head", params["embed"])
    return L.logits_projection(head, hidden, hidden.dtype)


def lm_loss(params, batch, cfg):
    """Next-token CE.  batch: {tokens (B, S) int, [frontend_embeds],
    [loss_mask]}.  With a frontend, the loss covers text positions only.
    Returns (loss, {"loss": loss})."""
    tokens = batch["tokens"]
    extra = batch.get("frontend_embeds")
    hidden = lm_hidden(params, tokens, cfg, extra_embeds=extra)
    logits = lm_logits(params, hidden, cfg)
    if extra is not None:
        logits = logits[:, extra.shape[1]:]
    loss = L.cross_entropy(logits[:, :-1], tokens[:, 1:],
                           mask=batch.get("loss_mask"))
    return loss, {"loss": loss}


# -- serving -------------------------------------------------------------------

def init_caches(cfg, batch, max_seq, dtype=torch.bfloat16, device=None):
    """Stacked (L-leading) per-layer KV caches: {"k", "v"} of shape
    (L, B, W, KV, hd)."""
    one = A.init_cache(cfg, batch, max_seq, dtype, device)
    return {name: t.new_zeros((cfg.num_layers,) + tuple(t.shape))
            for name, t in one.items()}


def decode_step(params, tokens1, caches, pos, cfg):
    """One token for every slot.  tokens1 (B, 1); caches from
    ``init_caches`` or ``prefill`` (updated in place).  Returns (logits
    (B, 1, V), caches)."""
    x = L.embed_lookup(params["embed"], tokens1,
                       L.dtype_of(cfg.compute_dtype))
    for i, blk in enumerate(params["blocks"]):
        layer_cache = {name: c[i] for name, c in caches.items()}
        x, _ = block_decode(blk, x, layer_cache, pos, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return L.gathered(lm_logits(params, x, cfg)), caches


def prefill(params, tokens, cfg, *, max_seq=None, cache_dtype=torch.bfloat16):
    """Process a full prompt: (last-token logits (B, 1, V), caches primed
    for decode at position S)."""
    x = L.embed_lookup(params["embed"], tokens, L.dtype_of(cfg.compute_dtype))
    return prefill_embeds(params, x, cfg, max_seq=max_seq,
                          cache_dtype=cache_dtype)


def prefill_embeds(params, x, cfg, *, max_seq=None,
                   cache_dtype=torch.bfloat16):
    """``prefill`` from the input embeddings x (B, S, D) (a frontend
    prefix joined to the text by the vlm family).

    The stack runs the training path for the hidden states; each layer's
    K/V is projected again from its normed input and placed in the (ring)
    cache layout, slot = pos % W.
    """
    b, s, _ = x.shape
    max_seq = max_seq or s
    dtype = x.dtype
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    w = cfg.sliding_window if cfg.sliding_window > 0 else max_seq
    w = min(w, max_seq)

    def to_cache(k):
        if w >= s:
            return torch.nn.functional.pad(
                k, (0, 0, 0, 0, 0, w - s)).to(cache_dtype)
        tail = k[:, -w:]                       # absolute positions [s-w, s)
        return torch.roll(tail, s % w, dims=1).to(cache_dtype)

    ks, vs = [], []
    for blk in params["blocks"]:
        normed = L.apply_norm(blk["ln1"], x, cfg.norm)
        _, k, v = A._project_qkv(blk["attn"], normed, cfg, positions, dtype)
        ks.append(to_cache(k))
        vs.append(to_cache(v))
        x = block_apply(blk, x, cfg, positions=positions)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    logits = lm_logits(params, x[:, -1:], cfg)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}
