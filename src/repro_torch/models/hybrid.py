"""Zamba2 hybrid (arXiv:2411.15242): a Mamba2 backbone and ONE shared
attention block applied every ``shared_attn_period`` layers.

Port of ``repro.models.hybrid``.  The shared block's parameters serve
every application; a small LoRA on its output projection tells the
applications apart.  It reads ``concat(hidden, original embeddings)``
(2 d_model wide), as Zamba does.

Layout: the layers form G groups, each [shared attention, then
``period`` Mamba2 blocks].  Parameters: ``mamba`` is a list of G lists
of ``period`` per-layer dicts, ``lora`` a list of G dicts (the reference
stacks them on (G, period) and (G,) axes).  The groups run through
``layers.scan`` (with ``cfg.remat == "full"`` each group is one
checkpoint, as the reference checkpoints the group body); the blocks of
a group run in a plain loop.

Decode keeps each Mamba2 layer's state (O(1) in sequence length) and one
K/V cache for each shared application.  ``init_caches(window=W)`` makes
those caches rings of W slots (written at ``pos % W``; the Mamba2 states
carry the longer range).  Caches are stacked, (G, period, ...) for the
Mamba2 states and (G, ...) for the rings, and updated in place.

The shared block's attention is the attention module's, on the block's
own config (``_attn_cfg``: causal with no window, full rotary, one
chunk).  Under the sharded executor's model-axis group
(``dist.annotate``) the carry is placed sequence-parallel at each
group's start, the shared block splits by heads (its concat gathered
over the sequence; wq / wk / wv by columns, wo by rows, the LoRA on each
rank's rows of the carry, the MLP by d_ff), each Mamba2 layer by SSM
heads (``ssm``), and decode reads each rank's kv-head block of the
rings and moves the Mamba2 states to the heads' placement and back.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve
from repro_torch.dist.annotate import Parts, annotate
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

LORA_RANK = 8


def n_groups(cfg):
    """(groups, period): the layers' grouping around the shared block."""
    period = cfg.shared_attn_period or cfg.num_layers
    if cfg.num_layers % period:
        raise ValueError("period must divide num_layers")
    return cfg.num_layers // period, period


def shared_attn_init(gen, cfg, device):
    """The one shared block: attention over concat(h, x0), then an MLP."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    return {
        "ln1": L.norm_init(2 * d, cfg.norm, device),
        "wq": L.dense_init(gen, 2 * d, h * hd, device=device),
        "wk": L.dense_init(gen, 2 * d, kv * hd, device=device),
        "wv": L.dense_init(gen, 2 * d, kv * hd, device=device),
        "wo": L.dense_init(gen, h * hd, d, device=device),
        "ln2": L.norm_init(d, cfg.norm, device),
        "mlp": L.mlp_init(gen, d, cfg.d_ff, act=cfg.act, device=device),
    }


def lora_init(gen, cfg, count, device):
    """The output LoRA of each of ``count`` applications (a list)."""
    d = cfg.d_model
    return [{"a": L.truncated_normal(gen, (d, LORA_RANK), 0.01, device),
             "b": torch.zeros((LORA_RANK, d), dtype=torch.float32,
                              device=device)}
            for _ in range(count)]


def mamba_block_init(gen, cfg, device):
    return {"ln": L.norm_init(cfg.d_model, cfg.norm, device),
            "mamba": S.mamba2_init(gen, cfg, device)}


def lm_init(gen, cfg, device=None):
    """Seeded random parameters, drawn from ``gen`` on ``device`` (the
    card by default; ``gen`` must live on the same device)."""
    device = resolve(device)
    groups, period = n_groups(cfg)
    params = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device),
        "shared": shared_attn_init(gen, cfg, device),
        "lora": lora_init(gen, cfg, groups, device),
        "mamba": [L.stack_layer_params(
            lambda g: mamba_block_init(g, cfg, device), gen, period)
            for _ in range(groups)],
        "final_norm": L.norm_init(cfg.d_model, cfg.norm, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                         device)
    return params


def _attn_cfg(cfg, s):
    """The shared block's attention as the attention module's on this
    config: causal with no window, full rotary, the ``s`` positions in
    one chunk (the reference's ``shared_attn_apply`` scores the whole
    sequence at once)."""
    return dataclasses.replace(cfg, sliding_window=0, rotary_pct=1.0,
                               attn_chunk=s)


def _concat(x, x0):
    """concat(x, x0) on the last dimension; split over "model", both
    gathered over the sequence first."""
    def join(a, b):
        return torch.cat([a, b.to(a.dtype)], dim=-1)
    if isinstance(x, Parts):
        return x.g.map(join, annotate(x, "batch"), annotate(x0, "batch"))
    return join(x, x0)


def _lora_out(o, lora_g):
    """The application's LoRA correction added to the output projection
    (float32 products, cast back); split over "model", on each rank's
    rows of the carry (a per-position map)."""
    if isinstance(o, Parts):
        return o.g.map(_lora_out, o, lora_g, dim=o.dim)
    return o + L.einsum("bsd,dr,re->bse", o.to(torch.float32), lora_g["a"],
                        lora_g["b"]).to(o.dtype)


def _mlp_residual(p, x, cfg):
    return x + L.mlp_apply(p["mlp"], L.apply_norm(p["ln2"], x, cfg.norm),
                           act=cfg.act, compute_dtype=x.dtype)


def shared_attn_apply(p, lora_g, x, x0, cfg):
    """One application of the shared block.  x, x0 (B, S, D): causal
    attention over the whole sequence in one chunk, as the reference's
    (split over "model": by heads, ``attention._attn_split``)."""
    cat = L.apply_norm(p["ln1"], _concat(x, x0), cfg.norm)
    o = A.attn_apply(p, cat, _attn_cfg(cfg, x.shape[1]))
    return _mlp_residual(p, x + _lora_out(o, lora_g), cfg)


def lm_hidden(params, tokens, cfg):
    """tokens (B, S) -> final hidden states (B, S, D)."""
    x0 = L.embed_lookup(params["embed"], tokens,
                        L.dtype_of(cfg.compute_dtype))

    def group_body(h, g):
        # the group's leaves are read here, inside the checkpointed body
        # (``layers.scan``)
        blocks_g, lora_g = params["mamba"][g], params["lora"][g]
        h = annotate(h, "batch", "tp", None)     # sequence-parallel carry
        h = shared_attn_apply(params["shared"], lora_g, h, x0, cfg)
        for blk in blocks_g:
            y, _ = S.mamba2_apply(blk["mamba"],
                                  L.apply_norm(blk["ln"], h, cfg.norm), cfg)
            h = h + y
        return h, None

    x, _ = L.scan(cfg, group_body, x0, range(len(params["mamba"])))
    return L.apply_norm(params["final_norm"], x, cfg.norm)


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

def init_caches(cfg, batch, max_seq, dtype=torch.bfloat16, device=None, *,
                window=0):
    """Every Mamba2 layer's state (float32, {"ssm": {"ssm" (G, period, B,
    H, P, N), "conv" (G, period, B, W-1, C)}}), the K/V of each shared
    application in ``dtype`` ({"attn_k", "attn_v"}: (G, B, w, KV, hd),
    w = min(window, max_seq) when ``window`` > 0, else max_seq) and
    "x0" (B, 1, D), carried as the reference carries it, on ``device``
    (the card by default)."""
    device = resolve(device)
    groups, period = n_groups(cfg)
    w = min(window, max_seq) if window > 0 else max_seq
    shape = (groups, batch, w, cfg.num_kv_heads, cfg.hd)
    return {
        "ssm": {name: t.new_zeros((groups, period) + tuple(t.shape))
                for name, t in S.init_state(cfg, batch, device).items()},
        "attn_k": torch.zeros(shape, dtype=dtype, device=device),
        "attn_v": torch.zeros(shape, dtype=dtype, device=device),
        "x0": torch.zeros((batch, 1, cfg.d_model), dtype=torch.float32,
                          device=device),
    }


def _shared_attn_decode(p, lora_g, x1, x0, k_cache, v_cache, pos: int, cfg):
    """One application of the shared block on one token.  Writes its K/V
    at ring slot ``pos % w`` of ``k_cache`` / ``v_cache`` (B, w, KV, hd)
    in place; the first min(pos + 1, w) slots are valid.  Split over
    "model", each rank writes and reads its block of the ring
    (``attention.read_split``)."""
    cat = L.apply_norm(p["ln1"], _concat(x1, x0), cfg.norm)
    o, _ = A.decode_attn_apply(p, cat, {"k": k_cache, "v": v_cache}, pos,
                               _attn_cfg(cfg, 1))
    return _mlp_residual(p, x1 + _lora_out(o, lora_g), cfg)


def decode_step(params, tokens1, caches, pos, cfg):
    """One token for every slot.  tokens1 (B, 1); caches from
    ``init_caches`` (updated in place).  The shared block reads the
    current token's embedding as x0; ``caches["x0"]`` is carried, never
    updated, as in the reference.  Returns (logits (B, 1, V), caches)."""
    x0 = L.embed_lookup(params["embed"], tokens1,
                        L.dtype_of(cfg.compute_dtype))
    x = x0
    ssm = caches["ssm"]
    for g, (blocks_g, lora_g) in enumerate(zip(params["mamba"],
                                               params["lora"])):
        x = _shared_attn_decode(params["shared"], lora_g, x, x0,
                                caches["attn_k"][g], caches["attn_v"][g],
                                pos, cfg)
        for i, blk in enumerate(blocks_g):
            state = {name: t[g, i] for name, t in ssm.items()}
            y, new = S.mamba2_decode(blk["mamba"],
                                     L.apply_norm(blk["ln"], x, cfg.norm),
                                     state, cfg)
            for name, t in new.items():
                L.assign(state[name], t)
            x = x + y
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return L.gathered(lm_logits(params, x)), caches
