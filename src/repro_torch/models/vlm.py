"""InternVL2-26B (arXiv:2404.16821): InternViT frontend + InternLM2 backbone.

Port of ``repro.models.vlm``.  The vision frontend is a stub: the batch
carries precomputed patch embeddings (B, F, d_model).  The language
backbone is the dense transformer (``models.transformer``) consuming the
patch prefix ahead of the text.

Variable-length patch sequences are packed with vcompress (pad patches
dropped, real patches front-packed) before the prefix is joined: the
whole batch packs in ONE block-diagonal crossbar pass
(``core.permute.vcompress_batched``).  On the card ``auto`` takes the
tile-skipping crossbar kernel when the plan's tile density is at most
``AUTO_SPARSE_DENSITY`` (B >= 4 requests), else the batched contraction
over the diagonal blocks, as the reference lowers it.  Under the
sharded executor's model-axis group every rank of a window's row packs
the window's rows (the batch rows are replicated over "model"), and the
stack splits as the dense family's.
"""

from __future__ import annotations

import torch

from repro_torch.core import permute as P
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

lm_init = T.lm_init
init_caches = T.init_caches
decode_step = T.decode_step


def pack_patches(patch_embeds: torch.Tensor,
                 patch_valid: torch.Tensor) -> torch.Tensor:
    """Front-pack the valid patch embeddings of every batch row.

    patch_embeds (B, F, D); patch_valid (B, F) bool.  Pad patch slots are
    compressed out to the tail and zeroed: fixed shapes, one crossbar
    pass for all B rows (a pass a rank for ``Parts``).
    """
    return L.each(lambda x, m: P.vcompress_batched(x, m, tail="zero",
                                                   backend="auto"),
                  patch_embeds, patch_valid)


def lm_loss(params, batch, cfg):
    """batch: tokens (B, S_text), frontend_embeds (B, F, D), optional
    patch_valid (B, F)."""
    embeds = batch["frontend_embeds"]
    if "patch_valid" in batch:
        embeds = pack_patches(embeds, batch["patch_valid"])
    return T.lm_loss(params, {**batch, "frontend_embeds": embeds}, cfg)


def prefill(params, tokens, cfg, *, frontend_embeds=None, max_seq=None,
            cache_dtype=torch.bfloat16):
    """Multimodal prefill: image prefix + prompt text -> (last-token
    logits, caches primed for decode at position F + S_text)."""
    if frontend_embeds is None:
        return T.prefill(params, tokens, cfg, max_seq=max_seq,
                         cache_dtype=cache_dtype)
    x = L.embed_lookup(params["embed"], tokens,
                       L.dtype_of(cfg.compute_dtype), prefix=frontend_embeds)
    return T.prefill_embeds(params, x, cfg, max_seq=max_seq,
                            cache_dtype=cache_dtype)
