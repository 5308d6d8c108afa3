"""Decoder-LM pieces shared across families.

Port of the two functions of ``repro.models.transformer`` that the MoE
family uses: the logits head and the stacked decode caches.  The dense
family itself is ROADMAP Queue 1 item 16.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L


def lm_logits(params, hidden, cfg):
    """Hidden states -> float32 logits over the padded vocabulary (the
    untied head, or the embedding table when tied)."""
    head = params.get("lm_head", params["embed"])
    return L.logits_projection(head, hidden, hidden.dtype)


def init_caches(cfg, batch, max_seq, dtype=torch.bfloat16, device=None):
    """Stacked (L-leading) per-layer KV caches: {"k", "v"} of shape
    (L, B, W, KV, hd)."""
    one = A.init_cache(cfg, batch, max_seq, dtype, device)
    return {name: t.new_zeros((cfg.num_layers,) + tuple(t.shape))
            for name, t in one.items()}
