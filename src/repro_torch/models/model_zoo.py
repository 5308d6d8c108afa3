"""Model zoo: one API over the model families the port builds.

Port of ``repro.models.model_zoo`` for all six families: ``dense``,
``moe``, ``rwkv``, ``hybrid``, ``vlm`` and ``encdec``.  ``build(cfg)``
returns a ``ModelAPI``:

    init(generator=None)                     -> params (on the device)
    loss_fn(params, batch)                   -> (loss, metrics)
    batch_specs(batch, seq)                  -> {name: (shape, dtype)}
    make_batch(generator, batch, seq)        -> the same tree, real tensors
    init_caches(batch, max_seq, dtype, window=0)  -> decode caches
    decode_fn(params, tokens1, caches, pos)  -> (logits, caches)

``make_batch`` draws every value from ``generator`` (a
``torch.Generator`` on the API's device).  Input shapes, as in the
reference:

* dense / moe / rwkv / hybrid: tokens (B, S);
* vlm: a patch prefix of F = min(256, frontend_seq) slots (with
  ``patch_valid``) and text of max(S - F, 8) tokens;
* encdec: frames and tokens of max(S // 2, 8) each; the cross-attention
  K/V (zeros from a max_seq // 2-frame encoding, as the reference's)
  live in the caches tree, so ``decode_fn`` stays uniform.

``window`` caps the hybrid's shared-attention K/V at a ring of that
many slots; the other families ignore it, as the reference's do.  An
unknown family raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch._device import resolve
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import params as _params

VLM_PATCHES = 256  # InternVL2 patch prefix (stub frontend output length)
# The families whose loss and decode functions split each layer's
# products over "model" in the sharded executor (``dist.spmd``): they
# carry ``model_split = True``.
MODEL_SPLIT_FAMILIES = ("dense", "moe", "vlm", "encdec", "hybrid", "rwkv")


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    loss_fn: Callable
    batch_specs: Callable
    make_batch: Callable
    init_caches: Callable
    decode_fn: Callable


def _token_specs(cfg, batch, seq):
    return {"tokens": ((batch, seq), torch.int32)}


def _token_batch(cfg, generator, batch, seq, device):
    return {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                    generator=generator, device=device,
                                    dtype=torch.int32)}


def _vlm_batch(cfg, f):
    dtype = L.dtype_of(cfg.compute_dtype)

    def specs(batch, seq):
        s_text = max(seq - f, 8)
        return {"tokens": ((batch, s_text), torch.int32),
                "frontend_embeds": ((batch, f, cfg.d_model), dtype),
                "patch_valid": ((batch, f), torch.bool)}

    def make(generator, batch, seq, device):
        s_text = max(seq - f, 8)
        return {
            "tokens": torch.randint(0, cfg.vocab_size, (batch, s_text),
                                    generator=generator, device=device,
                                    dtype=torch.int32),
            "frontend_embeds": torch.randn(
                (batch, f, cfg.d_model), generator=generator,
                device=device).mul_(0.02).to(dtype),
            "patch_valid": torch.rand((batch, f), generator=generator,
                                      device=device) < 0.9,
        }

    return specs, make


def _encdec_batch(cfg):
    dtype = L.dtype_of(cfg.compute_dtype)

    def specs(batch, seq):
        half = max(seq // 2, 8)
        return {"tokens": ((batch, half), torch.int32),
                "frontend_embeds": ((batch, half, cfg.d_model), dtype)}

    def make(generator, batch, seq, device):
        half = max(seq // 2, 8)
        return {
            "tokens": torch.randint(0, cfg.vocab_size, (batch, half),
                                    generator=generator, device=device,
                                    dtype=torch.int32),
            "frontend_embeds": torch.randn(
                (batch, half, cfg.d_model), generator=generator,
                device=device).mul_(0.02).to(dtype),
        }

    return specs, make


def build(cfg: ModelConfig, device=None) -> ModelAPI:
    """The model API of ``cfg`` on ``device`` (the card by default)."""
    M = _params.family_module(cfg)
    dev = resolve(device)
    specs = functools.partial(_token_specs, cfg)
    make = functools.partial(_token_batch, cfg)
    init_caches = (lambda batch, max_seq, dtype=torch.bfloat16, window=0:
                   M.init_caches(cfg, batch, max_seq, dtype, dev))
    decode_fn = (lambda p, t1, c, pos: M.decode_step(p, t1, c, pos, cfg))

    if cfg.family == "hybrid":
        init_caches = (lambda batch, max_seq, dtype=torch.bfloat16, window=0:
                       M.init_caches(cfg, batch, max_seq, dtype, dev,
                                     window=window))
    elif cfg.family == "vlm":
        specs, make = _vlm_batch(
            cfg, min(VLM_PATCHES, cfg.frontend_seq or VLM_PATCHES))
    elif cfg.family == "encdec":
        specs, make = _encdec_batch(cfg)

        def init_caches(batch, max_seq, dtype=torch.bfloat16, window=0):
            caches = M.init_caches(cfg, batch, max_seq, dtype, dev)
            f = max(max_seq // 2, 8)
            shape = (cfg.num_layers, batch, f, cfg.num_kv_heads, cfg.hd)
            caches["cross"] = {
                "k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
            return caches

        def decode_fn(p, t1, c, pos):
            logits, new_c = M.decode_step(p, t1, {"self": c["self"]}, pos,
                                          cfg, cross=c["cross"])
            new_c["cross"] = c["cross"]
            return logits, new_c

    loss_fn = (lambda p, b: M.lm_loss(p, b, cfg))
    if cfg.family in MODEL_SPLIT_FAMILIES:
        loss_fn.model_split = decode_fn.model_split = True
    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=lambda generator=None: _params.init_params(cfg, generator, dev),
        loss_fn=loss_fn,
        batch_specs=specs,
        make_batch=lambda generator, batch, seq: make(generator, batch, seq,
                                                      dev),
        init_caches=init_caches,
        decode_fn=decode_fn,
    )
