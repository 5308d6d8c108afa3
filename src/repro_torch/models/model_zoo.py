"""Model zoo: one API over the model families the port builds.

Port of ``repro.models.model_zoo`` for the ``dense`` and ``moe``
families.  ``build(cfg)`` returns a ``ModelAPI``:

    init(generator=None)                     -> params (on the device)
    loss_fn(params, batch)                   -> (loss, metrics)
    batch_specs(batch, seq)                  -> {name: (shape, dtype)}
    make_batch(generator, batch, seq)        -> the same tree, real tensors
    init_caches(batch, max_seq, dtype)       -> decode caches
    decode_fn(params, tokens1, caches, pos)  -> (logits, caches)

``make_batch`` draws uniform token ids from ``generator`` (a
``torch.Generator`` on the API's device).  The other families raise
``NotImplementedError`` (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch._device import resolve
from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as _params


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


def build(cfg: ModelConfig, device=None) -> ModelAPI:
    """The model API of ``cfg`` on ``device`` (the card by default)."""
    M = _params.family_module(cfg)
    dev = resolve(device)
    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=lambda generator=None: _params.init_params(cfg, generator, dev),
        loss_fn=lambda p, b: M.lm_loss(p, b, cfg),
        batch_specs=lambda batch, seq: _token_specs(cfg, batch, seq),
        make_batch=lambda generator, batch, seq: _token_batch(
            cfg, generator, batch, seq, dev),
        init_caches=lambda batch, max_seq, dtype=torch.bfloat16:
            M.init_caches(cfg, batch, max_seq, dtype, dev),
        decode_fn=lambda p, t1, c, pos: M.decode_step(p, t1, c, pos, cfg),
    )
