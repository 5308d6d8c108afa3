"""Model zoo: one API over the model families the port builds.

Port of ``repro.models.model_zoo`` for the serving side of family
``moe``.  ``build(cfg)`` returns a ``ModelAPI``:

    init(generator=None)                     -> params (on the device)
    init_caches(batch, max_seq, dtype)       -> decode caches
    decode_fn(params, tokens1, caches, pos)  -> (logits, caches)

The reference's training members (``loss_fn``, ``batch_specs``,
``make_batch``) and every other family are not ported yet: ``build``
raises ``NotImplementedError`` for them (ROADMAP.md, Queue 1 item 16).
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
    init_caches: Callable
    decode_fn: Callable


def build(cfg: ModelConfig, device=None) -> ModelAPI:
    """The model API of ``cfg`` on ``device`` (the card by default)."""
    M = _params.family_module(cfg)
    dev = resolve(device)
    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=lambda generator=None: _params.init_params(cfg, generator, dev),
        init_caches=lambda batch, max_seq, dtype=torch.bfloat16:
            M.init_caches(cfg, batch, max_seq, dtype, dev),
        decode_fn=lambda p, t1, c, pos: M.decode_step(p, t1, c, pos, cfg),
    )
