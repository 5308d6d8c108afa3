"""Parameters of the port's models: seeded random, or carried across.

* ``init_params(cfg, generator=None, device=None)`` draws seeded random
  weights directly on the device (the card, unless the caller asks for
  the CPU) from a ``torch.Generator`` on that device (seed 0 if none is
  given).
* ``params_from_numpy(tree, cfg, device=None)`` turns a parameter tree of
  the JAX package's ``lm_init`` (numpy leaves) into the port's tree.  The
  reference stacks layers on leading axes: (L, ...) under every
  ``*blocks`` key (``blocks``; encdec's ``enc_blocks`` and
  ``dec_blocks``) and the hybrid's ``lora``, (G, period, ...) under the
  hybrid's ``mamba``.  The port's tree holds a list of per-layer dicts
  for each stacked axis (``mamba``: G lists of ``period`` dicts).  The
  tests carry the reference's weights across with it.
* ``to_device(params, device)`` copies the port's tree to another device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch._tree import leaves, tree_map


def _to_tensor(a, device):
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def family_module(cfg):
    """The module of ``cfg``'s model family; raises ``ValueError`` for an
    unknown family."""
    if cfg.family == "dense":
        from repro_torch.models import transformer
        return transformer
    if cfg.family == "moe":
        from repro_torch.models import moe
        return moe
    if cfg.family == "vlm":
        from repro_torch.models import vlm
        return vlm
    if cfg.family == "encdec":
        from repro_torch.models import encdec
        return encdec
    if cfg.family == "rwkv":
        from repro_torch.models import rwkv
        return rwkv
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid
        return hybrid
    raise ValueError(f"unknown family {cfg.family!r}")


def init_params(cfg, generator=None, device=None):
    """Seeded random parameters of ``cfg``'s model on ``device``."""
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return family_module(cfg).lm_init(generator, cfg, dev)


def params_from_numpy(tree, cfg, device=None):
    """The port's parameters from a reference ``lm_init`` tree."""
    family_module(cfg)
    dev = resolve(device)
    return {key: _unstack(sub, _stacked_axes(key), dev)
            for key, sub in tree.items()}


def _stacked_axes(key):
    """How many leading layer axes the reference stacks under ``key``."""
    if key.endswith("blocks") or key == "lora":
        return 1
    return 2 if key == "mamba" else 0


def _unstack(sub, axes, dev):
    """``sub`` with ``axes`` leading stacked axes split into nested lists
    of per-layer trees."""
    if axes == 0:
        return tree_map(lambda a: _to_tensor(a, dev), sub)
    n = len(np.asarray(leaves(sub)[0]))
    return [_unstack(tree_map(lambda a, i=i: np.asarray(a)[i], sub),
                     axes - 1, dev) for i in range(n)]


def to_device(params, device):
    """The same parameters on ``device``."""
    dev = resolve(device)
    return tree_map(lambda t: t.to(dev), params)
