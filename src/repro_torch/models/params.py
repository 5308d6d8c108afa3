"""Parameters of the port's models: seeded random, or carried across.

* ``init_params(cfg, generator=None, device=None)`` draws seeded random
  weights directly on the device (the card, unless the caller asks for
  the CPU) from a ``torch.Generator`` on that device (seed 0 if none is
  given).
* ``params_from_numpy(tree, cfg, device=None)`` turns a parameter tree of
  the JAX package's ``lm_init`` — numpy leaves, each layer's weights
  stacked on a leading L axis under every ``*blocks`` key (``blocks``;
  encdec's ``enc_blocks`` and ``dec_blocks``) — into the port's tree,
  where each of them is a list of per-layer dicts.  The tests carry the
  reference's weights across with it.
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
    """The module of ``cfg``'s model family; raises for families the port
    does not build yet."""
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
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet; the port builds the "
        "'dense', 'moe', 'vlm' and 'encdec' families (ROADMAP.md, Queue 1)")


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
    out = {}
    for key, sub in tree.items():
        if key.endswith("blocks"):
            n = len(np.asarray(leaves(sub)[0]))
            out[key] = [tree_map(lambda a, i=i: _to_tensor(a[i], dev), sub)
                        for i in range(n)]
        else:
            out[key] = tree_map(lambda a: _to_tensor(a, dev), sub)
    return out


def to_device(params, device):
    """The same parameters on ``device``."""
    dev = resolve(device)
    return tree_map(lambda t: t.to(dev), params)
