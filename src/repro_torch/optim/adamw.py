"""AdamW on parameter trees (no ``torch.optim``).

Port of ``repro.optim.adamw``: decoupled weight decay, bias-corrected
moments, global-norm clipping.  Moments are stored in float32 whatever
the parameters' dtype; the update keeps each parameter's dtype, and with
bf16 live parameters a float32 master copy rides in the state.

``adamw_update`` computes each leaf's new values with the reference's
expressions and writes them into the given parameter, moment and master
tensors (the reference's trainer donates its state buffers to the
jitted step): at billions of parameters a second copy of the state does
not fit beside the first.  One leaf's temporaries are live at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import _tree


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor       # () int32
    mu: Any                  # first moment (float32 tree)
    nu: Any                  # second moment (float32 tree)
    master: Any = None       # float32 master params when the live params
                             # are bf16


def adamw_init(params, *, keep_master: bool = False) -> AdamWState:
    zeros = _tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
    master = (_tree.tree_map(lambda p: p.detach().to(torch.float32).clone(),
                             params) if keep_master else None)
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      mu=zeros, nu=_tree.tree_map(torch.clone, zeros),
                      master=master)


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.detach().to(torch.float32)))
          for x in _tree.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to at most ``max_norm`` in float32, their norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return _tree.tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0):
    """One AdamW step, in place.  Returns (params, state,
    {"grad_norm": norm}): ``params`` and the moment and master trees of
    ``state`` are the given ones, updated.

    ``lr`` is a float (or a 0-d tensor); ``grads`` has ``params``'
    structure.
    """
    flat_p = _tree.leaves(params)
    flat_g = _tree.leaves(grads)
    gnorm = global_norm(flat_g)
    scale = _clip_scale(gnorm, max_grad_norm)
    step = state.step + 1
    dev = flat_p[0].device if flat_p else step.device
    stepf = step.to(device=dev, dtype=torch.float32)
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=dev) ** stepf
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=dev) ** stepf
    flat_m = _tree.leaves(state.mu)
    flat_v = _tree.leaves(state.nu)
    flat_ms = (_tree.leaves(state.master) if state.master is not None
               else [None] * len(flat_p))
    for p, master, g, m, v in zip(flat_p, flat_ms, flat_g, flat_m, flat_v):
        gf = g.to(torch.float32) * scale
        pf = p.to(torch.float32) if master is None else master
        new_m = b1 * m + (1 - b1) * gf
        new_v = b2 * v + (1 - b2) * gf * gf
        mhat = new_m / c1
        vhat = new_v / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * pf
        new_master = pf - lr * delta
        del gf, mhat, vhat, delta
        p.copy_(new_master)
        m.copy_(new_m)
        v.copy_(new_v)
        if master is not None:
            master.copy_(new_master)
        del new_m, new_v, new_master    # before the next leaf's temporaries
    new_state = AdamWState(step=step, mu=state.mu, nu=state.nu,
                           master=state.master)
    return params, new_state, {"grad_norm": gnorm}
