"""Slide-based sequence operations for model layers.

Port of ``repro.core.sequence``: token shifting (``vslide1up`` lifted
over batch and feature axes — a pad-shift, outside the crossbar, as the
paper's Sec. IV advises for single-position slides) and the causal
sliding-window mask of SWA attention.  ``ring_halo`` (the context-
parallel halo exchange) comes with ``dist/``.
"""

from __future__ import annotations

import torch


def shift_right(x: torch.Tensor, *, dim: int = -2, fill=0) -> torch.Tensor:
    """Shift the sequence axis one step toward the future:
    ``y[t] = x[t-1]``, ``y[0] = fill``."""
    n = x.shape[dim]
    out = torch.full_like(x, fill)
    if n > 1:
        out.narrow(dim, 1, n - 1).copy_(x.narrow(dim, 0, n - 1))
    return out


def token_shift(x: torch.Tensor, *, dim: int = -2) -> torch.Tensor:
    """``shift_right`` with a zero fill (RWKV token shift, Mamba conv
    edges)."""
    return shift_right(x, dim=dim)


def sliding_window_mask(q_len: int, kv_len: int, window: int, *,
                        q_offset: int = 0, device=None) -> torch.Tensor:
    """Boolean (q_len, kv_len) mask: causal AND within ``window``
    lookback.  ``q_offset`` places the query block inside the sequence
    (chunked prefill); ``window <= 0`` means plain causal."""
    q_pos = torch.arange(q_len, dtype=torch.int32,
                         device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, dtype=torch.int32, device=device)[None, :]
    mask = k_pos <= q_pos
    if window > 0:
        mask &= k_pos > (q_pos - window)
    return mask
