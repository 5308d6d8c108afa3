"""Slide-based sequence operations for model layers.

Port of ``repro.core.sequence``: token shifting (``vslide1up`` lifted
over batch and feature axes — a pad-shift, outside the crossbar, as the
paper's Sec. IV advises for single-position slides) and the causal
sliding-window mask of SWA attention, and ``ring_halo``, the
context-parallel halo exchange as a ring step over a mesh's shards.
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


def ring_halo(shards, *, shift: int = 1) -> list:
    """Context-parallel halo exchange: each shard's edge to its
    ``shift``-th successor on the ring.

    ``shards`` holds one tensor a shard (the edges to send), in mesh
    order; shard ``(i + shift) % n`` receives shard ``i``'s, copied to
    the device of the tensor it replaces.  The reference's ``ppermute``
    ring step inside ``shard_map``, over the shard list one controller
    holds.  Stitches sliding-window attention across sequence shards.
    """
    n = len(shards)
    out = [None] * n
    for i, x in enumerate(shards):
        j = (i + shift) % n
        out[j] = torch.empty_like(x, device=shards[j].device).copy_(x)
    return out


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
