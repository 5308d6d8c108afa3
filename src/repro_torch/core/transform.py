"""Control-information transforms (paper Sec. III-B.1, Fig. 3).

Port of ``repro.core.transform``: input-driven control (mask bits,
slide offsets) becomes per-input output destinations that drive the
same crossbar as output-driven ``vrgather``.  Pure integer prefix sums,
branch-free and fixed-shape; out-of-range destinations drop.
"""

from __future__ import annotations

import torch

# Destination value meaning "routes nowhere" (matches no output).
DROP = -1


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive prefix sum along ``dim`` (low -> high indices)."""
    return torch.cumsum(x, dim=dim, dtype=x.dtype) - x


def exclusive_suffix_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive suffix sum: ``out[i] = sum(x[i+1:])``."""
    total = torch.sum(x, dim=dim, keepdim=True, dtype=x.dtype)
    return total - torch.cumsum(x, dim=dim, dtype=x.dtype)


def compress_destinations(mask: torch.Tensor) -> torch.Tensor:
    """Per-input destinations for ``vcompress`` — a bijection on [0, N).

    Selected elements go to ``i - zeros_below[i]`` (packed to the front,
    order kept), unselected ones to ``i + ones_above[i]`` (packed to the
    tail, order kept).
    """
    m = mask.to(torch.int32)
    n = m.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=m.device)
    ones_below = exclusive_cumsum(m, dim=-1)
    zeros_below = idx - ones_below
    ones_above = exclusive_suffix_sum(m, dim=-1)
    return torch.where(m == 1, idx - zeros_below,
                       idx + ones_above).to(torch.int32)


def compress_keep_count(mask: torch.Tensor) -> torch.Tensor:
    """Number of selected elements (the boundary of the packed prefix)."""
    return torch.sum(mask.to(torch.int32), dim=-1, dtype=torch.int32)


def slide_destinations(n: int, offset, *, up: bool,
                       device=None) -> torch.Tensor:
    """Per-input destinations for ``vslideup``/``vslidedown``.

    ``up``: dest = i + offset; down: dest = i - offset.  Destinations
    outside [0, n) slide out and drop.
    """
    if isinstance(offset, torch.Tensor):
        device = offset.device if device is None else device
        off = offset.to(device=device, dtype=torch.int32)
    else:
        off = int(offset)
    idx = torch.arange(n, dtype=torch.int32, device=device)
    out = idx + off if up else idx - off
    return out.to(torch.int32)


def gather_sources_from_destinations(dest: torch.Tensor, n_out: int):
    """Transpose per-input destinations into per-output sources.

    Returns ``(src, covered)``: ``src`` (n_out,) int32, DROP where no
    input routes; ``covered`` (n_out,) bool.  A fixed-shape one-hot
    contraction, as in the reference.
    """
    n_in = dest.shape[-1]
    out_iota = torch.arange(n_out, dtype=torch.int32, device=dest.device)
    onehot = (dest[None, :] == out_iota[:, None]).to(torch.int32)
    covered = torch.sum(onehot, dim=-1) > 0
    src = torch.sum(onehot * torch.arange(n_in, dtype=torch.int32,
                                          device=dest.device)[None, :],
                    dim=-1)
    return torch.where(covered, src, DROP).to(torch.int32), covered


def destinations_are_bijective(dest: torch.Tensor) -> torch.Tensor:
    """Scalar bool tensor: is the destination vector a permutation?"""
    n = dest.shape[-1]
    iota = torch.arange(n, dtype=dest.dtype, device=dest.device)
    onehot = (dest[..., None, :] == iota[:, None]).to(torch.int32)
    return torch.all(torch.sum(onehot, dim=-1) == 1)
