"""CUDA wrapper of the fused vcompress (``csrc/fused_compress.cu``).

Port of ``repro/kernels/fused_compress.py`` (``fused_vcompress_pallas``).
This is the raw entry: a (N,) mask and an (N, D) payload on a CUDA
device; it checks what the kernel takes, allocates the output and the
destination scratch, launches on PyTorch's current stream and counts
the launch.  The wrapper that also takes CPU tensors (the plain
version) is ``kernels.ops.fused_vcompress``.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import KernelLaunchError

TAILS = ("zero", "bijective")
_MAX_INT32 = 2**31 - 1

LAUNCHES = {"fused_vcompress": 0}
_LOCK = threading.Lock()


def check_tail(tail: str) -> None:
    if tail not in TAILS:
        raise ValueError(f"tail must be one of {TAILS}, got {tail!r}")


def fused_vcompress_cuda(mask, x, *, tail: str = "zero"):
    """Launch the fused vcompress: selected rows of x packed to the top in
    order, the rest after them (``bijective``) or zeroed (``zero``).

    mask: (N,) bool or integer, non-zero selects; x: (N, D) contiguous,
    any dtype (rows are moved as bits, so the move is exact).  Returns
    (N, D) in x's dtype.
    """
    check_tail(tail)
    if not x.is_cuda:
        raise ValueError(f"fused_vcompress kernel needs a CUDA payload, got "
                         f"{x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("payload must be a contiguous (N, D) tensor")
    n, d = x.shape
    if mask.device != x.device or tuple(mask.shape) != (n,):
        raise ValueError(f"mask must be ({n},) on the payload's device")
    row_bytes = d * x.element_size()
    if n > _MAX_INT32 or row_bytes > _MAX_INT32:
        raise ValueError(f"({n}, {d}) payload exceeds the kernel's int32 "
                         "row count or row size")
    m8 = (mask != 0).to(torch.uint8).contiguous()
    out = torch.empty_like(x)
    dest = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    err = _build.library().fused_vcompress(
        m8.data_ptr(), x.data_ptr(), out.data_ptr(), dest.data_ptr(), n,
        row_bytes, int(tail == "zero"), _build.stream_handle(x.device))
    with _LOCK:
        LAUNCHES["fused_vcompress"] += 1
    if err != 0:
        raise KernelLaunchError(f"fused_vcompress launch failed: cudaError "
                                f"{err}")
    return out
