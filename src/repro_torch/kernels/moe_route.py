"""CUDA wrapper of the MoE routing transform (``csrc/moe_route.cu``).

Port of ``repro/kernels/moe_route.py`` (``moe_route_transform_pallas``).
This is the raw entry: it takes (G, T*K) int32 expert ids on a CUDA
device — one routing group per row — checks what the kernel takes,
allocates the outputs, launches on PyTorch's current stream and counts
the launch.  The wrapper with the CPU plain version is
``kernels.ops.moe_route_transform``.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import KernelLaunchError

# The kernel keeps (1 + 8 warps) * E int32 counts in shared memory, under
# the 48 KB a block gets without opting in.
MAX_EXPERTS = 1024

LAUNCHES = {"moe_route": 0}
_LOCK = threading.Lock()


def check_geometry(num_experts: int, capacity: int) -> None:
    """Raise ``ValueError`` for an expert count or capacity the kernel
    (and the int32 destinations) cannot take."""
    if not 1 <= num_experts <= MAX_EXPERTS:
        raise ValueError(
            f"moe_route supports 1 to {MAX_EXPERTS} experts, got "
            f"{num_experts}")
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    if num_experts * capacity >= 2**31:
        raise ValueError(
            f"E * C = {num_experts * capacity} does not fit int32 "
            "destinations")


def moe_route_cuda(ids, *, num_experts: int, capacity: int):
    """Launch the routing kernel: ids (G, T*K) int32, rows t-major.

    Returns (pos, dest), each (G, T*K) int32.
    """
    if not ids.is_cuda:
        raise ValueError(f"moe_route kernel needs CUDA ids, got {ids.device}")
    if ids.dtype != torch.int32 or ids.dim() != 2 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous (G, T*K) int32 tensor")
    check_geometry(num_experts, capacity)
    groups, tk = ids.shape
    pos = torch.empty_like(ids)
    dest = torch.empty_like(ids)
    if groups == 0 or tk == 0:
        return pos, dest
    err = _build.library().moe_route(
        ids.data_ptr(), pos.data_ptr(), dest.data_ptr(), groups, tk,
        num_experts, capacity, _build.stream_handle(ids.device))
    with _LOCK:
        LAUNCHES["moe_route"] += 1
    if err != 0:
        raise KernelLaunchError(f"moe_route launch failed: cudaError {err}")
    return pos, dest
