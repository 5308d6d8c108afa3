"""Hand-written CUDA kernels of the port and their plain versions.

Kernels (``csrc/*.cu``, built for ``sm_90a`` at first use), each with its
raw wrapper here, its plain PyTorch version in ``ref`` and its padded
entry point in ``ops``:

  crossbar_permute_cuda / crossbar_permute_sparse_cuda — the dense and
      the tile-skipping crossbar (gather and scatter, weights, merge,
      GF(2) fold);
  plan_program_cuda — the plan-program megakernel VM;
  fused_vcompress_cuda — the whole vcompress in one launch;
  moe_route_cuda — the MoE routing transform.

``launch_counts()`` reads every wrapper's launch counter (a counter
moves only where its wrapper launches its CUDA kernel); the plain
versions run on CPU tensors and count nothing.
"""

from __future__ import annotations

from repro_torch.kernels import ops, ref
from repro_torch.kernels.crossbar_permute import (crossbar_permute_cuda,
                                                  crossbar_permute_sparse_cuda)
from repro_torch.kernels.fused_compress import fused_vcompress_cuda
from repro_torch.kernels.moe_route import moe_route_cuda
from repro_torch.kernels.plan_program_kernel import plan_program_cuda

__all__ = [
    "ops", "ref",
    "crossbar_permute_cuda", "crossbar_permute_sparse_cuda",
    "fused_vcompress_cuda", "moe_route_cuda", "plan_program_cuda",
    "launch_counts", "reset_launch_counts",
]


def _wrappers():
    from repro_torch.kernels import (crossbar_permute, fused_compress,
                                     moe_route, plan_program_kernel)
    return (crossbar_permute, plan_program_kernel, moe_route, fused_compress)


def launch_counts() -> dict:
    counts = {}
    for mod in _wrappers():
        with mod._LOCK:
            counts.update(mod.LAUNCHES)
    return counts


def reset_launch_counts() -> None:
    """Zero every launch counter, the megakernel's per-layout counts
    (``plan_program_kernel.LAYOUT_LAUNCHES``) included."""
    for mod in _wrappers():
        with mod._LOCK:
            for table in (mod.LAUNCHES, getattr(mod, "LAYOUT_LAUNCHES", {})):
                for key in table:
                    table[key] = 0
