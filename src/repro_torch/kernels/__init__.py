"""Hand-written CUDA kernels of the port and their plain versions.

``launch_counts()`` reads every wrapper's launch counter (a counter
moves only where its wrapper launches its CUDA kernel); the plain
versions run on CPU tensors and count nothing.
"""

from __future__ import annotations


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
