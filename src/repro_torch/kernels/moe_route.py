"""CUDA wrapper of the MoE routing transform (``csrc/moe_route.cu``).

Port of ``repro/kernels/moe_route.py`` (``moe_route_transform_pallas``).
This is the raw entry: it takes (G, T*K) int32 expert ids on a CUDA
device — one routing group per row — checks what the kernel takes,
allocates the outputs, picks the launch geometry (``launch_geometry``),
launches the one kernel on PyTorch's current stream and counts the
launch.  The wrapper with the CPU plain version is
``kernels.ops.moe_route_transform``; ``ref.moe_route_tiled`` emulates
the kernel's decomposition on a geometry.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import KernelLaunchError

# The cluster form keeps a (warps, E | 1) count table and three (E,)
# arrays in shared memory, within the 48 KB a block gets without opting
# in: 32 warps a CTA up to E = 351, 8 at E = 1024.
MAX_EXPERTS = 1024
SMEM_BYTES = 48 * 1024

# Launch geometry (csrc/moe_route.cu).  Groups of at most WARP_FORM_MAX
# ids take the warp form, WARP_FORM_WARPS warps a CTA; longer groups the
# cluster form: a cluster of up to MAX_CLUSTER CTAs (16 is above the
# portable 8: H100 SXM schedules it), at least IDS_PER_CTA ids a CTA
# before the cluster grows, and at most EXCHANGE_READS totals read from
# the cluster's other CTAs (E x (cluster - 1)) a CTA; about ROUNDS ids a
# thread (PER_THREAD at most in a chunk).  Chosen on the H100 (PERF.md,
# PR 15): at E = 16 the cluster of 16 was fastest, at E = 1024 that of 8.
WARP_FORM_MAX = 32
WARP_FORM_WARPS = 8
MAX_CLUSTER = 16
IDS_PER_CTA = 256
EXCHANGE_READS = 7 * 1024
ROUNDS = 2
PER_THREAD = 8
MAX_TK = 2**30

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


def _next_pow2(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(threads: int, num_experts: int) -> int:
    """Shared memory of a cluster-form CTA of ``threads`` threads."""
    return 4 * (threads // 32 * (num_experts | 1) + 3 * num_experts)


def table_warps(num_experts: int) -> int:
    """The most warps (a power of two, at most 32) whose count table fits
    ``SMEM_BYTES`` at ``num_experts`` experts."""
    w = 32
    while w > 1 and smem_bytes(32 * w, num_experts) > SMEM_BYTES:
        w //= 2
    return w


def launch_geometry(groups: int, tk: int, num_experts: int, *,
                    cluster: int | None = None,
                    threads: int | None = None) -> dict:
    """The kernel's launch geometry for ``groups`` groups of ``tk`` ids.

    ``form="warp"`` (tk <= 32): 2**seg_log2 lanes a group, ``threads`` a
    CTA, ``grid`` CTAs.  ``form="cluster"``: each group over ``cluster``
    CTAs (grid = groups * cluster) of ``threads`` threads, ``slice``
    consecutive ids a CTA taken in ``chunks`` chunks of threads *
    per_thread.  ``cluster`` and ``threads`` override the defaults (and
    force the cluster form), for timing alternatives; a value the kernel
    cannot take raises ``ValueError``.
    """
    if groups < 1 or not 1 <= tk <= MAX_TK:
        raise ValueError(f"moe_route takes 1 to {MAX_TK} ids a group and "
                         f"at least one group, got ({groups}, {tk})")
    if cluster is None and threads is None and tk <= WARP_FORM_MAX:
        seg = _next_pow2(tk)
        per_warp = 32 // seg
        warps = min(WARP_FORM_WARPS, _cdiv(groups, per_warp))
        return dict(form="warp", grid=_cdiv(groups, per_warp * warps),
                    threads=32 * warps, seg_log2=seg.bit_length() - 1,
                    per_thread=1, cluster=1, slice=tk, chunks=1, smem=0)
    w_max = table_warps(num_experts)
    if cluster is None:
        cluster = min(MAX_CLUSTER, 1 + EXCHANGE_READS // num_experts,
                      _cdiv(tk, IDS_PER_CTA))
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"cluster must be 1 to {MAX_CLUSTER}, got {cluster}")
    slice_ = _cdiv(tk, cluster)
    if threads is None:
        threads = min(32 * w_max, max(32, _next_pow2(_cdiv(slice_, ROUNDS))))
    if (threads < 32 or threads > 32 * w_max
            or threads & (threads - 1)):
        raise ValueError(f"threads must be a power of two from 32 to "
                         f"{32 * w_max} at E={num_experts}, got {threads}")
    per_thread = min(PER_THREAD, _next_pow2(_cdiv(slice_, threads)))
    if groups * cluster >= 2**31:
        raise ValueError(f"{groups} groups x {cluster} CTAs exceed the grid")
    return dict(form="cluster", grid=groups * cluster, threads=threads,
                seg_log2=0, per_thread=per_thread, cluster=cluster,
                slice=slice_, chunks=_cdiv(slice_, threads * per_thread),
                smem=smem_bytes(threads, num_experts))


def moe_route_cuda(ids, *, num_experts: int, capacity: int,
                   cluster: int | None = None, threads: int | None = None):
    """Launch the routing kernel: ids (G, T*K) int32, rows t-major.

    Returns (pos, dest), each (G, T*K) int32.  One device kernel a call.
    ``cluster`` and ``threads`` override ``launch_geometry``'s defaults
    (for timing alternatives).
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
    geo = launch_geometry(groups, tk, num_experts, cluster=cluster,
                          threads=threads)
    err = _build.library().moe_route(
        ids.data_ptr(), pos.data_ptr(), dest.data_ptr(), groups, tk,
        num_experts, capacity, int(geo["form"] == "cluster"), geo["grid"],
        geo["threads"], geo["seg_log2"], geo["per_thread"], geo["cluster"],
        geo["slice"], geo["chunks"], _build.stream_handle(ids.device))
    with _LOCK:
        LAUNCHES["moe_route"] += 1
    if err != 0:
        raise KernelLaunchError(f"moe_route launch failed: cudaError {err}")
    return pos, dest


def floor_launch(geometry: dict, device) -> None:
    """Launch an empty kernel with ``geometry``'s grid, block and cluster
    size (not counted): the floor a routing call's device time sits on."""
    err = _build.library().moe_route_floor(
        geometry["grid"], geometry["threads"], geometry["cluster"],
        _build.stream_handle(device))
    if err != 0:
        raise KernelLaunchError(f"empty launch failed: cudaError {err}")
