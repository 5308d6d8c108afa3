"""The MoE routing kernel's launch geometry and its decomposition.

``moe_route.launch_geometry`` picks the warp form for groups of at most
32 ids and the cluster form above, within the kernel's limits (shared
memory, cluster size, grid).  ``ref.moe_route_tiled`` ranks ids the way
the kernel does on a geometry (segments; slices, chunks, warps and
rounds, with the chunk carry and the cluster exchange) and is held,
bit-exact, against the plain transform and against the Pallas TPU
kernel in interpret mode, on seeded ids in [-1, E + 2) with capacity 0,
1 and large.  ``tests/test_torch_cuda.py`` runs the same cases through
the CUDA kernel on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import moe_route as mrk
from repro_torch.kernels import ref as tref
from test_torch_support import (assert_bitexact, jax_ref,  # noqa: F401
                                reset_torch_state)  # noqa: F401

# (groups, tokens, k, experts, cluster, threads, id range): cluster and
# threads None take the default geometry
ROUTE_CASES = [
    (1, 1, 1, 16, None, None, "mixed"),          # warp form, one id
    (5, 16, 2, 16, None, None, "mixed"),         # warp form, 32 ids
    (300, 1, 2, 16, None, None, "mixed"),        # 16 groups a warp
    (8, 1, 2, 16, None, None, "mixed"),          # the decode step
    (2, 17, 2, 5, None, None, "mixed"),          # 34 ids: one CTA
    (2, 2048, 2, 16, None, None, "mixed"),       # the prompt forward
    (1, 2048, 2, 1024, None, None, "mixed"),     # E = 1024: 8 warps
    (2, 600, 2, 1, None, None, "mixed"),         # E = 1
    (2, 300, 2, 16, None, None, "dropped"),      # every id out of range
    (3, 500, 2, 7, 2, 32, "mixed"),              # 2 chunks a CTA
    (2, 777, 1, 5, 3, 64, "mixed"),              # cluster of 3
    (1, 4097, 1, 16, 16, None, "mixed"),         # non-portable cluster
    (1, 40, 3, 4, 16, 32, "mixed"),              # the last CTA is empty
    (1, 20, 2, 3, None, 32, "mixed"),            # cluster form at 40 ids
]


def route_ids(case, seed):
    g, t, k, e = case[:4]
    rng = np.random.default_rng(seed)
    if case[6] == "dropped":
        return np.full((g, t * k), -1, np.int32)
    return rng.integers(-1, e + 2, (g, t * k)).astype(np.int32)


def route_capacities(case):
    g, t, k = case[:3]
    return (0, 1, t * k)


@pytest.mark.parametrize("groups", [1, 2, 8, 300])
@pytest.mark.parametrize("experts", [1, 16, 1024])
@pytest.mark.parametrize("tk", [1, 32, 33, 4096, 4097, 65536])
def test_launch_geometry_edges(tk, experts, groups):
    geo = mrk.launch_geometry(groups, tk, experts)
    if tk <= 32:
        assert geo["form"] == "warp"
        seg = 1 << geo["seg_log2"]
        assert tk <= seg < 2 * tk or seg == tk == 1
        per_cta = geo["threads"] // 32 * (32 // seg)
        assert geo["threads"] % 32 == 0
        assert geo["threads"] <= 32 * mrk.WARP_FORM_WARPS
        assert (geo["grid"] - 1) * per_cta < groups <= geo["grid"] * per_cta
        return
    assert geo["form"] == "cluster"
    c, sl, th = geo["cluster"], geo["slice"], geo["threads"]
    assert 1 <= c <= mrk.MAX_CLUSTER and geo["grid"] == groups * c
    assert (c - 1) * sl < tk <= c * sl                 # no empty CTA
    assert th & (th - 1) == 0 and 32 <= th <= 1024
    assert geo["smem"] == mrk.smem_bytes(th, experts) <= mrk.SMEM_BYTES
    assert geo["per_thread"] in (1, 2, 4, 8)
    rounds = geo["chunks"] * geo["per_thread"]
    assert geo["chunks"] * th * geo["per_thread"] >= sl
    # a thread's rounds grow with tk / (cluster * threads), not tk / 256
    assert rounds <= 2 * -(-sl // th)
    assert c == min(mrk.MAX_CLUSTER, -(-tk // mrk.IDS_PER_CTA),
                    1 + mrk.EXCHANGE_READS // experts)
    assert experts * (c - 1) <= mrk.EXCHANGE_READS


def test_launch_geometry_refuses_what_the_kernel_cannot_take():
    for kw in (dict(cluster=0), dict(cluster=17), dict(threads=48),
               dict(threads=2048), dict(threads=16)):
        with pytest.raises(ValueError):
            mrk.launch_geometry(2, 4096, 16, **kw)
    with pytest.raises(ValueError, match="threads"):      # 64 KB table
        mrk.launch_geometry(2, 4096, 1024, threads=512)
    for g, tk in ((0, 8), (1, 0), (1, mrk.MAX_TK + 1)):
        with pytest.raises(ValueError):
            mrk.launch_geometry(g, tk, 16)
    assert mrk.table_warps(1024) == 8 and mrk.table_warps(16) == 32


def test_overrides_force_the_cluster_form():
    geo = mrk.launch_geometry(3, 8, 4, threads=32)
    assert geo["form"] == "cluster" and geo["cluster"] == 1
    geo = mrk.launch_geometry(3, 500, 7, cluster=2, threads=32)
    assert (geo["slice"], geo["per_thread"], geo["chunks"]) == (250, 8, 1)
    geo = mrk.launch_geometry(3, 1000, 7, cluster=2, threads=32)
    assert (geo["slice"], geo["per_thread"], geo["chunks"]) == (500, 8, 2)


@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_tiled_matches_plain_version(case):
    g, t, k, e, cluster, threads, _ = case
    ids = torch.as_tensor(route_ids(case, seed=g + t + e))
    geo = mrk.launch_geometry(g, t * k, e, cluster=cluster, threads=threads)
    for cap in route_capacities(case):
        got = tref.moe_route_tiled(ids, geo, num_experts=e, capacity=cap)
        want = tref.moe_route_transform(ids, num_experts=e, capacity=cap)
        for a, b in zip(got, want):
            assert a.dtype == torch.int32
            assert_bitexact(a, b)


@pytest.mark.parametrize("case", [c for c in ROUTE_CASES if c[0] * c[1] <=
                                  4096],
                         ids=lambda c: "-".join(map(str, c)))
def test_tiled_matches_tpu_kernel(jax_ref, case):
    """Each capacity on the first two groups, through the Pallas kernel
    in interpret mode (T padded with -1 rows to its 64-token tiles)."""
    import jax.numpy as jnp
    from repro.kernels.moe_route import moe_route_transform_pallas
    g, t, k, e, cluster, threads, _ = case
    ids = route_ids(case, seed=g + t + e)
    geo = mrk.launch_geometry(g, t * k, e, cluster=cluster, threads=threads)
    t_pad = -(-t // 64) * 64
    for cap in route_capacities(case):
        pos, dest = tref.moe_route_tiled(torch.as_tensor(ids), geo,
                                         num_experts=e, capacity=cap)
        for gi in range(min(g, 2)):
            rows = np.full((t_pad, k), -1, np.int32)
            rows[:t] = ids[gi].reshape(t, k)
            jpos, jdest = moe_route_transform_pallas(
                jnp.asarray(rows), num_experts=e, capacity=cap, block_t=64,
                interpret=True)
            assert_bitexact(pos[gi].reshape(t, k), np.asarray(jpos)[:t])
            assert_bitexact(dest[gi].reshape(t, k), np.asarray(jdest)[:t])
