"""MoE routing and dispatch of the port against the JAX reference.

The same numpy inputs, made from a seed, go through ``repro`` and
``repro_torch`` on the CPU.  Exactness: routing ids, positions and
destinations, the moe_route transform and dispatch are bit-exact; gates
agree to ``rtol=1e-6``; combine (a weighted sum) to ``rtol=1e-5,
atol=1e-6`` in float32 and ``rtol=1e-2`` in bf16 (the gates round to
bf16 against a bf16 payload in the kernels and the reference's einsum,
not in the index oracle).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import crossbar as txb
from repro_torch.core import moe_dispatch as tmd
from repro_torch.core import telemetry
from repro_torch.kernels import launch_counts
from repro_torch.kernels import ops as tops
from repro_torch.kernels.moe_route import MAX_EXPERTS
from test_torch_support import (BF16_TOL, F32_TOL, assert_bitexact,
                                assert_close, jax_ref,  # noqa: F401
                                reset_torch_state, to_numpy)  # noqa: F401

BACKENDS = ("einsum", "kernel", "sparse", "reference")


def _ids(rng, t, k, lo, hi):
    return rng.integers(lo, hi, (t, k)).astype(np.int32)


@pytest.mark.parametrize("t,k,e,cap", [
    (256, 2, 8, 16),       # one Pallas tile, overflow
    (300, 2, 16, 8),       # T not a multiple of 256, heavy overflow
    (513, 1, 4, 1000),     # carry across tiles, no overflow
    (100, 4, 4, 0),        # capacity 0: everything drops
])
def test_moe_route_transform_matches_pallas_and_ref(jax_ref, t, k, e, cap):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    rng = np.random.default_rng(t + k + e)
    ids = _ids(rng, t, k, -1, e + 2)          # -1 padding and ids >= E
    pos, dest = tops.moe_route_transform(torch.as_tensor(ids),
                                         num_experts=e, capacity=cap)
    jpos, jdest = jops.moe_route_transform(jnp.asarray(ids), num_experts=e,
                                           capacity=cap, interpret=True)
    rpos, rdest = jref.moe_route_transform_ref(jnp.asarray(ids),
                                               num_experts=e, capacity=cap)
    for got, want in ((pos, jpos), (dest, jdest), (pos, rpos),
                      (dest, rdest)):
        assert_bitexact(got, want)
    assert pos.dtype == dest.dtype == torch.int32
    assert launch_counts()["moe_route"] == 0      # CPU: plain version


def test_moe_route_transform_pallas_raw_kernel(jax_ref):
    import jax.numpy as jnp
    from repro.kernels.moe_route import moe_route_transform_pallas
    rng = np.random.default_rng(1)
    ids = _ids(rng, 512, 2, -1, 17)
    jpos, jdest = moe_route_transform_pallas(
        jnp.asarray(ids), num_experts=16, capacity=40, block_t=256,
        interpret=True)
    pos, dest = tops.moe_route_transform(torch.as_tensor(ids),
                                         num_experts=16, capacity=40)
    assert_bitexact(pos, jpos)
    assert_bitexact(dest, jdest)


def test_moe_route_transform_groups_rank_independently():
    rng = np.random.default_rng(2)
    ids = torch.as_tensor(rng.integers(-1, 9, (3, 50, 2)).astype(np.int32))
    pos, dest = tops.moe_route_transform(ids, num_experts=8, capacity=7)
    assert pos.shape == dest.shape == (3, 50, 2)
    for g in range(3):
        pg, dg = tops.moe_route_transform(ids[g], num_experts=8, capacity=7)
        assert_bitexact(pos[g], pg)
        assert_bitexact(dest[g], dg)


def test_moe_route_transform_is_compute_positions_for_in_range_ids():
    rng = np.random.default_rng(3)
    ids = torch.as_tensor(rng.integers(0, 6, (2, 90, 2)).astype(np.int32))
    pos, dest = tops.moe_route_transform(ids, num_experts=6, capacity=20)
    want = tmd.compute_positions(ids, 6)
    assert_bitexact(pos, want)
    assert_bitexact(dest, torch.where(want < 20, ids * 20 + want, -1))


def test_moe_route_transform_refuses_bad_geometry():
    ids = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="experts"):
        tops.moe_route_transform(ids, num_experts=MAX_EXPERTS + 1,
                                 capacity=4)
    with pytest.raises(ValueError, match="capacity"):
        tops.moe_route_transform(ids, num_experts=4, capacity=-1)
    with pytest.raises(ValueError, match="integers"):
        tops.moe_route_transform(ids.float(), num_experts=4, capacity=4)
    with pytest.raises(ValueError, match="int32"):
        tops.moe_route_transform(ids, num_experts=1024, capacity=2**21)


def _logits(rng, shape, ties):
    if ties:   # few distinct bf16 values: ties among experts everywhere
        return rng.integers(-3, 4, shape).astype(np.float32) * 0.25
    x = rng.standard_normal(shape).astype(np.float32)
    return np.asarray(torch.as_tensor(x).to(torch.bfloat16).float())


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("renormalize", [True, False])
def test_make_routing_matches_reference(jax_ref, ties, renormalize):
    import jax.numpy as jnp
    from repro.core import moe_dispatch as jmd
    rng = np.random.default_rng(4)
    logits = _logits(rng, (64, 16), ties)
    want = jmd.make_routing(jnp.asarray(logits), num_experts=16, k=2,
                            capacity=9, renormalize=renormalize)
    got = tmd.make_routing(torch.as_tensor(logits), num_experts=16, k=2,
                           capacity=9, renormalize=renormalize)
    for name in ("expert_ids", "positions", "dest"):
        assert_bitexact(getattr(got, name), getattr(want, name))
    assert_close(got.gates, want.gates, dict(rtol=1e-6, atol=0))
    assert_close(got.probs, want.probs, dict(rtol=1e-6, atol=0))
    if ties:
        top = np.sort(logits, axis=1)[:, ::-1]
        assert (top[:, 1] == top[:, 2]).sum() > 10   # ties at the k border


def test_top_k_orders_ties_to_the_lower_index():
    v = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]])
    vals, ids = tmd.top_k(v, 3)
    assert ids.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0] * 3]


def test_batched_routing_equals_per_group(jax_ref):
    import jax
    import jax.numpy as jnp
    from repro.core import moe_dispatch as jmd
    rng = np.random.default_rng(5)
    logits = _logits(rng, (3, 40, 8), ties=True)
    got = tmd.make_routing(torch.as_tensor(logits), num_experts=8, k=2,
                           capacity=12)
    want = jax.vmap(lambda lg: jmd.make_routing(
        lg, num_experts=8, k=2, capacity=12))(jnp.asarray(logits))
    for name in ("expert_ids", "positions", "dest"):
        assert_bitexact(getattr(got, name), getattr(want, name))
    assert_close(got.gates, want.gates, dict(rtol=1e-6, atol=0))
    assert_close(tmd.load_balance_loss(got),
                 jax.vmap(jmd.load_balance_loss)(want), F32_TOL)
    assert_close(tmd.dropped_fraction(got),
                 jax.vmap(jmd.dropped_fraction)(want), F32_TOL)
    assert_close(tmd.router_z_loss(torch.as_tensor(logits)),
                 jmd.router_z_loss(jnp.asarray(logits)), F32_TOL)


def _routed(rng, t, e, cap, k=2, groups=None):
    shape = (t, e) if groups is None else (groups, t, e)
    logits = _logits(rng, shape, ties=False)
    return logits, tmd.make_routing(torch.as_tensor(logits), num_experts=e,
                                    k=k, capacity=cap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_and_combine_match_reference(jax_ref, dtype):
    import jax.numpy as jnp
    from repro.core import moe_dispatch as jmd
    rng = np.random.default_rng(6)
    t, e, cap, d = 96, 8, 20, 48
    logits, routing = _routed(rng, t, e, cap)
    jrouting = jmd.make_routing(jnp.asarray(logits), num_experts=e, k=2,
                                capacity=cap)
    x32 = rng.standard_normal((t, d)).astype(np.float32)
    y32 = rng.standard_normal((e, cap, d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    x, y = torch.as_tensor(x32).to(tdt), torch.as_tensor(y32).to(tdt)
    jx, jy = jnp.asarray(to_numpy(x)), jnp.asarray(to_numpy(y))
    if dtype == "bfloat16":
        jx, jy = jx.astype(jnp.bfloat16), jy.astype(jnp.bfloat16)
    want_buf = jmd.dispatch(jx, jrouting)
    want_out = jmd.combine(jy, jrouting)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for backend in BACKENDS:
        buf = tmd.dispatch(x, routing, backend=backend)
        assert buf.shape == (e, cap, d) and buf.dtype == tdt
        assert_bitexact(buf, want_buf)
        assert_close(tmd.combine(y, routing, backend=backend), want_out, tol)


def test_sparse_dispatch_pins_unfilled_capacity_slots(jax_ref):
    """Most of the E*C slots stay empty: whole 128-row output tiles are
    never visited by the tile-skipping kernel, and must read as zero."""
    import jax.numpy as jnp
    from repro.core import moe_dispatch as jmd
    rng = np.random.default_rng(7)
    t, e, cap, d = 48, 4, 512, 16
    logits, routing = _routed(rng, t, e, cap)
    plan = tmd.dispatch_plan(routing)
    occ = txb.compile_plan(plan).occupancy
    assert not bool(occ.any(dim=1).all())          # unvisited output tiles
    x = torch.as_tensor(rng.standard_normal((t, d)).astype(np.float32))
    buf = tmd.dispatch(x, routing, backend="sparse")
    assert_bitexact(buf, tmd.dispatch(x, routing, backend="reference"))
    jrouting = jmd.make_routing(jnp.asarray(logits), num_experts=e, k=2,
                                capacity=cap)
    assert_bitexact(buf, jmd.dispatch(jnp.asarray(x.numpy()), jrouting))
    filled = torch.zeros(e * cap, dtype=torch.bool)
    filled[routing.dest[routing.dest >= 0].long()] = True
    assert not bool(buf.reshape(e * cap, d)[~filled].any())


@pytest.mark.parametrize("backend", ["einsum", "kernel", "sparse"])
def test_batched_dispatch_is_one_pass_each_way(backend):
    rng = np.random.default_rng(8)
    g, t, e, cap, d = 3, 40, 8, 10, 24
    _, routing = _routed(rng, t, e, cap, groups=g)
    x = torch.as_tensor(rng.standard_normal((g, t, d)).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal((g, e, cap, d)).astype(
        np.float32))
    with telemetry.delta() as delta:
        buf = tmd.dispatch(x, routing, backend=backend)
        out = tmd.combine(y, routing, backend=backend)
    assert delta()["apply_calls"] == 2
    assert buf.shape == (g, e, cap, d) and out.shape == (g, t, d)
    for i in range(g):
        one = tmd.Routing(*(getattr(routing, f)[i] for f in (
            "expert_ids", "gates", "positions", "dest", "probs")), e, cap)
        assert_bitexact(buf[i], tmd.dispatch(x[i], one, backend=backend))
        assert_close(out[i], tmd.combine(y[i], one, backend=backend))


def test_dense_reference_matches_crossbar_path():
    rng = np.random.default_rng(9)
    t, e, cap, d = 64, 4, 24, 16
    _, routing = _routed(rng, t, e, cap)
    x = torch.as_tensor(rng.standard_normal((t, d)).astype(np.float32))
    scale = torch.as_tensor(rng.standard_normal((e, 1, d)).astype(
        np.float32))

    def expert_fn(buf):
        return torch.tanh(buf) * scale

    want = tmd.dense_reference(x, routing, expert_fn)
    for backend in BACKENDS:
        got = tmd.combine(expert_fn(tmd.dispatch(x, routing,
                                                 backend=backend)),
                          routing, backend=backend)
        assert_close(got, want, F32_TOL)


def test_apply_plan_leaves_the_tf32_flag_as_it_found_it():
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    plan = txb.gather_plan(torch.tensor([[1, 0], [0, 1]], dtype=torch.int32),
                           2, weights=torch.full((2, 2), 0.5))
    try:
        for setting in (True, False):
            flags.allow_tf32 = setting
            out = txb.apply_plan(plan, torch.ones(2, 3), backend="einsum")
            assert flags.allow_tf32 is setting
            assert out.tolist() == [[1.0] * 3] * 2
    finally:
        flags.allow_tf32 = saved


def test_model_products_turn_tf32_off_for_the_call_only(monkeypatch):
    """The model's float32 products run with TF32 off even when the
    process allows it, and leave the process-wide flag as they found it."""
    from repro_torch.models import layers as tL
    flags = torch.backends.cuda.matmul
    seen = []
    real = torch.einsum

    def spy(*args):
        seen.append(flags.allow_tf32)
        return real(*args)

    monkeypatch.setattr(torch, "einsum", spy)
    saved = flags.allow_tf32
    try:
        flags.allow_tf32 = True
        x = torch.ones(2, 3)
        assert tL.einsum_f32("ij,kj->ik", x, x).tolist() == [[3.0] * 2] * 2
        assert flags.allow_tf32 is True
    finally:
        flags.allow_tf32 = saved
    assert seen == [False]
