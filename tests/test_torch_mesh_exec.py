"""Port vs reference: mesh-sharded plans and programs on the CPU.

The host side (connectivity, schedule, stats, restricted controls,
``shard_restrict``) must give the reference's results on the same plans.
The port's scheduled and naive executors run on CPU meshes of 1, 2, 4
and 8 repeated ``"cpu"`` devices on every backend (the kernels' plain
versions here) and are held to the reference's single-device
``apply_plan`` under the exactness rule; the block-copy counter to the
schedule.  One test runs the reference's own sharded executors over 8
host devices in a subprocess and holds the port's outputs to them.
"""

import os
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import crossbar as jxb
from repro.core import plan_algebra as jpa
from repro.core import plan_program as jpp
from repro.core import semiring as jsr
from repro.crypto import chacha as JC
from repro.crypto import keccak as JK
from repro.dist import mesh_exec as jmx
from repro_torch.core import crossbar as txb
from repro_torch.core import faults
from repro_torch.core import plan_algebra as tpa
from repro_torch.core import plan_program as tpp
from repro_torch.core import telemetry
from repro_torch.crypto import chacha as TC
from repro_torch.crypto import keccak as TK
from repro_torch.dist import make_mesh
from repro_torch.dist import mesh_exec as tmx
from test_torch_support import (assert_bitexact, assert_close, jax_ref,
                                reset_torch_state)  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SHARDS = (1, 2, 4, 8)
BACKENDS = ("einsum", "kernel", "sparse", "reference")


def _moe_dest(t_tokens, n_experts, capacity, s, *, locality, seed):
    """The reference mesh benchmark's capacity-slotted MoE dispatch
    (``bench_mesh_sharded._moe_dispatch_plan``): a token routes to an
    expert of its own shard with probability ``locality``."""
    rng = np.random.default_rng(seed)
    dest = np.full((t_tokens,), -1, np.int32)
    fill = np.zeros((n_experts,), np.int32)
    for t in range(t_tokens):
        my_shard = t // (t_tokens // s)
        if rng.random() < locality:
            e = my_shard * (n_experts // s) + rng.integers(0, n_experts // s)
        else:
            e = rng.integers(0, n_experts)
        if fill[e] < capacity:
            dest[t] = e * capacity + fill[e]
            fill[e] += 1
    return dest


def _case(name):
    """(mode, idx, n_in, n_out, weights, semiring, payload) from a seed."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n = 64
    bits = rng.integers(0, 2, (n, 3)).astype(np.int32)
    ints = rng.integers(-1000, 1000, (n, 3)).astype(np.int32)
    if name == "identity":
        return "gather", np.arange(n, dtype=np.int32), n, n, None, "real", ints
    if name == "block_diag":
        idx = np.concatenate([8 * b + rng.permutation(8) for b in range(8)])
        return ("gather", idx.astype(np.int32), n, n, None, "gf2", bits)
    if name == "rotation":
        idx = ((np.arange(n) + n // 8) % n).astype(np.int32)
        return "gather", idx, n, n, None, "gf2", bits
    if name == "vslide":
        dest = (np.arange(n) + 12).astype(np.int32)
        return "scatter", dest, n, n, None, "real", ints
    if name == "vslide_weighted":
        dest = (np.arange(n) + 4).astype(np.int32)
        w = rng.standard_normal(n).astype(np.float32)
        x = rng.standard_normal((n, 3)).astype(np.float32)
        return "scatter", dest, n, n, w, "real", x
    if name == "moe_scatter":
        dest = _moe_dest(64, 8, 12, 8, locality=0.9, seed=7)
        x = rng.standard_normal((64, 5)).astype(np.float32)
        return "scatter", dest, 64, 96, None, "real", x
    if name == "gf2_k3":
        idx = rng.integers(-4, n, (n, 3)).astype(np.int32)
        return "gather", idx, n, n, None, "gf2", bits
    if name == "weighted_k2":
        idx = rng.integers(0, n, (n, 2)).astype(np.int32)
        w = rng.standard_normal((n, 2)).astype(np.float32)
        x = rng.standard_normal((n, 3)).astype(np.float32)
        return "gather", idx, n, n, w, "real", x
    raise KeyError(name)


CASES = ("identity", "block_diag", "rotation", "vslide", "vslide_weighted",
         "moe_scatter", "gf2_k3", "weighted_k2", "rho_pi")
EXACT = {"vslide_weighted": False, "weighted_k2": False}


def _plans(name):
    """(reference plan, port plan, payload numpy) of a case."""
    if name == "rho_pi":
        x = np.random.default_rng(5).integers(0, 2, (1600, 3)) \
            .astype(np.int32)
        return JK.rho_pi_plan(), TK.rho_pi_plan("cpu"), x
    mode, idx, n_in, n_out, w, sr, x = _case(name)
    if mode == "gather":
        jplan = jxb.gather_plan(jnp.asarray(idx), n_in, semiring=jsr.get(sr),
                                weights=None if w is None else jnp.asarray(w))
    else:
        jplan = jxb.scatter_plan(jnp.asarray(idx), n_out,
                                 semiring=jsr.get(sr),
                                 weights=None if w is None
                                 else jnp.asarray(w))
    tplan = txb.plan_from_numpy(mode, idx, n_in, n_out, weights=w,
                                semiring=sr, device="cpu")
    return jplan, tplan, x


def _cpu_mesh(s):
    return make_mesh((s,), ("data",), devices=["cpu"] * s)


_WANT = {}


def _want(name):
    """The reference's single-device ``apply_plan`` of a case, once."""
    if name not in _WANT:
        jplan, _, x = _plans(name)
        _WANT[name] = np.asarray(jxb.apply_plan(jplan, jnp.asarray(x),
                                                backend="einsum"))
    return _WANT[name]


# ---------------------------------------------------------------------------
# Host side: the reference's results
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_host_derivation_equals_reference(jax_ref, name):
    jplan, tplan, _ = _plans(name)
    for s in SHARDS:
        jconn = np.asarray(jmx.shard_connectivity(jplan, s))
        tconn = tmx.shard_connectivity(tplan, s)
        np.testing.assert_array_equal(tconn, jconn)
        assert tmx.is_lane_parallel(tplan, s) == jmx.is_lane_parallel(jplan,
                                                                      s)
        assert tmx.collective_schedule(tconn) == \
            jmx.collective_schedule(jconn)
        assert tmx.schedule_stats(tconn) == jmx.schedule_stats(jconn)
        assert tmx.shard_bounds(tplan.n_out, s) == \
            jmx.shard_bounds(jplan.n_out, s)


@pytest.mark.parametrize("name", CASES)
def test_stacked_restricted_controls_equal_reference(jax_ref, name):
    jplan, tplan, _ = _plans(name)
    for s in (2, 8):
        ji, jw, jk, jsr_ = jmx._stack_restricted(jplan, s)
        ti, tw, tk, tsr_ = tmx._stack_restricted(tplan, s)
        assert (tk, tsr_.name) == (jk, jsr_.name)
        assert_bitexact(ti, np.asarray(ji))
        assert (tw is None) == (jw is None)
        if tw is not None:
            assert_bitexact(tw, np.asarray(jw))


@pytest.mark.parametrize("name", ("gf2_k3", "weighted_k2", "moe_scatter",
                                  "rho_pi"))
def test_shard_restrict_equals_reference(jax_ref, name):
    jplan, tplan, _ = _plans(name)
    n_out, n_in = jplan.n_out, jplan.n_in
    for ow, iw in (((0, n_out // 2), (n_in // 2, n_in // 2)),
                   ((n_out // 4, n_out // 4), (0, n_in)),
                   ((n_out - n_out // 8, n_out // 8), (0, n_in // 8))):
        j = jpa.shard_restrict(jplan, ow, iw)
        t = tpa.shard_restrict(tplan, ow, iw)
        assert (t.n_in, t.n_out, t.k, t.semiring.name) == (
            j.n_in, j.n_out, j.k, j.semiring.name)
        assert_bitexact(t.idx, np.asarray(j.idx))
        if j.weights is not None:
            assert_bitexact(t.weights, np.asarray(j.weights))
    assert tpa.shard_restrict(tplan, (0, 8), (0, 8)) is \
        tpa.shard_restrict(tplan, (0, 8), (0, 8))      # memoised


def test_shard_restrict_rejects_bad_windows():
    plan = txb.gather_plan(torch.arange(8, dtype=torch.int32), 8)
    for ow, iw in (((0, 9), (0, 8)), ((4, 8), (0, 8)),
                   ((0, 8), (-1, 4)), ((0, 0), (0, 8))):
        with pytest.raises(ValueError, match="out of range"):
            tpa.shard_restrict(plan, ow, iw)


# ---------------------------------------------------------------------------
# Executors against the reference's single-device apply_plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("name", CASES)
def test_sharded_executors_equal_single_device(jax_ref, name, s):
    _, tplan, x = _plans(name)
    want = _want(name)
    mesh = _cpu_mesh(s)
    check = assert_bitexact if EXACT.get(name, True) else assert_close
    for backend in BACKENDS:
        fn = tmx.sharded_apply_fn(tplan, mesh, backend=backend)
        check(torch.cat(fn(torch.as_tensor(x))), want)
        check(tmx.apply_plan_sharded(tplan, torch.as_tensor(x), mesh,
                                     backend=backend), want)
        check(tmx.apply_plan_sharded_naive(tplan, torch.as_tensor(x), mesh,
                                           backend=backend), want)


@pytest.mark.parametrize("s", (2, 4, 8))
@pytest.mark.parametrize("name", ("rotation", "moe_scatter", "gf2_k3",
                                  "block_diag", "rho_pi"))
def test_block_copies_and_launches_follow_the_schedule(jax_ref, name, s):
    _, tplan, x = _plans(name)
    mesh = _cpu_mesh(s)
    fn = tmx.sharded_apply_fn(tplan, mesh, backend="sparse")
    stats = tmx.schedule_stats(fn.conn)
    local = int(np.diag(fn.conn).sum())
    txb.reset_apply_call_count()
    with telemetry.delta() as d:
        fn(torch.as_tensor(x))
    assert d().get("mesh_block_copies", 0) == stats["scheduled_block_transfers"]
    # one crossbar a diagonal block that carries traffic and one a
    # scheduled transfer; shards that receive nothing launch nothing
    assert txb.apply_call_count() == local + stats[
        "scheduled_block_transfers"]
    assert set(fn.blocks) == {(d_, d_) for d_ in range(s)
                              if fn.conn[d_, d_]} | {
        p for rnd in fn.schedule for p in rnd}
    naive = tmx.sharded_apply_naive_fn(tplan, mesh, backend="sparse")
    with telemetry.delta() as d:
        naive(torch.as_tensor(x))
    assert d().get("mesh_block_copies", 0) == s * (s - 1) == stats[
        "naive_block_transfers"]


def test_block_diagonal_plan_is_collective_free():
    _, tplan, x = _plans("block_diag")
    mesh = _cpu_mesh(8)
    assert tmx.is_lane_parallel(tplan, 8)
    with telemetry.delta() as d:
        tmx.apply_plan_sharded(tplan, torch.as_tensor(x), mesh)
    dd = d()
    assert dd.get("mesh_block_copies", 0) == 0
    assert dd["mesh_apply_calls"] == dd["mesh_apply_collective_free"] == 1


def test_shard_list_payload_and_bad_inputs():
    _, tplan, x = _plans("rotation")
    mesh = _cpu_mesh(4)
    xs = list(torch.as_tensor(x).chunk(4))
    out = tmx.apply_plan_sharded(tplan, xs, mesh)
    assert isinstance(out, list) and len(out) == 4
    assert_bitexact(torch.cat(out), _want("rotation"))
    with pytest.raises(ValueError, match="leading dim"):
        tmx.apply_plan_sharded(tplan, torch.as_tensor(x)[:32], mesh)
    with pytest.raises(ValueError, match="payload shards"):
        tmx.sharded_apply_fn(tplan, mesh)(xs[:3])
    with pytest.raises(ValueError, match="not on mesh"):
        tmx.sharded_apply_fn(tplan, mesh, axis="model")
    with pytest.raises(ValueError, match="does not divide"):
        tmx.sharded_apply_fn(txb.gather_plan(
            torch.arange(10, dtype=torch.int32), 10), mesh)
    with pytest.raises(ValueError, match="does not divide"):
        tmx.shard_connectivity(tplan, 3)
    gf28 = txb.gather_plan(torch.arange(8, dtype=torch.int32), 8,
                           semiring=txb.sr_mod.GF2_8)
    with pytest.raises(NotImplementedError, match="lift"):
        tmx.sharded_apply_fn(gf28, _cpu_mesh(2))


def test_collective_site_raises_a_launch_class_fault():
    from repro_torch.core.resilience import LaunchFault, classify
    _, tplan, x = _plans("rotation")
    with faults.inject_faults(seed=0, collective_rate=1.0,
                              sites=("collective",)) as inj:
        with pytest.raises(faults.InjectedCollectiveFailure, match="round 0"):
            tmx.sharded_apply_fn(tplan, _cpu_mesh(8))
        # a block-diagonal plan has no round: nothing to intercept
        _, bd, _ = _plans("block_diag")
        tmx.sharded_apply_fn(bd, _cpu_mesh(8))
    assert inj.injected == [("collective", 0)]
    assert classify(faults.InjectedCollectiveFailure("x")) is LaunchFault
    assert tmx._collective_round.__module__ == tmx.__name__    # restored


# ---------------------------------------------------------------------------
# Lane-parallel programs
# ---------------------------------------------------------------------------

def _program_case(which):
    rng = np.random.default_rng(11)
    if which == "keccak":
        x = rng.integers(0, 2, (1600, 16)).astype(np.int32)
        want = np.asarray(JK.keccak_f1600(jnp.asarray(x.T),
                                          backend="reference")).T
        return TK.megakernel_program("cpu"), torch.as_tensor(x), want
    x = rng.integers(0, 2**32, (16, 16), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jpp.run_program(JC.megakernel_program(),
                                      jnp.asarray(x), backend="chained"))
    tx = torch.as_tensor(x.view(np.int32)).view(torch.uint32)
    return TC.megakernel_program("cpu"), tx, want


@pytest.mark.parametrize("which", ("keccak", "chacha"))
def test_run_program_sharded_is_exact_with_zero_copies(jax_ref, which):
    prog, x, want = _program_case(which)
    for s in SHARDS:
        for backend in ("megakernel", "chained"):
            with telemetry.delta() as d:
                got = tmx.run_program_sharded(prog, x, _cpu_mesh(s),
                                              backend=backend)
            dd = d()
            assert dd.get("mesh_block_copies", 0) == 0
            assert dd["mesh_program_launches"] == 1
            if backend == "megakernel":
                assert dd["program_launches"] == s    # one a shard
            assert_bitexact(got, want)
    with pytest.raises(ValueError, match="does not divide"):
        tmx.run_program_sharded(prog, x[:, :5], _cpu_mesh(4))
    with pytest.raises(ValueError, match=r"\(n, D\)"):
        tmx.run_program_sharded(prog, x[:, 0], _cpu_mesh(4))


# ---------------------------------------------------------------------------
# The reference's own sharded executors, 8 host devices
# ---------------------------------------------------------------------------

REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax._src import core as jax_core
    jax.core.trace_state_clean = jax_core.trace_state_clean
    from repro.core import crossbar as xb
    from repro.core import semiring as sr
    from repro.dist import mesh_exec as mx

    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,)
    mesh = jax.make_mesh((8,), ("data",), **kw)
    cases = np.load(sys.argv[1], allow_pickle=True)["cases"].item()
    out = {}
    for name, (mode, idx, n_in, n_out, w, s_, x) in cases.items():
        fn = xb.gather_plan if mode == "gather" else xb.scatter_plan
        size = n_in if mode == "gather" else n_out
        plan = fn(jnp.asarray(idx), size, semiring=sr.get(s_),
                  weights=None if w is None else jnp.asarray(w))
        out[name] = np.asarray(mx.apply_plan_sharded(plan, jnp.asarray(x),
                                                     mesh))
        out[name + "/naive"] = np.asarray(
            mx.apply_plan_sharded_naive(plan, jnp.asarray(x), mesh))
    np.savez(sys.argv[2], **out)
    print("REF-SHARDED-OK")
""")

REF_CASES = ("block_diag", "rotation", "moe_scatter", "gf2_k3",
             "weighted_k2", "vslide")


def test_port_equals_reference_sharded_executors(tmp_path):
    cases = {name: _case(name) for name in REF_CASES}
    src, dst = tmp_path / "cases.npz", tmp_path / "ref.npz"
    np.savez(src, cases=np.asarray(cases, dtype=object))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(src),
                           str(dst)], capture_output=True, text=True,
                          timeout=300, env=env)
    assert "REF-SHARDED-OK" in proc.stdout, proc.stdout[-2000:] + \
        proc.stderr[-2000:]
    ref = np.load(dst)
    mesh = _cpu_mesh(8)
    for name in REF_CASES:
        mode, idx, n_in, n_out, w, sr, x = cases[name]
        plan = txb.plan_from_numpy(mode, idx, n_in, n_out, weights=w,
                                   semiring=sr, device="cpu")
        check = assert_bitexact if EXACT.get(name, True) else assert_close
        for backend in ("einsum", "sparse"):
            check(tmx.apply_plan_sharded(plan, torch.as_tensor(x), mesh,
                                         backend=backend), ref[name])
            check(tmx.apply_plan_sharded_naive(plan, torch.as_tensor(x),
                                               mesh, backend=backend),
                  ref[name + "/naive"])
