"""The port's sharding rules and placement against the JAX reference.

``_param_spec`` / ``_cache_spec`` / the batch spec are held to the
reference's ``repro.dist.sharding`` functions, which read only the
mesh's ``axis_names`` and ``shape`` (so both take the port's meshes),
on every leaf of every family's ``reduced()`` parameters, caches (batch
8, 16 positions) and batch, on meshes (1, 1), (4, 2), (16, 16) and (2,
16, 16): the reference's trees and the port's (layers stacked in one,
listed in the other).  At batch 8 the (16, 16) meshes take the
divisibility fallback for the batch, and the reduced widths for some
heads.  ``param_shardings`` on ``jax.make_mesh((1, 1))`` is compared
with the port's on the same tree.  ``device_put`` -> ``gather``
round-trips bit-exact on meshes of repeated CPU devices, and the ring
model equals the reference dry run's ``_collective_bytes`` on one
synthetic HLO line an op and group size.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.dist import make_mesh, spmd
from repro_torch.dist import sharding as shd
from repro_torch.models import model_zoo
from test_torch_support import one_thread, reset_torch_state  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

MESHES = [((1, 1), ("data", "model")), ((4, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
B, S = 8, 16


def _mesh(shape, axes, device="meta"):
    return make_mesh(shape, axes, devices=[device] * int(np.prod(shape)))


@pytest.fixture(scope="module")
def trees():
    """{arch: {"ref" / "port": (param shapes, cache shapes, batch shapes)}}
    for every family's reduced config."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.models.model_zoo import build as jbuild
    out = {}
    for arch in list_archs():
        japi = jbuild(jreduced(jget(arch)))
        ref = (jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0))),
               jax.eval_shape(lambda: japi.init_caches(B, S, jnp.float32)),
               japi.batch_specs(B, S))
        cfg = reduced(get_config(arch))
        api = model_zoo.build(cfg, device="meta")
        port = (_meta_init(cfg), api.init_caches(B, S, torch.float32),
                {k: torch.empty(s, dtype=dt, device="meta")
                 for k, (s, dt) in api.batch_specs(B, S).items()})
        out[arch] = {"ref": ref, "port": port}
    return out


def _meta_init(cfg):
    from repro_torch.models.params import family_module
    return family_module(cfg).lm_init(None, cfg, torch.device("meta"))


def _shapes(tree):
    import jax
    return [tuple(leaf.shape) for leaf in jax.tree.leaves(tree)]


@pytest.mark.parametrize("shape, axes", MESHES)
def test_specs_equal_reference_on_every_family(trees, shape, axes):
    from repro.dist import sharding as jshd
    m = _mesh(shape, axes)
    n_fallback = 0
    for arch, both in trees.items():
        for side in ("ref", "port"):
            params, caches, batch = both[side]
            for s in _shapes(params):
                want = tuple(jshd._param_spec(m, s))
                got = shd._param_spec(m, s)
                assert isinstance(got, shd.PartitionSpec)
                assert tuple(got) == want, (arch, side, s)
                n_fallback += len(s) >= 2 and None in want[-2:]
            for s in _shapes(caches):
                assert tuple(shd._cache_spec(m, s)) == tuple(
                    jshd._cache_spec(m, s)), (arch, side, s)
            for s in _shapes(batch):
                want = ([jshd._entry(m, s[0], jshd.batch_axes(m))]
                        if s else []) + [None] * (len(s) - 1)
                assert tuple(shd._batch_spec(m, s)) == tuple(want), (
                    arch, side, s)
    if shape[-1] == 16:
        assert n_fallback, "no leaf took the divisibility fallback"


def test_tree_functions_follow_the_spec_rules(trees):
    m = _mesh((4, 2), ("data", "model"))
    params, caches, batch = trees["phi3.5-moe-42b-a6.6b"]["port"]
    for fn, spec, tree in ((shd.param_shardings, shd._param_spec, params),
                           (shd.cache_shardings, shd._cache_spec, caches),
                           (lambda t, mm, _=None: shd.batch_shardings(t, mm),
                            shd._batch_spec, batch)):
        sh = fn(tree, m, None)
        for leaf, s in zip(_tree.leaves(tree), _tree.leaves(sh)):
            assert isinstance(s, shd.NamedSharding) and s.mesh is m
            assert s.spec == spec(m, tuple(leaf.shape))


def test_param_shardings_on_a_jax_mesh_equal_the_port(trees):
    import jax
    from repro.dist import sharding as jshd
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    m = _mesh((1, 1), ("data", "model"))
    for arch, both in trees.items():
        params = both["ref"][0]
        want = jshd.param_shardings(params, jmesh, None)
        got = shd.param_shardings(params, m)
        pairs = list(zip(jax.tree_util.tree_leaves_with_path(want),
                         jax.tree.leaves(got)))
        assert len(pairs) == len(jax.tree.leaves(params))
        for (path, w), g in pairs:
            assert tuple(g.spec) == tuple(w.spec), (arch, path)


def test_named_sharding_windows_and_replicas():
    m = _mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    sh = shd.NamedSharding(m, shd.P(("pod", "data"), None, "model"))
    assert sh.counts(3) == (4, 1, 2)
    assert sh.shard_shape((8, 3, 6)) == (2, 3, 3)
    # mesh index 5 = (pod 1, data 0, model 1): batch block 2, column 1
    assert sh.block(5, 3) == (2, 0, 1)
    assert sh.index(5, (8, 3, 6)) == (slice(4, 6), slice(0, 3), slice(3, 6))
    repl = shd.NamedSharding(m, shd.P("data"))
    groups = repl.blocks((4, 5))
    assert groups == {(0, 0): [0, 1, 4, 5], (1, 0): [2, 3, 6, 7]}
    with pytest.raises(ValueError, match="does not divide"):
        sh.shard_shape((6, 3, 6))
    with pytest.raises(ValueError, match="not on the mesh"):
        shd.NamedSharding(m, shd.P("bogus"))
    with pytest.raises(ValueError, match="twice"):
        shd.NamedSharding(m, shd.P("data", "data"))
    assert repr(shd.P("data", None)) == "PartitionSpec('data', None)"


@pytest.mark.parametrize("shape, axes", [((8,), ("data",)),
                                         ((4, 2), ("data", "model")),
                                         ((2, 2, 2), ("pod", "data",
                                                      "model"))])
def test_device_put_gather_round_trip_bit_exact(shape, axes):
    m = _mesh(shape, axes, "cpu")
    rng = np.random.default_rng(0)
    both = tuple(a for a in ("pod", "data") if a in axes)
    tree = {
        "mat": torch.as_tensor(rng.standard_normal((8, 4)), dtype=torch.float32),
        "stack": torch.as_tensor(rng.standard_normal((3, 8, 6))).to(
            torch.bfloat16),
        "ids": torch.as_tensor(rng.integers(-2**31, 2**31 - 1, (16, 2)),
                               dtype=torch.int32),
        "vec": torch.arange(5, dtype=torch.float32),
        "step": torch.tensor(7, dtype=torch.int64),
        "none": None,
    }
    specs = {"mat": shd.P(*dict.fromkeys((axes[0], axes[-1]))),
             "stack": shd.P(None, both if len(both) > 1 else axes[0]),
             "ids": shd.P(axes[-1]), "vec": shd.P(), "step": shd.P()}
    shardings = {k: shd.NamedSharding(m, p) for k, p in specs.items()}
    shardings["none"] = None
    placed = shd.device_put(tree, shardings)
    assert placed["none"] is None
    for name, t in tree.items():
        if t is None:
            continue
        leaf = placed[name]
        assert isinstance(leaf, shd.Sharded) and len(leaf.shards) == m.size
        ptrs = {s.data_ptr() for s in leaf.shards if s.numel()}
        assert len(ptrs) == m.size, "every mesh index holds its own copy"
        for p, s in enumerate(leaf.shards):
            assert torch.equal(s, t[leaf.sharding.index(p, tuple(t.shape))])
        back = shd.gather(leaf, "cpu")
        assert back.dtype == t.dtype and torch.equal(back, t)
        assert all(back.data_ptr() != s.data_ptr() for s in leaf.shards)
    assert shd.device_put(placed, shardings)["mat"] is placed["mat"]
    other = shd.NamedSharding(m, shd.P())
    again = shd.device_put(placed["mat"], other)
    assert torch.equal(shd.gather(again), tree["mat"])


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference dry run module; importing it sets XLA_FLAGS (512
    host devices) for the process, which is put back at once so that no
    later JAX test in this worker sees it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


@pytest.mark.parametrize("op", ["all-gather", "all-reduce", "reduce-scatter",
                                "all-to-all", "collective-permute"])
def test_ring_model_equals_reference(ref_dryrun, op):
    for dtype, itemsize in (("f32", 4), ("bf16", 2), ("s8", 1)):
        for k in (1, 2, 4, 16):
            line = (f"  %x.1 = {dtype}[4,8]{{1,0}} {op}({dtype}[4,8] %p), "
                    f"replica_groups=[{32 // k},{k}]<=[32]")
            total, by = ref_dryrun._collective_bytes(line)
            got = spmd.ring_bytes(op, 4 * 8 * itemsize, k)
            assert got == total and by.get(op, 0.0) == total, (op, k)
        listed = (f"  %y = f32[16]{{0}} {op}-start(f32[16] %q), "
                  "replica_groups={{0,1,2}}")
        assert spmd.ring_bytes(op, 64, 3) == ref_dryrun._collective_bytes(
            listed)[0]
    with pytest.raises(ValueError, match="unknown collective"):
        spmd.ring_bytes("broadcast", 4, 2)
    assert spmd.ring_bytes("copy", 10, 2) == 10.0


def test_transfer_link_classes():
    t = spmd.Transfer("all-gather", 64, 2, 0, (0, 7))
    assert t.intra_node and t.traffic == 32
    assert not spmd.Transfer("all-gather", 64, 2, 0, (0, 8)).intra_node
    assert not spmd.Transfer("all-gather", 64, 2, 0, (0, 16)).intra_node
