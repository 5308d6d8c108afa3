"""What a mesh index of the sharded executor (``dist.spmd``) holds: its
shards and its block of one layer at a time, not the whole model (the
dense and MoE families split each layer over "model";
``test_torch_spmd_tp.py`` holds the split's values).

* Peak live bytes, by the dry run's tracker (``launch.dryrun._run``:
  ``FakeTensorMode``, the live storages' bytes), of window 0's share of
  the sharded train step (``cfg.remat == "full"``) and of the sharded
  decode step, for a reduced dense and a reduced MoE config widened to
  d_ff 1024 (so that a layer outweighs the embeddings), on a (4 data x
  2 model) mesh of ``["cpu"] * 8``, at 2 and at 3 layers: the added
  layer adds less than half a layer's parameter bytes.  A whole-tree
  gather adds one layer (decode) or two (train: the gathered copy and
  its gradient).
* The transfer record of a real run on that mesh: mesh index 0's
  block of each layer leaf (``sharding.compute_block``: half of every
  matrix but the router) gathered once a microbatch piece, once more
  for the recompute under remat "full"; its blocks of the embeddings and
  head once a window; one reduction a parameter a piece (two where
  every rank's block overlaps every shard: the router, the expert
  weights); in decode, no cache row moves (each rank's own block).
* The per-layer views hold every family's decode: the sharded decode
  step of the reduced rwkv, hybrid, encdec and vlm configs, 3 greedy
  steps of 8 slots, against the port's single device and the JAX
  reference's on the same carried weights and tokens (``decode_ref``):
  logits ``rtol=1e-5, atol=1e-6`` against both, the same tokens; caches
  after ``rtol=1e-5, atol=1e-6`` against one device, and against the
  reference ``rtol=1e-5`` with ``atol`` 1e-5 of the leaf's largest
  magnitude, at least 1e-5.  Their sharded train step under remat
  "full" is held to the reference's in ``test_torch_train.py``, which
  compiles that step once a family already.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.dist import make_mesh, spmd
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun as D
from repro_torch.models import model_zoo
from repro_torch.train import TrainOptions
from repro_torch.train.trainer import init_state
from test_torch_support import (carried_params, jax_ref_alias,  # noqa: F401
                                one_thread, port_leaf, reset_torch_state)

pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = ["minicpm", "phi3.5-moe"]
FAMILIES = ["rwkv6", "zamba2", "seamless", "internvl2"]
TRAIN = ShapeCell("train_small", 16, 8, "train")
DECODE = ShapeCell("decode_small", 16, 8, "decode")
DECODE_STEPS = 3
DECODE_TOL = dict(rtol=1e-5, atol=1e-6)
# caches against the reference: the family files' tolerance
# (test_torch_rwkv.py, test_torch_ssm_hybrid.py, test_torch_vlm_encdec.py:
# rtol 1e-5, atol 1e-5), the atol taken of the leaf's largest magnitude
# where that passes 1 (the WKV state reaches ~3)
CACHE_RTOL = 1e-5


def _mesh(devices="cpu"):
    return make_mesh((4, 2), ("data", "model"), devices=[devices] * 8)


def _cfg(arch, layers, **kw):
    return reduced(get_config(arch), num_layers=layers, **kw)


def _layer_bytes(cfg) -> int:
    blocks = D._meta_params(cfg)["blocks"]
    return sum(t.numel() * t.element_size() for t in _tree.leaves(blocks[0]))


def _nbytes(leaf) -> int:
    return int(np.prod(leaf.shape)) * leaf.shards[0].element_size()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [TRAIN, DECODE], ids=["train", "decode"])
def test_peak_grows_by_less_than_half_a_layer_a_layer(arch, shape):
    temp = {n: D._run(_cfg(arch, n, d_ff=1024, remat="full"), shape,
                      _mesh(), 1)["temp_bytes"] for n in (2, 3)}
    per_layer = temp[3] - temp[2]
    layer = _layer_bytes(_cfg(arch, 2, d_ff=1024))
    assert 0 <= per_layer < layer / 2, (temp, layer)


def _train_run(arch, remat, accum):
    cfg = _cfg(arch, 2, remat=remat)
    api = model_zoo.build(cfg, device="cpu")
    state = init_state(api.init(torch.Generator().manual_seed(0)))
    batch = api.make_batch(torch.Generator().manual_seed(1), 8, 16)
    mesh = _mesh()
    sh = spmd.train_state_shardings(state, mesh, cfg)
    transfers = []
    step = spmd.make_sharded_train_step(
        api.loss_fn, TrainOptions(grad_accum=accum), mesh, sh,
        shd.batch_shardings(batch, mesh), transfers=transfers)
    placed = shd.device_put(state, sh)
    _, metrics = step(placed, batch, only=0)
    return placed.params, transfers, metrics


def _block_gathers(leaves_with_path, p=0, k=2) -> list:
    """(path, block bytes, leaf bytes) of each leaf whose compute block
    (``compute_block``, rank 0 of a model row of k) mesh index p gathers:
    one a leaf whose block its own shard does not hold."""
    out = []
    for path, leaf in leaves_with_path:
        rng = shd.compute_block(path, leaf.shape, k, 0)
        own = leaf.sharding.index(p, leaf.shape)
        size = [rng.get(d, (0, n)) for d, n in enumerate(leaf.shape)]
        if any(own[d].start > lo or hi > own[d].stop
               for d, (lo, hi) in enumerate(size)):
            out.append((path, leaf.shards[0].element_size()
                        * int(np.prod([hi - lo for lo, hi in size])),
                        _nbytes(leaf)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_gathers_a_layer_a_piece_and_again_for_the_recompute(arch,
                                                                    remat):
    # 8 rows over 4 windows, a row a microbatch: 2 pieces a window; mesh
    # index 0 (rank 0 of model row (0, 1)) gathers its block of each leaf
    params, transfers, metrics = _train_run(arch, remat, accum=8)
    assert np.isfinite(float(metrics["loss"]))
    pieces, passes = 2, 2 if remat == "full" else 1
    with_path = _tree.leaves_with_path(params)
    layers = _block_gathers([(p, v) for p, v in with_path
                             if p[0] == "blocks"])
    whole = _block_gathers([(p, v) for p, v in with_path
                            if p[0] != "blocks"])
    gathers = [t for t in transfers if t.kind == "weight"]
    assert all(t.op == "all-gather" for t in gathers)
    assert {t.dst for t in transfers} == {0}
    assert len(gathers) == len(whole) + pieces * passes * len(layers)
    assert sum(t.nbytes for t in gathers) == (
        sum(b for _, b, _ in whole)
        + pieces * passes * sum(b for _, b, _ in layers))
    # its block of a layer, never the layer: half of each matrix but the
    # router (every rank routes), half the vocabulary of the tables
    assert all(2 * b == n for path, b, n in layers + whole
               if "router" not in path), (layers, whole)
    # one reduction a parameter a piece: a reduce-scatter over the data
    # windows (an all-reduce for a vector); where every rank's block
    # overlaps every shard (the router, the expert weights under expert
    # parallelism) an all-reduce over the row too
    reductions = [t for t in transfers if t.kind == "grad" and t.nbytes > 4]
    both = [p for p, _ in with_path if "router" in p
            or (p[-2] == "moe" and p[-1] in ("wi", "wg", "wo"))]
    assert len(reductions) == pieces * (len(with_path) + len(both))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_gathers_each_layers_cache_rows_once_a_step(arch):
    cfg = _cfg(arch, 2)
    api = model_zoo.build(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(2))
    mesh = _mesh()
    caches = api.init_caches(8, 16, torch.float32)
    meta = model_zoo.build(cfg, device="meta")
    dims = spmd.cache_batch_dims(lambda b: meta.init_caches(
        b, 16, torch.float32))
    pc = shd.device_put(params, shd.param_shardings(params, mesh))
    cc = shd.device_put(caches, shd.cache_shardings(caches, mesh))
    tok = torch.zeros((8, 1), dtype=torch.int32)
    transfers = []
    spmd.sharded_decode_step(api.decode_fn, mesh, pc, tok, cc, 0,
                             batch_dims=dims, only=0, transfers=transfers)
    gathers = [t for t in transfers if t.kind == "weight"]
    # each layer's cache rows of window 0 (2 of 8 slots) are mesh index
    # 0's own block: read and written in place, never moved
    assert not [t for t in transfers if t.kind == "cache"]
    assert sorted(t.nbytes for t in gathers) == sorted(
        b for _, b, _ in _block_gathers(_tree.leaves_with_path(pc)))


def _placed_decode(api, cfg, params, slots, max_seq, mesh):
    caches = api.init_caches(slots, max_seq, torch.float32)
    meta = model_zoo.build(cfg, device="meta")
    dims = spmd.cache_batch_dims(lambda b: meta.init_caches(
        b, max_seq, torch.float32))
    pc = shd.device_put(params, shd.param_shardings(params, mesh))
    cc = shd.device_put(caches, shd.cache_shardings(caches, mesh))
    return caches, dims, pc, cc


@pytest.fixture(scope="module", params=FAMILIES)
def decode_ref(request):
    """One family's reduced config in the JAX reference: the carried
    weights and 3 greedy decode steps of 8 slots from seeded tokens (the
    tokens fed, the logits, the caches after)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get
    from repro.configs import reduced as j_reduced
    from repro.models import model_zoo as jzoo
    with jax_ref_alias():
        jcfg = j_reduced(j_get(request.param))
        japi = jzoo.build(jcfg)
        tcfg = ModelConfig(**dataclasses.asdict(jcfg))
        jparams, tparams = carried_params(japi, tcfg, seed=5)
        toks = np.random.default_rng(4).integers(
            0, jcfg.vocab_size, (8, 1)).astype(np.int32)
        decode = jax.jit(japi.decode_fn)
        caches, tok, fed, logits = japi.init_caches(8, 8, jnp.float32), \
            jnp.asarray(toks), [], []
        for pos in range(DECODE_STEPS):
            fed.append(np.array(tok))
            out, caches = decode(jparams, tok, caches, pos)
            logits.append(np.asarray(out))
            tok = jnp.argmax(out[:, -1], -1).astype(jnp.int32)[:, None]
        return dict(tcfg=tcfg, tparams=tparams, fed=fed, logits=logits,
                    caches=jax.tree.map(np.asarray, caches))


def test_every_familys_sharded_decode_equals_single_device_and_reference(
        decode_ref):
    cfg, params = decode_ref["tcfg"], decode_ref["tparams"]
    api = model_zoo.build(cfg, device="cpu")
    mesh = _mesh()
    caches, dims, pc, cc = _placed_decode(api, cfg, params, 8, 8, mesh)
    t1 = t2 = torch.as_tensor(decode_ref["fed"][0])
    with torch.no_grad():
        for pos in range(DECODE_STEPS):
            assert torch.equal(t2, torch.as_tensor(decode_ref["fed"][pos]))
            l1, caches = api.decode_fn(params, t1, caches, pos)
            l2, cc = spmd.sharded_decode_step(api.decode_fn, mesh, pc, t2,
                                              cc, pos, batch_dims=dims)
            np.testing.assert_allclose(l2.numpy(), l1.numpy(), **DECODE_TOL)
            np.testing.assert_allclose(l2.numpy(), decode_ref["logits"][pos],
                                       **DECODE_TOL)
            t1 = l1[:, -1].argmax(-1).to(torch.int32)[:, None]
            t2 = l2[:, -1].argmax(-1).to(torch.int32)[:, None]
            assert torch.equal(t1, t2)
    for path, a in _tree.leaves_with_path(caches):
        b = shd.gather(port_leaf(cc, path)).numpy()
        np.testing.assert_allclose(b, a.numpy(), **DECODE_TOL)
        want = port_leaf(decode_ref["caches"], path)
        np.testing.assert_allclose(
            b, want, rtol=CACHE_RTOL,
            atol=CACHE_RTOL * max(1.0, np.abs(want).max()), err_msg=str(path))
