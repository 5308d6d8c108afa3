"""The split over "model" of the hybrid family (``dist.spmd`` with
``dist.annotate``'s model-axis group) against one device and the JAX
reference.

A tiny Zamba2 (4 layers, period 2: 2 groups, d_model 32, 4 heads and 4
kv heads of 8, d_ff 64, vocab 128, ssm_state 8, ssm_head_dim 8, expand
2: 8 SSM heads, conv width 4, attn_chunk 8, float32) on a (4 data x 2
model) mesh of ``["cpu"] * 8``, each window on both indices of its model
row:

* ``hybrid``: Mamba2 by SSM heads (``in_proj``'s several column spans,
  the conv's channels, the gated norm from the ranks' sums of squares,
  ``out_proj`` by rows), the shared block by heads, the LoRA on each
  rank's rows of the sequence-parallel carry; decode moves each Mamba2
  state from the cache's P block to the heads' and back (an
  all-to-all) and reads the kv-head block of the rings;
* ``remat``: the same under remat "full" (the recompute repeats the
  moves);
* ``heads3``: d_model 24 with ssm_head_dim 16 (3 SSM heads) and 3
  attention heads (3 kv heads: MHA, as Zamba2's), none of which divide
  2: the Mamba2 leaves stay whole, the shared block's keys split
  instead, decode reads the head_dim block of the rings;
* ``r8``: ``hybrid`` decoded on (2 data x 2 model) of ``["cpu"] * 4``,
  where ``_cache_spec`` puts the data axis on the Mamba2 caches' period
  (reference quirk R8), so a window's state rows cross "data".

The train step (``hybrid``, ``remat``, ``heads3``: one step from the
reference's carried weights and its ``SyntheticLM`` batch of 8 x 16
tokens, ``TrainOptions(peak_lr=1e-3)``) is held to the port's single-device
``make_train_step`` and to the reference's jitted step: loss
``rtol=1e-5``, parameters ``rtol=2e-4, atol=2e-5``, first moment
``rtol=1e-4, atol=1e-7``, second ``rtol=1e-3, atol=1e-10``.  Five greedy
decode steps of 8 slots on rings of 4 slots (the ring wraps) are held to
the reference's jitted ``decode_fn`` and to the port's on one device:
the reference's tokens, logits ``rtol=1e-5, atol=1e-6``, the caches
after ``rtol=1e-5`` with atol 1e-5 of the leaf's largest magnitude
(against both: the Mamba2 states sum each step's terms in another order
on each rank's heads).  The transfer record: each mesh index gathers
exactly its compute block (``sharding.compute_block``, ``in_proj``'s
spans included) of every leaf it does not hold.
"""

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import spmd
from repro_torch.dist import sharding as shd
from repro_torch.models import model_zoo
from repro_torch.train import TrainOptions, make_train_step
from repro_torch.train.trainer import init_state
from test_torch_spmd_tp import _clone, _gathered, _mesh
from test_torch_support import (carried_params, jax_ref_alias,  # noqa: F401
                                one_thread, port_leaf, reference_leaves,
                                reset_torch_state)

pytestmark = pytest.mark.usefixtures("one_thread")

TINY = dict(name="tiny", family="hybrid", num_layers=4, shared_attn_period=2,
            d_model=32, num_heads=4, num_kv_heads=4, d_ff=64,
            vocab_size=128, head_dim=8, ssm_state=8, ssm_head_dim=8,
            ssm_expand=2, conv_width=4, compute_dtype="float32",
            remat="none", attn_chunk=8)
CASES = {
    "hybrid": (TINY, (4, 2)),
    "remat": (dict(TINY, remat="full"), (4, 2)),
    "heads3": (dict(TINY, d_model=24, ssm_head_dim=16, num_heads=3,
                    num_kv_heads=3), (4, 2)),
    "r8": (TINY, (2, 2)),
}
TRAINED = ["hybrid", "remat", "heads3"]
BATCH, SEQ = 8, 16
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
MU_TOL = dict(rtol=1e-4, atol=1e-7)
NU_TOL = dict(rtol=1e-3, atol=1e-10)
DECODE_TOL = dict(rtol=1e-5, atol=1e-6)
DECODE_STEPS, SLOTS, MAX_SEQ, WINDOW = 5, 8, 16, 4
CACHE_RTOL = 1e-5


@pytest.fixture(scope="module")
def reference():
    """Per case: the carried port params, the train batch (numpy), the
    JAX reference's jitted step's loss, grad norm, params, mu, nu, and
    its jitted ``decode_fn``'s greedy run on the same weights (the
    tokens fed, the logits, the caches after)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ModelConfig as JConfig
    from repro.data import SyntheticLM as JSynthetic
    from repro.models.model_zoo import build as jbuild
    from repro.train import TrainOptions as JOptions
    from repro.train import make_train_step as jstep
    from repro.train.trainer import init_state as jinit
    out = {}
    batch = {"tokens": np.asarray(JSynthetic(
        vocab_size=128, seq_len=SEQ, global_batch=BATCH).batch(0)["tokens"])}
    with jax_ref_alias():
        for name, (kw, _) in CASES.items():
            japi = jbuild(JConfig(**kw))
            jparams, tparams = carried_params(japi, ModelConfig(**kw), seed=1)
            ref = dict(tparams=tparams, batch=batch)
            if name in TRAINED:
                step = jax.jit(jstep(japi.loss_fn, JOptions(peak_lr=1e-3)))
                st, m = step(jinit(jparams, jax.random.PRNGKey(0)),
                             {"tokens": jnp.asarray(batch["tokens"])})
                ref.update(loss=float(m["loss"]),
                           grad_norm=float(m["grad_norm"]), params=st.params,
                           mu=st.opt.mu, nu=st.opt.nu)
            decode = jax.jit(japi.decode_fn)
            caches = japi.init_caches(SLOTS, MAX_SEQ, jnp.float32,
                                      window=WINDOW)
            tok = jnp.asarray(np.random.default_rng(4).integers(
                0, kw["vocab_size"], (SLOTS, 1)).astype(np.int32))
            fed, logits = [], []
            for pos in range(DECODE_STEPS):
                fed.append(np.array(tok))
                lg, caches = decode(jparams, tok, caches, pos)
                logits.append(np.asarray(lg))
                tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
            ref.update(fed=fed, logits=logits,
                       caches=jax.tree.map(np.asarray, caches))
            out[name] = ref
    return out


def _split_step(name, params, batch, transfers=None):
    kw, shape = CASES[name]
    cfg = ModelConfig(**kw)
    api = model_zoo.build(cfg, device="cpu")
    mesh = _mesh(shape)
    assert spmd.splits_over_model(api.loss_fn, mesh)
    state = init_state(_clone(params))
    sh = spmd.train_state_shardings(state, mesh, cfg)
    step = spmd.make_sharded_train_step(
        api.loss_fn, TrainOptions(peak_lr=1e-3), mesh, sh,
        shd.batch_shardings(batch, mesh), transfers=transfers)
    return api, mesh, step, shd.device_put(state, sh)


def _tokens(ref) -> dict:
    return {"tokens": torch.as_tensor(np.array(ref["batch"]["tokens"]))}


@pytest.mark.parametrize("name", TRAINED)
def test_split_step_equals_single_device_and_reference(reference, name):
    ref = reference[name]
    batch = _tokens(ref)
    transfers = []
    api, mesh, step, placed = _split_step(name, ref["tparams"], batch,
                                          transfers)
    got, m = step(placed, batch)
    single, ms = make_train_step(api.loss_fn, TrainOptions(peak_lr=1e-3))(
        init_state(_clone(ref["tparams"])), batch)

    np.testing.assert_allclose(float(m["loss"]), float(ms["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(m["loss"]), ref["loss"], **LOSS_TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), ref["grad_norm"],
                               rtol=1e-5)
    for key in ms:
        np.testing.assert_allclose(float(m[key]), float(ms[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    params = _gathered(got.params)
    mu, nu = _gathered(got.opt.mu), _gathered(got.opt.nu)
    for want_tree, got_tree, single_tree, tol in (
            (ref["params"], params, single.params, PARAM_TOL),
            (ref["mu"], mu, single.opt.mu, MU_TOL),
            (ref["nu"], nu, single.opt.nu, NU_TOL)):
        for path, want in reference_leaves(want_tree):
            g = port_leaf(got_tree, path).numpy()
            s = port_leaf(single_tree, path).detach().numpy()
            np.testing.assert_allclose(g, want, **tol, err_msg=str(path))
            np.testing.assert_allclose(g, s, **tol, err_msg=str(path))

    # the branch each case takes, read off the record
    ops = {(t.kind, t.op) for t in transfers}
    assert ("activation", "all-gather") in ops       # the carry gathered
    assert ("activation", "reduce-scatter") in ops   # partials into it
    if name == "heads3":
        assert ("activation", "all-to-all") in ops   # k, v to key blocks


def _block_bytes(leaf, rng) -> int:
    return leaf.shards[0].element_size() * int(np.prod(
        [sum(hi - lo for lo, hi in shd.spans(rng.get(d, (0, n))))
         for d, n in enumerate(leaf.shape)]))


def _covers(leaf, p, rng) -> bool:
    """Whether mesh index p's shard of ``leaf`` holds all of its block
    ``rng``."""
    own = leaf.sharding.index(p, leaf.shape)
    return all(own[d].start <= lo and hi <= own[d].stop
               for d, n in enumerate(leaf.shape)
               for lo, hi in shd.spans(rng.get(d, (0, n))))


@pytest.mark.parametrize("name", TRAINED)
def test_each_index_gathers_only_its_block(reference, name):
    ref = reference[name]
    batch = _tokens(ref)
    transfers = []
    _, mesh, step, placed = _split_step(name, ref["tparams"], batch,
                                        transfers)
    step(placed, batch)
    with_path = _tree.leaves_with_path(placed.params)
    ssm = shd.ssm_geometry(placed.params)
    k = mesh.shape["model"]
    model = lambda i: int(np.unravel_index(i, mesh.devices.shape)[1])
    split = ssm[1] % k == 0
    # a window is one microbatch piece; the layer stacks are gathered
    # once a piece, and again by the recompute under remat "full"
    passes = 2 if CASES[name][0]["remat"] == "full" else 1
    for p in range(mesh.size):
        r = model(p)
        blocks = {path: shd.compute_block(path, leaf.shape, k, r, ssm=ssm)
                  for path, leaf in with_path}
        want = sorted(
            b for path, leaf in with_path
            if not _covers(leaf, p, blocks[path])
            for b in [_block_bytes(leaf, blocks[path])]
            * (passes if path[0] in ("mamba", "lora") else 1))
        got = [t for t in transfers if t.kind == "weight" and t.dst == p]
        assert sorted(t.nbytes for t in got) == want, p
        # in_proj's block: its heads' z, x and dt columns and B and C,
        # several spans, some held by the other model index's shards
        for path, leaf in with_path:
            if path[-2:] != ("in_proj", "w"):
                continue
            spans = shd.spans(blocks[path].get(1, (0, leaf.shape[1])))
            assert (len(spans) > 1) == split, (path, spans)
            nbytes = _block_bytes(leaf, blocks[path])
            crossing = [t for t in got if t.nbytes == nbytes
                        and {model(i) for i in t.group} == {0, 1}]
            assert crossing or not split, (p, path)
    # every matrix of the shared block and of Mamba2 is a block where the
    # heads divide the axis; the vectors whole
    for path, leaf in with_path:
        block = shd.compute_block(path, leaf.shape, k, 1, ssm=ssm)
        if path[0] == "shared" and leaf.ndim == 2:
            assert block, path
        if path[0] == "mamba" and path[-2:] != ("ln", "scale") and (
                leaf.ndim == 2 or path[-1] == "conv_b"):
            assert bool(block) == split, path
        if path[-1] in ("A_log", "D", "dt_bias", "scale"):
            assert not block, path
    act = [t for t in transfers if t.kind == "activation"]
    assert act and all(t.k == 2 and t.group[0] % 2 == 0
                       and t.group[1] == t.group[0] + 1 for t in act)


@pytest.mark.parametrize("name", list(CASES))
def test_split_decode_equals_single_device_and_reference(reference, name):
    ref = reference[name]
    kw, shape = CASES[name]
    cfg = ModelConfig(**kw)
    api = model_zoo.build(cfg, device="cpu")
    params = ref["tparams"]
    mesh = _mesh(shape)
    assert spmd.splits_over_model(api.decode_fn, mesh)
    caches = api.init_caches(SLOTS, MAX_SEQ, torch.float32, window=WINDOW)
    meta = model_zoo.build(cfg, device="meta")
    dims = spmd.cache_batch_dims(
        lambda b: meta.init_caches(b, MAX_SEQ, torch.float32, window=WINDOW))
    pc = shd.device_put(params, shd.param_shardings(params, mesh))
    cc = shd.device_put(caches, shd.cache_shardings(caches, mesh))
    t1 = t2 = torch.as_tensor(ref["fed"][0])
    data, model = (lambda i, a=a: int(np.unravel_index(
        i, mesh.devices.shape)[a]) for a in (0, 1))
    ops = set()
    with torch.no_grad():
        for pos in range(DECODE_STEPS):
            assert torch.equal(t2, torch.as_tensor(ref["fed"][pos]))
            transfers = []
            l1, caches = api.decode_fn(params, t1, caches, pos)
            l2, cc = spmd.sharded_decode_step(api.decode_fn, mesh, pc, t2,
                                              cc, pos, batch_dims=dims,
                                              transfers=transfers)
            np.testing.assert_allclose(l2.numpy(), l1.numpy(), **DECODE_TOL)
            np.testing.assert_allclose(l2.numpy(), ref["logits"][pos],
                                       **DECODE_TOL)
            t1 = l1[:, -1].argmax(-1).to(torch.int32)[:, None]
            t2 = l2[:, -1].argmax(-1).to(torch.int32)[:, None]
            assert torch.equal(t1, t2)
            # cache rows never cross "model": each rank reads and writes
            # its block.  They cross "data" in every case: on (4 x 2) the
            # period (2) does not divide "data", so the Mamba2 caches and
            # x0 are whole over it and a window's rows are copied to the
            # other data indices; on (2 x 2) the period splits over
            # "data" (R8) and a window's Mamba2 rows live on both
            cache = [t for t in transfers if t.kind == "cache"]
            assert cache
            assert all(t.op == "copy" and len({model(i) for i in t.group})
                       == 1 and len({data(i) for i in t.group}) > 1
                       for t in cache)
            ops |= {t.op for t in transfers if t.kind == "activation"}
    for path, a in _tree.leaves_with_path(caches):
        b = shd.gather(port_leaf(cc, path)).numpy()
        for want in (a.numpy(), port_leaf(ref["caches"], path)):
            np.testing.assert_allclose(
                b, want, rtol=CACHE_RTOL,
                atol=CACHE_RTOL * max(1.0, np.abs(want).max()),
                err_msg=str(path))
    specs = {path: tuple(port_leaf(cc, path).sharding.spec)
             for path, _ in _tree.leaves_with_path(caches)}
    period = "data" if name == "r8" else None       # R8
    assert specs[("ssm", "ssm")] == (None, period, None, None, "model", None)
    assert specs[("ssm", "conv")] == (None, period, None, None, "model")
    ring = ((None, "data", None, None, "model") if name == "heads3"
            else (None, "data", None, "model", None))
    assert specs[("attn_k",)] == specs[("attn_v",)] == ring
    # the state's P block to the heads' and back where the heads split;
    # gathered whole where they do not
    assert ("all-to-all" in ops) == (name != "heads3")
    assert "all-gather" in ops
