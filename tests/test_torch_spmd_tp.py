"""The sharded executor's split over "model" (``dist.spmd`` with
``dist.annotate``'s model-axis group) against one device and the JAX
reference.

The reference test's tiny dense config (``tests/test_dist.py``: 2
layers, d_model 32, 4 heads, 2 kv heads, d_ff 64, vocab 128, float32)
and its MoE variant (4 experts, top 2) run on a (4 data x 2 model) mesh
of ``["cpu"] * 8``, each window on both indices of its model row, every
product split as the reference's annotations split it.  The cases take
every branch:

* ``dense``: heads over "model" (kv heads too), d_ff, the vocabulary,
  the sequence-parallel carry; decode reads the cache's kv-head block;
* ``moe``: experts parallel (4 experts over 2);
* ``heads3``: 3 heads (1 kv head, d_model 24) do not divide 2: the keys
  split instead (context-parallel softmax), and decode reads the
  cache's head_dim block (the partial scores summed);
* ``experts3``: 3 experts do not divide 2: each expert's d_ff splits;
* ``vocab``: the vocabulary does not divide the axis.  The padded
  vocabulary is a multiple of 2048, so this case runs the dense config
  on a (2 data x 3 model) mesh of ``["cpu"] * 6``: 2048 rows, 4 heads,
  d_ff 64 and 16 positions all stay whole over 3 (the replicated
  fallback of ``annotate.spec``), so every rank computes the window.

The train step (one step from the reference's carried weights and its
``SyntheticLM`` batch, ``TrainOptions(peak_lr=1e-3)``) is held to the
port's single-device ``make_train_step`` and to the reference's jitted
step at ``test_torch_spmd.py``'s tolerances: loss ``rtol=1e-5``,
parameters ``rtol=2e-4, atol=2e-5``, first moment ``rtol=1e-4,
atol=1e-7``, second ``rtol=1e-3, atol=1e-10`` (the bf16 router's
moments to one bf16 step of their largest entry).  Five greedy decode
steps of 8 slots from seeded tokens, on the same carried weights, are
held to the reference's jitted ``decode_fn`` and to the port's
``decode_fn`` on one device: the reference's tokens, logits ``rtol=1e-5,
atol=1e-6`` (the MoE family's against the reference at ``atol=1e-5``,
the tolerance the port's single-device MoE decode is held to there),
caches after (against the reference ``rtol=1e-5`` with
atol 1e-5 of the leaf's largest magnitude, as
``test_torch_spmd_memory.py`` holds them).  The transfer
record: each mesh index gathers exactly its compute block of every
leaf it does not hold (``sharding.compute_block``), so no weight bytes
cross "model" beyond the block, and activations move within its row.
"""

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import make_mesh, spmd
from repro_torch.dist import sharding as shd
from repro_torch.models import model_zoo
from repro_torch.train import TrainOptions, make_train_step
from repro_torch.train.trainer import init_state
from test_torch_support import (carried_params, jax_ref_alias,  # noqa: F401
                                one_thread, port_leaf, reference_leaves,
                                reset_torch_state)

pytestmark = pytest.mark.usefixtures("one_thread")

TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
            head_dim=8, compute_dtype="float32", remat="none", attn_chunk=8)
TINY_MOE = dict(TINY, family="moe", num_experts=4, num_experts_per_tok=2)
CASES = {
    "dense": (TINY, (4, 2)),
    "moe": (TINY_MOE, (4, 2)),
    "heads3": (dict(TINY, num_heads=3, num_kv_heads=1, d_model=24), (4, 2)),
    "experts3": (dict(TINY_MOE, num_experts=3), (4, 2)),
    "vocab": (TINY, (2, 3)),
}
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
MU_TOL = dict(rtol=1e-4, atol=1e-7)
NU_TOL = dict(rtol=1e-3, atol=1e-10)
DECODE_TOL = dict(rtol=1e-5, atol=1e-6)
DECODE_STEPS, SLOTS, MAX_SEQ = 5, 8, 16
CACHE_RTOL = 1e-5
# the split decode's logits against the reference's: the MoE family's at
# ``test_torch_models.py``'s MODEL_F32_TOL, which the port's single-device
# MoE decode is held to (its bf16 router rounds as the port rounds it)
REF_DECODE_TOL = {"dense": DECODE_TOL, "moe": dict(rtol=1e-5, atol=1e-5)}


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * int(np.prod(shape)))


@pytest.fixture(scope="module")
def reference():
    """Per case: the carried port params, the batch (numpy), the JAX
    reference's jitted step's loss, grad norm, params, mu, nu, and its
    jitted ``decode_fn``'s greedy run on the same weights (the tokens
    fed, the logits, the caches after)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ModelConfig as JConfig
    from repro.data import SyntheticLM as JSynthetic
    from repro.models.model_zoo import build as jbuild
    from repro.train import TrainOptions as JOptions
    from repro.train import make_train_step as jstep
    from repro.train.trainer import init_state as jinit
    out = {}
    tokens = np.asarray(JSynthetic(vocab_size=128, seq_len=16,
                                   global_batch=8).batch(0)["tokens"])
    with jax_ref_alias():
        for name, (kw, _) in CASES.items():
            japi = jbuild(JConfig(**kw))
            jparams, tparams = carried_params(japi, ModelConfig(**kw), seed=1)
            step = jax.jit(jstep(japi.loss_fn, JOptions(peak_lr=1e-3)))
            st, m = step(jinit(jparams, jax.random.PRNGKey(0)),
                         {"tokens": jnp.asarray(tokens)})
            decode = jax.jit(japi.decode_fn)
            caches = japi.init_caches(SLOTS, MAX_SEQ, jnp.float32)
            tok = jnp.asarray(np.random.default_rng(4).integers(
                0, kw["vocab_size"], (SLOTS, 1)).astype(np.int32))
            fed, logits = [], []
            for pos in range(DECODE_STEPS):
                fed.append(np.array(tok))
                lg, caches = decode(jparams, tok, caches, pos)
                logits.append(np.asarray(lg))
                tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
            out[name] = dict(
                tparams=tparams, tokens=tokens, loss=float(m["loss"]),
                grad_norm=float(m["grad_norm"]), params=st.params,
                mu=st.opt.mu, nu=st.opt.nu, fed=fed, logits=logits,
                caches=jax.tree.map(np.asarray, caches))
    return out


def _clone(tree):
    return _tree.tree_map(lambda t: t.detach().clone(), tree)


def _gathered(tree):
    return _tree.tree_map(shd.gather, tree)


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


@pytest.mark.parametrize("name", list(CASES))
def test_split_step_equals_single_device_and_reference(reference, name):
    ref = reference[name]
    batch = {"tokens": torch.as_tensor(np.array(ref["tokens"]))}
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
            leaf_tol = tol
            if "router" in str(path) and tol is not PARAM_TOL:
                steps = 7 if tol is MU_TOL else 6
                leaf_tol = dict(rtol=0, atol=2.0**-steps * np.abs(want).max())
            np.testing.assert_allclose(g, want, **leaf_tol, err_msg=str(path))
            np.testing.assert_allclose(g, s, **leaf_tol, err_msg=str(path))

    # the branch each case takes, read off the record
    ops = {(t.kind, t.op) for t in transfers}
    if name == "vocab":
        # nothing divides 3: every rank computes the whole window
        assert not [t for t in transfers if t.kind == "activation"]
    else:
        assert ("activation", "all-gather") in ops      # the carry gathered
        assert ("activation", "reduce-scatter") in ops  # partials into it
    if name == "heads3":
        assert ("activation", "all-to-all") in ops   # k, v to key blocks


def _wanted_gathers(params, mesh, p) -> list:
    """The block bytes mesh index p gathers in one window's step: its
    compute block of each leaf its own shard does not hold (once)."""
    k = mesh.shape["model"]
    r = int(np.unravel_index(p, mesh.devices.shape)[1])
    out = []
    for path, leaf in _tree.leaves_with_path(params):
        rng = shd.compute_block(path, leaf.shape, k, r)
        own = leaf.sharding.index(p, leaf.shape)
        size = [rng.get(d, (0, n)) for d, n in enumerate(leaf.shape)]
        if any(own[d].start > lo or hi > own[d].stop
               for d, (lo, hi) in enumerate(size)):
            out.append(leaf.shards[0].element_size()
                       * int(np.prod([hi - lo for lo, hi in size])))
    return sorted(out)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_each_index_gathers_only_its_block(reference, name):
    ref = reference[name]
    batch = {"tokens": torch.as_tensor(np.array(ref["tokens"]))}
    transfers = []
    _, mesh, step, placed = _split_step(name, ref["tparams"], batch,
                                        transfers)
    step(placed, batch)
    whole = {p: 0 for p in range(mesh.size)}
    for path, leaf in _tree.leaves_with_path(placed.params):
        for p in range(mesh.size):
            if len(leaf.sharding.blocks(leaf.shape)) > 1:
                whole[p] += leaf.shards[0].element_size() * int(
                    np.prod(leaf.shape))
    for p in range(mesh.size):
        got = sorted(t.nbytes for t in transfers
                     if t.kind == "weight" and t.dst == p)
        assert got == _wanted_gathers(placed.params, mesh, p), p
        # a block of each split matrix, not the matrix: under 60 % of
        # what gathering every leaf whole would take
        assert sum(got) < 0.6 * whole[p], (p, sum(got), whole[p])
    # activations move within a model row: (2j, 2j + 1)
    act = [t for t in transfers if t.kind == "activation"]
    assert act and all(t.k == 2 and t.group[0] % 2 == 0
                       and t.group[1] == t.group[0] + 1 for t in act)


def test_one_index_runs_its_share_alone(reference):
    ref = reference["dense"]
    batch = {"tokens": torch.as_tensor(np.array(ref["tokens"]))}
    transfers = []
    _, mesh, step, placed = _split_step("dense", ref["tparams"], batch,
                                        transfers)
    before = [[t.clone() for t in leaf.shards]
              for leaf in _tree.leaves(placed.opt.mu)]
    _, m = step(placed, batch, only=2)
    assert np.isfinite(float(m["loss"]))
    # window 2 = data row 2: mesh index 4, rank 0 of row (4, 5), alone
    assert {t.dst for t in transfers} == {4}
    for leaf, old in zip(_tree.leaves(placed.opt.mu), before):
        assert {p for p in range(8)
                if not torch.equal(leaf.shards[p], old[p])} <= {4}
    got = sorted(t.nbytes for t in transfers if t.kind == "weight")
    assert got == _wanted_gathers(placed.params, mesh, 4)


@pytest.mark.parametrize("name", list(CASES))
def test_split_decode_equals_single_device_and_reference(reference, name):
    ref = reference[name]
    kw, shape = CASES[name]
    cfg = ModelConfig(**kw)
    api = model_zoo.build(cfg, device="cpu")
    params = ref["tparams"]
    mesh = _mesh(shape)
    assert spmd.splits_over_model(api.decode_fn, mesh)
    caches = api.init_caches(SLOTS, MAX_SEQ, torch.float32)
    meta = model_zoo.build(cfg, device="meta")
    dims = spmd.cache_batch_dims(
        lambda b: meta.init_caches(b, MAX_SEQ, torch.float32))
    pc = shd.device_put(params, shd.param_shardings(params, mesh))
    cc = shd.device_put(caches, shd.cache_shardings(caches, mesh))
    t1 = t2 = torch.as_tensor(ref["fed"][0])
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
                                       **REF_DECODE_TOL[cfg.family])
            t1 = l1[:, -1].argmax(-1).to(torch.int32)[:, None]
            t2 = l2[:, -1].argmax(-1).to(torch.int32)[:, None]
            assert torch.equal(t1, t2)
    for path, a in _tree.leaves_with_path(caches):
        b = shd.gather(port_leaf(cc, path)).numpy()
        np.testing.assert_allclose(b, a.numpy(), **DECODE_TOL)
        want = port_leaf(ref["caches"], path)
        np.testing.assert_allclose(
            b, want, rtol=CACHE_RTOL,
            atol=CACHE_RTOL * max(1.0, np.abs(want).max()), err_msg=str(path))
    # the cache rows never move: each rank reads and writes its block
    assert not [t for t in transfers if t.kind == "cache"]
    spec = _tree.leaves(cc)[0].sharding.spec
    want = {"heads3": (None, "data", None, None, "model"),
            "vocab": (None, "data", None, None, None)}.get(
                name, (None, "data", None, "model", None))
    assert tuple(spec) == want
    ops = {t.op for t in transfers if t.kind == "activation"}
    if name == "heads3":
        assert "all-reduce" in ops      # the head_dim partial scores
