"""The sharded step executor (``dist.spmd``) against one device.

The reference test's tiny dense config (``tests/test_dist.py``: 2
layers, d_model 32, 4 heads, 2 kv heads, d_ff 64, vocab 128, float32)
and its MoE variant (4 experts, top 2) train one step on a (4 data x 2
model) mesh of ``["cpu"] * 8``, from the reference's carried weights
and its ``SyntheticLM`` batch (8 x 16), and the step is held to the
port's single-device ``make_train_step`` and to the JAX reference's
(``jax.jit(make_train_step(...))``) on the same state and batch, with
the reference test's options (``TrainOptions(peak_lr=1e-3)``: step 0
runs at lr 0, so the parameters move only by what the update writes
back) and its tolerances: loss ``rtol=1e-5``, parameters ``rtol=2e-4,
atol=2e-5``.  The gradient itself is held through the AdamW moments it
leaves: the first moment (0.1 x the clipped gradient) ``rtol=1e-4,
atol=1e-7`` — the port's float32 gradients agree with the reference's
to ~4e-7 (``test_torch_train.py``) — the second ``rtol=1e-3,
atol=1e-10``, the clip's norm ``rtol=1e-5``; the MoE router's product
runs in bf16, so its moments are held to one bf16 step of their largest
entry, as ``test_torch_train.py`` holds its gradient.  A third batch carries a
``loss_mask`` whose count differs between the data shards (15, 3, 0
and 24 tokens), so an unweighted mean of the shards' means would miss.

Port against port (no JAX): ``grad_accum`` 2 and 8 (windows inside a
microbatch, and microbatches inside a window), two steps at lr 1e-3 on
the masked batch (parameters ``rtol=2e-4, atol=2e-5``); the decode step
on sharded caches against ``decode_fn`` (logits ``rtol=1e-5,
atol=1e-6``, greedy tokens and caches equal), with the batch sharded and
with it replicated (6 slots over 4 data shards); one window's share
(``only=0``) and the transfer record.
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
CASES = [("dense", False), ("moe", False), ("dense", True), ("moe", True)]
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
MU_TOL = dict(rtol=1e-4, atol=1e-7)
NU_TOL = dict(rtol=1e-3, atol=1e-10)


def _mask():
    """(8, 15) loss mask: shard rows (0, 1) 15 + 0, (2, 3) 3 + 0, (4, 5)
    0 + 0, (6, 7) 15 + 9 valid tokens."""
    m = np.zeros((8, 15), np.float32)
    m[0, :] = 1
    m[2, :3] = 1
    m[6, :] = 1
    m[7, 3:12] = 1
    return m


def _mesh():
    return make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def reference():
    """Per case: the carried port params, the batch (numpy), and the JAX
    reference's single-device step's loss, grad norm, params, mu, nu."""
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
        for family, masked in CASES:
            kw = TINY_MOE if family == "moe" else TINY
            japi = jbuild(JConfig(**kw))
            jparams, tparams = carried_params(japi, ModelConfig(**kw), seed=1)
            batch = {"tokens": tokens}
            if masked:
                batch["loss_mask"] = _mask()
            step = jax.jit(jstep(japi.loss_fn, JOptions(peak_lr=1e-3)))
            st, m = step(jinit(jparams, jax.random.PRNGKey(0)),
                         jax.tree.map(jnp.asarray, batch))
            out[(family, masked)] = dict(
                tparams=tparams, batch=batch, loss=float(m["loss"]),
                grad_norm=float(m["grad_norm"]), params=st.params,
                mu=st.opt.mu, nu=st.opt.nu)
    return out


def _torch_batch(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def _clone(tree):
    return _tree.tree_map(lambda t: t.detach().clone(), tree)


def _sharded_step(api, cfg, params, batch, opts, mesh, transfers=None):
    state = init_state(_clone(params))
    sh = spmd.train_state_shardings(state, mesh, cfg)
    placed = shd.device_put(state, sh)
    step = spmd.make_sharded_train_step(
        api.loss_fn, opts, mesh, sh, shd.batch_shardings(batch, mesh),
        transfers=transfers)
    return step, placed


def _gathered(tree):
    return _tree.tree_map(shd.gather, tree)


@pytest.mark.parametrize("family, masked", CASES)
def test_sharded_step_equals_single_device_and_reference(reference, family,
                                                         masked):
    ref = reference[(family, masked)]
    cfg = ModelConfig(**(TINY_MOE if family == "moe" else TINY))
    api = model_zoo.build(cfg, device="cpu")
    batch = _torch_batch(ref["batch"])
    opts = TrainOptions(peak_lr=1e-3)
    mesh = _mesh()
    step, placed = _sharded_step(api, cfg, ref["tparams"], batch, opts, mesh)
    got, m = step(placed, batch)
    single, ms = make_train_step(api.loss_fn, opts)(
        init_state(_clone(ref["tparams"])), batch)

    np.testing.assert_allclose(float(m["loss"]), float(ms["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(m["loss"]), ref["loss"], **LOSS_TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), ref["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(ms["grad_norm"]), rtol=1e-5)
    for key in ms:
        np.testing.assert_allclose(float(m[key]), float(ms[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    params = _gathered(got.params)
    mu, nu = _gathered(got.opt.mu), _gathered(got.opt.nu)
    for want_tree, got_tree, single_tree, tol in (
            (ref["params"], params, single.params, PARAM_TOL),
            (ref["mu"], mu, single.opt.mu, MU_TOL),
            (ref["nu"], nu, single.opt.nu, NU_TOL)):
        for path, layer, want in reference_leaves(want_tree):
            g = port_leaf(got_tree, path, layer).numpy()
            s = port_leaf(single_tree, path, layer).detach().numpy()
            leaf_tol = tol
            if "router" in str(path) and tol is not PARAM_TOL:
                # the router's product runs in bf16, so its gradient sums
                # bf16 rows (per shard, or all at once): one bf16 step of
                # the largest entry (two for the squared moment)
                steps = 7 if tol is MU_TOL else 6
                leaf_tol = dict(rtol=0, atol=2.0**-steps * np.abs(want).max())
            np.testing.assert_allclose(g, want, **leaf_tol, err_msg=str(path))
            np.testing.assert_allclose(g, s, **leaf_tol, err_msg=str(path))
    assert int(got.step.shards[0]) == int(got.opt.step.shards[5]) == 1
    assert all(torch.equal(r, got.rng.shards[0]) for r in got.rng.shards)
    assert torch.equal(got.rng.shards[0], single.rng)


@pytest.mark.parametrize("accum", [2, 8])
def test_sharded_accumulation_and_two_steps_equal_single_device(
        reference, accum):
    ref = reference[("moe", True)]
    cfg = ModelConfig(**TINY_MOE)
    api = model_zoo.build(cfg, device="cpu")
    batch = _torch_batch(ref["batch"])
    opts = TrainOptions(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                        grad_accum=accum)
    step, state = _sharded_step(api, cfg, ref["tparams"], batch, opts,
                                _mesh())
    single = init_state(_clone(ref["tparams"]))
    one = make_train_step(api.loss_fn, opts)
    for _ in range(2):
        state, m = step(state, batch)
        single, ms = one(single, batch)
        np.testing.assert_allclose(float(m["loss"]), float(ms["loss"]),
                                   **LOSS_TOL)
    assert ms["lr"] == m["lr"] == pytest.approx(1e-3)
    for a, b in zip(_tree.leaves(_gathered(state.params)),
                    _tree.leaves(single.params)):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(),
                                   **PARAM_TOL)


def test_transfer_record_and_one_window(reference):
    ref = reference[("dense", False)]
    cfg = ModelConfig(**TINY)
    api = model_zoo.build(cfg, device="cpu")
    batch = _torch_batch(ref["batch"])
    mesh = _mesh()
    transfers = []
    step, placed = _sharded_step(api, cfg, ref["tparams"], batch,
                                 TrainOptions(peak_lr=1e-3), mesh, transfers)
    before = [[t.clone() for t in leaf.shards]
              for leaf in _tree.leaves(placed.opt.mu)]
    step(placed, batch, only=1)
    # window 1 = data row 1: compute index 2; only its shards change
    for leaf, old in zip(_tree.leaves(placed.opt.mu), before):
        changed = [p for p in range(8) if not torch.equal(leaf.shards[p],
                                                          old[p])]
        assert set(changed) <= {2}
    assert {t.dst for t in transfers} == {2}
    n_params = len(_tree.leaves(placed.params))
    by_op = {}
    for t in transfers:
        by_op.setdefault(t.op, []).append(t)
    # every multi-block parameter gathered once, reduced once
    split = [leaf for leaf in _tree.leaves(placed.params)
             if len(leaf.sharding.blocks(leaf.shape)) > 1]
    assert len(by_op["all-gather"]) == len(split)
    assert sum(t.nbytes for t in by_op["all-gather"]) == sum(
        leaf.shards[0].element_size() * int(np.prod(leaf.shape))
        for leaf in split)
    assert len(by_op["reduce-scatter"]) + sum(
        t.k == 4 for t in by_op["all-reduce"]) == n_params
    assert all(t.k == 8 and t.nbytes == 4 for t in by_op["all-reduce"]
               if t.k != 4)


@pytest.mark.parametrize("family, slots", [("dense", 8), ("moe", 8),
                                           ("dense", 6)])
def test_sharded_decode_equals_single_device(family, slots):
    cfg = ModelConfig(**(TINY_MOE if family == "moe" else TINY))
    api = model_zoo.build(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(3))
    mesh = _mesh()
    caches = api.init_caches(slots, 16, torch.float32)
    meta = model_zoo.build(cfg, device="meta")
    dims = spmd.cache_batch_dims(lambda b: meta.init_caches(b, 16,
                                                            torch.float32))
    assert _tree.leaves(dims) == [1, 1]
    pc = shd.device_put(params, shd.param_shardings(params, mesh))
    cc = shd.device_put(caches, shd.cache_shardings(caches, mesh))
    tok = torch.randint(0, cfg.vocab_size, (slots, 1),
                        generator=torch.Generator().manual_seed(4),
                        dtype=torch.int32)
    t1, t2 = tok, tok.clone()
    for pos in range(5):
        transfers = []
        l1, caches = api.decode_fn(params, t1, caches, pos)
        l2, cc = spmd.sharded_decode_step(api.decode_fn, mesh, pc, t2, cc,
                                          pos, batch_dims=dims,
                                          transfers=transfers)
        np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=1e-5,
                                   atol=1e-6)
        t1 = l1[:, -1].argmax(-1).to(torch.int32)[:, None]
        t2 = l2[:, -1].argmax(-1).to(torch.int32)[:, None]
        assert torch.equal(t1, t2)
    for a, b in zip(_tree.leaves(caches), _tree.leaves(cc)):
        np.testing.assert_allclose(shd.gather(b).numpy(), a.numpy(),
                                   rtol=1e-5, atol=1e-6)
    ops = {t.op for t in transfers}
    assert ops == {"all-gather", "copy"}
    windows = 4 if slots % 4 == 0 else 1
    assert sum(t.op == "all-gather" and t.k == windows and t.dst == 0
               for t in transfers) == (1 if windows > 1 else 0)


def test_sharded_forward_equals_loss(reference):
    ref = reference[("moe", True)]
    cfg = ModelConfig(**TINY_MOE)
    api = model_zoo.build(cfg, device="cpu")
    batch = _torch_batch(ref["batch"])
    mesh = _mesh()
    params = ref["tparams"]
    pc = shd.device_put(params, shd.param_shardings(params, mesh))
    bc = shd.device_put(batch, shd.batch_shardings(batch, mesh))
    loss, metrics = spmd.sharded_forward(api.loss_fn, mesh, pc, bc)
    with torch.no_grad():
        want, wm = api.loss_fn(params, batch)
    np.testing.assert_allclose(float(loss), float(want), **LOSS_TOL)
    for key in wm:
        np.testing.assert_allclose(float(metrics[key]), float(wm[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
