"""The split over "model" of the rwkv family (``dist.spmd`` with
``dist.annotate``'s model-axis group) against one device and the JAX
reference.

A tiny RWKV6 (2 layers, d_model 128: 2 heads of 64, d_ff 256, vocab
128, float32) on a (4 data x 2 model) mesh of ``["cpu"] * 8``, each
window on both indices of its model row:

* ``rwkv``: the carry sequence-parallel at each layer's start; the time
  mix by heads (wr / wk / wv / wg by columns, the ddlerp and the decay
  LoRA whole on every rank, the recurrence, its state and the group
  norm on the rank's head, wo by rows); the channel mix by d_ff (wk by
  columns, wv by rows, the receptance gate by wr's columns moved to the
  carry's rows by an all-to-all); decode moves each WKV state from the
  cache's key-row block to the heads' and back (an all-to-all) and
  gathers the token-shift inputs' d_model block;
* ``remat``: the same under remat "full" (the recompute repeats the
  moves);
* ``heads3``: d_model 192 (3 heads, which do not divide 2): the time
  mix whole on every rank, the channel mix still by d_ff; decode
  gathers the WKV state;
* ``r9``: ``rwkv`` decoded on (2 data x 2 model) of ``["cpu"] * 4``,
  where ``_cache_spec`` puts the data axis on the token-shift caches'
  layers (R9), so a window's rows of them cross "data".

(d_model 64, the reduced config's, has one head: nothing of the time
mix splits there.)  The train step (``rwkv``, ``remat``, ``heads3``: one
step from the reference's carried weights and its ``SyntheticLM`` batch
of 8 x 16 tokens, ``TrainOptions(peak_lr=1e-3)``) is held to the port's
single-device ``make_train_step`` and to the reference's jitted step:
loss ``rtol=1e-5``, parameters ``rtol=2e-4, atol=2e-5``, first moment
``rtol=1e-4, atol=1e-7``, second ``rtol=1e-3, atol=1e-10``.  Five greedy
decode steps of 8 slots are held to the reference's jitted
``decode_fn`` and to the port's on one device: the reference's tokens,
logits ``rtol=1e-5, atol=1e-6`` against one device and ``atol=1e-5``
against the reference (``test_torch_rwkv.py``'s: the port's one device
reads up to 3.8e-6 off it), the caches after ``rtol=1e-5`` with atol
1e-5 of the leaf's largest magnitude.  The transfer record: each
mesh index gathers exactly its compute block
(``sharding.compute_block``) of every leaf it does not hold, and no
whole time or channel mix matrix where the heads divide.  A decode
step's WKV and LoRA products (sums in float64, rounded once) equal the
chunk form's, and a window's rows or a rank's heads alone give exactly
the entries the whole call gives them.
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
from test_torch_spmd_tp_hybrid import _block_bytes, _covers
from test_torch_support import (carried_params, jax_ref_alias,  # noqa: F401
                                one_thread, port_leaf, reference_leaves,
                                reset_torch_state)

pytestmark = pytest.mark.usefixtures("one_thread")

TINY = dict(name="tiny", family="rwkv", num_layers=2, d_model=128,
            num_heads=2, num_kv_heads=2, d_ff=256, vocab_size=128,
            compute_dtype="float32", remat="none")
CASES = {
    "rwkv": (TINY, (4, 2)),
    "remat": (dict(TINY, remat="full"), (4, 2)),
    "heads3": (dict(TINY, d_model=192, num_heads=3, num_kv_heads=3),
               (4, 2)),
    "r9": (TINY, (2, 2)),
}
TRAINED = ["rwkv", "remat", "heads3"]
BATCH, SEQ = 8, 16
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
MU_TOL = dict(rtol=1e-4, atol=1e-7)
NU_TOL = dict(rtol=1e-3, atol=1e-10)
DECODE_TOL = dict(rtol=1e-5, atol=1e-6)
# the port's single-device rwkv decode reads up to 3.8e-6 off the
# reference's logits here (float32 sums in another order, largest logit
# ~1): against the reference, ``test_torch_rwkv.py``'s tolerance
REF_DECODE_TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_STEPS, SLOTS, MAX_SEQ = 5, 8, 16
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
            caches = japi.init_caches(SLOTS, MAX_SEQ, jnp.float32)
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

    # the moves each case makes, read off the record: the carry gathered
    # before each mix, wo's and wv's partial sums reduce-scattered into
    # it, the receptance gate moved to its rows
    ops = {(t.kind, t.op) for t in transfers}
    assert ("activation", "all-gather") in ops
    assert ("activation", "reduce-scatter") in ops
    assert ("activation", "all-to-all") in ops


@pytest.mark.parametrize("name", TRAINED)
def test_each_index_gathers_only_its_block(reference, name):
    ref = reference[name]
    batch = _tokens(ref)
    transfers = []
    _, mesh, step, placed = _split_step(name, ref["tparams"], batch,
                                        transfers)
    step(placed, batch)
    with_path = _tree.leaves_with_path(placed.params)
    k = mesh.shape["model"]
    model = lambda i: int(np.unravel_index(i, mesh.devices.shape)[1])
    split = CASES[name][0]["d_model"] // 64 % k == 0
    # a window is one microbatch piece; the layer stack is gathered once a
    # piece, and again by the recompute under remat "full"
    passes = 2 if CASES[name][0]["remat"] == "full" else 1
    for p in range(mesh.size):
        blocks = {path: shd.compute_block(path, leaf.shape, k, model(p))
                  for path, leaf in with_path}
        want = sorted(
            b for path, leaf in with_path
            if not _covers(leaf, p, blocks[path])
            for b in [_block_bytes(leaf, blocks[path])]
            * (passes if path[0] == "blocks" else 1))
        got = [t for t in transfers if t.kind == "weight" and t.dst == p]
        assert sorted(t.nbytes for t in got) == want, p
    # so no index gathers a whole matrix of the channel mix, nor of the
    # time mix where the heads divide the axis: each is a 1/k block; the
    # LoRAs and the vectors whole
    for path, leaf in with_path:
        block = shd.compute_block(path, leaf.shape, k, 1)
        if path[0] == "blocks" and path[-1] != "w":
            assert not block, path
        if path[-1] == "w" and path[2] in ("tmix", "cmix"):
            part = k if split or path[2] == "cmix" else 1
            assert (_block_bytes(leaf, block) * part
                    == _block_bytes(leaf, {})), path
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
    caches = api.init_caches(SLOTS, MAX_SEQ, torch.float32)
    meta = model_zoo.build(cfg, device="meta")
    dims = spmd.cache_batch_dims(
        lambda b: meta.init_caches(b, MAX_SEQ, torch.float32))
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
                                       **REF_DECODE_TOL)
            t1 = l1[:, -1].argmax(-1).to(torch.int32)[:, None]
            t2 = l2[:, -1].argmax(-1).to(torch.int32)[:, None]
            assert torch.equal(t1, t2)
            # cache rows never cross "model": each rank reads and writes
            # its block.  The token-shift rows cross "data" in every case:
            # on (4 x 2) their 2 layers do not divide "data", so they are
            # whole over it and a window's rows are copied to the other
            # data indices; on (2 x 2) the layers split over "data" (R9)
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
    layers = "data" if name == "r9" else None        # R9
    assert specs[("tmix_x",)] == specs[("cmix_x",)] == (
        layers, None, None, "model")
    assert specs[("wkv",)] == (None, "data", None, "model", None)
    # the state's key-row block to the heads' and back where the heads
    # split; gathered whole where they do not
    assert ("all-to-all" in ops) == (name != "heads3")
    assert "all-gather" in ops


def test_decode_step_is_the_chunk_form_on_any_rows_and_heads():
    # a decode step's WKV (``_wkv_step``) and LoRA products (``_lora``)
    # sum in float64, rounded once: the chunk form's values, and a
    # window's rows or a rank's heads alone give exactly the entries
    # that the whole call gives them
    from repro_torch.models import rwkv as R
    g = torch.Generator().manual_seed(0)
    b, h, n = 4, 4, 16
    r, k, v = (torch.randn(b, 1, h, n, generator=g) for _ in range(3))
    lw = -torch.exp(torch.randn(b, 1, h, n, generator=g) * 0.5 - 2)
    u = torch.randn(h, n, generator=g) * 0.1
    st = torch.randn(b, h, n, n, generator=g)
    out, state = R._wkv_step(r, k, v, lw, u, st)
    want, want_state = R._wkv_chunk(r, k, v, lw, u, st)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(state.numpy(), want_state.numpy(), rtol=1e-6,
                               atol=1e-6)
    rows, heads = slice(0, 2), slice(2, 4)
    part, part_state = R._wkv_step(
        *(t[rows, :, heads] for t in (r, k, v, lw)), u[heads],
        st[rows, heads])
    assert torch.equal(part, out[rows, :, heads])
    assert torch.equal(part_state, state[rows, heads])
    x = torch.randn(b, 1, 64, generator=g)
    w = torch.randn(64, 8, generator=g)
    lora = R._lora("bsd,de->bse", x, w)
    assert lora.dtype == torch.float32
    assert torch.equal(R._lora("bsd,de->bse", x[rows], w), lora[rows])
    np.testing.assert_allclose(lora.numpy(), (x @ w).numpy(), rtol=1e-5,
                               atol=1e-5)
