"""The split over "model" of the vlm and encdec families (``dist.spmd``
with ``dist.annotate``'s model-axis group) against one device and the
JAX reference.

Tiny configs in the style of ``test_torch_spmd_tp.py``'s (2 layers,
encdec 2 + 2, d_model 32, 4 heads, 2 kv heads, d_ff 64, vocab 128,
float32) on a (4 data x 2 model) mesh of ``["cpu"] * 8``, each window
on both indices of its model row:

* ``vlm``: an 8-slot patch prefix (``patch_valid``: every rank of a row
  packs its window's rows) ahead of 8 text tokens; the prefix joins the
  vocabulary-split embedding before the sequence-parallel carry, the
  logits are sliced rank by rank;
* ``encdec``: 8 frames (``frame_valid``: the pack) and 8 target tokens;
  heads over "model" in the encoder's, the decoder's and the cross
  attention, the cross keys and values from the encoder states gathered
  over "model"; decode reads the kv-head block of the self and of the
  primed cross caches;
* ``heads3``: encdec with 3 heads (1 kv head, d_model 24), which do not
  divide 2: the keys split instead (the sequence in self-attention, the
  frames in cross attention), and decode reads the head_dim block of
  both caches (the partial scores summed).

The train step (one step from the reference's carried weights,
``TrainOptions(peak_lr=1e-3)``, seeded numpy batches) is held to the
port's single-device ``make_train_step`` and to the reference's jitted
step: loss ``rtol=1e-5``, parameters ``rtol=2e-4, atol=2e-5``, first
moment ``rtol=1e-4, atol=1e-7``, second ``rtol=1e-3, atol=1e-10``.  Five
greedy decode steps of 8 slots (encdec: the cross caches primed from one
encode on one device, placed by ``cache_shardings``) are held to the
reference's jitted ``decode_fn`` and to the port's on one device: the
reference's tokens, logits ``rtol=1e-5, atol=1e-6``, the caches after
(against the reference ``rtol=1e-5`` with atol 1e-5 of the leaf's
largest magnitude).  ``prime_cross`` on a model-axis group makes each
rank's block of the cross K/V.  The transfer record: each mesh index
gathers exactly its compute block (``sharding.compute_block``) of every
leaf it does not hold, the encoder's, the decoder's and the cross
attention's included.
"""

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import annotate as ann
from repro_torch.dist import spmd
from repro_torch.dist import sharding as shd
from repro_torch.models import encdec as E
from repro_torch.models import model_zoo
from repro_torch.train import TrainOptions, make_train_step
from repro_torch.train.trainer import init_state
from test_torch_spmd_tp import _clone, _gathered, _mesh, _wanted_gathers
from test_torch_support import (carried_params, jax_ref_alias,  # noqa: F401
                                one_thread, port_leaf, reference_leaves,
                                reset_torch_state)

pytestmark = pytest.mark.usefixtures("one_thread")

TINY = dict(name="tiny", num_layers=2, d_model=32, num_heads=4,
            num_kv_heads=2, d_ff=64, vocab_size=128, head_dim=8,
            compute_dtype="float32", remat="none", attn_chunk=8)
TINY_VLM = dict(TINY, family="vlm", frontend="patch", frontend_seq=8)
TINY_ENCDEC = dict(TINY, family="encdec", encoder_layers=2,
                   frontend="frames")
CASES = {
    "vlm": TINY_VLM,
    "encdec": TINY_ENCDEC,
    "heads3": dict(TINY_ENCDEC, num_heads=3, num_kv_heads=1, d_model=24),
}
MESH = (4, 2)
BATCH, PREFIX, TEXT = 8, 8, 8
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
MU_TOL = dict(rtol=1e-4, atol=1e-7)
NU_TOL = dict(rtol=1e-3, atol=1e-10)
DECODE_TOL = dict(rtol=1e-5, atol=1e-6)
DECODE_STEPS, SLOTS, MAX_SEQ = 5, 8, 16
FRAMES = max(MAX_SEQ // 2, 8)      # the cross caches' frames (model_zoo)
CACHE_RTOL = 1e-5


def _batch(kw, rng) -> dict:
    """A train batch of the family, numpy: the vlm's patch prefix with
    ``patch_valid``, the encdec's frames with ``frame_valid``."""
    d = kw["d_model"]
    key = "patch_valid" if kw["family"] == "vlm" else "frame_valid"
    return {
        "tokens": rng.integers(0, kw["vocab_size"], (BATCH, TEXT)).astype(
            np.int32),
        "frontend_embeds": (rng.standard_normal((BATCH, PREFIX, d))
                            * 0.5).astype(np.float32),
        key: rng.random((BATCH, PREFIX)) < 0.75,
    }


@pytest.fixture(scope="module")
def reference():
    """Per case: the carried port params, the train batch and the decode
    frames (numpy), the JAX reference's jitted step's loss, grad norm,
    params, mu, nu, and its jitted ``decode_fn``'s greedy run on the same
    weights (encdec: from cross caches primed by one encode of the
    frames): the tokens fed, the logits, the caches after, the primed
    cross K/V."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ModelConfig as JConfig
    from repro.models import encdec as jE
    from repro.models.model_zoo import build as jbuild
    from repro.train import TrainOptions as JOptions
    from repro.train import make_train_step as jstep
    from repro.train.trainer import init_state as jinit
    out = {}
    with jax_ref_alias():
        for name, kw in CASES.items():
            jcfg = JConfig(**kw)
            japi = jbuild(jcfg)
            jparams, tparams = carried_params(japi, ModelConfig(**kw), seed=1)
            rng = np.random.default_rng(2)
            batch = _batch(kw, rng)
            frames = rng.standard_normal(
                (SLOTS, FRAMES, kw["d_model"])).astype(np.float32)
            step = jax.jit(jstep(japi.loss_fn, JOptions(peak_lr=1e-3)))
            st, m = step(jinit(jparams, jax.random.PRNGKey(0)),
                         {k: jnp.asarray(v) for k, v in batch.items()})
            decode = jax.jit(japi.decode_fn)
            caches = japi.init_caches(SLOTS, MAX_SEQ, jnp.float32)
            cross = None
            if kw["family"] == "encdec":
                enc = jE.encode(jparams, jnp.asarray(frames), jcfg)
                cross = jE.prime_cross(jparams, enc, jcfg, jnp.float32)
                caches["cross"] = cross
                cross = jax.tree.map(np.asarray, cross)
            tok = jnp.asarray(np.random.default_rng(4).integers(
                0, kw["vocab_size"], (SLOTS, 1)).astype(np.int32))
            fed, logits = [], []
            for pos in range(DECODE_STEPS):
                fed.append(np.array(tok))
                lg, caches = decode(jparams, tok, caches, pos)
                logits.append(np.asarray(lg))
                tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
            out[name] = dict(
                tparams=tparams, batch=batch, frames=frames,
                loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                params=st.params, mu=st.opt.mu, nu=st.opt.nu, fed=fed,
                logits=logits, caches=jax.tree.map(np.asarray, caches),
                cross=cross)
    return out


def _torch_batch(batch) -> dict:
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def _split_step(name, params, batch, transfers=None):
    cfg = ModelConfig(**CASES[name])
    api = model_zoo.build(cfg, device="cpu")
    mesh = _mesh(MESH)
    assert spmd.splits_over_model(api.loss_fn, mesh)
    state = init_state(_clone(params))
    sh = spmd.train_state_shardings(state, mesh, cfg)
    step = spmd.make_sharded_train_step(
        api.loss_fn, TrainOptions(peak_lr=1e-3), mesh, sh,
        shd.batch_shardings(batch, mesh), transfers=transfers)
    return api, mesh, step, shd.device_put(state, sh)


def test_the_families_split_and_the_recurrent_ones_do_not():
    mesh = _mesh(MESH)
    # every family splits now (rwkv the last); none on a mesh whose
    # "model" axis has one index
    assert model_zoo.MODEL_SPLIT_FAMILIES == (
        "dense", "moe", "vlm", "encdec", "hybrid", "rwkv")
    for family in model_zoo.MODEL_SPLIT_FAMILIES:
        api = model_zoo.build(ModelConfig(**dict(TINY_ENCDEC, family=family)),
                              device="meta")
        assert spmd.splits_over_model(api.loss_fn, mesh), family
        assert spmd.splits_over_model(api.decode_fn, mesh), family
        assert not spmd.splits_over_model(api.loss_fn, _mesh((8, 1)))
        assert not spmd.splits_over_model(api.decode_fn, _mesh((8, 1)))


@pytest.mark.parametrize("name", list(CASES))
def test_split_step_equals_single_device_and_reference(reference, name):
    ref = reference[name]
    batch = _torch_batch(ref["batch"])
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


@pytest.mark.parametrize("name", list(CASES))
def test_each_index_gathers_only_its_block(reference, name):
    ref = reference[name]
    batch = _torch_batch(ref["batch"])
    transfers = []
    _, mesh, step, placed = _split_step(name, ref["tparams"], batch,
                                        transfers)
    step(placed, batch)
    stacks = ("enc_blocks", "dec_blocks") if name != "vlm" else ("blocks",)
    with_path = _tree.leaves_with_path(placed.params)
    assert {p[0] for p, _ in with_path} >= set(stacks)
    if name != "vlm":
        assert any("cross_attn" in p for p, _ in with_path)
    whole = {p: 0 for p in range(mesh.size)}
    for path, leaf in with_path:
        if len(leaf.sharding.blocks(leaf.shape)) > 1:
            for p in range(mesh.size):
                whole[p] += leaf.shards[0].element_size() * int(
                    np.prod(leaf.shape))
    for p in range(mesh.size):
        got = sorted(t.nbytes for t in transfers
                     if t.kind == "weight" and t.dst == p)
        assert got == _wanted_gathers(placed.params, mesh, p), p
        assert sum(got) < 0.6 * whole[p], (p, sum(got), whole[p])
    # every matrix of the cross attention is a block, never the whole
    k = mesh.shape["model"]
    for path, leaf in with_path:
        if "cross_attn" in path and leaf.ndim == 2:
            assert shd.compute_block(path, leaf.shape, k, 1), path
    act = [t for t in transfers if t.kind == "activation"]
    assert act and all(t.k == 2 and t.group[0] % 2 == 0
                       and t.group[1] == t.group[0] + 1 for t in act)


def _primed(name, ref, api, cfg, params):
    """The decode caches: the self caches empty, encdec's cross caches
    primed on one device from one encode of the frames."""
    caches = api.init_caches(SLOTS, MAX_SEQ, torch.float32)
    if cfg.family == "encdec":
        with torch.no_grad():
            enc = E.encode(params, torch.as_tensor(ref["frames"]), cfg)
            caches["cross"] = E.prime_cross(params, enc, cfg, torch.float32)
    return caches


@pytest.mark.parametrize("name", list(CASES))
def test_split_decode_equals_single_device_and_reference(reference, name):
    ref = reference[name]
    cfg = ModelConfig(**CASES[name])
    api = model_zoo.build(cfg, device="cpu")
    params = ref["tparams"]
    mesh = _mesh(MESH)
    assert spmd.splits_over_model(api.decode_fn, mesh)
    caches = _primed(name, ref, api, cfg, params)
    meta = model_zoo.build(cfg, device="meta")
    dims = spmd.cache_batch_dims(
        lambda b: meta.init_caches(b, MAX_SEQ, torch.float32))
    pc = shd.device_put(params, shd.param_shardings(params, mesh))
    cc = shd.device_put(caches, shd.cache_shardings(caches, mesh))
    t1 = t2 = torch.as_tensor(ref["fed"][0])
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
            # the cache rows never move: each rank reads and writes its
            # block, the cross caches' too
            assert not [t for t in transfers if t.kind == "cache"]
            ops |= {t.op for t in transfers if t.kind == "activation"}
    for path, a in _tree.leaves_with_path(caches):
        b = shd.gather(port_leaf(cc, path)).numpy()
        np.testing.assert_allclose(b, a.numpy(), **DECODE_TOL)
        want = port_leaf(ref["caches"], path)
        np.testing.assert_allclose(
            b, want, rtol=CACHE_RTOL,
            atol=CACHE_RTOL * max(1.0, np.abs(want).max()), err_msg=str(path))
    want = ((None, "data", None, None, "model") if name == "heads3"
            else (None, "data", None, "model", None))
    assert {tuple(c.sharding.spec) for c in _tree.leaves(cc)} == {want}
    if name == "heads3":
        assert "all-reduce" in ops      # the head_dim partial scores


@pytest.mark.parametrize("name", ["encdec", "heads3"])
def test_prime_cross_on_a_group_makes_each_ranks_block(reference, name):
    ref = reference[name]
    cfg = ModelConfig(**CASES[name])
    params = ref["tparams"]
    mesh = _mesh(MESH)
    row = (0, 1)
    group = ann.ModelGroup(mesh, ["cpu", "cpu"], range(2))
    pc = shd.device_put(params, shd.param_shardings(params, mesh))
    tree, _ = spmd._placed_params(pc, row, None, group=group)
    with torch.no_grad():
        enc = E.encode(params, torch.as_tensor(ref["frames"]), cfg)
        whole = E.prime_cross(params, enc, cfg, torch.float32)
        f = enc.shape[1] // 2
        parts = group.parts({r: enc[:, r * f:(r + 1) * f] for r in range(2)},
                            1)                 # the carry's placement
        got = E.prime_cross(tree, parts, cfg, torch.float32)
    # kv heads where they divide the axis, else head_dim: the caches' rule
    d = 4 if name == "heads3" else 3
    for key in ("k", "v"):
        assert got[key].dim == d
        n = whole[key].shape[d] // 2
        for r in range(2):
            block = got[key].t[r]
            np.testing.assert_array_equal(
                block.numpy(), whole[key].narrow(d, r * n, n).numpy())
            want = np.take(ref["cross"][key], range(r * n, (r + 1) * n),
                           axis=d)
            np.testing.assert_allclose(
                block.numpy(), want, rtol=CACHE_RTOL,
                atol=CACHE_RTOL * max(1.0, np.abs(want).max()))
