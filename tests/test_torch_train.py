"""Training in the port against the JAX reference: AdamW, schedules, one
train step of a tiny dense and a tiny MoE model, gradient accumulation,
exact resume, the data pipeline, ``rescale_gradients`` and the launcher.

The reference's weights are carried across (``carried_params``) and the
reference's ``SyntheticLM`` batches feed both trainers (the port's
pipeline draws other tokens from the same seed).  Tolerances:
* one train step: loss ``rtol=1e-5``, grad norm ``rtol=1e-5``, float32
  gradients ``atol=1e-6`` (they agree to ~4e-7 at |g| <= 0.24), the
  bf16 router's gradients to one bf16 step of their largest entry
  (``atol = 2**-7 * max|g|``);
* the updated parameters: AdamW's first step is ``lr * sign(g)``
  (``mhat / sqrt(vhat)`` is +-1), so an entry whose tiny gradient takes
  the other sign, or sits near ``eps``, moves up to 2 lr apart.  Every
  entry within ``2.5 * lr``, at most 0.1 % of a leaf's entries more than
  ``1e-6`` apart;
* losses over several steps ``rtol=1e-4``.
"""

import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch.configs.base import ModelConfig
from repro_torch.data import SyntheticLM
from repro_torch.dist.fault import rescale_gradients
from repro_torch.kernels import ops as kops
from repro_torch.models import hybrid, model_zoo
from repro_torch.optim import adamw_init, adamw_update, make_schedule
from repro_torch.optim.schedules import cosine_schedule, wsd_schedule
from repro_torch.train import TrainOptions, Trainer, make_train_step
from repro_torch.train.trainer import init_state
from test_torch_support import (carried_params, jax_ref,  # noqa: F401
                                jax_ref_alias, one_thread, port_leaf,
                                reference_leaves, reset_torch_state)

pytestmark = pytest.mark.usefixtures("one_thread")

TINY = dict(name="tiny", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
            head_dim=16, compute_dtype="float32", remat="none",
            attn_chunk=8)
TINY_MOE = dict(TINY, family="moe", num_experts=4, num_experts_per_tok=2)
CFG = ModelConfig(**TINY)
LR = 1e-3
STEP_OPTS = dict(peak_lr=LR, warmup_steps=0, total_steps=100)


# -- AdamW and schedules -------------------------------------------------------

def _adamw_inputs(seed, bf16=False):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((8, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    grads = [{"w": rng.standard_normal((8, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32)}}
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("case", ["plain", "master", "clipped"])
def test_adamw_update_matches_reference(jax_ref, case):
    """Three consecutive updates (bias corrections at steps 1-3) on the
    same numpy params and grads.  ``master``: bf16 live params with a
    float32 master; ``clipped``: gradients 1e3 x, clipped to norm 1."""
    import jax
    import jax.numpy as jnp
    from repro.optim import adamw_init as j_init, adamw_update as j_update
    params, grads = _adamw_inputs(0)
    gmul = 1e3 if case == "clipped" else 1.0
    bf16 = case == "master"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                             torch.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), params)
    tp = _tree.tree_map(lambda a: torch.as_tensor(a).to(tdt, copy=True),
                        params)
    js, ts = j_init(jp, keep_master=bf16), adamw_init(tp, keep_master=bf16)
    for g in grads:
        jg = jax.tree.map(lambda a: jnp.asarray(a * gmul), g)
        tg = _tree.tree_map(lambda a: torch.as_tensor(a * gmul), g)
        jp, js, jm = j_update(jp, jg, js, jnp.float32(0.01))
        tp, ts, tm = adamw_update(tp, tg, ts, 0.01)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    for want, got in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
        for path, w in reference_leaves(want):
            g_ = port_leaf(got, path).to(torch.float32).numpy()
            np.testing.assert_allclose(g_, w, rtol=1e-5, atol=1e-7)
    assert (ts.master is None) == (js.master is None) == (not bf16)
    if bf16:
        for path, w in reference_leaves(js.master):
            np.testing.assert_allclose(port_leaf(ts.master, path).numpy(), w,
                                       rtol=1e-6, atol=1e-7)
        assert port_leaf(tp, ("w",)).dtype == torch.bfloat16


def test_clip_by_global_norm_matches_reference():
    import jax
    import jax.numpy as jnp
    from repro.optim.adamw import clip_by_global_norm as j_clip
    from repro_torch.optim.adamw import clip_by_global_norm
    _, grads = _adamw_inputs(2)
    for max_norm in (0.5, 1e3):
        jg, jn = j_clip(jax.tree.map(jnp.asarray, grads[0]), max_norm)
        tg, tn = clip_by_global_norm(_tree.tree_map(torch.as_tensor,
                                                    grads[0]), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for path, w in reference_leaves(jg):
            np.testing.assert_allclose(port_leaf(tg, path).numpy(), w,
                                       rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("bf16", [False, True])
def test_adamw_update_writes_the_given_state_in_place(bf16):
    """The update returns the parameter, moment and master tensors it
    was given, holding the new values (bf16 live parameters are their
    float32 master rounded)."""
    params, grads = _adamw_inputs(1)
    dt = torch.bfloat16 if bf16 else torch.float32
    p = _tree.tree_map(lambda a: torch.as_tensor(a).to(dt, copy=True),
                       params)
    s = adamw_init(p, keep_master=bf16)
    given = _tree.leaves((p, s.mu, s.nu, s.master))
    before = [t.clone() for t in given]
    for g in grads:
        p, s, _ = adamw_update(p, _tree.tree_map(torch.as_tensor, g), s,
                               0.01)
    after = _tree.leaves((p, s.mu, s.nu, s.master))
    assert len(after) == len(given) and int(s.step) == len(grads)
    for a, b, old in zip(after, given, before):
        assert a is b and not torch.equal(a, old)
    if bf16:
        for live, master in zip(_tree.leaves(p), _tree.leaves(s.master)):
            assert torch.equal(live, master.to(torch.bfloat16))


class TestAdamW:
    """The reference's AdamW tests, mirrored."""

    def test_descends_quadratic(self):
        params = {"w": torch.tensor([3.0, -2.0])}
        state = adamw_init(params)
        for _ in range(200):
            grads = {"w": 2 * params["w"]}
            params, state, _ = adamw_update(params, grads, state, 0.05,
                                            weight_decay=0.0)
        assert float(params["w"].abs().max()) < 0.1

    def test_weight_decay_shrinks(self):
        params = {"w": torch.ones(4)}
        state = adamw_init(params)
        p2, _, _ = adamw_update(params, {"w": torch.zeros(4)}, state, 0.1,
                                weight_decay=0.5)
        assert float(p2["w"][0]) < 1.0

    def test_clipping_reported(self):
        params = {"w": torch.ones(4)}
        state = adamw_init(params)
        _, _, m = adamw_update(params, {"w": torch.full((4,), 1e6)}, state,
                               0.1, max_grad_norm=1.0)
        assert float(m["grad_norm"]) > 1e5


def test_schedules_match_reference_at_integer_steps():
    import jax.numpy as jnp
    from repro.optim import schedules as js
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    for step in list(range(0, 101, 3)) + [9, 10, 11, 89, 90, 91, 100, 130]:
        s = jnp.asarray(step, jnp.float32)
        for port, ref in ((cosine_schedule, js.cosine_schedule),
                          (wsd_schedule, js.wsd_schedule)):
            np.testing.assert_allclose(port(step, **kw), float(ref(s, **kw)),
                                       rtol=2e-6, err_msg=f"step {step}")
        np.testing.assert_allclose(
            make_schedule("wsd", **kw)(step),
            float(js.make_schedule("wsd", **kw)(s)), rtol=2e-6)


class TestSchedules:
    """The reference's schedule tests, mirrored."""

    def test_wsd_three_phases(self):
        f = lambda s: wsd_schedule(s, peak_lr=1.0, warmup_steps=100,
                                   total_steps=1000)
        assert f(50) == pytest.approx(0.5, rel=1e-3)
        assert f(500) == pytest.approx(1.0)
        assert f(899) == pytest.approx(1.0)
        assert f(950) < 0.2
        assert f(1000) == pytest.approx(0.01, rel=1e-2)

    def test_cosine_monotone_after_peak(self):
        f = make_schedule("cosine", peak_lr=1.0, warmup_steps=10,
                          total_steps=100)
        vals = [f(s) for s in range(10, 100, 10)]
        assert all(a >= b for a, b in zip(vals, vals[1:]))


# -- one train step against the reference ------------------------------------

# The families trained at their reduced configs (the reference's
# ``reduced``: 2 layers, d_model 64, float32), batch 2 x 32 from the
# reference's ``make_batch``.
REDUCED_ARCHS = {"rwkv": "rwkv6-7b", "hybrid": "zamba2-2.7b",
                 "vlm": "internvl2-26b", "encdec": "seamless-m4t-large-v2"}
# Gradients of the recurrent families are held as their own test files
# hold them (test_torch_rwkv.py, test_torch_ssm_hybrid.py): rtol 1e-4,
# atol 1e-4 of the leaf's largest magnitude (the WKV and SSD chunk forms
# sum in another order than the reference's).
RECURRENT = ("rwkv", "hybrid")


@pytest.fixture(scope="module", params=["dense", "moe"] + list(REDUCED_ARCHS))
def stepped(request):
    """One reference train step (jitted once a family) and its inputs:
    the carried weights, the reference batch of step 0 and the
    reference's gradients, plus three further steps' losses."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get
    from repro.configs import reduced as j_reduced
    from repro.configs.base import ModelConfig as JCfg
    from repro.data import SyntheticLM as JData
    from repro.models import model_zoo as jzoo
    from repro.train import TrainOptions as JOpts
    from repro.train import make_train_step as j_make
    from repro.train.trainer import init_state as j_init
    family = request.param
    with jax_ref_alias():
        if family in REDUCED_ARCHS:
            jcfg = j_reduced(j_get(REDUCED_ARCHS[family]))
            japi = jzoo.build(jcfg)
            batches = [jax.tree.map(np.asarray, japi.make_batch(
                jax.random.PRNGKey(s), 2, 32)) for s in range(4)]
        else:
            jcfg = JCfg(**(TINY if family == "dense" else TINY_MOE))
            japi = jzoo.build(jcfg)
            data = JData(vocab_size=128, seq_len=16, global_batch=4)
            batches = [{"tokens": np.array(data.batch(s)["tokens"])}
                       for s in range(4)]
        tcfg = ModelConfig(**dataclasses.asdict(jcfg))
        jparams, tparams = carried_params(japi, tcfg, seed=3)
        jbatches = [jax.tree.map(jnp.asarray, b) for b in batches]
        jstep = jax.jit(j_make(japi.loss_fn, JOpts(**STEP_OPTS)))
        jgrads = jax.jit(jax.grad(lambda p, b: japi.loss_fn(p, b)[0]))(
            jparams, jbatches[0])
        jstate = j_init(jparams, jax.random.PRNGKey(0))
        losses, metrics0, params1 = [], None, None
        for i, b in enumerate(jbatches):
            jstate, m = jstep(jstate, b)
            losses.append(float(m["loss"]))
            if i == 0:
                metrics0 = {k: float(v) for k, v in m.items()}
                params1 = jax.tree.map(np.asarray, jstate.params)
    return dict(family=family, tcfg=tcfg, tparams=tparams,
                batches=batches, jgrads=jgrads, metrics0=metrics0,
                params1=params1, losses=losses)


def _batch(b):
    return {k: torch.as_tensor(np.array(v)) for k, v in b.items()}


def _port_step(stepped, **opts):
    api = model_zoo.build(stepped["tcfg"], device="cpu")
    caught = {}
    hook = lambda p, g: caught.update(grads=_tree.tree_map(
        lambda x: x.detach().clone(), g))
    step = make_train_step(api.loss_fn, TrainOptions(**STEP_OPTS, **opts),
                           grad_hook=hook)
    params = _tree.tree_map(lambda t: t.clone(), stepped["tparams"])
    return step, init_state(params, 0), caught


def test_train_step_matches_reference(stepped):
    step, state, caught = _port_step(stepped)
    state, m = step(state, _batch(stepped["batches"][0]))
    want = stepped["metrics0"]
    assert set(want) <= set(m)
    for k in want:
        np.testing.assert_allclose(float(m[k]), want[k],
                                   rtol=1e-6 if k == "lr" else 1e-5,
                                   atol=1e-6, err_msg=k)
    routers = 0
    recurrent = stepped["family"] in RECURRENT
    for path, g in reference_leaves(stepped["jgrads"]):
        got = port_leaf(caught["grads"], path).numpy()
        if "router" in str(path):
            routers += 1
            assert np.abs(g).max() > 0, "reference router gradient is zero"
            np.testing.assert_allclose(got, g, rtol=0,
                                       atol=2.0**-7 * np.abs(g).max())
        elif recurrent:
            np.testing.assert_allclose(got, g, rtol=1e-4,
                                       atol=1e-4 * np.abs(g).max(),
                                       err_msg=str(path))
        else:
            np.testing.assert_allclose(got, g, rtol=0, atol=1e-6,
                                       err_msg=str(path))
    assert routers == (2 if stepped["family"] == "moe" else 0)
    for path, want_p in reference_leaves(stepped["params1"]):
        got = port_leaf(state.params, path).detach().numpy()
        diff = np.abs(got - want_p)
        assert diff.max() <= 2.5 * LR, (path, diff.max())
        assert (diff > 1e-6).mean() <= 1e-3, (path, (diff > 1e-6).mean())


def test_train_steps_follow_reference_losses(stepped):
    step, state, _ = _port_step(stepped)
    losses = []
    for b in stepped["batches"]:
        state, m = step(state, _batch(b))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, stepped["losses"], rtol=1e-4)
    assert int(state.step) == len(stepped["batches"])


def test_remat_full_recomputes_each_layer_and_changes_nothing(
        stepped, monkeypatch):
    """``remat="full"`` runs each layer stack's body again in the
    backward pass (a layer; a hybrid group; each encoder and decoder
    layer; an MoE layer routes again: moe_route twice a layer) and gives
    the same loss and gradients."""
    from repro_torch.models import layers
    bodies, routes = [], []
    real_route, real_scan = kops.moe_route_transform, layers.scan

    def counted_scan(cfg, body, carry, xs):
        return real_scan(cfg, lambda c, x: bodies.append(1) or body(c, x),
                         carry, xs)

    monkeypatch.setattr(kops, "moe_route_transform",
                        lambda *a, **k: routes.append(1) or real_route(*a,
                                                                        **k))
    monkeypatch.setattr(layers, "scan", counted_scan)
    batch = _batch(stepped["batches"][0])
    out = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(stepped["tcfg"], remat=remat)
        api = model_zoo.build(cfg, device="cpu")
        params = _tree.tree_map(lambda t: t.clone().requires_grad_(True),
                                stepped["tparams"])
        bodies.clear()
        routes.clear()
        loss, _ = api.loss_fn(params, batch)
        fwd = (len(bodies), len(routes))
        grads = torch.autograd.grad(loss, _tree.leaves(params))
        out[remat] = (loss.detach(), grads, fwd, (len(bodies), len(routes)))
    cfg = stepped["tcfg"]
    family = stepped["family"]
    if family == "hybrid":
        bodies_a_pass = hybrid.n_groups(cfg)[0]
    elif family == "encdec":
        bodies_a_pass = cfg.encoder_layers + cfg.num_layers
    else:
        bodies_a_pass = cfg.num_layers
    routes_a_pass = cfg.num_layers if family == "moe" else 0
    once = (bodies_a_pass, routes_a_pass)
    twice = (2 * bodies_a_pass, 2 * routes_a_pass)
    assert out["none"][2:] == (once, once)
    assert out["full"][2:] == (once, twice)
    assert torch.equal(out["none"][0], out["full"][0])
    for a, b in zip(out["none"][1], out["full"][1]):
        assert torch.equal(a, b)


def _reference_grad_check(path, got, want, family):
    """``test_train_step_matches_reference``'s tolerance for one gradient
    leaf."""
    if "router" in str(path):
        tol = dict(rtol=0, atol=2.0**-7 * np.abs(want).max())
    elif family in RECURRENT:
        tol = dict(rtol=1e-4, atol=1e-4 * np.abs(want).max())
    else:
        tol = dict(rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, **tol, err_msg=str(path))


def test_sharded_remat_full_step_matches_reference(stepped):
    """The sharded executor's step under remat "full" (``dist.spmd`` on a
    (2 data x 2 model) mesh of ``["cpu"] * 4``: each layer gathered
    inside its checkpointed body, again by the recompute, its gradient
    reduced by ``_GatherLayer``'s backward) against the reference's step
    and the port's single-device one.  Against the reference: the
    metrics and parameters as ``test_train_step_matches_reference``
    holds them, and the gradient, read back from the first moment (0.1 x
    the clipped gradient), at that test's gradient tolerances.  Against
    one device: every metric ``rtol=1e-5, atol=1e-7`` and the first
    moment ``rtol=1e-4, atol=1e-7`` (``test_torch_spmd.py``'s; the
    router's one bf16 step of its largest entry)."""
    from repro_torch.dist import make_mesh, spmd
    from repro_torch.dist import sharding as shd
    cfg = dataclasses.replace(stepped["tcfg"], remat="full")
    api = model_zoo.build(cfg, device="cpu")
    opts = TrainOptions(**STEP_OPTS)
    batch = _batch(stepped["batches"][0])
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    state = init_state(_tree.tree_map(lambda t: t.clone(),
                                      stepped["tparams"]), 0)
    sh = spmd.train_state_shardings(state, mesh, cfg)
    step = spmd.make_sharded_train_step(api.loss_fn, opts, mesh, sh,
                                        shd.batch_shardings(batch, mesh))
    got, m = step(shd.device_put(state, sh), batch)
    single, ms = make_train_step(api.loss_fn, opts)(
        init_state(_tree.tree_map(lambda t: t.clone(), stepped["tparams"]),
                   0), batch)
    want = stepped["metrics0"]
    for k in want:
        np.testing.assert_allclose(float(m[k]), want[k],
                                   rtol=1e-6 if k == "lr" else 1e-5,
                                   atol=1e-6, err_msg=k)
    for k in ms:
        np.testing.assert_allclose(float(m[k]), float(ms[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    clip = min(1.0, opts.max_grad_norm / want["grad_norm"])
    for path, g in reference_leaves(stepped["jgrads"]):
        mu = shd.gather(port_leaf(got.opt.mu, path)).numpy()
        one = port_leaf(single.opt.mu, path).numpy()
        tol = (dict(rtol=0, atol=2.0**-7 * np.abs(one).max())
               if "router" in str(path) else dict(rtol=1e-4, atol=1e-7))
        np.testing.assert_allclose(mu, one, **tol, err_msg=str(path))
        _reference_grad_check(path, mu / ((1 - opts.b1) * clip), g,
                              stepped["family"])
    for path, want_p in reference_leaves(stepped["params1"]):
        diff = np.abs(shd.gather(port_leaf(got.params, path)).numpy()
                      - want_p)
        assert diff.max() <= 2.5 * LR, (path, diff.max())
        assert (diff > 1e-6).mean() <= 1e-3, (path, (diff > 1e-6).mean())


# -- the reference's training tests, mirrored ---------------------------------

def test_loss_goes_down():
    api = model_zoo.build(CFG, device="cpu")
    pipe = SyntheticLM(vocab_size=128, seq_len=32, global_batch=8)
    tr = Trainer(api, TrainOptions(peak_lr=3e-3, warmup_steps=5,
                                   total_steps=100), pipeline=pipe)
    state = tr.init_or_restore(0)
    state, hist = tr.run(state, steps=15, log_every=0)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.5
    assert {"loss", "lr", "grad_norm", "step_time_s", "step"} <= set(hist[0])


def test_checkpoint_exact_resume():
    """Restore + rerun produces bit-equal losses (deterministic pipeline,
    the CPU's deterministic kernels)."""
    api = model_zoo.build(CFG, device="cpu")
    pipe = SyntheticLM(vocab_size=128, seq_len=32, global_batch=8)
    opts = TrainOptions(peak_lr=1e-3, warmup_steps=2, total_steps=100)
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(api, opts, pipeline=pipe, ckpt_dir=d)
        state = tr.init_or_restore(0)
        state, _ = tr.run(state, steps=6, ckpt_every=3, log_every=0)
        tr2 = Trainer(api, opts, pipeline=pipe, ckpt_dir=d)
        state2 = tr2.init_or_restore(0)
        assert int(state2.step) == 6
        for a, b in zip(_tree.leaves(state), _tree.leaves(state2)):
            assert torch.equal(a.detach(), b.detach())
        state, hist_a = tr.run(state, steps=3, log_every=0)
        state2, hist_b = tr2.run(state2, steps=3, log_every=0)
        np.testing.assert_array_equal([h["loss"] for h in hist_a],
                                      [h["loss"] for h in hist_b])


def test_grad_accum_matches_full_batch():
    """accum=2 == accum=1 on the same global batch (linearity of grads)."""
    api = model_zoo.build(CFG, device="cpu")
    batch = SyntheticLM(vocab_size=128, seq_len=16, global_batch=8).batch(0)
    params = api.init(torch.Generator().manual_seed(0))
    s1 = init_state(_tree.tree_map(torch.clone, params), 0)
    s2 = init_state(_tree.tree_map(torch.clone, params), 0)
    s1, m1 = make_train_step(api.loss_fn, TrainOptions(grad_accum=1))(s1,
                                                                       batch)
    s2, m2 = make_train_step(api.loss_fn, TrainOptions(grad_accum=2))(s2,
                                                                       batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for a, b in zip(_tree.leaves(s1.params), _tree.leaves(s2.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_data_pipeline_determinism_and_sharding():
    pipe = SyntheticLM(vocab_size=100, seq_len=16, global_batch=8)
    b1, b2 = pipe.batch(3), pipe.batch(3)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].dtype == torch.int32
    full = pipe.batch(5)["tokens"]
    parts = [pipe.host_batch(5, h, 4)["tokens"] for h in range(4)]
    assert torch.equal(torch.cat(parts, dim=0), full)
    assert not torch.equal(full, pipe.batch(6)["tokens"])
    assert int(full.min()) >= 0 and int(full.max()) < 100


def test_synthetic_data_follows_its_markov_chain():
    """Tokens are latent ids times the stride; every row draws from its
    own generator (rows of one step differ, a row is the same whatever
    the batch around it)."""
    pipe = SyntheticLM(vocab_size=128, seq_len=64, global_batch=4, seed=7)
    toks = pipe.batch(0)["tokens"].numpy()
    stride = 128 // 61
    assert np.all(toks % stride == 0) and toks.max() < 61 * stride
    assert len({tuple(r) for r in toks}) == 4
    wide = SyntheticLM(vocab_size=128, seq_len=64, global_batch=8, seed=7)
    assert np.array_equal(wide.batch(0)["tokens"].numpy()[:4], toks)
    other = SyntheticLM(vocab_size=128, seq_len=64, global_batch=4, seed=8)
    assert not np.array_equal(other.batch(0)["tokens"].numpy(), toks)


def test_rescale_gradients_matches_reference():
    import jax.numpy as jnp
    from repro.dist.fault import rescale_gradients as j_rescale
    rng = np.random.default_rng(4)
    g = {"a": rng.standard_normal((4, 3, 2)).astype(np.float32),
         "b": [rng.standard_normal((4, 5)).astype(np.float32)]}
    for alive in ([True, False, True, True], [False] * 4):
        want = j_rescale({"a": jnp.asarray(g["a"]),
                          "b": [jnp.asarray(g["b"][0])]}, np.array(alive))
        got = rescale_gradients(_tree.tree_map(torch.as_tensor, g),
                                torch.tensor(alive))
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["b"][0].numpy(),
                                   np.asarray(want["b"][0]),
                                   rtol=1e-6, atol=1e-7)


def test_bf16_params_keep_a_float32_master():
    api = model_zoo.build(CFG, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    state = init_state(params, 0, bf16_params=True)
    assert all(p.dtype == torch.bfloat16 for p in _tree.leaves(state.params))
    assert all(m.dtype == torch.float32 for m in _tree.leaves(state.opt.master))
    batch = SyntheticLM(vocab_size=128, seq_len=16, global_batch=4).batch(0)
    step = make_train_step(api.loss_fn, TrainOptions(**STEP_OPTS))
    state, m = step(state, batch)
    assert np.isfinite(float(m["loss"]))
    for p, master in zip(_tree.leaves(state.params),
                         _tree.leaves(state.opt.master)):
        assert torch.equal(p.detach(), master.to(torch.bfloat16))


@pytest.mark.parametrize("arch", ["minicpm", "rwkv6", "zamba2", "internvl2",
                                  "seamless"])
def test_launcher_trains_on_the_cpu_when_asked(tmp_path, arch):
    """Three steps with a checkpoint at step 2, then a resumed run: it
    starts at step 2 and repeats that step's loss bit for bit (the
    hybrid's G lists and encdec's two stacks go through the checkpoint
    as lists)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    cfg = get_config(arch)
    logs = []
    out = launch.main(["--arch", arch, "--steps", "3", "--seq-len", "16",
                       "--batch", "4", "--ckpt-dir", str(tmp_path),
                       "--ckpt-every", "2"], device="cpu",
                      log_fn=logs.append)
    assert len(out["history"]) == 3 and int(out["state"].step) == 3
    assert logs[0].startswith(f"arch={cfg.name}-reduced "
                              f"family={cfg.family}")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002"]
    again = launch.main(["--arch", arch, "--steps", "1", "--seq-len", "16",
                         "--batch", "4", "--ckpt-dir", str(tmp_path)],
                        device="cpu", log_fn=logs.append)
    assert again["history"][0]["step"] == 2     # resumed at the checkpoint
    assert again["history"][0]["loss"] == out["history"][2]["loss"]


@pytest.mark.parametrize("arch", ["minicpm", "rwkv6", "internvl2", "seamless"])
def test_launcher_synthetic_data_only_for_token_batches(arch, monkeypatch):
    """``--data synthetic`` (tokens only) trains a family whose batch is
    tokens; for vlm and encdec, whose batch also carries frontend
    embeddings, the launcher refuses it before it builds anything and
    names ``--data random``, which trains."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    argv = ["--arch", arch, "--steps", "1", "--seq-len", "16", "--batch",
            "2"]
    built = []
    real_build = launch.build
    monkeypatch.setattr(launch, "build",
                        lambda *a, **k: built.append(1) or real_build(*a,
                                                                       **k))
    quiet = lambda _: None
    if get_config(arch).family in ("vlm", "encdec"):
        with pytest.raises(ValueError, match="--data random"):
            launch.main(argv + ["--data", "synthetic"], device="cpu",
                        log_fn=quiet)
        assert not built
        out = launch.main(argv + ["--data", "random"], device="cpu",
                          log_fn=quiet)
    else:
        out = launch.main(argv + ["--data", "synthetic"], device="cpu",
                          log_fn=quiet)
        assert isinstance(out["trainer"].pipeline, SyntheticLM)
    assert built == [1] and np.isfinite(out["history"][0]["loss"])
