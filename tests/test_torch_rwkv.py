"""The rwkv family of the port (RWKV6 "Finch") against the JAX reference.

Reduced RWKV6-7B (``configs.reduced``: 2 layers, d_model 64, one head of
64, float32 compute) on the reference's weights carried across; tokens
are made from a seed with numpy.  The weights follow the harness's rule
except RWKV's own ranges: the token-shift mixes are interpolation
weights, drawn in [0, 1], and the decays in [-6, 1] (the published
model's span from -6, and past it toward the clip).  S = 48, so three
WKV chunks of 16 carry the state.  Forward, loss, decode logits and
every cache leaf agree to ``rtol=1e-5, atol=1e-5`` (float32 throughout;
the packages sum in different orders), greedy tokens token for token,
gradients to ``rtol=1e-4`` (atol 1e-4 of the gradient's largest
magnitude).  One run of the reference serves every test of the module.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch.configs import base as tbase
from repro_torch.models import model_zoo
from repro_torch.models import params as tP
from repro_torch.models import rwkv as tR
from test_torch_support import (assert_close, carried_params,  # noqa: F401
                                jax_ref_alias, one_thread,
                                reset_torch_state)

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, STEPS = 2, 48, 8
CLIPPED_DECAY = 4.5     # decay + dyn far above the clip at 1.5
GRAD_LEAVES = (("tmix", "decay_w1"), ("tmix", "decay_w2"), ("tmix", "bonus"))


def _rwkv_leaf(name, shape, rng):
    mix = ("['maa_x']", "['maa_rkvwg']", "['maa_k']", "['maa_r']")
    if name.endswith(mix):
        return rng.uniform(0.0, 1.0, shape)
    if name.endswith("['decay']"):
        return rng.uniform(-6.0, 1.0, shape)
    return None


def _port_cfg(jcfg):
    return tbase.ModelConfig(**dataclasses.asdict(jcfg))


def _np_tree(tree):
    return {k: (_np_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def ref():
    """The reference's reduced RWKV6: hidden states, logits, loss and the
    gradients of the decay LoRA and the bonus on a (2, 48) batch; 8
    greedy decode steps (logits, tokens, caches); the forward with every
    decay at the clip."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get
    from repro.configs import reduced as j_reduced
    from repro.models import model_zoo as jzoo
    from repro.models import rwkv as jR
    with jax_ref_alias():
        jcfg = j_reduced(j_get("rwkv6-7b"))
        japi = jzoo.build(jcfg)
        jparams, tparams = carried_params(japi, _port_cfg(jcfg), seed=41,
                                            leaf_fn=_rwkv_leaf)
        toks = np.random.default_rng(42).integers(
            0, jcfg.vocab_size, (B, S)).astype(np.int32)
        jt = jnp.asarray(toks)

        def loss_fn(p):
            hidden = jR.lm_hidden(p, jt, jcfg)
            logits = jR.L.logits_projection(p.get("lm_head", p["embed"]),
                                            hidden, hidden.dtype)
            loss = jR.L.cross_entropy(logits[:, :-1], jt[:, 1:])
            return loss, (hidden, logits)

        # one compiled forward and backward for both weight sets
        run = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (loss, (hidden, logits)), grads = run(jparams)
        out = dict(
            tcfg=_port_cfg(jcfg), tparams=tparams, toks=toks,
            hidden=np.asarray(hidden), logits=np.asarray(logits),
            loss=float(loss),
            grads={name: np.asarray(grads["blocks"][a][name])
                   for a, name in GRAD_LEAVES})
        decode = jax.jit(japi.decode_fn)
        caches = japi.init_caches(B, STEPS, jnp.float32)
        tok, steps, greedy = jt[:, :1], [], []
        for j in range(STEPS):
            logits, caches = decode(jparams, tok, caches, j)
            steps.append(np.asarray(logits))
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
            greedy.append(np.asarray(tok[:, 0]))
        out.update(decode=steps, greedy=np.stack(greedy, 1),
                   caches=_np_tree(caches))
        clipped = dict(jparams, blocks=dict(jparams["blocks"]))
        clipped["blocks"]["tmix"] = dict(
            jparams["blocks"]["tmix"],
            decay=jnp.full_like(jparams["blocks"]["tmix"]["decay"],
                                CLIPPED_DECAY))
        (loss, (hidden, _)), _ = run(clipped)
        out.update(clipped_hidden=np.asarray(hidden),
                   clipped_loss=float(loss))
    return out


def test_rwkv_forward_and_loss_match_reference(ref):
    cfg, p = ref["tcfg"], ref["tparams"]
    toks = torch.as_tensor(ref["toks"])
    hidden = tR.lm_hidden(p, toks, cfg)
    assert_close(hidden, ref["hidden"], TOL)
    assert_close(tR.lm_logits(p, hidden), ref["logits"], TOL)
    loss, metrics = tR.lm_loss(p, {"tokens": toks}, cfg)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-6)
    assert metrics["loss"] is loss
    api = model_zoo.build(cfg, device="cpu")
    np.testing.assert_allclose(float(api.loss_fn(p, {"tokens": toks})[0]),
                               ref["loss"], rtol=1e-6)


def test_rwkv_greedy_decode_matches_reference(ref):
    """8 greedy decode steps: each step's logits, the greedy tokens and
    every cache leaf after the last step equal the reference's."""
    cfg, p = ref["tcfg"], ref["tparams"]
    api = model_zoo.build(cfg, device="cpu")
    caches = api.init_caches(B, STEPS, torch.float32)
    tok, greedy = torch.as_tensor(ref["toks"][:, :1]), []
    for j in range(STEPS):
        logits, caches = api.decode_fn(p, tok, caches, j)
        assert_close(logits, ref["decode"][j], TOL)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        greedy.append(tok[:, 0])
    assert torch.equal(torch.stack(greedy, 1),
                       torch.as_tensor(ref["greedy"]))
    assert set(caches) == set(ref["caches"])
    for name, want in ref["caches"].items():
        assert caches[name].dtype == torch.float32
        assert_close(caches[name], want, TOL)


def test_rwkv_decode_matches_the_parallel_forward(ref):
    """Decoding the 48 tokens one at a time gives the parallel forward's
    logits at every position: the chunked and the one-token forms of the
    recurrence agree."""
    cfg, p = ref["tcfg"], ref["tparams"]
    toks = torch.as_tensor(ref["toks"])
    caches = tR.init_caches(cfg, B, S, torch.float32, "cpu")
    for j in range(S):
        logits, caches = tR.decode_step(p, toks[:, j:j + 1], caches, j, cfg)
        assert_close(logits[:, 0], ref["logits"][:, j],
                     dict(rtol=1e-4, atol=1e-4))


def test_rwkv_gradients_match_reference(ref):
    """``torch.autograd`` through ``lm_loss`` against ``jax.grad`` for
    the decay LoRA (w1, w2) and the bonus u of every layer."""
    cfg = ref["tcfg"]
    p = _tree.tree_map(lambda t: t.clone().requires_grad_(True),
                       ref["tparams"])
    loss, _ = tR.lm_loss(p, {"tokens": torch.as_tensor(ref["toks"])}, cfg)
    loss.backward()
    for part, name in GRAD_LEAVES:
        want = ref["grads"][name]
        got = torch.stack([blk[part][name].grad for blk in p["blocks"]])
        assert float(got.abs().max()) > 0
        assert_close(got, want, dict(rtol=1e-4,
                                     atol=1e-4 * float(np.abs(want).max())))


def test_rwkv_decay_at_the_clip_matches_reference(ref):
    """Every decay above the clip (|log w| = e^1.5, so exp(-lp) reaches
    ~e^72 inside a 16-position chunk): finite, and the reference's."""
    cfg = ref["tcfg"]
    p = _tree.tree_map(lambda t: t.clone(), ref["tparams"])
    for blk in p["blocks"]:
        blk["tmix"]["decay"].fill_(CLIPPED_DECAY)
    toks = torch.as_tensor(ref["toks"])
    hidden = tR.lm_hidden(p, toks, cfg)
    assert bool(torch.isfinite(hidden).all())
    assert_close(hidden, ref["clipped_hidden"], TOL)
    np.testing.assert_allclose(
        float(tR.lm_loss(p, {"tokens": toks}, cfg)[0]), ref["clipped_loss"],
        rtol=1e-6)
    lw = tR._decay_logw(p["blocks"][0]["tmix"], torch.randn(1, 3, cfg.d_model))
    assert torch.allclose(lw, torch.full_like(lw, -float(np.exp(1.5))))


@pytest.mark.parametrize("s, chunk", [(48, 16), (20, 20), (8, 8)])
def test_rwkv_wkv_chunks_follow_the_reference_rule(ref, s, chunk):
    """Chunks of 16 positions, or the whole sequence when 16 does not
    divide it: the default equals the explicit chunk, and decode-sized
    chunks of 1 give the same result."""
    cfg = ref["tcfg"]
    tm = ref["tparams"]["blocks"][0]["tmix"]
    x = torch.as_tensor(np.random.default_rng(s).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32))
    out, (last, state) = tR.time_mix_apply(tm, x, cfg)
    want, (_, want_state) = tR.time_mix_apply(tm, x, cfg, chunk=chunk)
    assert torch.equal(out, want) and torch.equal(state, want_state)
    assert torch.equal(last, x[:, -1:])
    one, (_, one_state) = tR.time_mix_apply(tm, x, cfg, chunk=1)
    assert_close(one, want, dict(rtol=1e-4, atol=1e-4))
    assert_close(one_state, want_state, dict(rtol=1e-4, atol=1e-4))


def test_rwkv_decode_writes_only_the_caches(ref):
    """The token shift and the WKV step write into new tensors: the
    carried inputs and state a layer is given are unchanged by it, and
    ``decode_step`` updates the stacked caches it was given in place."""
    cfg, p = ref["tcfg"], ref["tparams"]
    blk = p["blocks"][0]
    rng = np.random.default_rng(5)
    cache = {name: torch.as_tensor(rng.standard_normal(shape).astype(
        np.float32)) for name, shape in (("tmix_x", (B, 1, cfg.d_model)),
                                         ("wkv", (B, 1, 64, 64)),
                                         ("cmix_x", (B, 1, cfg.d_model)))}
    before = {k: v.clone() for k, v in cache.items()}
    x1 = torch.as_tensor(rng.standard_normal((B, 1, cfg.d_model)).astype(
        np.float32))
    _, new = tR.block_decode(blk, x1, cache, cfg)
    for k in cache:
        assert torch.equal(cache[k], before[k])
        assert new[k].data_ptr() != cache[k].data_ptr()
    caches = tR.init_caches(cfg, B, 4, torch.bfloat16, "cpu")
    ptrs = {k: v.data_ptr() for k, v in caches.items()}
    _, out = tR.decode_step(p, torch.as_tensor(ref["toks"][:, :1]), caches,
                            0, cfg)
    assert out is caches
    assert {k: v.data_ptr() for k, v in out.items()} == ptrs
    assert all(v.dtype == torch.float32 and bool(v.any())
               for v in out.values())


def test_rwkv_init_and_remat(ref):
    """Seeded ``init_params`` draws the reference's tree (shapes and the
    reference's fixed initial values); ``remat="full"`` changes nothing
    in the loss or the gradients."""
    cfg = ref["tcfg"]
    fresh = tP.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: sorted((p, tuple(x.shape))
                              for p, x in _tree.leaves_with_path(t))
    assert shapes(fresh) == shapes(ref["tparams"])
    tm = fresh["blocks"][1]["tmix"]
    assert torch.equal(tm["decay"], torch.full((cfg.d_model,), -4.0))
    assert not bool(tm["maa_rkvwg"].any())
    toks = torch.as_tensor(ref["toks"][:, :20])
    grads = {}
    for remat in ("none", "full"):
        q = _tree.tree_map(lambda t: t.clone().requires_grad_(True),
                           ref["tparams"])
        loss, _ = tR.lm_loss(q, {"tokens": toks},
                             dataclasses.replace(cfg, remat=remat))
        grads[remat] = (loss.detach(),
                        torch.autograd.grad(loss, _tree.leaves(q)))
    assert torch.equal(grads["none"][0], grads["full"][0])
    for a, b in zip(grads["none"][1], grads["full"][1]):
        assert torch.equal(a, b)
