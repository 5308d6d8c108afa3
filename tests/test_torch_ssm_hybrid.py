"""The ssm (Mamba2) blocks and the hybrid family (Zamba2) of the port
against the JAX reference.

Reduced Zamba2-2.7B at 4 layers (``configs.reduced(cfg, num_layers=4)``:
two groups of a shared attention application and 2 Mamba2 blocks, so two
LoRA slices; d_model 64, SSM state 16, float32 compute) on the
reference's weights carried across; tokens are made from a seed with
numpy.  S = 24 with ``attn_chunk`` 8, so three SSD chunks carry the
state.  Forward, loss, decode logits and every cache leaf agree to
``rtol=1e-5, atol=1e-5`` (float32 throughout), greedy tokens token for
token, gradients to ``rtol=1e-4`` (atol 1e-4 of the gradient's largest
magnitude).  The shared-attention ring (``window=4``) is decoded past
its wrap.  One run of the reference serves every test of the module.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch.configs import base as tbase
from repro_torch.models import hybrid as tH
from repro_torch.models import model_zoo
from repro_torch.models import params as tP
from repro_torch.models import ssm as tS
from test_torch_support import (assert_close, carried_params,  # noqa: F401
                                jax_ref_alias, one_thread,
                                reset_torch_state)

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, STEPS, MAX_SEQ, WINDOW = 2, 24, 8, 16, 4
HOT_A_LOG = 3.0     # a decay of ~e^3 a step: a chunk of 8 sums past 88


def _port_cfg(jcfg):
    return tbase.ModelConfig(**dataclasses.asdict(jcfg))


def _np_tree(tree):
    return {k: (_np_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _port(caches, path):
    for k in path:
        caches = caches[k]
    return caches


@pytest.fixture(scope="module")
def ref():
    """The reference's reduced Zamba2 at 4 layers: hidden states, logits,
    loss and the gradients of A_log, dt_bias and the LoRA a on a (2, 24)
    batch; 8 greedy decode steps with full caches and 8 with a ring of 4
    (logits, tokens, caches); one Mamba2 block alone (chunked, with a
    carried state and conv edge, and one decode step)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get
    from repro.configs import reduced as j_reduced
    from repro.models import hybrid as jH
    from repro.models import model_zoo as jzoo
    from repro.models import ssm as jS
    with jax_ref_alias():
        jcfg = j_reduced(j_get("zamba2-2.7b"), num_layers=4)
        japi = jzoo.build(jcfg)
        jparams, tparams = carried_params(japi, _port_cfg(jcfg), seed=51)
        rng = np.random.default_rng(52)
        toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        jt = jnp.asarray(toks)

        def loss_fn(p):
            hidden = jH.lm_hidden(p, jt, jcfg)
            logits = jH.L.logits_projection(p.get("lm_head", p["embed"]),
                                            hidden, hidden.dtype)
            loss = jH.L.cross_entropy(logits[:, :-1], jt[:, 1:])
            return loss, (hidden, logits)

        (loss, (hidden, logits)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(jparams)
        out = dict(
            tcfg=_port_cfg(jcfg), tparams=tparams, toks=toks,
            hidden=np.asarray(hidden), logits=np.asarray(logits),
            loss=float(loss),
            grads={"A_log": np.asarray(grads["mamba"]["mamba"]["A_log"]),
                   "dt_bias": np.asarray(grads["mamba"]["mamba"]["dt_bias"]),
                   "a": np.asarray(grads["lora"]["a"])})
        decode = jax.jit(japi.decode_fn)
        for name, window in (("full", 0), ("ring", WINDOW)):
            caches = japi.init_caches(B, MAX_SEQ, jnp.float32, window=window)
            tok, steps, greedy = jt[:, :1], [], []
            for j in range(STEPS):
                logits, caches = decode(jparams, tok, caches, j)
                steps.append(np.asarray(logits))
                tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
                greedy.append(np.asarray(tok[:, 0]))
            out[name] = dict(decode=steps, greedy=np.stack(greedy, 1),
                             caches=_np_tree(caches))
        # one Mamba2 block: group 1, layer 0
        blk = jax.tree.map(lambda t: t[1, 0], jparams["mamba"])["mamba"]
        x = (rng.standard_normal((B, S, jcfg.d_model))).astype(np.float32)
        st = jS.init_state(jcfg, B)
        state0 = rng.standard_normal(st["ssm"].shape).astype(np.float32)
        edge0 = rng.standard_normal(st["conv"].shape).astype(np.float32)

        @jax.jit
        def block(blk, x, state0, edge0):
            return (jS.mamba2_apply(blk, x, jcfg, state=state0,
                                    conv_edge=edge0),
                    jS.mamba2_decode(blk, x[:, :1],
                                     {"ssm": state0, "conv": edge0}, jcfg))

        (y, (state, edge)), (y1, c1) = block(blk, x, state0, edge0)
        hot = dict(blk, A_log=blk["A_log"] + HOT_A_LOG)
        (y_hot, _), _ = block(hot, x, state0, edge0)
        out["block"] = dict(x=x, state0=state0, edge0=edge0, y=np.asarray(y),
                            state=np.asarray(state), edge=np.asarray(edge),
                            y1=np.asarray(y1), c1=_np_tree(c1),
                            y_hot=np.asarray(y_hot))
    return out


def test_hybrid_forward_and_loss_match_reference(ref):
    cfg, p = ref["tcfg"], ref["tparams"]
    assert tH.n_groups(cfg) == (2, 2) and len(p["lora"]) == 2
    toks = torch.as_tensor(ref["toks"])
    hidden = tH.lm_hidden(p, toks, cfg)
    assert_close(hidden, ref["hidden"], TOL)
    assert_close(tH.lm_logits(p, hidden), ref["logits"], TOL)
    loss, metrics = tH.lm_loss(p, {"tokens": toks}, cfg)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-6)
    assert metrics["loss"] is loss
    api = model_zoo.build(cfg, device="cpu")
    np.testing.assert_allclose(float(api.loss_fn(p, {"tokens": toks})[0]),
                               ref["loss"], rtol=1e-6)


@pytest.mark.parametrize("name", ["full", "ring"])
def test_hybrid_greedy_decode_matches_reference(ref, name):
    """8 greedy decode steps with full K/V caches and with rings of 4
    slots (written past the wrap): each step's logits, the greedy tokens
    and every cache leaf after the last step equal the reference's."""
    cfg, p = ref["tcfg"], ref["tparams"]
    want = ref[name]
    api = model_zoo.build(cfg, device="cpu")
    caches = api.init_caches(B, MAX_SEQ, torch.float32,
                             window=WINDOW if name == "ring" else 0)
    tok, greedy = torch.as_tensor(ref["toks"][:, :1]), []
    for j in range(STEPS):
        logits, caches = api.decode_fn(p, tok, caches, j)
        assert_close(logits, want["decode"][j], TOL)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        greedy.append(tok[:, 0])
    assert torch.equal(torch.stack(greedy, 1),
                       torch.as_tensor(want["greedy"]))
    leaves = dict(_leaves(want["caches"]))
    assert sorted(leaves) == sorted(path for path, _ in _leaves(caches))
    for path, leaf in leaves.items():
        assert_close(_port(caches, path), leaf, TOL)
    assert caches["attn_k"].shape[2] == (WINDOW if name == "ring" else
                                         MAX_SEQ)


def test_hybrid_ring_equals_full_cache_before_the_wrap(ref):
    """Until the ring of 4 wraps, its logits equal the full cache's."""
    for j in range(WINDOW):
        assert_close(ref["ring"]["decode"][j], ref["full"]["decode"][j],
                     dict(rtol=1e-6, atol=1e-6))
    assert not np.allclose(ref["ring"]["decode"][-1],
                           ref["full"]["decode"][-1], rtol=1e-3, atol=1e-3)


def test_hybrid_decode_matches_the_parallel_forward(ref):
    """Decoding the 24 tokens one at a time gives the parallel forward's
    logits at every position (full caches of 24)."""
    cfg, p = ref["tcfg"], ref["tparams"]
    toks = torch.as_tensor(ref["toks"])
    caches = tH.init_caches(cfg, B, S, torch.float32, "cpu")
    for j in range(S):
        logits, caches = tH.decode_step(p, toks[:, j:j + 1], caches, j, cfg)
        assert_close(logits[:, 0], ref["logits"][:, j],
                     dict(rtol=1e-4, atol=1e-4))


def test_hybrid_gradients_match_reference(ref):
    """``torch.autograd`` through ``lm_loss`` against ``jax.grad`` for
    A_log and dt_bias of every Mamba2 block and the LoRA a of every
    application."""
    cfg = ref["tcfg"]
    p = _tree.tree_map(lambda t: t.clone().requires_grad_(True),
                       ref["tparams"])
    loss, _ = tH.lm_loss(p, {"tokens": torch.as_tensor(ref["toks"])}, cfg)
    loss.backward()
    got = {name: torch.stack([torch.stack([blk["mamba"][name].grad
                                           for blk in group])
                              for group in p["mamba"]])
           for name in ("A_log", "dt_bias")}
    got["a"] = torch.stack([lo["a"].grad for lo in p["lora"]])
    for name, want in ref["grads"].items():
        assert float(got[name].abs().max()) > 0
        assert_close(got[name], want,
                     dict(rtol=1e-4, atol=1e-4 * float(np.abs(want).max())))


def test_mamba2_block_matches_reference(ref):
    """One Mamba2 block from a carried state and conv edge: the chunked
    forward (3 chunks of 8), its new state and edge, and one decode step
    equal the reference's; the state and edge it is given are not
    written."""
    cfg = ref["tcfg"]
    r = ref["block"]
    blk = ref["tparams"]["mamba"][1][0]["mamba"]
    state0 = torch.as_tensor(r["state0"])
    edge0 = torch.as_tensor(r["edge0"])
    y, (state, edge) = tS.mamba2_apply(blk, torch.as_tensor(r["x"]), cfg,
                                       state=state0, conv_edge=edge0)
    assert_close(y, r["y"], TOL)
    assert_close(state, r["state"], TOL)
    assert_close(edge, r["edge"], TOL)
    cache = {"ssm": state0.clone(), "conv": edge0.clone()}
    y1, c1 = tS.mamba2_decode(blk, torch.as_tensor(r["x"][:, :1]), cache,
                              cfg)
    assert_close(y1, r["y1"], TOL)
    for name in ("ssm", "conv"):
        assert_close(c1[name], r["c1"][name], TOL)
        assert c1[name].dtype == torch.float32
    assert torch.equal(cache["ssm"], state0)
    assert torch.equal(cache["conv"], edge0)


@pytest.mark.parametrize("chunk", [1, 4, 12, 24])
def test_ssd_chunks_agree(ref, chunk):
    """Any chunking of the SSD recurrence gives the same block output
    and state (the reference's rule: ``attn_chunk``, or the whole
    sequence when that does not divide it)."""
    cfg = ref["tcfg"]
    r = ref["block"]
    blk = ref["tparams"]["mamba"][1][0]["mamba"]
    x = torch.as_tensor(r["x"])
    y, (state, _) = tS.mamba2_apply(blk, x, cfg, chunk=chunk)
    want, (want_state, _) = tS.mamba2_apply(blk, x, cfg)
    assert_close(y, want, dict(rtol=1e-4, atol=1e-4))
    assert_close(state, want_state, dict(rtol=1e-4, atol=1e-4))
    odd, _ = tS.mamba2_apply(blk, x[:, :20], cfg)       # 8 does not divide
    whole, _ = tS.mamba2_apply(blk, x[:, :20], cfg, chunk=20)
    assert torch.equal(odd, whole)


def test_ssd_chunk_past_the_float32_range_stays_finite(ref):
    """With decays whose sum over a chunk passes ~88, the reference's
    ``exp(dec) * mask`` overflows above the diagonal and gives inf * 0 =
    NaN (ROADMAP R6); the port masks before the exp and gives the values
    of one-position chunks, where no exponent is positive."""
    cfg = ref["tcfg"]
    r = ref["block"]
    assert np.isnan(r["y_hot"]).any()
    blk = dict(ref["tparams"]["mamba"][1][0]["mamba"])
    blk["A_log"] = blk["A_log"] + HOT_A_LOG
    x, state0 = torch.as_tensor(r["x"]), torch.as_tensor(r["state0"])
    edge0 = torch.as_tensor(r["edge0"])
    y, (state, _) = tS.mamba2_apply(blk, x, cfg, state=state0,
                                    conv_edge=edge0)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    want, (want_state, _) = tS.mamba2_apply(blk, x, cfg, state=state0,
                                            conv_edge=edge0, chunk=1)
    assert_close(y, want, dict(rtol=1e-4, atol=1e-4))
    assert_close(state, want_state, dict(rtol=1e-4, atol=1e-4))
    finite = ~np.isnan(r["y_hot"])
    assert_close(y.numpy()[finite], r["y_hot"][finite], TOL)


def test_split_and_conv_follow_the_reference_layout(ref):
    """``in_proj``'s output splits at the reference's indices
    ([z | x, B, C | dt]) and the causal conv's edge is the last W-1
    inputs."""
    cfg = ref["tcfg"]
    d_inner, h, _, n = tS.geometry(cfg)
    proj = torch.arange(2 * d_inner + 2 * n + h, dtype=torch.float32)
    z, xbc, dt = tS._split_proj(proj[None, None], cfg)
    assert z.shape[-1] == d_inner and xbc.shape[-1] == d_inner + 2 * n
    assert float(xbc[0, 0, 0]) == d_inner and float(dt[0, 0, 0]) == (
        2 * d_inner + 2 * n)
    x = torch.randn(B, 5, 3)
    w = torch.zeros(cfg.conv_width, 3)
    w[-1] = 1.0                            # the current input only
    y, edge = tS._causal_conv(x, w, torch.zeros(3))
    assert torch.allclose(y, torch.nn.functional.silu(x))
    assert torch.equal(edge, x[:, -(cfg.conv_width - 1):])


def test_hybrid_init_caches_and_remat(ref):
    """Seeded ``init_params`` draws the reference's tree; the caches hold
    float32 states, K/V rings in the cache dtype; ``remat="full"``
    changes nothing in the loss or the gradients."""
    cfg = ref["tcfg"]
    fresh = tP.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: sorted((p, tuple(x.shape))
                              for p, x in _tree.leaves_with_path(t))
    assert shapes(fresh) == shapes(ref["tparams"])
    assert not bool(fresh["lora"][1]["b"].any())
    caches = tH.init_caches(cfg, 3, 10, torch.bfloat16, "cpu", window=4)
    assert caches["ssm"]["ssm"].shape == (2, 2, 3) + tuple(
        tS.init_state(cfg, 3, "cpu")["ssm"].shape[1:])
    assert caches["ssm"]["ssm"].dtype == torch.float32
    assert caches["ssm"]["conv"].dtype == torch.float32
    assert caches["attn_k"].shape == (2, 3, 4, cfg.num_kv_heads, cfg.hd)
    assert caches["attn_v"].dtype == torch.bfloat16
    assert caches["x0"].dtype == torch.float32
    toks = torch.as_tensor(ref["toks"][:, :16])
    grads = {}
    for remat in ("none", "full"):
        q = _tree.tree_map(lambda t: t.clone().requires_grad_(True),
                           ref["tparams"])
        loss, _ = tH.lm_loss(q, {"tokens": toks},
                             dataclasses.replace(cfg, remat=remat))
        grads[remat] = (loss.detach(),
                        torch.autograd.grad(loss, _tree.leaves(q)))
    assert torch.equal(grads["none"][0], grads["full"][0])
    for a, b in zip(grads["none"][1], grads["full"][1]):
        assert torch.equal(a, b)
