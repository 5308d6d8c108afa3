"""The dense family and the config registry of the port against the JAX
reference.

The four dense architectures, reduced (``configs.reduced``: 2 layers,
d_model 64, float32 compute): qwen1.5 (QKV bias), starcoder2 (LayerNorm,
GELU, QKV bias, sliding window 8: the ring cache), stablelm (partial
rotary, LayerNorm) and minicpm (tied embeddings, MHA).  The reference's
weights are carried across; inputs are made from a seed with numpy.
Tolerance: ``rtol=1e-5, atol=1e-5`` (float32 throughout; activations are
O(1) after each norm and the packages sum in different orders);
decode against the parallel forward inside the port ``rtol=1e-4,
atol=1e-4`` (a cache read against a chunked softmax).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.models import model_zoo
from repro_torch.models import transformer as tT
from repro_torch.serve import ServeOptions, ServingEngine
from test_torch_support import (assert_close, carried_params,  # noqa: F401
                                jax_ref_alias, one_thread,
                                reset_torch_state)

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)
DENSE = ("qwen1.5-110b", "starcoder2-15b", "stablelm-12b", "minicpm-2b")
B, S, MAX_SEQ, DECODE = 2, 10, 16, 4


def _port_cfg(jcfg):
    return tbase.ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    """The reference's outputs for one reduced dense architecture:
    hidden states, logits and loss of a (2, 10) batch, ``prefill`` with
    room for 16 positions, and 4 decode steps after it."""
    import jax.numpy as jnp
    from repro.configs import get_config as j_get
    from repro.configs import reduced as j_reduced
    from repro.models import model_zoo as jzoo
    from repro.models import transformer as jT
    with jax_ref_alias():
        jcfg = j_reduced(j_get(request.param))
        tcfg = _port_cfg(jcfg)
        jparams, tparams = carried_params(jzoo.build(jcfg), tcfg, seed=5)
        rng = np.random.default_rng(6)
        toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        nxt = rng.integers(0, jcfg.vocab_size, (B, DECODE)).astype(np.int32)
        jt = jnp.asarray(toks)
        hidden = jT.lm_hidden(jparams, jt, jcfg)
        out = dict(
            tcfg=tcfg, tparams=tparams, toks=toks, nxt=nxt,
            hidden=np.asarray(hidden),
            logits=np.asarray(jT.lm_logits(jparams, hidden, jcfg)),
            loss=float(jT.lm_loss(jparams, {"tokens": jt}, jcfg)[0]))
        logits, caches = jT.prefill(jparams, jt, jcfg, max_seq=MAX_SEQ,
                                    cache_dtype=jnp.float32)
        out["prefill"] = np.asarray(logits)
        out["prefill_caches"] = {k: np.asarray(v) for k, v in caches.items()}
        steps = []
        for j in range(DECODE):
            logits, caches = jT.decode_step(
                jparams, jnp.asarray(nxt[:, j:j + 1]), caches, S + j, jcfg)
            steps.append(np.asarray(logits))
        out["decode"] = steps
        out["decode_caches"] = {k: np.asarray(v) for k, v in caches.items()}
    return out


def test_dense_forward_and_loss_match_reference(dense):
    cfg, p = dense["tcfg"], dense["tparams"]
    toks = torch.as_tensor(dense["toks"])
    hidden = tT.lm_hidden(p, toks, cfg)
    assert_close(hidden, dense["hidden"], TOL)
    assert_close(tT.lm_logits(p, hidden, cfg), dense["logits"], TOL)
    loss, metrics = tT.lm_loss(p, {"tokens": toks}, cfg)
    np.testing.assert_allclose(float(loss), dense["loss"], rtol=1e-6)
    assert metrics["loss"] is loss
    api = model_zoo.build(cfg, device="cpu")
    np.testing.assert_allclose(float(api.loss_fn(p, {"tokens": toks})[0]),
                               dense["loss"], rtol=1e-6)


def test_dense_loss_mask_and_remat(dense):
    """A loss mask weighs positions as the reference's ``cross_entropy``
    does; ``remat="full"`` changes nothing in the loss or gradients."""
    cfg, p = dense["tcfg"], dense["tparams"]
    toks = torch.as_tensor(dense["toks"])
    mask = torch.zeros((B, S - 1))
    mask[:, :4] = 1.0
    masked, _ = tT.lm_loss(p, {"tokens": toks, "loss_mask": mask}, cfg)
    logits = torch.tensor(dense["logits"])[:, :-1]
    nll = (torch.logsumexp(logits, -1) - torch.take_along_dim(
        logits, toks[:, 1:, None].long(), -1)[..., 0])
    np.testing.assert_allclose(float(masked), float(nll[:, :4].mean()),
                               rtol=1e-5)
    grads = {}
    for remat in ("none", "full"):
        q = _tree.tree_map(lambda t: t.clone().requires_grad_(True), p)
        loss, _ = tT.lm_loss(q, {"tokens": toks},
                             dataclasses.replace(cfg, remat=remat))
        grads[remat] = (loss.detach(),
                        torch.autograd.grad(loss, _tree.leaves(q)))
    assert torch.equal(grads["none"][0], grads["full"][0])
    for a, b in zip(grads["none"][1], grads["full"][1]):
        assert torch.equal(a, b)


def test_dense_prefill_and_decode_match_reference(dense):
    cfg, p = dense["tcfg"], dense["tparams"]
    logits, caches = tT.prefill(p, torch.as_tensor(dense["toks"]), cfg,
                                max_seq=MAX_SEQ, cache_dtype=torch.float32)
    assert_close(logits, dense["prefill"], TOL)
    for k in ("k", "v"):
        assert_close(caches[k], dense["prefill_caches"][k], TOL)
    w = cfg.sliding_window or MAX_SEQ
    assert caches["k"].shape == (cfg.num_layers, B, min(w, MAX_SEQ),
                                 cfg.num_kv_heads, cfg.hd)
    for j in range(DECODE):
        logits, caches = tT.decode_step(
            p, torch.as_tensor(dense["nxt"][:, j:j + 1]), caches, S + j, cfg)
        assert_close(logits, dense["decode"][j], TOL)
    for k in ("k", "v"):
        assert_close(caches[k], dense["decode_caches"][k], TOL)


def test_dense_decode_matches_the_parallel_forward(dense):
    """Prefill then decode gives, position by position, the logits of
    one parallel forward over the whole sequence."""
    cfg, p = dense["tcfg"], dense["tparams"]
    full = torch.as_tensor(np.concatenate([dense["toks"], dense["nxt"]], 1))
    parallel = tT.lm_logits(p, tT.lm_hidden(p, full, cfg), cfg)
    logits, caches = tT.prefill(p, full[:, :S], cfg, max_seq=MAX_SEQ,
                                cache_dtype=torch.float32)
    assert_close(logits[:, 0], parallel[:, S - 1], DECODE_TOL)
    for j in range(DECODE):
        logits, caches = tT.decode_step(p, full[:, S + j:S + j + 1], caches,
                                        S + j, cfg)
        assert_close(logits[:, 0], parallel[:, S + j], DECODE_TOL)


def test_dense_serving_decodes_greedily_without_autograd(dense):
    """``ServingEngine`` on a dense model whose parameters require grad
    (as a trainer leaves them): greedy tokens are the parallel forward's
    argmax, and decoding builds no autograd graph."""
    cfg = dense["tcfg"]
    p = _tree.tree_map(lambda t: t.clone().requires_grad_(True),
                       dense["tparams"])
    api = model_zoo.build(cfg, device="cpu")
    engine = ServingEngine(api, ServeOptions(batch_slots=2,
                                             max_new_tokens=3),
                           max_seq=MAX_SEQ)
    prompts = [list(map(int, dense["toks"][0, :5])),
               list(map(int, dense["toks"][1, :5]))]
    outs = engine.generate(p, prompts)
    assert not any(c.requires_grad for c in engine._caches.values())
    with torch.no_grad():
        for prompt, out in zip(prompts, outs):
            seq = torch.as_tensor([prompt + out])
            logits = tT.lm_logits(p, tT.lm_hidden(p, seq, cfg), cfg)
            want = logits[0, len(prompt) - 1:-1].argmax(-1).tolist()
            assert out == want


def test_dense_model_api_members():
    cfg = tconfigs.reduced(tconfigs.get_config("minicpm"))
    api = model_zoo.build(cfg, device="cpu")
    assert api.batch_specs(3, 7) == {"tokens": ((3, 7), torch.int32)}
    batch = api.make_batch(torch.Generator().manual_seed(0), 3, 7)
    again = api.make_batch(torch.Generator().manual_seed(0), 3, 7)
    assert batch["tokens"].shape == (3, 7)
    assert batch["tokens"].dtype == torch.int32
    assert torch.equal(batch["tokens"], again["tokens"])
    assert int(batch["tokens"].max()) < cfg.vocab_size
    params = api.init(torch.Generator().manual_seed(1))
    assert "lm_head" not in params        # tied embeddings
    loss, _ = api.loss_fn(params, batch)
    assert loss.shape == () and np.isfinite(float(loss))
    caches = api.init_caches(3, 8, torch.float32)
    logits, caches = api.decode_fn(params, batch["tokens"][:, :1], caches, 0)
    assert logits.shape == (3, 1, cfg.padded_vocab)
    n = sum(t.numel() for t in _tree.leaves(params))
    norms = cfg.d_model * (2 * cfg.num_layers + 1)
    assert n == cfg.param_count() + norms


# -- the config registry ------------------------------------------------------

def test_registry_lists_the_reference_architectures_and_aliases():
    from repro import configs as jconfigs
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs._ALIASES == jconfigs._ALIASES
    assert tconfigs._ARCHS == jconfigs._ARCHS
    for alias, name in jconfigs._ALIASES.items():
        assert tconfigs.get_config(alias) is tconfigs.get_config(name)
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-5")


@pytest.mark.parametrize("arch", sorted(tconfigs._ARCHS))
def test_every_config_is_the_reference_config(arch):
    from repro import configs as jconfigs
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (dataclasses.asdict(tconfigs.reduced(tcfg))
            == dataclasses.asdict(jconfigs.reduced(jcfg)))
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    for name, shape in jconfigs.SHAPES.items():
        tshape = tconfigs.SHAPES[name]
        assert dataclasses.asdict(tshape) == dataclasses.asdict(shape)
        assert (tconfigs.cell_applicable(tcfg, tshape)
                == jconfigs.cell_applicable(jcfg, shape))
    assert model_zoo.build(tconfigs.reduced(tcfg), device="cpu")
