"""The MoE model stack of the port against the JAX reference.

The reference's ``lm_init`` weights are carried across with
``params_from_numpy``; inputs are made from a seed with numpy.
Tolerances: float32 compute to ``rtol=1e-5`` with an absolute floor of
``1e-5`` for entries near zero (activations are O(1) after each norm,
and summation order differs between the two packages' matmuls); bf16
compute to ``rtol=1e-2, atol=1e-2``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import phi3_5_moe as tphi
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.core import sequence as tseq
from repro_torch.core import telemetry
from repro_torch.models import attention as tA
from repro_torch.models import layers as tL
from repro_torch.models import model_zoo
from repro_torch.models import moe as tM
from repro_torch.models import params as tP
from repro_torch.models import transformer as tT
from test_torch_support import (BF16_TOL, assert_bitexact, assert_close,
                                jax_ref, reset_torch_state)  # noqa: F401

MODEL_F32_TOL = dict(rtol=1e-5, atol=1e-5)


MOE_ARCHS = ("phi3.5-moe", "mixtral-8x22b")


def _jax_cfg(arch="phi3.5-moe", **overrides):
    from repro.configs import base as jb
    from repro.configs import get_config
    return jb.reduced(get_config(arch), **overrides)


def _port_cfg(jcfg, **overrides):
    return dataclasses.replace(ModelConfig(**dataclasses.asdict(jcfg)),
                               **overrides)


def _models(jcfg, seed=0):
    """Seeded numpy weights in the layout of the reference's ``lm_init``
    (the reference's params), and the same weights in the port."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jM
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jM.lm_init(jax.random.PRNGKey(0), jcfg))

    def leaf(path, spec):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return np.ones(spec.shape, np.float32)
        scale = (0.02 if "table" in name or "router" in name
                 else 1.0 / np.sqrt(spec.shape[-2]))
        return (rng.standard_normal(spec.shape) * scale).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jparams, tP.params_from_numpy(tree, _port_cfg(jcfg), "cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_configs_are_the_reference_configs(arch):
    from repro.configs import base as jb
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    jcfg, cfg = jget(arch), get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (dataclasses.asdict(reduced(cfg, d_model=256))
            == dataclasses.asdict(jb.reduced(jcfg, d_model=256)))
    assert (cfg.hd, cfg.padded_vocab) == (128, 32768)
    assert cfg.param_count() == jcfg.param_count()
    if arch == "mixtral-8x22b":
        assert (cfg.sliding_window, cfg.num_experts,
                cfg.num_experts_per_tok) == (4096, 8, 2)
        assert reduced(cfg).sliding_window == 8


def test_sequence_ops_match_reference(jax_ref):
    import jax.numpy as jnp
    from repro.core import sequence as jseq
    x = np.random.default_rng(0).standard_normal((2, 7, 3)).astype(
        np.float32)
    assert_bitexact(tseq.token_shift(torch.as_tensor(x)),
                    jseq.token_shift(jnp.asarray(x)))
    assert_bitexact(tseq.shift_right(torch.as_tensor(x), dim=1, fill=5.0),
                    jseq.shift_right(jnp.asarray(x), axis=1, fill=5.0))
    for window, off in ((0, 0), (3, 4), (5, 0)):
        assert_bitexact(tseq.sliding_window_mask(4, 9, window, q_offset=off),
                        jseq.sliding_window_mask(4, 9, window, q_offset=off))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(jax_ref, dtype):
    import jax.numpy as jnp
    from repro.models import layers as jL
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = {"w": rng.standard_normal((16, 8)).astype(np.float32) * 0.3,
         "b": rng.standard_normal(8).astype(np.float32)}
    pos = np.arange(5)[None] + 100
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = MODEL_F32_TOL if dtype == "float32" else BF16_TOL
    tw = {k: torch.as_tensor(v) for k, v in w.items()}
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    for p, jp in ((tw, jw), ({"w": tw["w"]}, {"w": jw["w"]})):
        assert_close(tL.dense(p, torch.as_tensor(x), td),
                     jL.dense(jp, jnp.asarray(x), jd), tol)
    assert_close(tL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos),
                               theta=1e4, rotary_pct=0.5),
                 jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e4,
                               rotary_pct=0.5), MODEL_F32_TOL)
    scale = {"scale": rng.standard_normal(16).astype(np.float32),
             "bias": rng.standard_normal(16).astype(np.float32)}
    for kind in ("rmsnorm", "layernorm"):
        assert_close(
            tL.apply_norm({k: torch.as_tensor(v) for k, v in scale.items()},
                          torch.as_tensor(x), kind),
            jL.apply_norm({k: jnp.asarray(v) for k, v in scale.items()},
                          jnp.asarray(x), kind), MODEL_F32_TOL)


@pytest.mark.parametrize("backend", ["einsum", "kernel", "sparse"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_moe_mlp_apply_matches_reference(jax_ref, backend, compute):
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jM
    # XLA's CPU dot has no bf16 x bf16 -> f32, so the reference runs in
    # float32 on the same bf16-rounded input; the router is bf16 in both.
    jcfg = _jax_cfg()
    jparams, tparams = _models(jcfg)
    x = np.random.default_rng(2).standard_normal((2, 24, 64)).astype(
        np.float32)
    tx = torch.as_tensor(x).to(getattr(torch, compute))
    jx = jnp.asarray(tx.to(torch.float32).numpy())
    jblk = jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"])
    jy, jaux = jM.moe_mlp_apply(jblk, jx, jcfg)
    tcfg = _port_cfg(jcfg, compute_dtype=compute, dispatch_backend=backend)
    with telemetry.delta() as delta:
        ty, taux = tM.moe_mlp_apply(tparams["blocks"][0]["moe"], tx, tcfg)
    assert delta()["apply_calls"] == 2       # one dispatch + one combine
    tol = MODEL_F32_TOL if compute == "float32" else BF16_TOL
    assert ty.dtype == tx.dtype
    assert_close(ty, jy, tol)
    for k in jaux:
        assert_close(taux[k], jaux[k], MODEL_F32_TOL)


def test_wide_layer_covers_the_512_token_capacity_branch(jax_ref):
    """One layer at d_model 256 and 16 experts, S = 512: capacity rounds
    up to 128 (int(1.25 * 512 * 2 / 16) = 80)."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jM
    jcfg = _jax_cfg(num_layers=1, d_model=256, num_experts=16,
                    d_ff=256, attn_chunk=128)
    tcfg = _port_cfg(jcfg, dispatch_backend="sparse")
    assert tM.capacity_of(_port_cfg(jcfg), 512) == jM.capacity_of(jcfg,
                                                                   512) == 128
    assert tM.capacity_of(_port_cfg(jcfg), 511) == jM.capacity_of(jcfg,
                                                                   511) == 79
    jparams, tparams = _models(jcfg, seed=1)
    x = np.random.default_rng(3).standard_normal((1, 512, 256)).astype(
        np.float32)
    jblk = jax.tree.map(lambda a: a[0], jparams["blocks"])
    jy, jaux = jM.block_apply(jblk, jnp.asarray(x), jcfg)
    ty, taux = tM.block_apply(tparams["blocks"][0], torch.as_tensor(x), tcfg)
    assert_close(ty, jy, MODEL_F32_TOL)
    assert_close(taux["dropped"], jaux["dropped"], MODEL_F32_TOL)


# Decode runs 14 positions: past Mixtral's reduced window of 8, so its
# ring cache wraps; Phi-3.5-MoE (no window) keeps all 14 rows.
DECODE_STEPS = 14


@pytest.fixture(scope="module")
def moe_reference():
    """One reference run per arch, shared by the model-level tests: the
    carried weights, the parallel forward (hidden, logits, aux) of 2 x 16
    tokens, and a 14-step greedy decode of 3 rows (logits, tokens, the
    final caches).  float32 compute, the reduced config."""
    from test_torch_support import jax_ref_alias
    runs = {}

    def run(arch):
        if arch in runs:
            return runs[arch]
        import jax.numpy as jnp
        from repro.models import moe as jM
        from repro.models import transformer as jT
        with jax_ref_alias():
            jcfg = _jax_cfg(arch)
            jparams, tparams = _models(jcfg)
            toks = np.random.default_rng(4).integers(0, jcfg.vocab_size,
                                                     (2, 16))
            jh, jaux = jM.lm_hidden(jparams, jnp.asarray(toks, jnp.int32),
                                    jcfg)
            out = dict(jcfg=jcfg, tparams=tparams, toks=toks,
                       hidden=np.asarray(jh),
                       logits=np.asarray(jT.lm_logits(jparams, jh, jcfg)),
                       aux={k: np.asarray(v) for k, v in jaux.items()})
            first = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                                      (3, 1))
            jc = jM.init_caches(jcfg, 3, DECODE_STEPS, jnp.float32)
            feed, steps = first, []
            for pos in range(DECODE_STEPS):
                jl, jc = jM.decode_step(jparams, jnp.asarray(feed, jnp.int32),
                                        jc, pos, jcfg)
                jl = np.asarray(jl)
                steps.append((feed, jl))
                feed = np.argmax(jl[:, -1, :jcfg.vocab_size], -1)[:, None]
            out.update(decode=steps, caches={k: np.asarray(v)
                                             for k, v in jc.items()})
        runs[arch] = out
        return out

    return run


@pytest.mark.parametrize("backend", ["einsum", "kernel", "sparse"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_hidden_and_logits_match_reference(moe_reference, arch, backend):
    ref = moe_reference(arch)
    tcfg = _port_cfg(ref["jcfg"], dispatch_backend=backend)
    with telemetry.delta() as delta:
        th, taux = tM.lm_hidden(ref["tparams"], torch.as_tensor(ref["toks"]),
                                tcfg)
    assert delta()["apply_calls"] == 2 * tcfg.num_layers
    assert_close(th, ref["hidden"], MODEL_F32_TOL)
    assert_close(tT.lm_logits(ref["tparams"], th, tcfg), ref["logits"],
                 MODEL_F32_TOL)
    for k in ref["aux"]:
        assert_close(taux[k], ref["aux"][k], MODEL_F32_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_step_matches_reference(moe_reference, arch):
    """Greedy decode of 14 positions on the 'kernel' backend, fed the
    reference's tokens: every step's logits within ``MODEL_F32_TOL``, the
    port's greedy token equal to the reference's, and the final caches
    (Mixtral's a ring of 8 slots, overwritten 6 times) equal."""
    ref = moe_reference(arch)
    jcfg = ref["jcfg"]
    tcfg = _port_cfg(jcfg, dispatch_backend="kernel")
    tc = tM.init_caches(tcfg, 3, DECODE_STEPS, torch.float32, device="cpu")
    width = jcfg.sliding_window or DECODE_STEPS
    assert tc["k"].shape[2] == width
    for pos, (feed, jl) in enumerate(ref["decode"]):
        if pos:
            assert np.array_equal(greedy, feed)
        tl, tc = tM.decode_step(ref["tparams"], torch.as_tensor(feed), tc,
                                pos, tcfg)
        assert_close(tl, jl, MODEL_F32_TOL)
        greedy = tl[:, -1, :jcfg.vocab_size].argmax(-1)[:, None].numpy()
    for name in ("k", "v"):
        assert_close(tc[name], ref["caches"][name], MODEL_F32_TOL)


def test_ring_cache_decode_matches_reference(jax_ref):
    """Sliding-window configs decode through a ring cache (slot pos % W)."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jA
    jcfg = _jax_cfg(sliding_window=3)
    jparams, tparams = _models(jcfg)
    tcfg = _port_cfg(jcfg)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["attn"])
    tp = tparams["blocks"][0]["attn"]
    rng = np.random.default_rng(6)
    jc = jA.init_cache(jcfg, 2, 8, jnp.float32)
    tc = tA.init_cache(tcfg, 2, 8, torch.float32, device="cpu")
    assert tc["k"].shape == (2, 3, jcfg.num_kv_heads, jcfg.hd)
    for pos in range(6):
        x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jo, jc = jA.decode_attn_apply(jp, jnp.asarray(x1), jc, pos, jcfg)
        to, tc = tA.decode_attn_apply(tp, torch.as_tensor(x1), tc, pos, tcfg)
        assert_close(to, jo, MODEL_F32_TOL)
    x = rng.standard_normal((2, 10, 64)).astype(np.float32)
    assert_close(tA.attn_apply(tp, torch.as_tensor(x), tcfg),
                 jA.attn_apply(jp, jnp.asarray(x), jcfg), MODEL_F32_TOL)


def test_params_from_numpy_and_init_params_share_one_layout(jax_ref):
    jcfg = _jax_cfg()
    tcfg = _port_cfg(jcfg)
    _, carried = _models(jcfg)
    fresh = tP.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    again = tP.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(fresh) == shapes(carried)
    assert shapes(tP.to_device(fresh, "cpu")) == shapes(fresh)
    assert len(fresh["blocks"]) == tcfg.num_layers
    n = sum(t.numel() for t in _leaves(fresh))
    norms = tcfg.d_model * (2 * tcfg.num_layers + 1)
    assert n == tcfg.param_count() + norms
    for a, b in zip(_leaves(fresh), _leaves(again)):
        assert torch.equal(a, b)
    wi = fresh["blocks"][0]["moe"]["wi"]
    assert float(wi.abs().max()) <= 2.0 / np.sqrt(tcfg.d_model) + 1e-6


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_model_zoo_builds_moe_and_refuses_other_families():
    """``build`` makes every one of the six families (MoE at length, the
    others one decode step each, ``window`` taken by every family's
    ``init_caches``) and refuses an unknown family with the reference's
    ``ValueError``."""
    cfg = reduced(tphi.CONFIG)
    api = model_zoo.build(cfg, device="cpu")
    params = api.init()
    caches = api.init_caches(2, 6, torch.float32)
    assert caches["k"].shape == (cfg.num_layers, 2, 6, cfg.num_kv_heads,
                                 cfg.hd)
    logits, caches = api.decode_fn(params, torch.zeros((2, 1),
                                                       dtype=torch.int32),
                                   caches, 0)
    assert logits.shape == (2, 1, cfg.padded_vocab)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(
        logits).all())
    from repro_torch.configs import get_config
    families = {}
    for arch in ("minicpm-2b", "phi3.5-moe", "rwkv6-7b", "zamba2-2.7b",
                 "internvl2-26b", "seamless-m4t-large-v2"):
        fcfg = reduced(get_config(arch))
        fapi = model_zoo.build(fcfg, device="cpu")
        fparams = fapi.init()
        fcaches = fapi.init_caches(2, 6, torch.float32, window=4)
        logits, _ = fapi.decode_fn(fparams, torch.ones((2, 1),
                                                       dtype=torch.int32),
                                   fcaches, 0)
        assert logits.shape == (2, 1, fcfg.padded_vocab)
        assert bool(torch.isfinite(logits).all())
        families[fcfg.family] = fapi
    assert sorted(families) == ["dense", "encdec", "hybrid", "moe", "rwkv",
                                "vlm"]
    with pytest.raises(ValueError, match="unknown family 'ssm'"):
        model_zoo.build(dataclasses.replace(cfg, family="ssm"),
                        device="cpu")


@pytest.mark.parametrize("entry", ["lm_init", "init_caches", "init_cache",
                                   "init_params", "build", "encdec_lm_init",
                                   "encdec_init_caches", "launch_serve",
                                   "rwkv_lm_init", "rwkv_init_caches",
                                   "hybrid_lm_init", "hybrid_init_caches"])
def test_model_entry_points_default_to_the_card(monkeypatch, entry):
    """With no device given, every entry point that makes tensors asks
    for the card and raises without one; nothing lands on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.configs import rwkv6_7b, zamba2_2_7b
    from repro_torch.configs import seamless_m4t_large_v2 as tsm
    from repro_torch.launch import serve as tserve
    from repro_torch.models import encdec as tE
    from repro_torch.models import hybrid as tH
    from repro_torch.models import rwkv as tR
    cfg = reduced(tphi.CONFIG)
    encdec_cfg = reduced(tsm.CONFIG)
    rwkv_cfg = reduced(rwkv6_7b.CONFIG)
    hybrid_cfg = reduced(zamba2_2_7b.CONFIG)
    calls = {
        "lm_init": lambda: tM.lm_init(torch.Generator(), cfg),
        "init_caches": lambda: tM.init_caches(cfg, 2, 6),
        "init_cache": lambda: tA.init_cache(cfg, 2, 6),
        "init_params": lambda: tP.init_params(cfg),
        "build": lambda: model_zoo.build(cfg),
        "encdec_lm_init": lambda: tE.lm_init(torch.Generator(), encdec_cfg),
        "encdec_init_caches": lambda: tE.init_caches(encdec_cfg, 2, 6),
        "launch_serve": lambda: tserve.main(["--arch", "internvl2-26b"],
                                            log_fn=lambda _: None),
        "rwkv_lm_init": lambda: tR.lm_init(torch.Generator(), rwkv_cfg),
        "rwkv_init_caches": lambda: tR.init_caches(rwkv_cfg, 2, 6),
        "hybrid_lm_init": lambda: tH.lm_init(torch.Generator(), hybrid_cfg),
        "hybrid_init_caches": lambda: tH.init_caches(hybrid_cfg, 2, 6,
                                                     window=4),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
