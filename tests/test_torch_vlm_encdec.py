"""The vlm and encdec families of the port against the JAX reference.

Reduced InternVL2-26B (a patch prefix of 8 slots before the text; dense
backbone, 2 layers, d_model 64) and reduced SeamlessM4T-large-v2 (2
encoder and 2 decoder layers, LayerNorm, GELU, d_model 64), float32
compute.  The reference's weights are carried across; inputs are made
from a seed with numpy.  Patch and frame packing (vcompress over the
whole batch as one block-diagonal crossbar pass) is bit-exact on every
backend; model outputs agree to ``rtol=1e-5, atol=1e-5`` and decode
logits to ``rtol=1e-4, atol=1e-4``, the dense family's tolerances.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.core import permute as tP
from repro_torch.models import attention as tA
from repro_torch.models import encdec as tE
from repro_torch.models import model_zoo
from repro_torch.models import vlm as tV
from test_torch_support import (assert_bitexact, assert_close,  # noqa: F401
                                carried_params, jax_ref_alias, one_thread,
                                reset_torch_state)

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)
B, S_TEXT, MAX_SEQ, DECODE = 2, 6, 24, 3
VALID = np.array([[1, 0, 1, 1, 0, 1, 1, 1],
                  [0, 1, 1, 0, 0, 0, 1, 0]], dtype=bool)


def _port_cfg(jcfg):
    return tbase.ModelConfig(**dataclasses.asdict(jcfg))


def _np(tree):
    return {k: (_np(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def _specs(jspecs):
    return {k: (tuple(v.shape), str(np.dtype(v.dtype)))
            for k, v in jspecs.items()}


def _port_specs(tspecs):
    return {k: (tuple(shape), str(dtype).replace("torch.", ""))
            for k, (shape, dtype) in tspecs.items()}


@pytest.fixture(scope="module")
def vlm_ref():
    """The reference's reduced InternVL2: packed patches, the loss with
    and without packing, and prefill + decode with a full cache and with
    a ring cache (sliding window 4 < the prefix + text)."""
    import jax.numpy as jnp
    from repro.configs import get_config as j_get
    from repro.configs import reduced as j_reduced
    from repro.models import model_zoo as jzoo
    from repro.models import vlm as jV
    with jax_ref_alias():
        jcfg = j_reduced(j_get("internvl2-26b"))
        f = jcfg.frontend_seq
        jparams, tparams = carried_params(jzoo.build(jcfg), _port_cfg(jcfg),
                                          seed=11)
        rng = np.random.default_rng(12)
        embeds = (rng.standard_normal((B, f, jcfg.d_model)) * 0.02).astype(
            np.float32)
        toks = rng.integers(0, jcfg.vocab_size, (B, S_TEXT)).astype(np.int32)
        nxt = rng.integers(0, jcfg.vocab_size, (B, DECODE)).astype(np.int32)
        je, jt, jv = jnp.asarray(embeds), jnp.asarray(toks), jnp.asarray(VALID)
        packed = jV.pack_patches(je, jv)
        out = dict(jcfg=jcfg, tparams=tparams, embeds=embeds, toks=toks,
                   nxt=nxt, packed=np.array(packed),
                   own=np.asarray(jV.pack_patches(
                       jnp.arange(24, dtype=jnp.float32).reshape(1, 6, 4),
                       jnp.asarray([[True, False, True, True, False,
                                     True]]))),
                   specs=_specs(jzoo.build(jcfg).batch_specs(B, 16)))
        batch = {"tokens": jt, "frontend_embeds": je}
        out["loss"] = float(jV.lm_loss(jparams, batch, jcfg)[0])
        out["loss_packed"] = float(jV.lm_loss(
            jparams, {**batch, "patch_valid": jv}, jcfg)[0])
        for window in (0, 4):
            cfg = dataclasses.replace(jcfg, sliding_window=window)
            logits, caches = jV.prefill(jparams, jt, cfg,
                                        frontend_embeds=packed,
                                        max_seq=MAX_SEQ,
                                        cache_dtype=jnp.float32)
            run = {"prefill": np.asarray(logits), "caches": _np(caches),
                   "decode": []}
            for j in range(DECODE):
                logits, caches = jV.decode_step(
                    jparams, jnp.asarray(nxt[:, j:j + 1]), caches,
                    f + S_TEXT + j, cfg)
                run["decode"].append(np.asarray(logits))
            out[window] = run
    return out


@pytest.fixture(scope="module")
def encdec_ref():
    """The reference's reduced SeamlessM4T: the encoder with and without
    frame packing, one cross-attention call, the teacher-forced loss,
    the primed cross K/V and greedy-free decode steps from BOS."""
    import jax.numpy as jnp
    from repro.configs import get_config as j_get
    from repro.configs import reduced as j_reduced
    from repro.models import attention as jA
    from repro.models import encdec as jE
    from repro.models import model_zoo as jzoo
    with jax_ref_alias():
        jcfg = j_reduced(j_get("seamless-m4t-large-v2"))
        f = jcfg.frontend_seq
        japi = jzoo.build(jcfg)
        jparams, tparams = carried_params(japi, _port_cfg(jcfg), seed=13)
        rng = np.random.default_rng(14)
        frames = (rng.standard_normal((B, f, jcfg.d_model)) * 0.02).astype(
            np.float32)
        toks = rng.integers(0, jcfg.vocab_size, (B, S_TEXT)).astype(np.int32)
        jf, jt, jv = (jnp.asarray(frames), jnp.asarray(toks),
                      jnp.asarray(VALID))
        enc = jE.encode(jparams, jf, jcfg, frame_valid=jv)
        x = jnp.asarray(rng.standard_normal((B, S_TEXT, jcfg.d_model)),
                        jnp.float32)
        cross_p = {k: {n: w[0] for n, w in v.items()} for k, v in
                   jparams["dec_blocks"]["cross_attn"].items()}
        out = dict(jcfg=jcfg, tparams=tparams, frames=frames, toks=toks,
                   x=np.asarray(x),
                   enc_plain=np.asarray(jE.encode(jparams, jf, jcfg)),
                   enc=np.asarray(enc),
                   packed=np.asarray(_jpack(jf, jv)),
                   cross_attn=np.asarray(jA.cross_attn_apply(
                       cross_p, x, enc, jcfg)),
                   specs=_specs(japi.batch_specs(B, 16)))
        batch = {"tokens": jt, "frontend_embeds": jf, "frame_valid": jv}
        out["loss"] = float(jE.lm_loss(jparams, batch, jcfg)[0])
        cross = jE.prime_cross(jparams, enc, jcfg, jnp.float32)
        out["cross"] = _np(cross)
        caches = jE.init_caches(jcfg, B, MAX_SEQ, jnp.float32)
        tok, steps = jnp.zeros((B, 1), jnp.int32), []
        for j in range(DECODE):
            logits, caches = jE.decode_step(jparams, tok, caches, j, jcfg,
                                            cross=cross)
            steps.append(np.asarray(logits))
            tok = jt[:, j:j + 1]
        out["decode"] = steps
        out["self_caches"] = _np(caches["self"])
    return out


def _jpack(x, valid):
    from repro.core import permute as jP
    return jP.vcompress_batched(x, valid, tail="zero", backend="auto")


# -- vlm -----------------------------------------------------------------------

def test_pack_patches_reference_case(vlm_ref):
    """The reference's own case: pads out, real patches front-packed."""
    x = torch.arange(24, dtype=torch.float32).reshape(1, 6, 4)
    valid = torch.tensor([[True, False, True, True, False, True]])
    packed = tV.pack_patches(x, valid)
    assert_bitexact(packed, vlm_ref["own"])
    assert_bitexact(packed[0, :4], x[0, [0, 2, 3, 5]])
    assert not packed[0, 4:].any()


@pytest.mark.parametrize("backend",
                         ["auto", "einsum", "kernel", "sparse", "reference"])
def test_pack_patches_bit_exact_on_every_backend(vlm_ref, backend):
    x, v = torch.as_tensor(vlm_ref["embeds"]), torch.as_tensor(VALID)
    got = (tV.pack_patches(x, v) if backend == "auto" else
           tP.vcompress_batched(x, v, tail="zero", backend=backend))
    assert_bitexact(got, vlm_ref["packed"])


def test_vlm_loss_matches_reference(vlm_ref):
    cfg, p = _port_cfg(vlm_ref["jcfg"]), vlm_ref["tparams"]
    batch = {"tokens": torch.as_tensor(vlm_ref["toks"]),
             "frontend_embeds": torch.as_tensor(vlm_ref["embeds"])}
    np.testing.assert_allclose(float(tV.lm_loss(p, batch, cfg)[0]),
                               vlm_ref["loss"], **TOL)
    packed = {**batch, "patch_valid": torch.as_tensor(VALID)}
    api = model_zoo.build(cfg, device="cpu")
    np.testing.assert_allclose(float(api.loss_fn(p, packed)[0]),
                               vlm_ref["loss_packed"], **TOL)


@pytest.mark.parametrize("window", [0, 4], ids=["full_cache", "ring_cache"])
def test_vlm_prefill_and_decode_match_reference(vlm_ref, window):
    cfg = dataclasses.replace(_port_cfg(vlm_ref["jcfg"]),
                              sliding_window=window)
    p, ref = vlm_ref["tparams"], vlm_ref[window]
    logits, caches = tV.prefill(
        p, torch.as_tensor(vlm_ref["toks"]), cfg,
        frontend_embeds=torch.as_tensor(vlm_ref["packed"]), max_seq=MAX_SEQ,
        cache_dtype=torch.float32)
    assert_close(logits, ref["prefill"], TOL)
    for k in ("k", "v"):
        assert_close(caches[k], ref["caches"][k], TOL)
    f = cfg.frontend_seq
    for j in range(DECODE):
        logits, caches = tV.decode_step(
            p, torch.as_tensor(vlm_ref["nxt"][:, j:j + 1]), caches,
            f + S_TEXT + j, cfg)
        assert_close(logits, ref["decode"][j], DECODE_TOL)


def test_vlm_batch_specs_and_make_batch(vlm_ref):
    cfg = _port_cfg(vlm_ref["jcfg"])
    api = model_zoo.build(cfg, device="cpu")
    assert _port_specs(api.batch_specs(B, 16)) == vlm_ref["specs"]
    batch = api.make_batch(torch.Generator().manual_seed(0), B, 16)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in batch.items()} == vlm_ref["specs"]
    again = api.make_batch(torch.Generator().manual_seed(0), B, 16)
    for k in batch:
        assert torch.equal(batch[k], again[k])


# -- encdec --------------------------------------------------------------------

def test_cross_attn_apply_matches_reference(encdec_ref):
    cfg, p = _port_cfg(encdec_ref["jcfg"]), encdec_ref["tparams"]
    got = tA.cross_attn_apply(p["dec_blocks"][0]["cross_attn"],
                              torch.as_tensor(encdec_ref["x"]),
                              torch.as_tensor(encdec_ref["enc"]), cfg)
    assert_close(got, encdec_ref["cross_attn"], TOL)


def test_attention_without_mask_is_the_encoders(encdec_ref):
    """``causal=False`` lets every query see every key: the last query's
    output is the same as the causal path's, the first one's is not."""
    cfg, p = _port_cfg(encdec_ref["jcfg"]), encdec_ref["tparams"]
    attn = p["enc_blocks"][0]["attn"]
    x = torch.as_tensor(encdec_ref["x"])
    full = tA.attn_apply(attn, x, cfg, causal=False)
    causal = tA.attn_apply(attn, x, cfg)
    assert_close(full[:, -1], causal[:, -1], TOL)
    assert not torch.allclose(full[:, 0], causal[:, 0])


def test_encode_packs_frames_bit_exact_and_matches_reference(encdec_ref):
    cfg, p = _port_cfg(encdec_ref["jcfg"]), encdec_ref["tparams"]
    frames, v = (torch.as_tensor(encdec_ref["frames"]),
                 torch.as_tensor(VALID))
    for backend in ("auto", "einsum", "kernel", "sparse"):
        assert_bitexact(tP.vcompress_batched(frames, v, tail="zero",
                                             backend=backend),
                        encdec_ref["packed"])
    assert_close(tE.encode(p, frames, cfg), encdec_ref["enc_plain"], TOL)
    assert_close(tE.encode(p, frames, cfg, frame_valid=v),
                 encdec_ref["enc"], TOL)


def test_encdec_loss_matches_reference(encdec_ref):
    cfg, p = _port_cfg(encdec_ref["jcfg"]), encdec_ref["tparams"]
    batch = {"tokens": torch.as_tensor(encdec_ref["toks"]),
             "frontend_embeds": torch.as_tensor(encdec_ref["frames"]),
             "frame_valid": torch.as_tensor(VALID)}
    loss, metrics = tE.lm_loss(p, batch, cfg)
    np.testing.assert_allclose(float(loss), encdec_ref["loss"], **TOL)
    assert metrics["loss"] is loss
    remat, _ = tE.lm_loss(p, batch, dataclasses.replace(cfg, remat="full"))
    assert torch.equal(remat, loss)


def test_prime_cross_and_decode_match_reference(encdec_ref):
    cfg, p = _port_cfg(encdec_ref["jcfg"]), encdec_ref["tparams"]
    cross = tE.prime_cross(p, torch.as_tensor(encdec_ref["enc"]), cfg,
                           torch.float32)
    for k in ("k", "v"):
        assert_close(cross[k], encdec_ref["cross"][k], TOL)
    caches = tE.init_caches(cfg, B, MAX_SEQ, torch.float32, "cpu")
    toks = torch.as_tensor(encdec_ref["toks"])
    tok = torch.zeros((B, 1), dtype=torch.int32)
    for j in range(DECODE):
        logits, caches = tE.decode_step(p, tok, caches, j, cfg, cross=cross)
        assert_close(logits, encdec_ref["decode"][j], DECODE_TOL)
        tok = toks[:, j:j + 1]
    for k in ("k", "v"):
        assert_close(caches["self"][k], encdec_ref["self_caches"][k],
                     DECODE_TOL)


def test_encdec_decode_matches_teacher_forced_decoder(encdec_ref):
    """Decode from BOS over the targets gives, step by step, the logits
    of the teacher-forced parallel decoder (``lm_loss``'s forward)."""
    cfg, p = _port_cfg(encdec_ref["jcfg"]), encdec_ref["tparams"]
    enc = torch.as_tensor(encdec_ref["enc"])
    toks = torch.as_tensor(encdec_ref["toks"])
    hidden = tE.decode_hidden(p, toks, enc, cfg)
    parallel = tE.L.logits_projection(p["lm_head"], hidden, hidden.dtype)
    api = model_zoo.build(cfg, device="cpu")
    caches = api.init_caches(B, MAX_SEQ, torch.float32)
    assert caches["cross"]["k"].shape == (cfg.num_layers, B, MAX_SEQ // 2,
                                          cfg.num_kv_heads, cfg.hd)
    caches["cross"] = tE.prime_cross(p, enc, cfg, torch.float32)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    for j in range(S_TEXT):
        logits, caches = api.decode_fn(p, tok, caches, j)
        assert_close(logits[:, 0], parallel[:, j], DECODE_TOL)
        tok = toks[:, j:j + 1]


def test_encdec_batch_specs_and_make_batch(encdec_ref):
    cfg = _port_cfg(encdec_ref["jcfg"])
    api = model_zoo.build(cfg, device="cpu")
    assert _port_specs(api.batch_specs(B, 16)) == encdec_ref["specs"]
    batch = api.make_batch(torch.Generator().manual_seed(1), B, 16)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in batch.items()} == encdec_ref["specs"]
    assert np.isfinite(float(api.loss_fn(api.init(), batch)[0]))

