"""Serving of the port's MoE model against the JAX reference.

Greedy decoding is held to the reference token for token.  The random
draws of sampled decoding come from different generators in the two
packages, so sampled decoding is held to shape and support only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import phi3_5_moe as tphi
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.core import telemetry
from repro_torch.models import model_zoo
from repro_torch.models import params as tP
from repro_torch.serve import ServeOptions, ServingEngine, sample_token
from test_torch_support import (assert_bitexact, jax_ref,  # noqa: F401
                                reset_torch_state)  # noqa: F401

PROMPTS = [[5, 17, 99, 3], [42], [7, 7, 120, 64, 1, 8], [100, 2]]


def _reference_model(seed=0):
    import jax
    from repro.configs import base as jb
    from repro.configs import phi3_5_moe as jphi
    from repro.models import model_zoo as jzoo
    jcfg = jb.reduced(jphi.CONFIG)
    japi = jzoo.build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(seed))
    return jcfg, japi, jparams, jax.tree.map(np.asarray, jparams)


@pytest.mark.parametrize("backend", ["einsum", "sparse"])
def test_greedy_generate_matches_reference_token_for_token(jax_ref,
                                                            backend):
    import jax.numpy as jnp
    from repro.serve import engine as jeng
    jcfg, japi, jparams, tree = _reference_model()
    opts = dict(batch_slots=6, max_new_tokens=5)
    jout = jeng.ServingEngine(japi, jeng.ServeOptions(**opts), max_seq=16,
                              cache_dtype=jnp.float32).generate(jparams,
                                                                PROMPTS)
    tcfg = dataclasses.replace(ModelConfig(**dataclasses.asdict(jcfg)),
                               dispatch_backend=backend)
    api = model_zoo.build(tcfg, device="cpu")
    tparams = tP.params_from_numpy(tree, tcfg, "cpu")
    engine = ServingEngine(api, ServeOptions(**opts), max_seq=16)
    out = engine.generate(tparams, PROMPTS)
    assert out == jout
    assert [len(o) for o in out] == [5] * len(PROMPTS)
    # A second call starts from a fresh cache, as the reference's does.
    assert engine.generate(tparams, PROMPTS) == out


def test_sampled_generate_has_the_reference_shape_and_support():
    cfg = reduced(tphi.CONFIG)
    api = model_zoo.build(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(1))
    engine = ServingEngine(api, ServeOptions(
        batch_slots=4, max_new_tokens=6, temperature=1.0, top_k=8),
        max_seq=16)
    gen = torch.Generator().manual_seed(0)
    out = engine.generate(params, PROMPTS[:3], generator=gen)
    assert [len(o) for o in out] == [6, 6, 6]
    assert all(0 <= t < cfg.padded_vocab for o in out for t in o)
    again = engine.generate(params, PROMPTS[:3],
                            generator=torch.Generator().manual_seed(0))
    assert again == out                        # seeded: reproducible


def test_eos_stops_a_request_and_max_seq_bounds_generation():
    cfg = reduced(tphi.CONFIG)
    api = model_zoo.build(cfg, device="cpu")
    params = api.init()
    greedy = ServingEngine(api, ServeOptions(batch_slots=2,
                                             max_new_tokens=4), max_seq=16)
    first = greedy.generate(params, [[3, 4]])[0]
    stop = ServingEngine(api, ServeOptions(batch_slots=2, max_new_tokens=4,
                                           eos_id=first[0]), max_seq=16)
    assert stop.generate(params, [[3, 4]]) == [first[:1]]
    short = ServingEngine(api, ServeOptions(batch_slots=2,
                                            max_new_tokens=10), max_seq=4)
    assert len(short.generate(params, [[3, 4]])[0]) == 3


def test_generate_refuses_degenerate_requests():
    api = model_zoo.build(reduced(tphi.CONFIG), device="cpu")
    engine = ServingEngine(api, ServeOptions(batch_slots=2), max_seq=8)
    params = api.init()
    with pytest.raises(ValueError, match="at least one prompt"):
        engine.generate(params, [])
    with pytest.raises(ValueError, match="empty"):
        engine.generate(params, [[1], []])
    with pytest.raises(ValueError, match="slots"):
        engine.generate(params, [[1], [2], [3]])


def test_sample_token_greedy_and_top_k(jax_ref):
    import jax
    import jax.numpy as jnp
    from repro.serve import engine as jeng
    rng = np.random.default_rng(0)
    logits = (rng.integers(-4, 5, (6, 50)) * 0.5).astype(np.float32)
    got = sample_token(torch.as_tensor(logits))
    assert_bitexact(got, jeng.sample_token(jnp.asarray(logits),
                                           jax.random.PRNGKey(0)))
    with telemetry.delta() as delta:
        tok = sample_token(torch.as_tensor(logits),
                           torch.Generator().manual_seed(2),
                           temperature=0.7, top_k=5)
    assert delta()["apply_calls"] == 1         # one fused top-k gather
    assert tok.shape == (6,) and tok.dtype == torch.int32
    jvals, jids = jax.lax.top_k(jnp.asarray(logits), 5)
    for row, t in enumerate(tok.tolist()):
        assert t in np.asarray(jids[row]).tolist()
    full = sample_token(torch.as_tensor(logits),
                        torch.Generator().manual_seed(2), temperature=1.0)
    assert full.shape == (6,) and bool(((full >= 0) & (full < 50)).all())


def test_decode_step_costs_one_dispatch_and_one_combine_per_layer():
    cfg = dataclasses.replace(reduced(tphi.CONFIG), dispatch_backend="sparse")
    api = model_zoo.build(cfg, device="cpu")
    params = api.init()
    caches = api.init_caches(3, 4, torch.float32)
    with telemetry.delta() as delta:
        api.decode_fn(params, torch.ones((3, 1), dtype=torch.int32),
                      caches, 0)
    d = delta()
    assert d["apply_calls"] == 2 * cfg.num_layers
    assert d.get("apply_calls_sparse", 0) == 2 * cfg.num_layers
