"""The serving launcher of the port against the reference's engine.

``repro_torch.launch.serve.main`` for one reduced config of each of the
six families (dense, moe, rwkv, hybrid, vlm, encdec) on the CPU.  With
the reference's weights carried across, its greedy tokens equal, token
for token, those of the reference's ``ServingEngine`` on the launcher's
prompts and options (float32 caches).  The engine starts every
``generate`` from the initial caches, nested ones (encdec's self and
cross K/V, the hybrid's Mamba2 states) included.
"""

import dataclasses

import numpy as np
import pytest

from repro_torch.configs import base as tbase
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve as tserve
from repro_torch.models import model_zoo
from repro_torch.serve import ServeOptions, ServingEngine
from test_torch_support import (carried_params, jax_ref_alias,  # noqa: F401
                                one_thread, reset_torch_state)

pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = {"dense": "minicpm-2b", "moe": "phi3.5-moe-42b-a6.6b",
         "rwkv": "rwkv6-7b", "hybrid": "zamba2-2.7b",
         "vlm": "internvl2-26b", "encdec": "seamless-m4t-large-v2"}
SLOTS, NEW, MAX_SEQ = 4, 4, 16
ARGV = ["--slots", str(SLOTS), "--max-new-tokens", str(NEW),
        "--max-seq", str(MAX_SEQ)]


@pytest.fixture(scope="module", params=sorted(ARCHS))
def served(request):
    """The reference engine's greedy tokens for one family's reduced
    config, and the weights carried into the port."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get
    from repro.configs import reduced as j_reduced
    from repro.models import model_zoo as jzoo
    from repro.serve import ServeOptions as JOptions
    from repro.serve import ServingEngine as JEngine
    arch = ARCHS[request.param]
    with jax_ref_alias():
        jcfg = j_reduced(j_get(arch))
        japi = jzoo.build(jcfg)
        jparams, tparams = carried_params(
            japi, tbase.ModelConfig(**dataclasses.asdict(jcfg)), seed=21)
        engine = JEngine(japi, JOptions(batch_slots=SLOTS,
                                        max_new_tokens=NEW),
                         max_seq=MAX_SEQ, cache_dtype=jnp.float32)
        prompts = tserve.prompts_for(SLOTS, jcfg.vocab_size)
        want = engine.generate(jparams, prompts, key=jax.random.PRNGKey(1))
    return dict(family=request.param, arch=arch, tparams=tparams,
                prompts=prompts, want=want,
                padded_vocab=jcfg.padded_vocab)


def test_launcher_greedy_tokens_equal_reference_engine(served, monkeypatch):
    """The launcher serving the reference's weights (its model's ``init``
    returns them) gives the reference engine's tokens."""
    def build(cfg, device=None):
        api = model_zoo.build(cfg, device=device)
        return dataclasses.replace(
            api, init=lambda generator=None: served["tparams"])

    monkeypatch.setattr(tserve, "build", build)
    lines = []
    outs = tserve.main(["--arch", served["arch"]] + ARGV, device="cpu",
                       log_fn=lines.append)
    assert outs == served["want"]
    assert lines == [f"{p} -> {o}" for p, o in zip(served["prompts"],
                                                   served["want"])]


def test_launcher_seeded_weights_serve_in_range_and_repeat(served):
    """The launcher's own seeded weights: every token in the (padded)
    vocabulary the engine samples over, the same tokens on a rerun."""
    argv = ["--arch", served["arch"]] + ARGV
    outs = tserve.main(argv, device="cpu", log_fn=lambda _: None)
    assert [len(o) for o in outs] == [NEW] * SLOTS
    assert all(0 <= t < served["padded_vocab"] for o in outs for t in o)
    assert tserve.main(argv, device="cpu", log_fn=lambda _: None) == outs


def test_generate_restarts_from_the_initial_caches(served):
    """A second ``generate`` on the same engine starts from zeroed
    caches — every leaf of a nested cache tree — and repeats the
    first's tokens."""
    cfg = reduced(get_config(served["arch"]))
    api = model_zoo.build(cfg, device="cpu")
    engine = ServingEngine(api, ServeOptions(batch_slots=SLOTS,
                                             max_new_tokens=NEW),
                           max_seq=MAX_SEQ)
    first = engine.generate(served["tparams"], served["prompts"])
    assert first == served["want"]
    leaves = [t for t in _leaves(engine._caches)]
    assert any(bool(t.any()) for t in leaves)
    assert engine.generate(served["tparams"], served["prompts"]) == first
    if served["family"] == "encdec":
        assert set(engine._caches) == {"self", "cross"}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
def test_launcher_serves_the_recurrent_families(arch):
    """``--arch rwkv6-7b`` and ``--arch zamba2-2.7b`` with the launcher's
    defaults: 4 slots of 16 new tokens, each in the padded vocabulary."""
    outs = tserve.main(["--arch", arch], device="cpu", log_fn=lambda _: None)
    vocab = reduced(get_config(arch)).padded_vocab
    assert [len(o) for o in outs] == [16] * 4
    assert all(0 <= t < vocab for o in outs for t in o)


def test_parse_args_defaults_are_the_references():
    args = tserve.parse_args(["--arch", "minicpm-2b"])
    assert (args.slots, args.max_new_tokens, args.max_seq, args.temperature,
            args.full) == (4, 16, 128, 0.0, False)
    assert tserve.prompts_for(3, 10) == [[0, 1, 2], [7, 8, 9, 0],
                                         [4, 5, 6, 7, 8]]
    assert np.array_equal(np.array(tserve.prompts_for(1, 100)[0]),
                          np.arange(3))
