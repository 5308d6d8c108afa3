"""Shared harness of the PyTorch-port tests, and a test of it.

The port's tests feed the same numpy inputs, made from a seed, to the
JAX reference (``repro``) and to the port (``repro_torch``) on the CPU.

Nothing here imports JAX at module level, so the card-only tests can
import the helpers on a machine without it.

* ``jax_ref`` — the reference calls ``jax.core.trace_state_clean``,
  which jax 0.9 moved to ``jax._src.core``.  The fixture aliases it back
  through ``monkeypatch`` for the duration of the test only, so the JAX
  suite's own tests in the same worker see the module unchanged.
* ``reset_torch_state`` — autouse in every file that imports it: zero
  the port's counters and caches between tests.
* ``assert_bitexact`` / ``assert_close`` — the exactness rule: integer,
  GF(2), unweighted gathers and unique-destination scatters are
  bit-exact; weighted float32 REAL sums and colliding scatters agree to
  ``rtol=1e-5, atol=1e-6``; bf16 payloads (against bf16-rounded weights)
  to ``rtol=1e-2``.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture
def jax_ref(monkeypatch):
    """Make the JAX reference runnable on this jax for one test, and
    leave the reference's crypto registry as the test found it (its
    plans outlive a test, and the JAX suite shares the worker)."""
    import jax
    from jax._src import core as jax_core
    from repro.crypto.registry import REGISTRY
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax_core.trace_state_clean, raising=False)
    tables = (REGISTRY._plans, REGISTRY._programs, REGISTRY._observed,
              REGISTRY._quarantined)
    saved = [dict(t) for t in tables]
    yield
    for table, before in zip(tables, saved):
        table.clear()
        table.update(before)


@contextlib.contextmanager
def jax_ref_alias():
    """``jax_ref``'s alias for a block wider than one test (a module
    fixture that runs the reference once for several tests)."""
    import jax
    from jax._src import core as jax_core
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "trace_state_clean", jax_core.trace_state_clean,
                   raising=False)
        yield


def carried_params(japi, tcfg, seed=0, leaf_fn=None):
    """Seeded numpy weights in the layout of the reference model
    ``japi``'s ``init`` (norm scales 1, biases N(0, 0.1), tables and
    routers N(0, 0.02), matrices N(0, 1/d_in)), as (reference params,
    the port's params on the CPU).  ``leaf_fn(name, shape, rng)`` may
    draw a leaf itself (a family's own parameter ranges): it returns the
    array, or None for the rule above."""
    import jax
    import jax.numpy as jnp
    from repro_torch.models import params as tP
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0)))

    def leaf(path, spec):
        name = jax.tree_util.keystr(path)
        if leaf_fn is not None:
            own = leaf_fn(name, spec.shape, rng)
            if own is not None:
                return np.asarray(own, np.float32)
        if "scale" in name:
            return np.ones(spec.shape, np.float32)
        if "bias" in name or name.endswith("['b']"):
            return (rng.standard_normal(spec.shape) * 0.1).astype(np.float32)
        scale = (0.02 if "table" in name or "router" in name
                 else 1.0 / np.sqrt(spec.shape[-2]))
        return (rng.standard_normal(spec.shape) * scale).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return (jax.tree.map(jnp.asarray, tree),
            tP.params_from_numpy(tree, tcfg, "cpu"))


def port_leaf(tree, path):
    """The port's leaf at a path of ``reference_leaves``."""
    node = tree
    for key in path:
        node = node[key]
    return node


def reference_leaves(jtree):
    """(path in the port's tree, numpy float32 leaf) for every leaf of a
    reference tree of parameters, gradients or moments.  The tree goes
    through ``models.params.params_from_numpy``, which splits the
    reference's stacked layer axes as the port lays them out (``blocks``,
    encdec's ``enc_blocks`` / ``dec_blocks``, the hybrid's (G,) ``lora``
    and (G, period) ``mamba``): each layer's leaf is its own leaf."""
    import jax
    from repro_torch import _tree
    from repro_torch.models import params as tP
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jtree)
    port = tP.params_from_numpy(tree, _ANY_FAMILY, "cpu")
    return [(path, leaf.numpy())
            for path, leaf in _tree.leaves_with_path(port)]


# params_from_numpy splits by key, whatever the family
_ANY_FAMILY = types.SimpleNamespace(family="dense")


@pytest.fixture(scope="module")
def one_thread():
    """Run a module's tiny models on one intra-op thread: they gain
    nothing from more, and under the suite's parallel workers a pool of
    spinning threads a process slows every worker sharing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def reset_torch_state():
    from repro_torch.core import telemetry
    from repro_torch.crypto import registry
    telemetry.reset()
    registry.reset_observations()
    yield


def to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        if t.dtype == torch.uint32:
            return t.view(torch.int32).numpy().view(np.uint32)
        return t.numpy()
    arr = np.asarray(a)
    if str(arr.dtype) == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def assert_bitexact(got, want) -> None:
    g, w = to_numpy(got), to_numpy(want)
    assert g.shape == w.shape, f"shape {g.shape} != {w.shape}"
    assert np.array_equal(g, w), (
        f"not bit-exact: {np.count_nonzero(g != w)} of {g.size} differ")


def assert_close(got, want, tol=None) -> None:
    g = to_numpy(got).astype(np.float64)
    w = to_numpy(want).astype(np.float64)
    assert g.shape == w.shape, f"shape {g.shape} != {w.shape}"
    np.testing.assert_allclose(g, w, **(tol or F32_TOL))


def test_jax_ref_alias_makes_reference_runnable(jax_ref):
    import jax
    import jax.numpy as jnp
    from repro.core import crossbar as jxb
    assert jax.core.trace_state_clean()
    plan = jxb.gather_plan(jnp.asarray([2, 0, 1], jnp.int32), 3)
    compiled = jxb.compile_plan(plan, block_o=2, block_n=2)
    assert compiled.is_static and compiled.num_active == 3


def test_exactness_helpers_enforce_the_rule():
    x = np.arange(6, dtype=np.int32).reshape(2, 3)
    assert_bitexact(torch.as_tensor(x), x)
    y = x.copy()
    y[1, 2] += 1
    with pytest.raises(AssertionError):
        assert_bitexact(torch.as_tensor(y), x)
    f = np.linspace(1.0, 2.0, 8, dtype=np.float32)
    assert_close(torch.as_tensor(f * (1 + 5e-7)), f)
    with pytest.raises(AssertionError):
        assert_close(torch.as_tensor(f * (1 + 1e-3)), f)
    assert_close(torch.as_tensor(f).to(torch.bfloat16), f, BF16_TOL)
    u = torch.as_tensor(np.array([1, -1], np.int32)).view(torch.uint32)
    assert_bitexact(u, np.array([1, 2**32 - 1], np.uint32))
