"""The paper's baseline datapaths in the port (``core.baselines``): each
bit-exact against the reference's on the same numpy inputs, and the
unified datapath equal to the baseline inside the port on every
crossbar backend (the plain versions of the kernels on the CPU) and the
fused vcompress, mirroring the reference's ``TestUnifiedEqualsSeparate``
and ``test_dispatch_vs_argsort_baseline``.  Unweighted routing: every
comparison is bit-exact (finite payloads)."""

import numpy as np
import pytest
import torch

from repro_torch.core import baselines as B
from repro_torch.core import moe_dispatch as md
from repro_torch.core import permute as P
from repro_torch.kernels import ops
from test_torch_support import (assert_bitexact, jax_ref,  # noqa: F401
                                one_thread, reset_torch_state)

pytestmark = pytest.mark.usefixtures("one_thread")

BACKENDS = ("einsum", "kernel", "sparse", "reference")


def _payload(rng, n, d, dtype):
    if dtype == "int32":
        return rng.integers(-2**20, 2**20, (n, d)).astype(np.int32)
    return rng.standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("n", [1, 5, 32])
def test_gather_baseline_matches_reference(jax_ref, n, dtype):
    import jax.numpy as jnp
    from repro.core import baselines as jB
    rng = np.random.default_rng(n)
    x = _payload(rng, n, 3, dtype)
    idx = rng.integers(-2, n + 3, n).astype(np.int32)
    assert_bitexact(B.gather_baseline(torch.as_tensor(x), torch.as_tensor(idx)),
                    jB.gather_baseline(jnp.asarray(x), jnp.asarray(idx)))


@pytest.mark.parametrize("up", [True, False])
@pytest.mark.parametrize("n", [1, 2, 7, 32])
def test_slide_baseline_matches_reference(jax_ref, n, up):
    import jax.numpy as jnp
    from repro.core import baselines as jB
    rng = np.random.default_rng(10 + n)
    x = _payload(rng, n, 2, "float32")
    for off in sorted({0, 1, n - 1, n, n + 3, int(rng.integers(0, 2 * n))}):
        want = jB.slide_baseline(jnp.asarray(x), off, up=up)
        assert_bitexact(B.slide_baseline(torch.as_tensor(x), off, up=up), want)
        assert_bitexact(B.slide_baseline(torch.as_tensor(x),
                                         torch.tensor(off, dtype=torch.int32),
                                         up=up), want)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("n,d", [(1, 1), (8, 3), (32, 128)])
def test_compress_baseline_sequential_matches_reference(jax_ref, n, d, dtype):
    import jax.numpy as jnp
    from repro.core import baselines as jB
    rng = np.random.default_rng(20 + n)
    x = _payload(rng, n, d, dtype)
    for mask in (rng.random(n) < 0.5, np.ones(n, bool), np.zeros(n, bool)):
        assert_bitexact(
            B.compress_baseline_sequential(torch.as_tensor(x),
                                           torch.as_tensor(mask)),
            jB.compress_baseline_sequential(jnp.asarray(x),
                                            jnp.asarray(mask.astype(
                                                np.int32))))


@pytest.mark.parametrize("t,e,cap", [(32, 4, 32), (32, 4, 5), (64, 8, 3)])
def test_argsort_dispatch_baseline_matches_reference(jax_ref, t, e, cap):
    import jax.numpy as jnp
    from repro.core import baselines as jB
    rng = np.random.default_rng(30 + cap)
    x = _payload(rng, t, 8, "float32")
    ids = rng.integers(0, e, (t, 1)).astype(np.int32)
    assert_bitexact(
        B.moe_dispatch_argsort_baseline(torch.as_tensor(x),
                                        torch.as_tensor(ids), e, cap),
        jB.moe_dispatch_argsort_baseline(jnp.asarray(x), jnp.asarray(ids),
                                         e, cap))


# -- unified == separate inside the port ---------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_compress_vs_sequential_baseline(backend):
    rng = np.random.default_rng(40)
    for n in (1, 7, 32):
        x = torch.arange(n * 2, dtype=torch.float32).reshape(n, 2) + 1
        for mask in (rng.random(n) < 0.4, np.ones(n, bool)):
            m = torch.as_tensor(mask)
            seq = B.compress_baseline_sequential(x, m)
            assert_bitexact(P.vcompress(x, m.to(torch.int32), backend=backend),
                            seq)
            assert_bitexact(ops.fused_vcompress(m, x), seq)


@pytest.mark.parametrize("backend", BACKENDS)
def test_slide_vs_log_shifter(backend):
    for n in (1, 5, 32):
        x = torch.arange(n * 2, dtype=torch.float32).reshape(n, 2) + 1
        for off in (0, 1, n - 1, n, n + 7, 3 * n // 2):
            for up in (True, False):
                unified = (P.vslideup if up else P.vslidedown)(
                    x, off, backend=backend)
                assert_bitexact(unified, B.slide_baseline(x, off, up=up))


@pytest.mark.parametrize("backend", BACKENDS)
def test_gather_vs_baseline(backend):
    rng = np.random.default_rng(41)
    x = torch.as_tensor(rng.standard_normal((16, 2)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(-2, 20, 16).astype(np.int32))
    assert_bitexact(P.vrgather(x, idx, backend=backend),
                    B.gather_baseline(x, idx))


@pytest.mark.parametrize("backend", BACKENDS)
def test_dispatch_vs_argsort_baseline(backend):
    """Top-1 routing from ``make_routing`` (positions from the moe_route
    transform's plain version) dispatched on the crossbar equals the
    sort-based baseline, overflow included."""
    rng = np.random.default_rng(42)
    for t, e, cap in ((32, 4, 32), (32, 4, 5)):
        logits = torch.as_tensor(rng.standard_normal((t, e)).astype(
            np.float32))
        routing = md.make_routing(logits, num_experts=e, k=1, capacity=cap)
        x = torch.as_tensor(rng.standard_normal((t, 8)).astype(np.float32))
        assert_bitexact(md.dispatch(x, routing, backend=backend),
                        B.moe_dispatch_argsort_baseline(
                            x, routing.expert_ids, e, cap))


def test_sequential_baseline_takes_n_steps(monkeypatch):
    """The sequential datapath makes one step an element whatever the
    mask (its latency is proportional to N)."""
    calls = []
    real = torch.Tensor.__add__
    for n in (4, 16):
        calls.clear()
        x = torch.ones(n, 2)

        def counting_add(a, b, _real=real):
            calls.append(1)
            return _real(a, b)

        monkeypatch.setattr(torch.Tensor, "__add__", counting_add)
        B.compress_baseline_sequential(x, torch.zeros(n, dtype=torch.bool))
        monkeypatch.setattr(torch.Tensor, "__add__", real)
        assert len(calls) == 2 * n      # out + row, cursor + bit
