"""Port vs reference: payload dtypes on the four crossbar backends.

The kernels carry real and integer payloads only.  A complex payload
on 'kernel' or 'sparse' is refused with ``KernelLaunchError`` before
any schedule is compiled or the payload is cast, on every device (here
the CPU, where the kernel backends run their plain versions), as the
reference's Pallas kernels raise on it.  'einsum' and 'auto' keep the
reference's values; 'reference' drops the imaginary part in both
packages (ROADMAP P12).  float16 and the narrow integer and bool
payloads agree with the reference on all four backends."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import crossbar as jxb
from repro.core import moe_dispatch as jmd
from repro.core import permute as jP
from repro.kernels import ops as jops
from repro_torch.core import crossbar as txb
from repro_torch.core import moe_dispatch as tmd
from repro_torch.core import permute as tP
from repro_torch.core import semiring as tsr
from repro_torch.kernels import ops as tops
from repro_torch.kernels._build import KernelLaunchError
from test_torch_support import (assert_bitexact, jax_ref, one_thread,
                                reset_torch_state, to_numpy)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

N = 8
BACKENDS = ("reference", "einsum", "kernel", "sparse", "auto")


def _complex_payload(d=None):
    x = np.arange(N) * (1 + 2j)
    if d is not None:
        x = x[:, None] * (1 + np.arange(d))[None, :]
    return x.astype(np.complex64)


def _reversed():
    return np.arange(N)[::-1].astype(np.int32)


@pytest.mark.parametrize("backend", ["kernel", "sparse"])
def test_kernel_backends_refuse_complex_as_the_reference_does(jax_ref,
                                                              backend):
    x, idx = _complex_payload(), _reversed()
    with pytest.raises(jops.KernelLaunchError):
        jP.vrgather(jnp.asarray(x), jnp.asarray(idx), backend=backend)
    compiles = txb.compile_cache_info()
    with pytest.raises(KernelLaunchError, match="complex64"):
        tP.vrgather(torch.as_tensor(x), torch.as_tensor(idx),
                    backend=backend)
    # refused before the tile schedule was built
    assert txb.compile_cache_info() == compiles


@pytest.mark.parametrize("backend", ["einsum", "auto"])
def test_einsum_and_auto_keep_the_reference_on_complex(jax_ref, backend):
    x, idx = _complex_payload(), _reversed()
    want = jP.vrgather(jnp.asarray(x), jnp.asarray(idx), backend=backend)
    got = tP.vrgather(torch.as_tensor(x), torch.as_tensor(idx),
                      backend=backend)
    assert_bitexact(got, want)
    assert to_numpy(got)[0] == 7 + 14j


def test_reference_backend_drops_the_imaginary_part_in_both(jax_ref):
    """P12: the index oracle sums in float32 in both packages."""
    x, idx = _complex_payload(), _reversed()
    want = jP.vrgather(jnp.asarray(x), jnp.asarray(idx), backend="reference")
    got = tP.vrgather(torch.as_tensor(x), torch.as_tensor(idx),
                      backend="reference")
    assert_bitexact(got, want)
    assert not np.any(to_numpy(got).imag)


@pytest.mark.parametrize("mode", ["gather", "scatter"])
def test_einsum_contraction_keeps_the_imaginary_part(mode):
    """A weighted two-select plan takes the one-hot contraction, not the
    take lowering: the port's holds the complex sum (the reference's
    contracts into float32 and drops the imaginary part, P12)."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, N, (N, 2)).astype(np.int32)
    w = rng.standard_normal((N, 2)).astype(np.float32)
    x = _complex_payload(3)
    want = np.zeros((N, 3), np.complex128)
    for o in range(N):
        for j in range(2):
            if mode == "gather":
                want[o] += w[o, j] * x[idx[o, j]]
            else:
                want[idx[o, j]] += w[o, j] * x[o]
    make = txb.gather_plan if mode == "gather" else txb.scatter_plan
    plan = make(torch.as_tensor(idx), N, weights=torch.as_tensor(w))
    got = txb.apply_plan(plan, torch.as_tensor(x), backend="einsum")
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-5, atol=1e-5)
    for backend in ("kernel", "sparse"):
        with pytest.raises(KernelLaunchError, match="complex64"):
            txb.apply_plan(plan, torch.as_tensor(x), backend=backend)


def test_kernel_wrappers_refuse_complex_on_their_own():
    """The wrappers refuse before any cast, also when called directly."""
    plan = txb.gather_plan(torch.as_tensor(_reversed()[:, None]), N)
    x = torch.as_tensor(_complex_payload(2))
    for call in (lambda: tops.dense_operands(plan, x),
                 lambda: tops.crossbar_permute(plan, x),
                 lambda: tops.sparse_operands(plan, x),
                 lambda: tops.crossbar_permute_sparse(plan, x),
                 lambda: tops.fused_vcompress(torch.ones(N, dtype=torch.bool),
                                              x)):
        with pytest.raises(KernelLaunchError, match="complex64"):
            call()


@pytest.mark.parametrize("backend", ["kernel", "sparse"])
def test_moe_dispatch_and_combine_refuse_complex(jax_ref, backend):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 4)).astype(np.float32)
    x = (rng.standard_normal((6, 3)) + 1j * rng.standard_normal(
        (6, 3))).astype(np.complex64)
    jr = jmd.make_routing(jnp.asarray(logits), num_experts=4, k=2,
                          capacity=3)
    with pytest.raises(jops.KernelLaunchError):
        jmd.dispatch(jnp.asarray(x), jr, backend=backend)
    tr = tmd.make_routing(torch.as_tensor(logits), num_experts=4, k=2,
                          capacity=3)
    with pytest.raises(KernelLaunchError, match="complex64"):
        tmd.dispatch(torch.as_tensor(x), tr, backend=backend)
    y = torch.zeros(4, 3, 3, dtype=torch.complex64)
    with pytest.raises(KernelLaunchError, match="complex64"):
        tmd.combine(y, tr, backend=backend)


def test_gf2_plan_refuses_complex_with_the_references_error(jax_ref):
    idx = _reversed()[:, None]
    x = _complex_payload()
    for backend in ("einsum", "kernel"):
        jplan = jxb.gather_plan(jnp.asarray(idx), N,
                                semiring=jxb.GF2)
        with pytest.raises(ValueError, match="small integers"):
            jxb.apply_plan(jplan, jnp.asarray(x), backend=backend)
        tplan = txb.gather_plan(torch.as_tensor(idx), N, semiring=tsr.GF2)
        with pytest.raises(ValueError, match="small integers"):
            txb.apply_plan(tplan, torch.as_tensor(x), backend=backend)


@pytest.mark.parametrize("dtype", ["float16", "int8", "uint8", "int16",
                                   "bool"])
def test_narrow_payloads_agree_on_every_backend(jax_ref, dtype):
    rng = np.random.default_rng(1)
    if dtype == "bool":
        x = rng.integers(0, 2, (N, 3)).astype(bool)
    elif dtype == "float16":
        x = rng.standard_normal((N, 3)).astype(np.float16)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max + 1, (N, 3)).astype(dtype)
    idx = rng.integers(-1, N, (N,)).astype(np.int32)
    two = np.stack([_reversed(), np.full(N, -1, np.int32)], 1)
    for backend in BACKENDS:
        want = jP.vrgather(jnp.asarray(x), jnp.asarray(idx), backend=backend)
        got = tP.vrgather(torch.as_tensor(x), torch.as_tensor(idx),
                          backend=backend)
        assert got.dtype == torch.as_tensor(x).dtype
        assert_bitexact(got, want)
        # two selects, one of them DROP: the contraction, not the take
        jplan = jxb.gather_plan(jnp.asarray(two), N)
        tplan = txb.gather_plan(torch.as_tensor(two), N)
        assert_bitexact(txb.apply_plan(tplan, torch.as_tensor(x),
                                       backend=backend),
                        jxb.apply_plan(jplan, jnp.asarray(x),
                                       backend=backend))


def test_one_integer_helper_counts_complex_as_not_integer():
    """The kernel layer holds the one helper; ``core.crossbar`` keeps no
    copy of its own."""
    assert not hasattr(txb, "is_integer_payload")
    assert not hasattr(txb, "_is_int") and not hasattr(tops, "_is_int")
    ints = (torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64,
            torch.bool)
    for dtype in ints:
        assert tops.is_integer_payload(torch.zeros(1, dtype=dtype))
    for dtype in (torch.float16, torch.bfloat16, torch.float32,
                  torch.complex64, torch.complex128):
        assert not tops.is_integer_payload(torch.zeros(1, dtype=dtype))
