"""The fused vcompress of the port against the JAX reference.

``ops.fused_vcompress`` (on CPU tensors: its plain version) against the
Pallas kernel in interpret mode and the reference's oracle, bit-exact:
the operation moves rows and rounds nothing.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fused_compress import fused_vcompress_cuda
from test_torch_support import (assert_bitexact, jax_ref,  # noqa: F401
                                reset_torch_state)  # noqa: F401


def _inputs(n, d, density, seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    mask = rng.random(n) < density
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    return mask, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tail", ["zero", "bijective"])
@pytest.mark.parametrize("n,density", [(8, 0.5), (100, 0.3), (256, 0.7),
                                       (64, 0.0), (64, 1.0)])
def test_matches_pallas_kernel_and_oracle(jax_ref, n, density, tail, dtype):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.fused_compress import fused_vcompress_pallas
    mask, tx = _inputs(n, 128, density, n, dtype)
    jx = jnp.asarray(tx.to(torch.float32).numpy()).astype(getattr(jnp,
                                                                  dtype))
    got = tops.fused_vcompress(torch.as_tensor(mask), tx, tail=tail)
    assert got.dtype == tx.dtype
    assert_bitexact(got, fused_vcompress_pallas(jnp.asarray(mask), jx,
                                                tail=tail, interpret=True))
    assert_bitexact(got, jref.fused_vcompress_ref(jnp.asarray(mask), jx,
                                                  tail=tail))
    assert launch_counts()["fused_vcompress"] == 0     # CPU: plain version


def test_unaligned_width_integer_payload_and_int_mask(jax_ref):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    rng = np.random.default_rng(1)
    x = rng.integers(-2**23, 2**23, (40, 37)).astype(np.int32)
    mask = rng.integers(0, 2, 40).astype(np.int32)
    for tail in ("zero", "bijective"):
        got = tops.fused_vcompress(torch.as_tensor(mask), torch.as_tensor(x),
                                   tail=tail)
        assert got.dtype == torch.int32
        assert_bitexact(got, jops.fused_vcompress(
            jnp.asarray(mask), jnp.asarray(x), tail=tail, interpret=True))


def test_any_length_against_the_oracle(jax_ref):
    """The reference kernel holds N in one VMEM block (about 2048 rows);
    the port takes any N."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    mask, tx = _inputs(5000, 6, 0.4, 2, "float32")
    got = tops.fused_vcompress(torch.as_tensor(mask), tx)
    assert_bitexact(got, jref.fused_vcompress_ref(jnp.asarray(mask),
                                                  jnp.asarray(tx.numpy())))


@pytest.mark.parametrize("dtype", ["int32", "int64", "int8", "bool"])
def test_integer_payloads_move_exactly_at_any_magnitude(dtype):
    """Rows move as bits: integers past the reference's float32 limit of
    2^24, and 1-byte payloads of odd width, come out exact."""
    rng = np.random.default_rng(4)
    info = np.iinfo(dtype) if dtype != "bool" else None
    x = (rng.integers(info.min, info.max, (30, 5), dtype=dtype, endpoint=True)
         if info else rng.random((30, 5)) < 0.5)
    mask = rng.random(30) < 0.4
    for tail in ("zero", "bijective"):
        want = np.concatenate([x[mask], x[~mask]])
        if tail == "zero":
            want[int(mask.sum()):] = 0
        got = tops.fused_vcompress(torch.as_tensor(mask), torch.as_tensor(x),
                                   tail=tail)
        assert got.dtype == torch.as_tensor(x).dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_plain_version_is_a_bijection_onto_the_packed_order():
    mask, tx = _inputs(33, 3, 0.5, 3, "float32")
    m = torch.as_tensor(mask)
    out = tref.fused_vcompress(m, tx, tail="bijective")
    order = torch.argsort((~m).to(torch.int8), stable=True)
    assert_bitexact(out, tx[order])
    zero = tref.fused_vcompress(m, tx, tail="zero")
    k = int(m.sum())
    assert_bitexact(zero[:k], tx[m])
    assert not bool(zero[k:].any())


def test_refuses_what_it_cannot_take():
    x = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="tail"):
        tops.fused_vcompress(torch.ones(4, dtype=torch.bool), x, tail="keep")
    with pytest.raises(ValueError, match="mask"):
        tops.fused_vcompress(torch.ones(3, dtype=torch.bool), x)
    with pytest.raises(ValueError, match="CUDA"):
        fused_vcompress_cuda(torch.ones(4, dtype=torch.bool), x)
    assert launch_counts()["fused_vcompress"] == 0


@pytest.mark.parametrize("n", [1, 31, 2048, 5000])
def test_launch_geometry(n):
    """Rows split into whole CTAs of a multiple of 16 rows, at most two
    CTAs an SM, capped for narrow rows at row_bytes / mask bytes (each CTA
    reads the whole mask); vectors as wide as the pitch and addresses
    allow, 1-32 lanes a row."""
    from repro_torch.kernels import fused_compress as fck
    sms = 132
    for row_bytes, align, mask_bytes, vec, lanes in (
            (8192, 256, 1, 16, 32),     # (N, 4096) bf16: 512 vectors a row
            (28, 256, 1, 4, 8),         # 7 float32: 7 words
            (28, 256, 8, 4, 8),         # ... under an int64 mask
            (8200, 256 + 8, 1, 8, 32),  # 4100 bf16, 8-byte aligned
            (3, 1, 4, 1, 4)):           # 3 int8, an odd address
        geo = fck.launch_geometry(n, row_bytes, mask_bytes, align, sms)
        per, grid = geo["rows_per_cta"], geo["grid"]
        assert per % fck.ROW_ALIGN == 0
        assert (grid - 1) * per < n <= grid * per
        assert grid <= max(1, min(fck.CTAS_PER_SM * sms,
                                  row_bytes // mask_bytes))
        assert (geo["vec_bytes"], 1 << geo["lpr_log2"]) == (vec, lanes)
    wide = fck.launch_geometry(n, 8192, 1, 256, sms)
    # 16 rows a CTA up to 264 CTAs (4224 rows), then 32 rows a CTA
    assert wide["grid"] == (-(-n // 16) if n <= 4224 else -(-n // 32))
    narrow = fck.launch_geometry(n, 3, 1, 1, sms)
    assert narrow["grid"] <= 3                  # 3-byte rows: 3 CTAs at most


@pytest.mark.parametrize("dtype", ["bool", "int8", "uint8", "int16", "int32",
                                   "int64", "float16", "bfloat16", "float32",
                                   "float64", "complex64"])
def test_mask_reaches_the_kernel_in_its_own_dtype(dtype):
    """Bool, integer and floating masks go to the kernel as they are (no
    cast kernel): the kernel tests an element's bits under ``keep`` —
    every bit for integers, all but the sign bit for floats, so -0.0 does
    not select.  Complex masks are compared with 0 first.  The keep mask
    applied to the raw bits here gives the plain version's selection."""
    from repro_torch.kernels import fused_compress as fck
    vals = torch.tensor([0, 1, 0, 3, 0, 0, 1, 2])
    mask = vals.to(getattr(torch, dtype))
    if mask.dtype.is_floating_point:
        mask[0] = -0.0
        mask[3] = -2.5
    got, es, keep_lo, keep_hi = fck.mask_operand(mask)
    assert (got is mask) == (dtype != "complex64")
    assert es == got.element_size()
    keep = (keep_hi << 32) | keep_lo
    raw = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    bits = got.view(raw[es]).to(torch.int64)
    if es == 8:                 # int64 carriers: sign bit through the view
        sel = (bits & (keep - (1 << 64) if keep >= 1 << 63 else keep)) != 0
    else:
        sel = (bits & (keep & ((1 << 8 * es) - 1))) != 0
    assert torch.equal(sel, mask != 0)
