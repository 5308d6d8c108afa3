"""AES-128 and the GF(2^k) bit lift in the port.

FIPS-197 (Appendix B, C.1) and NIST SP 800-38A (F.5.1, F.5.2) on every
crossbar backend ('kernel' and 'sparse' through their plain versions on
the CPU), fused and chained; the tables, every registered plan and the
lifted plans' control equal the reference's element for element; the
lift cache's LRU and its integrity guard.  Every comparison is
bit-exact.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import crossbar as jxb
from repro.core import semiring as jsr
from repro.crypto import aes as JA
from repro.crypto import aes_layers as JL
from repro.crypto.registry import REGISTRY as JREG
from repro_torch.core import crossbar as txb
from repro_torch.core import integrity
from repro_torch.core import semiring as tsr
from repro_torch.core import telemetry
from repro_torch.core.integrity import IntegrityError
from repro_torch.core.static_registry import FixedLatencyError
from repro_torch.crypto import aes as TA
from repro_torch.crypto import aes_layers as TL
from repro_torch.crypto.registry import registry
from test_torch_support import (assert_bitexact, jax_ref,
                                reset_torch_state)  # noqa: F401

BACKENDS = ["reference", "einsum", "kernel", "sparse"]

FIPS_B = (bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c"),
          bytes.fromhex("3243f6a8885a308d313198a2e0370734"),
          bytes.fromhex("3925841d02dc09fbdc118597196a0b32"))
FIPS_C1 = (bytes.fromhex("000102030405060708090a0b0c0d0e0f"),
           bytes.fromhex("00112233445566778899aabbccddeeff"),
           bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a"))
CTR_KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
CTR_IV = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
CTR_PLAIN = bytes.fromhex(
    "6bc1bee22e409f96e93d7e117393172a" "ae2d8a571e03ac9c9eb76fac45af8e51"
    "30c81c46a35ce411e5fbc1191a0a52ef" "f69f2445df4f9b17ad2b417be66c3710")
CTR_CIPHER = bytes.fromhex(
    "874d6191b620e3261bef6864990db6ce" "9806f66b7970fdff8617187bb9fffdff"
    "5ae4df3edbd5d35e5b4f09020db03eab" "1e031dda2fbe03d1792170a0f3009cee")

PLAN_KEYS = ["aes/mix_columns", "aes/inv_mix_columns", "aes/sbox",
             "aes/inv_sbox", "aes/shift_rows", "aes/inv_shift_rows",
             "aes/shift_rows_mix_columns",
             "aes/inv_shift_rows_inv_mix_columns"]


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "chained"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_fips197_vectors(backend, fuse):
    for key, plain, cipher in (FIPS_B, FIPS_C1):
        kw = dict(backend=backend, fuse_layers=fuse, device="cpu")
        assert TA.aes128_encrypt(key, plain, **kw) == cipher
        assert TA.aes128_decrypt(key, cipher, **kw) == plain


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "chained"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_sp800_38a_ctr(backend, fuse):
    kw = dict(backend=backend, fuse_layers=fuse, device="cpu")
    assert TA.aes128_ctr_xor(CTR_KEY, CTR_IV, CTR_PLAIN, **kw) \
        == CTR_CIPHER                                            # F.5.1
    assert TA.aes128_ctr_xor(CTR_KEY, CTR_IV, CTR_CIPHER, **kw) \
        == CTR_PLAIN                                             # F.5.2
    assert TA.aes128_ctr_xor(CTR_KEY, CTR_IV, CTR_PLAIN[:37], **kw) \
        == CTR_CIPHER[:37]
    assert TA.aes128_ctr_xor(CTR_KEY, CTR_IV, b"", **kw) == b""


def test_ctr_counter_wraps_mod_2_128():
    iv = b"\xff" * 16
    blocks = TA._ctr_blocks(iv, 2)
    assert blocks == b"\xff" * 16 + b"\x00" * 16
    with pytest.raises(ValueError, match="16 bytes"):
        TA._ctr_blocks(iv[:8], 1)


def test_tables_match_reference(jax_ref):
    for got, want in zip(TA.sbox_tables(), JA.sbox_tables()):
        assert_bitexact(got, want)
    for key in (FIPS_B[0], FIPS_C1[0]):
        assert_bitexact(TA.key_expansion(key), JA.key_expansion(key))
    rk = TA.key_expansion(FIPS_B[0])[3]
    assert_bitexact(TA._inv_mix_key(rk), JA._inv_mix_key(rk))
    assert_bitexact(tsr.gf2_8_bit_matrix_table(),
                    jsr.gf2_8_bit_matrix_table())
    for a in (0, 1, 2, 0x53, 0xCA, 0xFF):
        assert tsr.gf2_8_inv(a) == jsr.gf2_8_inv(a)
        assert tsr.gf2_8_pow(a, 7) == jsr.gf2_8_pow(a, 7)


def _register_reference_plans():
    JL._register()
    for inverse in (False, True):
        JA.mix_columns_plan(inverse=inverse)
        JA.sbox_plan(inverse=inverse)
        JA.round_linear_plan(inverse=inverse)


def _register_port_plans():
    for inverse in (False, True):
        TA.mix_columns_plan(inverse=inverse, device="cpu")
        TA.sbox_plan(inverse=inverse, device="cpu")
        TA.round_linear_plan(inverse=inverse, device="cpu")


@pytest.mark.parametrize("key", PLAN_KEYS)
def test_registered_plans_match_reference(jax_ref, key):
    _register_reference_plans()
    _register_port_plans()
    jplan, tplan = JREG[key], registry("cpu")[key]
    assert (tplan.mode, tplan.n_in, tplan.n_out, tplan.k,
            tplan.semiring.name) == (jplan.mode, jplan.n_in, jplan.n_out,
                                     jplan.k, jplan.semiring.name)
    assert_bitexact(tplan.idx, np.asarray(jplan.idx))
    if jplan.weights is None:
        assert tplan.weights is None
    else:
        assert_bitexact(tplan.weights.to(torch.int32),
                        np.asarray(jplan.weights).astype(np.int32))


@pytest.mark.parametrize("key", ["aes/mix_columns", "aes/inv_mix_columns",
                                 "aes/shift_rows_mix_columns",
                                 "aes/inv_shift_rows_inv_mix_columns"])
def test_lift_matches_reference(jax_ref, key):
    _register_reference_plans()
    _register_port_plans()
    jl = jxb.lift_gf2_8(JREG[key])
    tl = txb.lift_gf2_8(registry("cpu")[key])
    assert (tl.mode, tl.n_in, tl.n_out, tl.k, tl.semiring.name) == (
        jl.mode, jl.n_in, jl.n_out, jl.k, jl.semiring.name) == (
        "gather", 128, 128, 32, "gf2")
    assert tl.weights is None and jl.weights is None
    assert_bitexact(tl.idx, np.asarray(jl.idx))


@pytest.mark.parametrize("width", [4, 8, 16])
def test_gf2k_tile_table_matches_reference(jax_ref, width):
    poly = tsr.DEFAULT_POLYS[width]
    assert_bitexact(tsr.gf2k_tile_table(width, poly),
                    jsr.gf2k_tile_table(width, poly))
    rng = np.random.default_rng(width)
    a = rng.integers(0, 1 << width, 64).astype(np.int32)
    b = rng.integers(0, 1 << width, 64).astype(np.int32)
    want = [tsr.gf2k_mul_int(int(x), int(y), width, poly)
            for x, y in zip(a, b)]
    assert_bitexact(tsr.gf2k_mul(a, b, width, poly), np.array(want))
    assert_bitexact(tsr.gf2k_mul(torch.as_tensor(a), torch.as_tensor(b),
                                 width, poly), np.array(want))
    assert_bitexact(tsr.gf2k_xtime(a, width, poly),
                    jsr.gf2k_xtime(a, width, poly))


def test_gf2_k_family_is_interned():
    assert tsr.gf2_k(8) is tsr.GF2_8 and tsr.gf2_k(1) is tsr.GF2
    assert tsr.gf2_k(16) is tsr.gf2_k(16) is tsr.get("gf2_16")
    assert tsr.gf2_k(4, 0x19).name == "gf2_4_p19"
    with pytest.raises(ValueError, match="degree"):
        tsr.gf2_k(8, 0x1B)
    # wide widths carry byte limbs (GHASH's GF(2^128)); the default and
    # the named polynomial intern to one member
    for width, poly in ((32, (1 << 32) | 0x8D), (128, None)):
        g = tsr.gf2_k(width, poly)
        assert g.limbs == width // 8 and g is tsr.gf2_k(width, g.poly)
    with pytest.raises(ValueError, match="multiples of 8"):
        tsr.gf2_k(36, (1 << 36) | 0x9)


@pytest.mark.parametrize("width,mode", [(4, "gather"), (8, "scatter"),
                                        (16, "gather"), (16, "scatter")])
def test_gf2k_plans_on_every_backend_match_reference(jax_ref, width, mode):
    """A random GF(2^width) plan (DROPs, collisions in scatter form) on
    the port's lifted backends equals the reference's direct field
    arithmetic, and the lifted control equals the reference's."""
    rng = np.random.default_rng(width + (mode == "scatter"))
    n, k, d = 20, 3, 5
    idx = rng.integers(-2, n + 2, (n, k)).astype(np.int32)
    w = rng.integers(0, 1 << width, (n, k)).astype(np.int32)
    x = rng.integers(0, 1 << width, (n, d)).astype(np.int32)
    jsemi, tsemi = jsr.gf2_k(width), tsr.gf2_k(width)
    make = jxb.gather_plan if mode == "gather" else jxb.scatter_plan
    jplan = make(jnp.asarray(idx), n, weights=jnp.asarray(w),
                 semiring=jsemi)
    tplan = txb.plan_from_numpy(mode, idx, n, n, weights=w,
                                semiring=tsemi, device="cpu")
    want = jxb.apply_plan(jplan, jnp.asarray(x), backend="reference")
    for backend in BACKENDS:
        assert_bitexact(txb.apply_plan(tplan, torch.as_tensor(x),
                                       backend=backend), want)
    assert_bitexact(txb.lift_gf2_k(tplan).idx,
                    np.asarray(jxb.lift_gf2_k(jplan).idx))


@functools.lru_cache(maxsize=None)
def _jax_cipher(data: bytes, inverse: bool) -> bytes:
    fn = JA.aes128_decrypt if inverse else JA.aes128_encrypt
    return fn(FIPS_B[0], data, backend="reference")


@pytest.mark.parametrize("backend", BACKENDS)
def test_blocks_equal_jax_package(jax_ref, backend):
    data = bytes(np.random.default_rng(3).integers(0, 256, 64,
                                                   dtype=np.uint8))
    for inverse in (False, True):
        fn = TA.aes128_decrypt if inverse else TA.aes128_encrypt
        assert fn(FIPS_B[0], data, backend=backend,
                  device="cpu") == _jax_cipher(data, inverse)


@pytest.mark.parametrize("backend", BACKENDS)
def test_layers_equal_jax_package(jax_ref, backend):
    st = np.random.default_rng(4).integers(0, 256, (16, 3)).astype(np.int32)
    tst = torch.as_tensor(st)
    for inverse in (False, True):
        assert_bitexact(
            TA.mix_columns(tst, inverse=inverse, backend=backend),
            JA.mix_columns(jnp.asarray(st), inverse=inverse,
                           backend="reference"))
        assert_bitexact(
            TA.sub_bytes(tst, inverse=inverse, backend=backend),
            JA.sub_bytes(jnp.asarray(st), inverse=inverse,
                         backend="reference"))
    assert_bitexact(TL.shift_rows(tst, backend=backend),
                    JL.shift_rows(jnp.asarray(st), backend="reference"))
    assert_bitexact(TL.inv_shift_rows(tst, backend=backend),
                    JL.inv_shift_rows(jnp.asarray(st), backend="reference"))
    assert_bitexact(TA.mix_columns(st[:, 0], backend=backend, device="cpu"),
                    JA.mix_columns(jnp.asarray(st[:, 0])))


@pytest.mark.parametrize("fuse,passes", [(True, 20), (False, 29)],
                         ids=["fused", "chained"])
def test_fixed_latency_pass_counts(fuse, passes):
    rng = np.random.default_rng(5)
    for backend in ("kernel", "sparse"):
        with telemetry.delta() as d:
            for _ in range(2):
                data = bytes(rng.integers(0, 256, 48, dtype=np.uint8))
                TA.aes128_encrypt(FIPS_C1[0], data, backend=backend,
                                  fuse_layers=fuse, fixed_latency=True,
                                  device="cpu")
                TA.aes128_decrypt(FIPS_C1[0], data, backend=backend,
                                  fuse_layers=fuse, fixed_latency=True,
                                  device="cpu")
        assert d()[f"apply_calls_{backend}"] == 4 * passes
    reg = registry("cpu")
    sig = reg._observed[(("aes128", "encrypt", fuse), ((16, 3), "torch.int32"),
                         "sparse")]
    assert sig[0] == passes
    # the GF(2^8) plans fingerprint their executed lift
    lifted = [fp for fp in sig[1] if fp[4] == "gf2_8"]
    assert lifted and all(fp[-1][0] == "lift" for fp in lifted)
    with telemetry.delta() as d:
        TA.mix_columns(torch.zeros(16, 2, dtype=torch.int32),
                       backend="kernel", fixed_latency=True)
    assert d()["apply_calls"] == 1


def test_lift_cache_hits_misses_and_evicts():
    txb.clear_lift_cache()
    rng = np.random.default_rng(6)

    def plan():
        return txb.plan_from_numpy(
            "gather", rng.integers(0, 16, (16, 4)), 16, 16,
            weights=rng.integers(0, 256, (16, 4)).astype(np.int32),
            semiring=tsr.GF2_8, device="cpu")

    first = plan()
    lifted = txb.lift_gf2_k(first)
    assert txb.lift_gf2_k(first) is lifted
    info = txb.lift_cache_info()
    assert (info["hits"], info["misses"], info["size"]) == (1, 1, 1)
    for _ in range(info["capacity"]):
        txb.lift_gf2_k(plan())
    info = txb.lift_cache_info()
    assert info["size"] == info["capacity"]
    again = txb.lift_gf2_k(first)                     # evicted: rebuilt
    assert again is not lifted
    assert_bitexact(again.idx, lifted.idx)
    assert txb.lift_cache_info()["misses"] == info["capacity"] + 2
    with pytest.raises(ValueError, match="GF\\(2\\^k\\)"):
        txb.lift_gf2_k(txb.gather_plan(first.idx, 16))
    with pytest.raises(ValueError, match="GF2_8"):
        txb.lift_gf2_8(txb.gather_plan(first.idx, 16, semiring=tsr.GF2))
    txb.clear_lift_cache()
    assert txb.lift_cache_info()["size"] == 0


def test_lift_corruption_caught_and_rebuilt():
    txb.clear_lift_cache()
    plan = TA.mix_columns_plan(device="cpu")
    want = txb.lift_gf2_k(plan).idx.clone()
    with integrity.always_verify():
        cached = txb.lift_gf2_k(plan)
        assert txb.lift_gf2_k(plan) is cached          # verified hit
        cached.idx[5, 3] ^= 1                          # a flipped bit
        with pytest.raises(IntegrityError) as ei:
            txb.lift_gf2_k(plan)
        assert ei.value.guard == "lift"
        again = txb.lift_gf2_k(plan)
    assert again is not cached
    assert_bitexact(again.idx, want)
    assert telemetry.snapshot().get("integrity_faults", 0) >= 1
    txb.clear_lift_cache()


def test_registry_execute_keys_info():
    TA.mix_columns_plan(device="cpu")
    reg = registry("cpu")
    assert "aes/mix_columns" in set(reg.keys())
    info = reg.info()
    assert info["name"] == "crypto@cpu" and info["plans"] >= 1
    st = torch.arange(32, dtype=torch.int32).reshape(16, 2)
    assert_bitexact(reg.execute("aes/mix_columns", st, backend="sparse"),
                    reg.execute("aes/mix_columns", st, backend="reference"))
    assert_bitexact(reg.execute("aes/mix_columns", st, fixed_latency=True,
                                audit_host_syncs=True),
                    reg.execute("aes/mix_columns", st, backend="reference"))
    # The kernels' check that an integer payload fits float32 reads its
    # values on the host (as the reference's does): the audit refuses it.
    with pytest.raises(FixedLatencyError, match="host sync"):
        reg.execute("aes/mix_columns", st, backend="sparse",
                    fixed_latency=True, audit_host_syncs=True)


def test_bad_arguments():
    with pytest.raises(ValueError, match="multiple of 16"):
        TA.aes128_encrypt(FIPS_C1[0], b"short", device="cpu")
    with pytest.raises(ValueError, match="16 bytes"):
        TA.key_expansion(b"k" * 15)
    with pytest.raises(ValueError, match="byte rows"):
        TA.mix_columns(torch.zeros(8, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="requested"):
        TA.sub_bytes(torch.zeros(16, dtype=torch.int32), device="meta")
