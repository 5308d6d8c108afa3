"""AES-128-GCM, GHASH and the GF(2^128) lift in the port.

Oracles: the NIST CAVP vectors (McGrew-Viega test cases 1-4) and an
independent pure-Python GCM on big-endian field ints (the FIPS bit
order, the opposite of the engine's reflected limbs), both as the JAX
package's ``tests/test_gcm.py`` has them, over the port's own host AES.
Against the JAX reference (under the ``jax_ref`` alias): the limb
arithmetic, the wide lift and ``apply_plan`` on every backend, GHASH,
and the fused seal/open with its program step for step.  Every
comparison is bit-exact.  The register-file placement of the
megakernel's word layout is checked here at GCM's geometries.

Nothing here imports JAX at module level: the card tests import the
oracle from this file on a machine without it.
"""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import crossbar as txb
from repro_torch.core import plan_program as tpp
from repro_torch.core import semiring as tsr
from repro_torch.core import telemetry
from repro_torch.core.static_registry import FixedLatencyError
from repro_torch.crypto import aes as TA
from repro_torch.crypto import gcm as TG
from repro_torch.kernels import plan_program_kernel as ppk
from test_torch_support import (assert_bitexact, jax_ref,  # noqa: F401
                                reset_torch_state)

BACKENDS = ("einsum", "reference", "kernel", "sparse")
KEY = bytes(range(16))
SMEM = 232448                # the H100's opt-in shared memory a block


# ---------------------------------------------------------------------------
# Independent oracle (big-endian field convention)
# ---------------------------------------------------------------------------

def _gmul(x: int, y: int) -> int:
    r = 0xE1000000000000000000000000000000
    z, v = 0, x
    for i in range(127, -1, -1):
        if (y >> i) & 1:
            z ^= v
        v = (v >> 1) ^ (r if v & 1 else 0)
    return z


def ghash_ref(h: bytes, data: bytes) -> bytes:
    hi = int.from_bytes(h, "big")
    y = 0
    for i in range(0, len(data), 16):
        y = _gmul(hi, y ^ int.from_bytes(data[i:i + 16], "big"))
    return y.to_bytes(16, "big")


def aes_ref(key: bytes, block: bytes) -> bytes:
    return TG._host_encrypt_block(TA.key_expansion(key), block)


def gcm_ref(key: bytes, iv: bytes, pt: bytes, aad: bytes = b""):
    """(ciphertext, tag) of one record."""
    assert len(iv) == 12
    h = aes_ref(key, b"\x00" * 16)
    ct = b""
    for t in range(-(-len(pt) // 16)):
        ks = aes_ref(key, iv + (t + 2).to_bytes(4, "big"))
        ct += bytes(a ^ b for a, b in zip(pt[16 * t:16 * t + 16], ks))

    def pad(x):
        return x + b"\x00" * ((-len(x)) % 16)

    lens = ((8 * len(aad)).to_bytes(8, "big")
            + (8 * len(pt)).to_bytes(8, "big"))
    s = ghash_ref(h, pad(aad) + pad(ct) + lens)
    tag = bytes(a ^ b for a, b in
                zip(s, aes_ref(key, iv + b"\x00\x00\x00\x01")))
    return ct, tag


_K34 = bytes.fromhex("feffe9928665731c6d6a8f9467308308")
_IV34 = bytes.fromhex("cafebabefacedbaddecaf888")
_PT3 = bytes.fromhex(
    "d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
    "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b391aafd255")
_CT3 = bytes.fromhex(
    "42831ec2217774244b7221b784d0d49ce3aa212f2c02a4e035c17e2329aca12e"
    "21d514b25466931c7d8f6a5aac84aa051ba30b396a0aac973d58e091473f5985")
_AAD4 = bytes.fromhex("feedfacedeadbeeffeedfacedeadbeefabaddad2")

# (key, iv, pt, aad, ct, tag): empty; one zero block; 4 full blocks; AAD
# with a 60-byte plaintext (a partial final block).
CAVP = [
    (b"\x00" * 16, b"\x00" * 12, b"", b"", b"",
     bytes.fromhex("58e2fccefa7e3061367f1d57a4e7455a")),
    (b"\x00" * 16, b"\x00" * 12, b"\x00" * 16, b"",
     bytes.fromhex("0388dace60b6a392f328c2b971b2fe78"),
     bytes.fromhex("ab6e47d42cec13bdf53a67b21257bddf")),
    (_K34, _IV34, _PT3, b"", _CT3,
     bytes.fromhex("4d5c2af327cd64a62cf35abd2ba6fab4")),
    (_K34, _IV34, _PT3[:60], _AAD4, _CT3[:60],
     bytes.fromhex("5bc94fbc3221a5db94fae95ae7121a47")),
]


def vecs(pt_len, aad_len, b=3, seed=0):
    """B records of one geometry: (ivs, plaintexts, aads), from a seed."""
    rng = np.random.default_rng(seed)

    def draw(n):
        return [bytes(rng.integers(0, 256, n, dtype=np.uint8))
                for _ in range(b)]

    return draw(12), draw(pt_len), draw(aad_len)


# The two geometries held against the JAX reference's fused path (B <= 4,
# m <= 2): a partial final block without AAD, and full blocks with AAD.
JAX_GEOMETRIES = [(20, 0, 2), (32, 16, 3)]


@pytest.fixture(scope="module")
def jax_module():
    """``jax_ref`` for a whole module: the reference's outputs that take
    seconds a call (its interpret-mode kernels, its wide lift) are
    computed once and shared by the tests that compare against them."""
    import jax
    from jax._src import core as jax_core
    from repro.crypto.registry import REGISTRY
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "trace_state_clean",
                   jax_core.trace_state_clean, raising=False)
        tables = (REGISTRY._plans, REGISTRY._programs, REGISTRY._observed,
                  REGISTRY._quarantined)
        saved = [dict(t) for t in tables]
        yield
        for table, before in zip(tables, saved):
            table.clear()
            table.update(before)


# ---------------------------------------------------------------------------
# Anchors
# ---------------------------------------------------------------------------

def test_oracle_matches_cavp_and_fips197():
    for key, iv, pt, aad, ct, tag in CAVP:
        assert gcm_ref(key, iv, pt, aad) == (ct, tag)
    assert aes_ref(bytes.fromhex("000102030405060708090a0b0c0d0e0f"),
                   bytes.fromhex("00112233445566778899aabbccddeeff")) \
        == bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")


@pytest.mark.parametrize("backend", ("fused",) + BACKENDS)
def test_cavp_vectors(backend):
    for key, iv, pt, aad, ct, tag in CAVP:
        sealed = TG.aes128_gcm_seal(key, iv, pt, aad, backend=backend,
                                    device="cpu")
        assert sealed == ct + tag, (backend, sealed.hex())
        assert TG.aes128_gcm_open(key, iv, sealed, aad, backend=backend,
                                  device="cpu") == pt


# ---------------------------------------------------------------------------
# GF(2^128) limbs, the wide lift, GHASH: bit-exact against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [32, 64, 128])
def test_limb_arithmetic_matches_reference(jax_ref, width):
    from repro.core import semiring as jsr
    poly = tsr.gf2_k(width).poly if width == 128 else (
        (1 << width) | 0x8D)
    rng = np.random.default_rng(width)
    a = rng.integers(0, 256, (7, 3, width // 8)).astype(np.int32)
    b = rng.integers(0, 256, (7, 3, width // 8)).astype(np.int32)
    want = np.asarray(jsr.gf2k_mul_limbs(a, b, width, poly))
    assert_bitexact(tsr.gf2k_mul_limbs(a, b, width, poly), want)
    assert_bitexact(tsr.gf2k_mul_limbs(torch.as_tensor(a),
                                       torch.as_tensor(b), width, poly),
                    want)
    assert_bitexact(tsr.gf2k_xtime_limbs(torch.as_tensor(a), width, poly),
                    np.asarray(jsr.gf2k_xtime_limbs(a, width, poly)))
    assert_bitexact(tsr._poly_limbs(poly, width // 8),
                    jsr._poly_limbs(poly, width // 8))
    top = int.from_bytes(rng.integers(0, 256, width // 8,
                                      dtype=np.uint8).tobytes(), "little")
    for v in (0, 1, top):
        limbs = tsr.gf2k_to_limbs(v, width)
        assert_bitexact(limbs, jsr.gf2k_to_limbs(v, width))
        assert tsr.gf2k_from_limbs(limbs) == v == jsr.gf2k_from_limbs(limbs)
    x, y = (tsr.gf2k_from_limbs(a[0, 0]), tsr.gf2k_from_limbs(b[0, 0]))
    assert tsr.gf2k_from_limbs(want[0, 0]) == tsr.gf2k_mul_int(x, y, width,
                                                               poly)
    assert tsr._limb_count(width) == width // 8 and tsr._limb_count(31) == 0


@pytest.mark.parametrize("width", [32, 128])
def test_wide_tile_table_matches_reference(jax_ref, width):
    from repro.core import semiring as jsr
    poly = tsr.gf2_k(width).poly if width == 128 else (1 << 32) | 0x8D
    assert_bitexact(tsr.gf2k_tile_table(width, poly),
                    jsr.gf2k_tile_table(width, poly))


def test_wide_semirings_are_interned_limbed():
    g = tsr.gf2_k(128)
    assert g is tsr.gf2_k(128) is tsr.get("gf2_128")
    assert (g.limbs, g.width, g.poly) == (16, 128, TG.GCM_POLY)
    assert g.carrier_mask is None and g.is_gf2k
    assert tsr.gf2_k(32, (1 << 32) | 0x8D).name == "gf2_32_p10000008d"
    assert_bitexact(g.ones((2,)), np.eye(1, 16, dtype=np.int32).repeat(2, 0))
    with pytest.raises(ValueError, match="multiples of 8"):
        tsr.gf2_k(36, (1 << 36) | 0x9)
    with pytest.raises(ValueError, match="no dense one-hot"):
        txb.build_onehot(TG.ghash_plan(3, mode="horner", device="cpu")[0])


def _wide_plan(mode, module, *, seed=3, n=9, k=3):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-2, n + 1, (n, k)).astype(np.int32)
    w = rng.integers(0, 256, (n, k, 16)).astype(np.int32)
    if module == "torch":
        make = txb.gather_plan if mode == "gather" else txb.scatter_plan
        return make(torch.as_tensor(idx), n, weights=torch.as_tensor(w),
                    semiring=tsr.gf2_k(128))
    import jax.numpy as jnp
    from repro.core import crossbar as jxb
    from repro.core import semiring as jsr
    make = jxb.gather_plan if mode == "gather" else jxb.scatter_plan
    return make(jnp.asarray(idx), n, weights=jnp.asarray(w),
                semiring=jsr.gf2_k(128))


@pytest.mark.parametrize("mode", ["gather", "scatter"])
def test_wide_lift_matches_reference(jax_ref, mode):
    from repro.core import crossbar as jxb
    got = txb.lift_gf2_k(_wide_plan(mode, "torch"))
    want = jxb.lift_gf2_k(_wide_plan(mode, "jax"))
    assert (got.mode, got.n_in, got.n_out) == (want.mode, want.n_in,
                                                want.n_out)
    assert got.semiring is tsr.GF2 and got.weights is None
    assert_bitexact(got.idx, np.asarray(want.idx))
    # the lift is memoised on the source tensors
    plan = _wide_plan(mode, "torch")
    assert txb.lift_gf2_k(plan) is txb.lift_gf2_k(plan)
    bad = txb.gather_plan(plan.idx, plan.n_in, weights=plan.weights[..., :8],
                          semiring=tsr.gf2_k(128))
    with pytest.raises(ValueError, match="limb axis"):
        txb.lift_gf2_k(bad)


WIDE_X = np.random.default_rng(4).integers(0, 256, (9, 4, 16)).astype(
    np.int32)
GHASH_DATA = bytes((i * 7 + 5) & 0xFF for i in range(80))


@pytest.fixture(scope="module")
def jax_wide(jax_module):
    """The reference's wide apply_plan (gather: its lifted einsum path
    and its limb oracle; scatter: its reference path, the lifted plan's
    parity scatter-add) and its GHASH (both modes)."""
    import jax.numpy as jnp
    from repro.core import crossbar as jxb
    from repro.crypto import gcm as JG
    out = {}
    for mode in ("gather", "scatter"):
        plan = _wide_plan(mode, "jax")
        out[mode] = [np.asarray(jxb.apply_plan(plan, jnp.asarray(WIDE_X),
                                               backend=b))
                     for b in (("einsum", "reference") if mode == "gather"
                               else ("reference",))]
    h = TG._hash_key(KEY)
    for mode in ("powers", "horner"):
        out[mode] = JG.ghash(h, GHASH_DATA, mode=mode, backend="reference")
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["gather", "scatter"])
def test_wide_apply_plan_matches_reference(jax_wide, mode, backend):
    """A GF(2^128) plan over (n, 4, 16) limbed payloads: every backend of
    the port equals the reference's (``jax_wide``)."""
    got = txb.apply_plan(_wide_plan(mode, "torch"), torch.as_tensor(WIDE_X),
                         backend=backend)
    for want in jax_wide[mode]:
        assert_bitexact(got, want)
    with pytest.raises(ValueError, match="trailing limb axis"):
        txb.apply_plan(_wide_plan(mode, "torch"), torch.zeros(
            (9, 7), dtype=torch.int32), backend="einsum")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["powers", "horner"])
def test_ghash_matches_reference_and_oracle(jax_wide, mode, backend):
    h = TG._hash_key(KEY)
    with telemetry.delta() as d:
        got = TG.ghash(h, GHASH_DATA, mode=mode, backend=backend,
                       device="cpu")
    assert got == ghash_ref(aes_ref(KEY, b"\x00" * 16), GHASH_DATA)
    assert got == jax_wide[mode]
    assert d()[f"apply_calls_{backend}"] == (1 if mode == "powers" else 5)
    assert TG.ghash(h, b"", device="cpu") == bytes(16)
    with pytest.raises(ValueError, match="whole blocks"):
        TG.ghash(h, b"abc", device="cpu")


def test_mul_bits_and_field_plumbing_match_reference(jax_ref):
    from repro.crypto import gcm as JG
    h = TG._hash_key(KEY)
    assert h == JG._hash_key(KEY)
    assert_bitexact(TG._mul_bits(h), JG._mul_bits(h))
    assert TG._hpowers(h, 5) == JG._hpowers(h, 5)
    block = bytes(range(16))
    assert TG._block_to_field(block) == JG._block_to_field(block)
    assert TG._field_to_block(TG._block_to_field(block)) == block
    bits = np.unpackbits(np.frombuffer(block, np.uint8), bitorder="little")
    got = np.packbits((TG._mul_bits(h) @ bits) % 2, bitorder="little")
    assert got.tobytes() == ghash_ref(aes_ref(KEY, b"\x00" * 16), block)


# ---------------------------------------------------------------------------
# The fused program against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_fused(jax_module):
    """The JAX reference's fused seal/open outputs and programs at
    JAX_GEOMETRIES (its interpret-mode megakernel takes seconds a
    call)."""
    from repro.crypto import gcm as JG
    out = {}
    for pt_len, aad_len, b in JAX_GEOMETRIES:
        ivs, pts, aads = vecs(pt_len, aad_len, b)
        sealed = JG.aes128_gcm_seal_batch(KEY, ivs, pts, aads)
        opened = JG.aes128_gcm_open_batch(KEY, ivs, sealed, aads)
        progs = {mode: _program_content(JG.build_gcm_program(
            KEY, pt_len, aad_len, open_mode=mode == "open")[0])
            for mode in ("seal", "open")}
        out[(pt_len, aad_len)] = (sealed, opened, progs)
    return out


def _program_content(program):
    """Each step as (op, dst, a, b, plan idx, plan weights, const row),
    slot numbers resolved to what they hold."""
    consts = None if program.consts is None else np.asarray(program.consts)
    steps = []
    for s in program.steps:
        idx = w = crow = None
        if s.op == "permute":
            plan = program.plans[s.plan]
            idx = np.asarray(plan.idx.cpu() if torch.is_tensor(plan.idx)
                             else plan.idx)
            if plan.weights is not None:
                w = np.asarray(plan.weights.cpu() if torch.is_tensor(
                    plan.weights) else plan.weights).astype(np.int64)
        if s.const >= 0:
            crow = consts[s.const]
        steps.append((s.op, s.dst, s.a, s.b if s.op in (
            "xor", "and", "andn", "add") else -1, idx, w, crow,
            None if idx is None else program.plans[s.plan].semiring.name))
    return program.n, program.n_regs, program.rounds, steps


@pytest.mark.parametrize("geometry", JAX_GEOMETRIES,
                         ids=lambda g: f"pt{g[0]}-aad{g[1]}-b{g[2]}")
def test_fused_seal_open_match_reference(jax_fused, geometry):
    pt_len, aad_len, b = geometry
    ivs, pts, aads = vecs(pt_len, aad_len, b)
    sealed_j, opened_j, _ = jax_fused[(pt_len, aad_len)]
    sealed = TG.aes128_gcm_seal_batch(KEY, ivs, pts, aads, device="cpu")
    assert sealed == sealed_j
    for r in range(b):
        assert sealed[r] == b"".join(gcm_ref(KEY, ivs[r], pts[r], aads[r]))
    assert TG.aes128_gcm_open_batch(KEY, ivs, sealed, aads,
                                    device="cpu") == opened_j == pts


@pytest.mark.parametrize("mode", ["seal", "open"])
@pytest.mark.parametrize("geometry", JAX_GEOMETRIES,
                         ids=lambda g: f"pt{g[0]}-aad{g[1]}-b{g[2]}")
def test_fused_program_steps_match_reference(jax_fused, geometry, mode):
    """Step for step: op, registers, the content of each step's plan
    (selects, weights, semiring) and constant row.  Slot numbers differ
    by design (the port builds each absorb plan once)."""
    pt_len, aad_len, _ = geometry
    n_j, regs_j, rounds_j, steps_j = jax_fused[(pt_len, aad_len)][2][mode]
    prog, lay = TG.build_gcm_program(KEY, pt_len, aad_len,
                                     open_mode=mode == "open", device="cpu")
    n, regs, rounds, steps = _program_content(prog)
    assert (n, regs, rounds, len(steps)) == (n_j, regs_j, rounds_j,
                                             len(steps_j))
    assert lay == TG._layout(*TG._geometry(pt_len, aad_len)[::2])
    for i, (got, want) in enumerate(zip(steps, steps_j)):
        assert got[:4] == want[:4], i
        assert got[7] == want[7], i
        for part in (4, 5, 6):
            assert (got[part] is None) == (want[part] is None), (i, part)
            if got[part] is not None:
                assert np.array_equal(got[part], want[part]), (i, part)


def test_each_absorb_plan_is_built_once():
    """The plan table does not grow with the record: a 3-block and a
    9-block record (each with a partial last block) have the same plan
    slots — AES's seven, d1, d2, ctr, place_ej0, the full and the masked
    absorb, e2 — and the trips share their absorb plan."""
    counts = {}
    for pt_len in (40, 136):
        for mode in ("seal", "open"):
            prog, _ = TG.build_gcm_program(KEY, pt_len, 0,
                                           open_mode=mode == "open",
                                           device="cpu")
            counts[pt_len, mode] = len(prog.plans)
            absorbs = [s.plan for s in prog.steps if s.op == "permute"
                       and s.dst == (2 if mode == "seal" else 1)
                       and s.a == (1 if mode == "seal" else 2)]
            assert len(absorbs) == -(-pt_len // 16)
            assert len(set(absorbs)) == (2 if mode == "seal" else 1)
    assert counts[40, "seal"] == counts[136, "seal"] == 13
    assert counts[40, "open"] == counts[136, "open"] == 14


# ---------------------------------------------------------------------------
# Contracts: tamper, validation, one launch, counters, fixed latency
# ---------------------------------------------------------------------------

def test_tamper_raises_with_indices():
    ivs, pts, aads = vecs(32, 8, b=4)
    sealed = TG.aes128_gcm_seal_batch(KEY, ivs, pts, aads, device="cpu")
    bad = list(sealed)
    bad[1] = bad[1][:-1] + bytes([bad[1][-1] ^ 1])       # tag bit
    bad[3] = bytes([bad[3][0] ^ 0x80]) + bad[3][1:]      # ciphertext bit
    with pytest.raises(TG.InvalidTagError) as ei:
        TG.aes128_gcm_open_batch(KEY, ivs, bad, aads, device="cpu")
    assert ei.value.indices == (1, 3)
    with pytest.raises(TG.InvalidTagError):
        TG.aes128_gcm_open(KEY, ivs[0], sealed[0], b"not-the-aad",
                           backend="einsum", device="cpu")


def test_geometry_validation():
    with pytest.raises(ValueError, match="96-bit IV"):
        TG.aes128_gcm_seal(KEY, b"\x00" * 16, b"hi", device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        TG.aes128_gcm_seal_batch(KEY, [b"\x00" * 12] * 2, [b"a", b"bb"],
                                 device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        TG.aes128_gcm_seal_batch(KEY, [b"\x00" * 12] * 2, [b"a"],
                                 device="cpu")
    with pytest.raises(ValueError, match="empty"):
        TG.aes128_gcm_seal_batch(KEY, [], [], device="cpu")
    with pytest.raises(ValueError, match="shorter than"):
        TG.aes128_gcm_open(KEY, b"\x00" * 12, b"short", device="cpu")


def test_batch_is_one_launch_with_counters_histogram_and_gauge():
    ivs, pts, aads = vecs(40, 16, b=4)
    TG.gcm_program(KEY, 40, 16, device="cpu")          # warm the registry
    obs.enable()
    try:
        with telemetry.delta() as d:
            sealed = TG.aes128_gcm_seal_batch(KEY, ivs, pts, aads,
                                              device="cpu")
            opened = TG.aes128_gcm_open_batch(KEY, ivs, sealed, aads,
                                              device="cpu")
    finally:
        obs.disable()
    dd = d()
    assert opened == pts
    assert dd["program_launches"] == 2 and dd["apply_calls"] == 0
    assert dd["gcm_seal_calls"] == dd["gcm_open_calls"] == 1
    assert dd["gcm_seal_records"] == dd["gcm_open_records"] == 4
    assert dd["gcm_seal_launches"] == dd["gcm_open_launches"] == 1
    _, prog, _ = TG.gcm_program(KEY, 40, 16, device="cpu")
    assert dd["gcm_passes_avoided"] == prog.passes + TG.gcm_program(
        KEY, 40, 16, open_mode=True, device="cpu")[1].passes
    assert telemetry.counter("gcm_seal_calls") == 1
    names = [s.name for s in obs.finished_spans()]
    assert "gcm_seal" in names and "gcm_open" in names
    span = next(s for s in obs.finished_spans() if s.name == "gcm_seal")
    assert span.attrs == {"records": 4, "blocks": 3, "aad_blocks": 1,
                          "program": TG._program_key(KEY, 40, 16, False)}
    snap = obs.snapshot()
    assert snap["histograms"]["gcm_seal_latency_rec64b"]["count"] == 1
    assert "ghash_lift_cache" in snap["gauges"]
    TG.ghash(TG._hash_key(KEY), bytes(32), mode="horner", device="cpu")
    assert obs.snapshot(include_telemetry=False)["gauges"][
        "ghash_lift_cache"] == txb.lift_cache_info()["size"] >= 1


def test_fixed_latency_contract():
    """Twice through the observed region (the registry fingerprints the
    program on the first call); a second launch inside it breaks the
    contract."""
    ivs, pts, aads = vecs(32, 0, b=4)
    for seed in (0, 1):
        ivs, pts, aads = vecs(32, 0, b=4, seed=seed)
        TG.aes128_gcm_seal_batch(KEY, ivs, pts, aads, fixed_latency=True,
                                 device="cpu")
    prog_key, prog, _ = TG.gcm_program(KEY, 32, 0, device="cpu")
    from repro_torch.crypto.registry import registry
    with pytest.raises(FixedLatencyError, match="program launches"):
        with registry("cpu").observe(
                ("gcm_seal", 2, 0, 0), program_keys=(prog_key,),
                expect_apply_calls=0, expect_program_launches=1):
            for _ in range(2):
                tpp.run_program(prog, torch.zeros((prog.n, 1),
                                                  dtype=torch.int32))


# ---------------------------------------------------------------------------
# The megakernel's register-file placement at GCM's geometries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pt_len,aad_len,b,n,placement,lanes", [
    (64, 16, 1024, 2688, "global", 8),       # BENCH_aes_gcm's geometry
    (1024, 16, 256, 8800, "global", 2),      # 1 KiB records
    (1500, 13, 64, 12640, "global", 1),      # one Ethernet MTU, TLS AAD
    (64, 16, 37, 2688, "shared", 1),         # fewer records than SMs
])
def test_register_file_placement_at_gcm_geometries(pt_len, aad_len, b, n,
                                                   placement, lanes):
    """One wave of 132 CTAs: the lanes a CTA that takes, and the file's
    placement for those lanes."""
    m, _, a = TG._geometry(pt_len, aad_len)
    assert TG._layout(m, a)["n"] == n
    assert ppk.lanes_per_cta(n, 4, b, SMEM, sms=132) == lanes
    assert ppk.register_file(n, 4, SMEM, lanes) == placement


def test_register_file_boundary_and_refusal():
    # 5 physical registers x n rows x 4 B: 232440 B fit, 232460 do not
    assert ppk.register_file(11622, 4, SMEM) == "shared"
    assert ppk.register_file(11623, 4, SMEM) == "global"
    assert ppk.register_file(11622, 4, SMEM, 2) == "global"
    # as many lanes a CTA as one wave needs, whatever the placement
    assert ppk.lanes_per_cta(11622, 4, 8, SMEM) == 8
    assert ppk.lanes_per_cta(11622, 4, 8, SMEM, sms=132) == 1
    assert ppk.lanes_per_cta(11623, 4, 1024, SMEM, sms=132) == 8
    assert ppk.lanes_per_cta(11623, 4, 8, SMEM) == 8
    with pytest.raises(ValueError, match="register file"):
        ppk.register_file(2**29, 4, SMEM)
    with pytest.raises(ValueError, match="register file"):
        ppk.lanes_per_cta(2**29, 4, 8, SMEM)
