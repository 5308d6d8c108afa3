"""ChaCha20 in the port: RFC 8439 on every backend that routes int32
words exactly, bit-exact against the JAX package, and control identical
to the reference's.

The oracle is RFC 8439 (§2.3.2 block, §2.4.2 encryption) and a
pure-Python quarter-round.  The reference's ``backend="reference"``
index oracle sums in float32 and does not give RFC 8439 blocks (int32
words exceed 2^24), so it is not used as truth here.
"""

import functools
import struct

import numpy as np
import pytest
import torch

from repro.crypto import chacha as JC
from repro.core import plan_program as jpp
from repro_torch.core import plan_program as tpp
from repro_torch.core import telemetry
from repro_torch.crypto import chacha as TC
from repro_torch.crypto.registry import registry
from repro_torch.kernels import ref
from test_torch_support import (assert_bitexact, jax_ref,
                                reset_torch_state)  # noqa: F401

KEY = bytes(range(32))
NONCE_232 = bytes.fromhex("000000090000004a00000000")
BLOCK_232 = bytes.fromhex(
    "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
    "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")
NONCE_242 = bytes.fromhex("000000000000004a00000000")
PLAIN_242 = (b"Ladies and Gentlemen of the class of '99: If I could offer "
             b"you only one tip for the future, sunscreen would be it.")
CIPHER_242 = bytes.fromhex(
    "6e2e359a2568f98041ba0728dd0d6981e97e7aec1d4360c20a27afccfd9fae0b"
    "f91b65c5524733ab8f593dabcd62b3571639d624e65152ab8f530c359f0861d8"
    "07ca0dbf500d6a6156a38e088a22b65e52bc514d16ccf806818ce91ab7793736"
    "5af90bbf74a35be6b40b8eedf2785e42874d")

MODES = [("einsum", "payload"), ("einsum", "block_diag"),
         ("megakernel", "payload"), ("megakernel", "block_diag")]


def _rotl(v, c):
    return ((v << c) & 0xFFFFFFFF) | (v >> (32 - c))


def _qr(s, a, b, c, d):
    for x, y, z, r in ((a, b, d, 16), (c, d, b, 12), (a, b, d, 8),
                       (c, d, b, 7)):
        s[x] = (s[x] + s[y]) & 0xFFFFFFFF
        s[z] = _rotl(s[z] ^ s[x], r)


def _python_block(key: bytes, counter: int, nonce: bytes) -> bytes:
    """RFC 8439 §2.3 in plain Python: the independent oracle."""
    s = (list(struct.unpack("<4I", b"expand 32-byte k"))
         + list(struct.unpack("<8I", key)) + [counter & 0xFFFFFFFF]
         + list(struct.unpack("<3I", nonce)))
    w = s[:]
    for _ in range(10):
        for q in ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14),
                  (3, 7, 11, 15), (0, 5, 10, 15), (1, 6, 11, 12),
                  (2, 7, 8, 13), (3, 4, 9, 14)):
            _qr(w, *q)
    return struct.pack("<16I", *[(a + b) & 0xFFFFFFFF
                                 for a, b in zip(w, s)])


def test_python_oracle_gives_rfc8439_block():
    assert _python_block(KEY, 1, NONCE_232) == BLOCK_232


@pytest.mark.parametrize("backend,batch_mode", MODES)
def test_rfc8439_vectors(backend, batch_mode):
    kw = dict(backend=backend, batch_mode=batch_mode, device="cpu")
    assert TC.chacha20_blocks(KEY, 1, NONCE_232, 1, **kw) == BLOCK_232
    assert TC.chacha20_encrypt(KEY, 1, NONCE_242, PLAIN_242,
                               **kw) == CIPHER_242
    assert TC.chacha20_encrypt(KEY, 1, NONCE_242, CIPHER_242,
                               **kw) == PLAIN_242
    # several counter blocks, one wrapping the 32-bit counter
    got = TC.chacha20_blocks(KEY, 0xFFFFFFFE, NONCE_232, 3, **kw)
    assert got == b"".join(_python_block(KEY, 0xFFFFFFFE + i, NONCE_232)
                           for i in range(3))


def test_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.crypto import aes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.chacha20_block(KEY, 1, NONCE_232, backend="megakernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        aes.aes128_ctr_xor(bytes(16), bytes(16), b"abc")


def test_crypto_package_exports_every_reference_name():
    import repro.crypto
    import repro_torch.crypto
    assert set(repro.crypto.__all__) <= set(repro_torch.crypto.__all__)
    for name in repro_torch.crypto.__all__:
        assert hasattr(repro_torch.crypto, name), name


@functools.lru_cache(maxsize=None)
def _jax_blocks(counter: int, n_blocks: int) -> bytes:
    return JC.chacha20_blocks(KEY, counter, NONCE_232, n_blocks,
                              backend="einsum", batch_mode="payload")


@pytest.mark.parametrize("backend,batch_mode", MODES)
def test_blocks_equal_jax_package(jax_ref, backend, batch_mode):
    want = _jax_blocks(7, 5)
    assert want[:64] == _python_block(KEY, 7, NONCE_232)
    assert TC.chacha20_blocks(KEY, 7, NONCE_232, 5, backend=backend,
                              batch_mode=batch_mode, device="cpu") == want


def test_megakernel_program_matches_reference(jax_ref):
    jprog = JC.megakernel_program()
    tprog = TC.megakernel_program("cpu")
    assert (tprog.n, tprog.n_regs, tprog.rounds, tprog.const_stride) == (
        jprog.n, jprog.n_regs, jprog.rounds, jprog.const_stride) == (
        16, 2, 10, 0)
    assert len(tprog.steps) == 42
    np.testing.assert_array_equal(tpp.encode_steps(tprog),
                                  jpp.encode_steps(jprog))
    np.testing.assert_array_equal(tprog.consts, np.asarray(jprog.consts))
    assert len(tprog.plans) == len(jprog.plans)
    for tp, jp in zip(tprog.plans, jprog.plans):
        assert (tp.mode, tp.n_in, tp.n_out) == (jp.mode, jp.n_in, jp.n_out)
        assert_bitexact(tp.idx, np.asarray(jp.idx))
    assert not tpp.bit_sliceable(tprog)
    assert tpp.control_for(tprog, torch.device("cpu"))["layout"] == "word"


def test_diag_undiag_control_matches_reference(jax_ref):
    for tplan, jplan in ((TC.diag_plan("cpu"), JC.diag_plan()),
                         (TC.undiag_plan("cpu"), JC.undiag_plan())):
        assert (tplan.mode, tplan.n_in, tplan.n_out, tplan.semiring.name) \
            == (jplan.mode, jplan.n_in, jplan.n_out, jplan.semiring.name)
        assert_bitexact(tplan.idx, np.asarray(jplan.idx))
    for key in TC._QR_MAPS:
        assert_bitexact(TC._qr_map_plan(key, "cpu").idx,
                        np.asarray(JC._qr_map_plan(key).idx))


@pytest.mark.parametrize("backend", ["kernel", "sparse"])
def test_float32_kernels_refuse_chacha_words(jax_ref, backend):
    """The crossbar kernels route integers through float32 and refuse
    magnitudes of 2^24 and more; the reference refuses ChaCha payloads
    the same way, and so does the port."""
    with pytest.raises(ValueError, match="2\\^24"):
        TC.chacha20_block(KEY, 1, NONCE_232, backend=backend, device="cpu")
    with pytest.raises(ValueError, match="2\\^24"):
        JC.chacha20_block(KEY, 1, NONCE_232, backend=backend)


def test_fixed_latency_counts():
    with telemetry.delta() as d:
        for counter in (1, 99):
            TC.chacha20_blocks(KEY, counter, NONCE_232, 4, backend="einsum",
                               fixed_latency=True, device="cpu")
    assert d()["apply_calls"] == 2 * TC.PASSES_PER_BLOCK == 40
    with telemetry.delta() as d:
        for counter in (1, 99):
            TC.chacha20_blocks(KEY, counter, NONCE_232, 4,
                               backend="megakernel", fixed_latency=True,
                               device="cpu")
    delta = d()
    assert delta["program_launches"] == 2 and delta["apply_calls"] == 0
    sig = registry("cpu")._observed[
        (("chacha20", "megakernel"), ((4, 16), "torch.int32"), "megakernel")]
    assert sig[0] == 0 and sig[2] == 1      # passes, launches


def test_word_layout_vm_runs_the_program():
    """The plain VM on the program's control (what the word-layout kernel
    is held to on the card) gives the rounds of RFC 8439 before the
    feed-forward."""
    prog = TC.megakernel_program("cpu")
    ctl = tpp.control_for(prog, torch.device("cpu"))
    host = TC._setup_states(KEY, 1, NONCE_232, 2).view(np.int32)
    words = torch.as_tensor(host.T.copy()).view(torch.uint32)
    out = ref.plan_program_vm(words, *tpp.vm_operands(ctl),
                              n_regs=ctl["n_regs"], rounds=ctl["rounds"],
                              const_stride=ctl["const_stride"])
    fed = TC._add32(out.view(torch.int32).T, torch.as_tensor(host))
    assert fed.numpy().astype("<i4").tobytes()[:64] == BLOCK_232


def test_bad_arguments():
    with pytest.raises(ValueError, match="batch_mode"):
        TC.chacha20_blocks(KEY, 1, NONCE_232, 2, batch_mode="x",
                           device="cpu")
    with pytest.raises(ValueError, match="32 bytes"):
        TC.chacha20_block(KEY[:16], 1, NONCE_232, device="cpu")
    with pytest.raises(ValueError, match="12 bytes"):
        TC.chacha20_block(KEY, 1, NONCE_232[:8], device="cpu")
