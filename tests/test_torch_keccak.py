"""The slice as a whole: Keccak-f[1600] and the SHA-3 / SHAKE sponges.

Every backend of the port on the CPU ('kernel', 'sparse' and
'megakernel' through their plain versions) against ``hashlib`` and the
JAX package; control arrays identical to the reference's.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan_program as jpp
from repro.crypto import keccak as JK
from repro_torch.core import plan_program as tpp
from repro_torch.core import telemetry
from repro_torch.core.static_registry import FixedLatencyError
from repro_torch.crypto import keccak as TK
from repro_torch.crypto.registry import registry
from test_torch_support import (assert_bitexact, jax_ref,
                                reset_torch_state)  # noqa: F401

BACKENDS = ["reference", "einsum", "kernel", "sparse", "megakernel"]


def _msg(n, seed=0):
    return bytes(np.random.default_rng(seed).integers(0, 256, n,
                                                      dtype=np.uint8))


@pytest.mark.parametrize("backend", BACKENDS)
def test_sponges_equal_hashlib(backend):
    for n in (0, 135, 200):
        m = _msg(n, n)
        assert TK.sha3_256(m, backend=backend, device="cpu") == \
            hashlib.sha3_256(m).digest()
    m = _msg(100, 1)
    assert TK.sha3_512(m, backend=backend, device="cpu") == \
        hashlib.sha3_512(m).digest()
    assert TK.shake_128(m, 200, backend=backend, device="cpu") == \
        hashlib.shake_128(m).digest(200)
    assert TK.shake_256(m, 40, backend=backend, device="cpu") == \
        hashlib.shake_256(m).digest(40)


@pytest.mark.parametrize("backend,batch_mode", [
    ("megakernel", "payload"), ("sparse", "block_diag"),
    ("kernel", "payload"), ("einsum", "block_diag"),
    ("reference", "payload")])
def test_sha3_256_batched_equals_hashlib(backend, batch_mode):
    msgs = [_msg(150, s) for s in range(3)]
    got = TK.sha3_256_batched(msgs, backend=backend, batch_mode=batch_mode,
                              device="cpu")
    assert got == [hashlib.sha3_256(m).digest() for m in msgs]
    with pytest.raises(ValueError, match="equal-length"):
        TK.sha3_256_batched([b"a", b"bc"], device="cpu")


def test_sponges_equal_jax_package(jax_ref):
    msg = _msg(70, 5)
    want = JK.sha3_256(msg, backend="reference")
    assert TK.sha3_256_batched([msg], backend="megakernel",
                               device="cpu") == [want]
    assert TK.sha3_256(msg, backend="sparse", device="cpu") == want


@pytest.mark.parametrize("backend", ["megakernel", "einsum"])
def test_first_lane_of_zero_state(backend):
    out = TK.keccak_f1600(np.zeros(1600, np.int32), backend=backend,
                          device="cpu")
    lane = sum(int(v) << i for i, v in enumerate(out[:64].tolist()))
    assert lane == 0xF1258F7940E1DDE7


def test_keccak_states_match_jax_per_round_path(jax_ref):
    s = np.random.default_rng(9).integers(0, 2, (2, 1600)).astype(np.int32)
    want = JK.keccak_f1600(jnp.asarray(s), backend="reference")
    for backend, mode, fuse in (("kernel", "payload", True),
                                ("sparse", "block_diag", False),
                                ("einsum", "block_diag", True)):
        got = TK.keccak_f1600(torch.as_tensor(s), backend=backend,
                              batch_mode=mode, fuse_rho_pi=fuse)
        assert_bitexact(got, want)


def test_control_arrays_identical_to_reference(jax_ref):
    for name in ("rho_plan", "pi_plan", "rho_pi_plan", "theta_plan",
                 "theta_rho_pi_plan"):
        tp, jp = getattr(TK, name)("cpu"), getattr(JK, name)()
        assert tp.semiring.name == jp.semiring.name
        assert_bitexact(tp.idx, jp.idx)
    assert TK.theta_rho_pi_plan("cpu").k == 11
    for shift in (1, 2):
        assert_bitexact(TK.chi_shift_plan(shift, "cpu").idx,
                        JK.chi_shift_plan(shift).idx)
    tprog, jprog = TK.megakernel_program("cpu"), JK.megakernel_program()
    assert_bitexact(tpp.encode_steps(tprog), jpp.encode_steps(jprog))
    assert_bitexact(tprog.consts, jprog.consts)
    assert (tprog.rounds, tprog.const_stride, tprog.n_regs) == (
        jprog.rounds, jprog.const_stride, jprog.n_regs)
    for tplan, jplan in zip(tprog.plans, jprog.plans):
        assert_bitexact(tplan.idx, jplan.idx)
    from repro.core import plan_algebra as jpa
    from repro_torch.core import plan_algebra as tpa
    assert_bitexact(tpa.batch(TK.rho_pi_plan("cpu"), 4).idx,
                    jpa.batch(JK.rho_pi_plan(), 4).idx)


def test_fixed_latency_contract():
    s = torch.as_tensor(np.random.default_rng(2).integers(
        0, 2, (2, 1600)).astype(np.int32))
    with telemetry.delta() as d:
        TK.keccak_f1600(s, backend="megakernel", fixed_latency=True)
        TK.keccak_f1600(s ^ 1, backend="megakernel", fixed_latency=True)
    dd = d()
    assert (dd["program_launches"], dd["apply_calls"]) == (2, 0)
    assert dd["kernel_launches_plan_program"] == 0      # plain VM on CPU
    for backend, mode, fuse, passes in (("kernel", "payload", True, 24),
                                        ("sparse", "block_diag", True, 24),
                                        ("einsum", "payload", False, 48)):
        with telemetry.delta() as d:
            TK.keccak_f1600(s, backend=backend, batch_mode=mode,
                            fuse_rho_pi=fuse, fixed_latency=True)
        assert d()["apply_calls"] == passes
    assert TK.sha3_256(b"abc", backend="megakernel", fixed_latency=True,
                       device="cpu") == hashlib.sha3_256(b"abc").digest()
    reg = registry("cpu")
    assert "keccak/rho_pi_x2" in reg
    with pytest.raises(FixedLatencyError, match="expected 3"):
        with reg.observe("probe", expect_apply_calls=3):
            TK.keccak_f1600(s, backend="einsum", batch_mode="payload")


def test_registry_quarantine_and_program_fingerprint():
    reg = registry("cpu")
    prog = TK.megakernel_program("cpu")
    fp = reg.program_fingerprint(TK.MEGAKERNEL_PROGRAM_KEY)
    assert fp[:4] == (1600, 3, 24, 1)
    TK.rho_pi_plan("cpu")
    reg.batch_variant("keccak/rho_pi", 3)
    assert reg.quarantine("keccak/rho_pi") == 1
    assert "keccak/rho_pi" not in reg and "keccak/rho_pi_x3" not in reg
    assert TK.rho_pi_plan("cpu") is not None          # rebuilt on demand
    assert reg.quarantine(TK.MEGAKERNEL_PROGRAM_KEY) == 1
    assert TK.megakernel_program("cpu") is not prog
    assert reg.program_fingerprint(TK.MEGAKERNEL_PROGRAM_KEY) == fp
