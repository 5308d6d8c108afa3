"""Port vs reference: plan programs, the plain VM and the megakernel IR.

The port's 'megakernel' backend runs the plain VM here (CPU tensors);
it is held against the JAX Pallas megakernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import crossbar as jxb
from repro.core import plan_program as jpp
from repro.core import semiring as jsr
from repro_torch.core import integrity
from repro_torch.core import plan_program as tpp
from repro_torch.core import telemetry
from repro_torch.kernels import plan_program_kernel as ppk
from test_torch_support import (assert_bitexact, jax_ref,
                                reset_torch_state)  # noqa: F401

N = 64


def _all_ops_jax_program():
    """A 3-round program over every opcode, with a weighted ADD plan, a
    GF(2) plan run in place and per-round strided constants."""
    rng = np.random.default_rng(0)
    b = jpp.ProgramBuilder("all_ops", N, n_regs=4)
    rot = b.add_const_rows(rng.integers(0, 32, (3, N)))
    xc = b.add_const_rows(rng.integers(-2**31, 2**31, (3, N)))
    eqc = b.add_const_rows(rng.integers(0, 3, (3, N)))
    src3 = jnp.asarray(rng.integers(-4, N + 4, (N, 3)).astype(np.int32))
    b.permute(1, 0, jxb.gather_plan(
        jnp.asarray(rng.permutation(N).astype(np.int32)), N))
    b.permute(2, 1, jxb.gather_plan(src3, N, weights=jnp.asarray(
        rng.integers(-9, 9, (N, 3)).astype(np.int32))))
    b.xor(3, 3, 1)
    b.permute(3, 3, jxb.gather_plan(src3, N, semiring=jsr.GF2))
    b.eq_const_at(3, 3, eqc)
    b.and_(1, 1, 2)
    b.andn(2, 3, 0)
    b.add(0, 0, 2)
    b.rotlv_at(0, 0, rot)
    b.xor_const_at(0, 0, xc)
    b.add(0, 0, 1)
    return b.build(rounds=3, const_stride=1)


def _port_of(jprog):
    plans = [(np.asarray(p.idx), None if p.weights is None
              else np.asarray(p.weights), p.semiring.name)
             for p in jprog.plans]
    return tpp.program_from_numpy(
        jprog.name, jprog.n, jpp.encode_steps(jprog), plans, jprog.consts,
        jprog.n_regs, jprog.rounds, jprog.const_stride, device="cpu")


def _u32_payload(seed, d):
    raw = np.random.default_rng(seed).integers(0, 2**32, (N, d),
                                               dtype=np.uint64)
    return raw.astype(np.uint32)


def test_opcode_tables_agree():
    assert ppk.OPCODES == tpp.OPS
    from repro.kernels import plan_program_kernel as jppk
    assert ppk.OPCODES == jppk.OPCODES


def test_all_opcode_program_matches_jax_megakernel(jax_ref):
    jprog = _all_ops_jax_program()
    tprog = _port_of(jprog)
    assert_bitexact(tpp.encode_steps(tprog), jpp.encode_steps(jprog))
    x = _u32_payload(1, 5)
    want = jpp.run_program(jprog, jnp.asarray(x), backend="megakernel")
    tx = torch.as_tensor(x.view(np.int32)).view(torch.uint32)
    with telemetry.delta() as d:
        got = tpp.run_program(tprog, tx)
    assert (d()["program_launches"], d()["apply_calls"]) == (1, 0)
    assert d()["program_passes_avoided"] == tprog.passes == 9
    assert_bitexact(got, want)
    assert_bitexact(tpp.run_program(tprog, tx, backend="chained"), want)


def test_unroll_and_prefix_agree_with_chained():
    tprog = _port_of(_all_ops_jax_program())
    x = torch.as_tensor(_u32_payload(2, 3).view(np.int32)).view(torch.uint32)
    flat = tprog.unroll()
    assert flat.rounds == 1 and len(flat.steps) == 3 * len(tprog.steps)
    assert_bitexact(tpp.run_program(flat, x), tpp.run_program(tprog, x))
    for cut in (0, 4, 17, len(flat.steps)):
        pre = flat.prefix(cut)
        assert_bitexact(tpp.run_program(pre, x),
                        tpp.run_program(pre, x, backend="chained"))
    with pytest.raises(ValueError, match="single-trip"):
        tprog.prefix(2)


def test_keccak_program_plain_vm_matches_jax_megakernel(jax_ref):
    from repro.crypto import keccak as JK
    from repro_torch.crypto import keccak as TK
    s = np.random.default_rng(3).integers(0, 2, (3, 1600)).astype(np.int32)
    want = JK.keccak_f1600(jnp.asarray(s), backend="megakernel")
    got = TK.keccak_f1600(torch.as_tensor(s), backend="megakernel")
    assert_bitexact(got, want)
    prog = TK.megakernel_program("cpu")
    assert_bitexact(
        tpp.run_program(prog, torch.as_tensor(s.T.copy()), backend="chained"),
        np.asarray(want).T)


def test_program_validation():
    from repro_torch.core import crossbar as txb
    g = txb.gather_plan(torch.arange(N, dtype=torch.int32), N)
    with pytest.raises(ValueError, match="scatter form"):
        tpp.PlanProgram("p", N, (), (txb.transpose_plan(
            txb.gather_plan(torch.arange(N - 1, dtype=torch.int32), N)),),
            None, 2)
    with pytest.raises(ValueError, match="const rows"):
        tpp.PlanProgram("p", N, (tpp.Step("xor_const", 0, 0, const=0),),
                        (g,), np.zeros((1, N), np.int32), 2, rounds=2,
                        const_stride=1)
    b = tpp.ProgramBuilder("rot", N, n_regs=2)
    b.rotlv(0, 0, np.ones(N))
    with pytest.raises(ValueError, match="unsigned"):
        tpp.run_program(b.build(), torch.zeros(N, 2, dtype=torch.int32))
    # A builder deduplicates plans by identity and constants by value.
    b.permute(1, 0, g)
    b.permute(1, 1, g)
    b.rotlv(0, 0, np.ones(N))
    prog = b.build()
    assert len(prog.plans) == 1 and prog.consts.shape[0] == 1


def test_lanes_per_cta_derivation():
    # Keccak: 3 registers + scratch x 1600 rows x 4 B = 25.6 KB a lane.
    assert ppk.lanes_per_cta(1600, 3, 1024, 232448) == 8
    assert ppk.lanes_per_cta(1600, 3, 3, 232448) == 3
    with pytest.raises(ValueError, match="one lane"):
        ppk.lanes_per_cta(100_000, 4, 8, 232448)


def test_control_cache_seals_and_catches_corruption():
    tprog = _port_of(_all_ops_jax_program())
    x = torch.as_tensor(_u32_payload(4, 2).view(np.int32)).view(torch.uint32)
    tpp.run_program(tprog, x)
    tpp.run_program(tprog, x)
    assert tpp.program_cache_info()["hits"] == 1
    with integrity.always_verify():
        tprog.consts[0, 0] ^= 1
        with pytest.raises(integrity.IntegrityError):
            tpp.run_program(tprog, x)
    assert tpp.program_cache_info()["size"] == 0
