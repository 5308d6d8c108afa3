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
    # Lanes are a power of two (the word kernel finds a lane by shifts):
    # 3 lanes of payload take a CTA of 4, one of them idle.  On one SM
    # (sms=1) every lane goes to the one CTA of the wave; the files then
    # go to global memory where they overflow the shared memory.
    assert ppk.lanes_per_cta(1600, 3, 1024, 232448) == 1024
    assert ppk.register_file(1600, 3, 232448, 8) == "shared"
    assert ppk.register_file(1600, 3, 232448, 16) == "global"
    assert ppk.lanes_per_cta(1600, 3, 3, 232448) == 4
    assert ppk.lanes_per_cta(1600, 3, 1, 232448) == 1
    assert ppk.lanes_per_cta(64, 3, 1000, 232448) == 1024
    # a file over the shared memory goes to global memory; past the global
    # file's 32-bit word offsets too, the program is refused
    assert ppk.lanes_per_cta(100_000, 4, 8, 232448) == 8
    with pytest.raises(ValueError, match="register file"):
        ppk.lanes_per_cta(2**29, 4, 8, 232448)


def test_word_geometry_covers_the_card():
    # ChaCha20 (n = 16, 2 registers + scratch): 16384 lanes over 132 SMs
    # take 128 a CTA (128 CTAs, one wave), each CTA a thread per 4-lane
    # group of a row.
    assert ppk.lanes_per_cta(16, 2, 16384, 232448) == 16384
    assert ppk.lanes_per_cta(16, 2, 16384, 232448, sms=132) == 128
    assert ppk.word_threads(16, 128) == 512
    assert ppk.word_threads(16, 64) == 256
    assert ppk.word_threads(16, 1024) == 1024
    assert ppk.word_threads(16, 2) == 32 and ppk.word_threads(16, 1) == 32
    # threads are a power of two: 80 rows of one lane take 128
    assert ppk.word_threads(80, 1) == 128
    # Keccak (25.6 KB a lane): 1024 lanes take 8 a CTA, in shared memory
    assert ppk.lanes_per_cta(1600, 3, 1024, 232448, sms=132) == 8
    assert ppk.word_threads(1600, 8) == 1024
    # fewer lanes than SMs: one lane a CTA
    assert ppk.lanes_per_cta(256, 4, 77, 232448, sms=132) == 1
    assert ppk.word_threads(256, 1) == 256


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


# ---------------------------------------------------------------------------
# The packed (32 lanes a word) layout: the static check, the register
# renaming both layouts run, and the plain bit-sliced emulation
# ---------------------------------------------------------------------------

def _gf2_perm_plan(rng):
    from repro_torch.core import crossbar as txb
    from repro_torch.core.semiring import GF2
    return txb.gather_plan(torch.as_tensor(
        rng.integers(-2, N + 2, (N, 2)).astype(np.int32)), N, semiring=GF2)


def _check_program(case):
    """(program, layout the static check must choose) for one case."""
    from repro_torch.core import crossbar as txb
    from repro_torch.crypto import keccak as TK
    if case == "keccak":
        return TK.megakernel_program("cpu"), "packed"
    if case == "all_opcodes":
        return _port_of(_all_ops_jax_program()), "word"
    rng = np.random.default_rng(5)
    b = tpp.ProgramBuilder(case, N, n_regs=3)
    if case == "gf2_andn_chain":        # r0 rewritten by a PERMUTE first
        b.permute(0, 0, _gf2_perm_plan(rng))
        b.permute(1, 0, txb.gather_plan(torch.as_tensor(
            rng.permutation(N).astype(np.int32)), N))
        b.andn(2, 0, 1)
        b.and_(0, 0, 2)
        b.xor_const(0, 0, rng.integers(0, 2, N))
        return b.build(rounds=3), "packed"
    if case == "input_xored_last":      # r0 ^= a clean register: tainted
        b.permute(1, 0, _gf2_perm_plan(rng))
        b.xor(0, 0, 1)
        return b.build(), "word"
    if case == "xor_const_2":           # a constant row with bit 1 set
        b.permute(0, 0, _gf2_perm_plan(rng))
        row = np.zeros(N, np.int64)
        row[3] = 2
        b.xor_const(0, 0, row)
        return b.build(), "word"
    assert case == "add_fold"           # two selects summed: carries
    b.permute(0, 0, txb.gather_plan(torch.as_tensor(
        rng.integers(0, N, (N, 2)).astype(np.int32)), N))
    return b.build(), "word"


CHECK_CASES = ["keccak", "gf2_andn_chain", "all_opcodes", "input_xored_last",
               "xor_const_2", "add_fold"]


@pytest.mark.parametrize("case", CHECK_CASES)
def test_bit_sliceable_static_check(case):
    prog, layout = _check_program(case)
    assert tpp.bit_sliceable(prog) == (layout == "packed")
    ctl = tpp.build_control(prog, "cpu")
    assert ctl["layout"] == layout
    assert (ctl["blob"] is None) == (layout == "word")


def _run_renamed(ctl, state):
    """Word-semantics interpreter of the renamed step table (what the word
    kernel runs): n_phys registers, the table's round period, register 0
    read from out_reg."""
    from repro_torch.kernels.ref import _from_u32, _to_u32
    mask = 0xFFFFFFFF
    n = state.shape[0]
    rows = ctl["phys_steps"].tolist()
    koff, kcnt, folds, woff = (ctl[k].tolist() for k in
                               ("koff", "kcnt", "folds", "woff"))
    tbl = ctl["plan_tbl"].to(torch.int64)
    wts = None if ctl["w_flat"] is None else _to_u32(ctl["w_flat"])
    cst = _to_u32(ctl["consts"])
    regs = [_to_u32(state)] + [torch.zeros_like(_to_u32(state))
                               for _ in range(ctl["n_phys"] - 1)]
    n_steps, period = ctl["n_steps"], ctl["period"]
    for rnd in range(ctl["rounds"]):
        for code, dst, a, b, p, c, _ in rows[(rnd % period) * n_steps:
                                             (rnd % period + 1) * n_steps]:
            op, av = ppk.OPCODES[code], regs[a]
            if op == "permute":
                assert dst != a, "renamed PERMUTE runs in place"
                acc = torch.zeros_like(av)
                for j in range(kcnt[p]):
                    src = tbl[koff[p] + j]
                    g = av[src.clamp(0, n - 1)]
                    if woff[p] >= 0:
                        g = (g * wts[woff[p] + j][:, None]) & mask
                    g = torch.where(((src >= 0) & (src < n))[:, None], g, 0)
                    acc = acc ^ (g & 1) if folds[p] else (acc + g) & mask
                val = acc
            elif op in ("xor", "and", "andn", "add"):
                bv = regs[b]
                val = {"xor": av ^ bv, "and": av & bv,
                       "andn": (av ^ mask) & bv,
                       "add": (av + bv) & mask}[op]
            else:
                k = cst[c + rnd * ctl["const_stride"]][:, None]
                if op == "rotlv":
                    left = torch.where(k < 32, (av << k.clamp(max=32)) & mask,
                                       0)
                    val = left | (av >> ((32 - k) & 31))
                elif op == "xor_const":
                    val = av ^ k
                else:
                    val = (av == k).to(torch.int64)
            regs[dst] = val
    return _from_u32(regs[ctl["out_reg"]], state.dtype)


def _barrier_hazards(rows):
    """Cross-thread hazards the barrier flags leave open: a PERMUTE reading
    a register written since the last barrier, or a write to a register a
    PERMUTE read since then (a thread owns the same rows in every step)."""
    open_, written, perm_reads = [], set(), set()
    for i, (code, dst, a, b, p, c, barrier) in enumerate(rows):
        if barrier:
            written, perm_reads = set(), set()
        if (code == 0 and a in written) or dst in perm_reads:
            open_.append(i)
        written.add(dst)
        if code == 0:
            perm_reads.add(a)
    return open_


@pytest.mark.parametrize("case", ["keccak", "all_opcodes",
                                  "all_opcodes_copy_back"])
def test_register_renaming_keeps_the_program(case, monkeypatch):
    """Both kernels run the renamed step table: an in-place PERMUTE, or a
    write to a register a PERMUTE is still reading, goes to the free
    register, which takes its name; barriers only where a PERMUTE crosses
    threads (Keccak: 2 a round, the assignment back at its start after
    each round); past the period limit an AND copies back instead."""
    if case == "all_opcodes_copy_back":
        monkeypatch.setattr(tpp, "_MAX_RENAME_PERIOD", 1)
    prog, _ = _check_program(case.replace("_copy_back", ""))
    ctl = tpp.build_control(prog, "cpu")
    rows = ctl["phys_steps"]
    if case == "keccak":
        assert (ctl["period"], ctl["out_reg"], ctl["n_steps"]) == (1, 0, 6)
        assert rows[:, 6].tolist() == [1, 1, 0, 0, 0, 0]
    elif case == "all_opcodes":
        assert ctl["n_steps"] == len(prog.steps)
    else:
        assert (ctl["period"], ctl["out_reg"]) == (1, 0)
        assert ctl["n_steps"] == len(prog.steps) + 1     # the AND copy
    assert rows.shape == (ctl["period"] * ctl["n_steps"], 7)
    assert _barrier_hazards(rows.tolist()) == []
    for phase in range(ctl["period"]):
        assert rows[phase * ctl["n_steps"], 6] == 1     # each round's start
    d = 3
    x = (torch.as_tensor(np.random.default_rng(6).integers(
        0, 2, (prog.n, d)).astype(np.int32)) if case == "keccak" else
        torch.as_tensor(_u32_payload(6, d).view(np.int32)).view(torch.uint32))
    want = tpp.run_program(prog, x)
    assert_bitexact(_run_renamed(ctl, x).view(torch.int32),
                    want.view(torch.int32))


def test_megakernel_entry_picks_the_layout_once():
    """``_run_megakernel`` takes the layout from the program's cached
    control: packed for Keccak-f[1600], word for the all-opcode program;
    a second call is a cache hit and decides nothing again."""
    from repro_torch.crypto import keccak as TK
    s = torch.as_tensor(np.random.default_rng(7).integers(
        0, 2, (2, 1600)).astype(np.int32))
    TK.keccak_f1600(s, backend="megakernel")
    prog = TK.megakernel_program("cpu")
    assert tpp.control_for(prog, torch.device("cpu"))["layout"] == "packed"
    syn = _port_of(_all_ops_jax_program())
    x = torch.as_tensor(_u32_payload(8, 2).view(np.int32)).view(torch.uint32)
    tpp.run_program(syn, x)
    assert tpp.control_for(syn, "cpu")["layout"] == "word"
    assert tpp.program_cache_info()["misses"] == 2


def _keccak_state(kind, d, seed):
    rng = np.random.default_rng(seed)
    if kind == "bits":
        return rng.integers(0, 2, (1600, d)).astype(np.int32)
    return rng.integers(-2**31, 2**31, (1600, d)).astype(np.int32)


@pytest.mark.parametrize("kind", ["bits", "int32"])
@pytest.mark.parametrize("d", [1, 31, 33, 64])
def test_packed_emulation_matches_vm_and_jax_megakernel(jax_ref, d, kind):
    """The packed layout's arithmetic (32 lanes a word, on the kernel's own
    control blob) against the plain VM and the JAX megakernel (interpret
    mode), bit-exact, on 0/1 states and on int32 states with high bits
    set: the program reads bit 0 of its input only."""
    from repro.core import plan_program as jpp
    from repro.crypto import keccak as JK
    from repro_torch.crypto import keccak as TK
    from repro_torch.kernels import ref
    s = _keccak_state(kind, d, d)
    ctl = tpp.build_control(TK.megakernel_program("cpu"), "cpu")
    x = torch.as_tensor(s)
    got = ref.plan_program_packed(x, ctl)
    assert_bitexact(got, ref.plan_program_vm(
        x, *tpp.vm_operands(ctl), n_regs=3, rounds=24, const_stride=1))
    assert_bitexact(got, jpp.run_program(JK.megakernel_program(),
                                         jnp.asarray(s), backend="megakernel"))
