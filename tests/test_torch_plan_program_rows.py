"""The word layout's row walk (``core.plan_program.word_tables``) on the CPU.

The word kernel runs each step over the rows it may change, and each row
over its live selects (a CSR per plan).  Its plain version
(``kernels.ref.plan_program_rows``) walks the same tables; here it is
held against the plain VM (the program's semantics) and the JAX Pallas
megakernel in interpret mode, on seeded random programs (every opcode,
in-place PERMUTEs that rename, several rounds with strided constants,
weighted REAL plans, XOR and ADD folds, rows heavy enough to share among
lanes), ChaCha20 and AES-128-GCM seal and open.  The reference runs once
for the module (``jax_outputs``).
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
from repro_torch.kernels import ref
from test_torch_support import (assert_bitexact, jax_ref_alias,
                                one_thread, reset_torch_state)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

N = 48
LANES = 3
SEEDS = (0, 1, 2, 3)
KEY = bytes(range(16))
# (plaintext bytes, AAD bytes) of the GCM programs held here
GCM_CASES = [(16, 0), (48, 16)]
_MASK32 = (1 << 32) - 1


def _random_jax_program(seed):
    """A seeded program over every opcode, 3 or 4 registers, 1 to 3
    rounds with strided constants: sparse plans (most rows DROP), a
    weighted REAL plan, GF(2) plans, a plan whose first rows hold more
    selects than a lane takes alone, PERMUTEs in place (renamed), and
    constant rows mostly zero (so a step changes some rows only)."""
    rng = np.random.default_rng(seed)
    n_regs = 3 + seed % 2
    rounds = 1 + seed % 3
    b = jpp.ProgramBuilder(f"random_{seed}", N, n_regs=n_regs)

    def plan(kind):
        k = 40 if kind == "heavy" else int(rng.integers(1, 5))
        idx = rng.integers(-3, N + 3, (N, k))
        rows = rng.random(N) < 0.6
        if kind == "heavy":
            rows[:4] = True
            rows[4:] &= False
            idx[4:, :] = -1
        idx[~rows] = -1
        idx = jnp.asarray(idx.astype(np.int32))
        if kind == "weighted":
            return jxb.gather_plan(idx, N, weights=jnp.asarray(
                rng.integers(-9, 9, idx.shape).astype(np.int32)))
        if kind == "add":
            return jxb.gather_plan(idx, N)
        return jxb.gather_plan(idx, N, semiring=jsr.GF2)

    def const_block(kind):
        rows = np.zeros((rounds, N), np.int64)
        live = rng.random((rounds, N)) < 0.3
        if kind == "rot":
            vals = rng.integers(0, 40, (rounds, N))
        elif kind == "eq":
            vals = rng.integers(0, 3, (rounds, N))
        else:
            vals = rng.integers(-2**31, 2**31, (rounds, N))
        rows[live] = vals[live]
        return b.add_const_rows(rows)

    plans = [plan(k) for k in ("weighted", "add", "gf2", "heavy", "gf2")]
    ops = ["permute", "permute", "permute", "xor", "and", "andn", "add",
           "rotlv", "xor_const", "eq_const"]
    for i in range(14):
        op = ops[i % len(ops)] if i < len(ops) else ops[
            int(rng.integers(len(ops)))]
        dst, a, c = (int(v) for v in rng.integers(0, n_regs, 3))
        if op == "permute":
            p = plans[int(rng.integers(len(plans)))] if i >= 3 else plans[i]
            b.permute(dst, a if i % 3 else dst, p)      # some in place
        elif op in ("xor", "and", "andn", "add"):
            getattr(b, op if op != "and" else "and_")(dst, a, c)
        elif op == "rotlv":
            b.rotlv_at(dst, a, const_block("rot"))
        elif op == "xor_const":
            b.xor_const_at(dst, a, const_block("xor"))
        else:
            b.eq_const_at(dst, a, const_block("eq"))
    b.permute(3 % n_regs, 0, plans[3])                  # heavy rows
    b.xor(0, 0, 3 % n_regs)
    return b.build(rounds=rounds, const_stride=1)


def _port_of(jprog):
    plans = [(np.asarray(p.idx), None if p.weights is None
              else np.asarray(p.weights), p.semiring.name)
             for p in jprog.plans]
    return tpp.program_from_numpy(
        jprog.name, jprog.n, jpp.encode_steps(jprog), plans, jprog.consts,
        jprog.n_regs, jprog.rounds, jprog.const_stride, device="cpu")


def _payload(seed, n, bits=False):
    rng = np.random.default_rng(100 + seed)
    if bits:
        return rng.integers(0, 2, (n, LANES)).astype(np.int32)
    return rng.integers(0, 2**32, (n, LANES), dtype=np.uint64).astype(
        np.uint32)


def _jax_programs():
    """name -> (JAX program, the port's program, payload as numpy)."""
    from repro.crypto import chacha as JC
    from repro.crypto import gcm as JG
    from repro_torch.crypto import chacha as TC
    from repro_torch.crypto import gcm as TG
    out = {}
    for seed in SEEDS:
        jprog = _random_jax_program(seed)
        out[f"random_{seed}"] = (jprog, _port_of(jprog), _payload(seed, N))
    host = TC._setup_states(bytes(range(32)), 1, bytes(12), LANES)
    out["chacha20"] = (JC.megakernel_program(), TC.megakernel_program("cpu"),
                       np.ascontiguousarray(host.T))
    for pt_len, aad_len in GCM_CASES:
        for mode in ("seal", "open"):
            open_mode = mode == "open"
            jprog = JG.build_gcm_program(KEY, pt_len, aad_len,
                                         open_mode=open_mode)[0]
            tprog = TG.build_gcm_program(KEY, pt_len, aad_len,
                                         open_mode=open_mode,
                                         device="cpu")[0]
            out[f"gcm_{mode}_{pt_len}_{aad_len}"] = (
                jprog, tprog, _payload(pt_len, tprog.n, bits=True))
    return out


CASES = ([f"random_{s}" for s in SEEDS] + ["chacha20"]
         + [f"gcm_{m}_{p}_{a}" for p, a in GCM_CASES
            for m in ("seal", "open")])


@pytest.fixture(scope="module")
def reference():
    """The cases' programs and the JAX megakernel's output on each
    case's payload, run once; the reference's crypto registry is left as
    the module found it."""
    from repro.crypto.registry import REGISTRY
    tables = (REGISTRY._plans, REGISTRY._programs, REGISTRY._observed,
              REGISTRY._quarantined)
    saved = [dict(t) for t in tables]
    with jax_ref_alias():
        progs = _jax_programs()
        out = {}
        for name, (jprog, _, x) in progs.items():
            got = jpp.run_program(jprog, jnp.asarray(x),
                                  backend="megakernel")
            out[name] = np.asarray(got).view(np.int32)
    yield progs, out
    for table, before in zip(tables, saved):
        table.clear()
        table.update(before)


@pytest.fixture(scope="module")
def programs(reference):
    return reference[0]


@pytest.fixture(scope="module")
def jax_outputs(reference):
    return reference[1]


def _state(x):
    t = torch.as_tensor(x.view(np.int32))
    return t.view(torch.uint32) if x.dtype == np.uint32 else t


def _vm(prog, ctl, state):
    return ref.plan_program_vm(state, *tpp.vm_operands(ctl),
                               n_regs=prog.n_regs, rounds=prog.rounds,
                               const_stride=prog.const_stride)


@pytest.mark.parametrize("case", CASES)
def test_row_walk_equals_vm_and_jax_megakernel(programs, jax_outputs, case):
    _, prog, x = programs[case]
    ctl = tpp.build_control(prog, "cpu")
    state = _state(x)
    got = ref.plan_program_rows(state, ctl)
    assert got.dtype == state.dtype
    assert_bitexact(got.view(torch.int32), _vm(prog, ctl, state).view(
        torch.int32))
    assert_bitexact(got.view(torch.int32), jax_outputs[case])


@pytest.mark.parametrize("case", CASES)
def test_csr_holds_exactly_the_live_selects(programs, case):
    """Each plan's CSR: the (row, source, weight) of every select of its
    padded table inside [0, n), in row then column order; the kernel's
    tables are the plans' CSRs end to end, row pointers as offsets into
    the sources."""
    _, prog, _ = programs[case]
    n = prog.n
    ctl = tpp.build_control(prog, "cpu")
    rps, cols, wts, at = [], [], [], 0
    for plan in prog.plans:
        rp, src, w = tpp.plan_csr(plan, n)
        idx = plan.idx.numpy()
        wp = (None if plan.weights is None
              else plan.weights.to(torch.int32).numpy())
        want = [(r, int(s), None if wp is None else int(wp[r, j]))
                for r in range(n) for j, s in enumerate(idx[r])
                if 0 <= s < n]
        got = [(r, int(src[j]), None if w is None else int(w[j]))
               for r in range(n) for j in range(rp[r], rp[r + 1])]
        assert got == want
        assert rp[0] == 0 and rp[-1] == len(want)
        rps.append(rp + at)
        cols.append(src)
        wts.append(np.ones_like(src) if w is None else w)
        at += src.size
    assert_bitexact(ctl["w_rp"], np.concatenate(rps).astype(np.int32))
    assert_bitexact(ctl["w_cols"][:at], np.concatenate(cols))
    weighted = any(p.weights is not None for p in prog.plans)
    assert (ctl["w_wts"] is None) == (not weighted)
    if weighted:
        assert_bitexact(ctl["w_wts"][:at], np.concatenate(wts))


def _visited(step, ranges):
    """Rows a table step walks, as a set."""
    out = set()
    for lo, hi, _, _ in [step[8:12]] + ranges[step[5]:step[5] + step[6]]:
        out.update(range(lo, hi))
    return out


def _full_step(prog, ctl, t, regs):
    """Table step t over every row, as the VM computes it, on the
    physical registers (n_phys, n, d) of int64 carriers."""
    n_steps = ctl["n_steps"]
    rnd, s = divmod(t, n_steps)
    code, dst, a, b, p, c, _ = ctl["phys_steps"][
        (rnd % ctl["period"]) * n_steps + s].tolist()
    op = tpp.OPS[code]
    av = regs[a]
    if op == "permute":
        plan = prog.plans[p]
        idx = plan.idx.numpy().astype(np.int64)
        w = (np.ones_like(idx) if plan.weights is None else
             plan.weights.to(torch.int32).numpy().astype(np.int64)
             & _MASK32)
        valid = (idx >= 0) & (idx < prog.n)
        g = (av[np.clip(idx, 0, prog.n - 1)] * w[..., None]) & _MASK32
        g = np.where(valid[..., None], g, 0)
        val = ((g & 1).sum(1) & 1 if plan.semiring.name == "gf2"
               else g.sum(1) & _MASK32)
    elif op in ("xor", "and", "andn", "add"):
        bv = regs[b]
        val = {"xor": av ^ bv, "and": av & bv,
               "andn": (av ^ _MASK32) & bv,
               "add": (av + bv) & _MASK32}[op]
    else:
        k = (prog.consts[c + rnd * prog.const_stride].astype(np.int64)
             & _MASK32)[:, None]
        if op == "rotlv":
            left = np.where(k < 32, (av << np.minimum(k, 32)) & _MASK32, 0)
            val = left | (av >> ((32 - k) & 31))
        elif op == "xor_const":
            val = av ^ k
        else:
            val = (av == k).astype(np.int64)
    return dst, val


@pytest.mark.parametrize("case", CASES)
def test_row_lists_never_drop_a_changed_row(programs, case):
    """Step by step over every row, on the physical registers: every row
    whose value a step changes lies in the step's row list."""
    _, prog, x = programs[case]
    ctl = tpp.build_control(prog, "cpu")
    steps = ctl["w_steps"].tolist()
    ranges = ctl["w_ranges"].tolist()
    t_rounds, cycle, n_steps = ctl["w_rounds"], ctl["w_cycle"], ctl["n_steps"]
    regs = np.zeros((ctl["n_phys"], prog.n, LANES), np.int64)
    regs[0] = x.view(np.uint32).astype(np.int64) if x.dtype == np.uint32 \
        else x.astype(np.int64) & _MASK32
    walked = 0
    for t in range(prog.rounds * ctl["n_steps"]):
        dst, val = _full_step(prog, ctl, t, regs)
        changed = set(np.flatnonzero((val != regs[dst]).any(1)).tolist())
        rnd = t // n_steps          # its table round: warm-up, then cycle
        if rnd >= t_rounds:
            rnd = t_rounds - cycle + (rnd - t_rounds + cycle) % cycle
        visited = _visited(steps[rnd * n_steps + t % n_steps], ranges)
        assert changed <= visited, (t, sorted(changed - visited)[:8])
        walked += len(visited)
        regs[dst] = val
    assert walked == ctl["w_visits"]
    assert_bitexact(torch.as_tensor(regs[ctl["out_reg"]]), _vm(
        prog, ctl, _state(x)).view(torch.int32).to(torch.int64) & _MASK32)


@pytest.mark.parametrize("case", ["random_1", "random_2", "chacha20"])
def test_row_walk_past_the_unroll_limit(programs, monkeypatch, case):
    """Past UNROLL_STEPS the table keeps the renaming's period and every
    step walks every row: still the VM's result."""
    _, prog, x = programs[case]
    monkeypatch.setattr(tpp, "UNROLL_STEPS", 8)
    ctl = tpp.build_control(prog, "cpu")
    assert ctl["w_rounds"] == ctl["w_cycle"] == ctl["period"]
    assert ctl["w_visits"] == prog.n * prog.total_steps
    state = _state(x)
    assert_bitexact(ref.plan_program_rows(state, ctl).view(torch.int32),
                    _vm(prog, ctl, state).view(torch.int32))


@pytest.mark.parametrize("rounds,want", [
    ("A", (0, 1)), ("AB", (0, 2)), ("ABBB", (1, 1)), ("ABCBCB", (1, 2)),
    ("ABCD", (0, 4)), ("AABAAB", (0, 3))])
def test_table_cycle(rounds, want):
    """The table keeps warm-up rounds, then one cycle of the rest."""
    assert tpp._table_cycle([[r] for r in rounds]) == want


def test_row_walk_counts_at_a_gcm_record():
    """A 48-byte record with 16 bytes of AAD: the walk's select slots
    are the live selects of the rows it walks, at most the plans' live
    selects and far under n x k a PERMUTE; it walks under n rows a
    step; heavy ranges (rows shared by lanes) only on GHASH's Y rows."""
    from repro_torch.crypto import gcm as TG
    prog, lay = TG.build_gcm_program(KEY, 48, 16, device="cpu")
    ctl = tpp.build_control(prog, "cpu")
    kcnt = ctl["kcnt"].tolist()
    padded = prog.n * sum(kcnt[s.plan] for s in prog.steps
                          if s.op == "permute")
    assert ctl["w_slots"] <= ctl["w_live"] < padded / 4
    assert ctl["w_visits"] < prog.n * len(prog.steps) * 0.6
    heavy = [r for r in (ctl["w_steps"][:, 8:12].tolist()
                         + ctl["w_ranges"].tolist()) if r[2] & 31]
    assert heavy and all(lay["y"] <= lo < hi <= lay["y"] + 128
                         for lo, hi, _, _ in heavy)


def test_tables_do_not_depend_on_the_payload_and_are_sealed():
    """Two payloads leave the cached tables as a fresh build makes them;
    a corrupted row-walk table fails ``control_for``'s seal."""
    jprog = _random_jax_program(1)
    prog = _port_of(jprog)
    first = _state(_payload(7, N))
    tpp.run_program(prog, first)
    tpp.run_program(prog, _state(_payload(8, N)))
    ctl = tpp.control_for(prog, "cpu")
    fresh = tpp.build_control(prog, "cpu")
    for k in tpp.WORD_TABLES:
        if fresh[k] is None:
            assert ctl[k] is None
        else:
            assert_bitexact(ctl[k], fresh[k])
    for k in ("w_rounds", "w_cycle", "w_visits", "w_slots", "w_live"):
        assert ctl[k] == fresh[k]
    with integrity.always_verify():
        ctl["w_cols"][0] ^= 1
        with pytest.raises(integrity.IntegrityError):
            tpp.run_program(prog, first)
    assert tpp.program_cache_info()["size"] == 0
