"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the test) when there is no
CUDA device with ``nvcc``.  On a machine with the card:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports the JAX package.)
"""

import hashlib

import numpy as np
import pytest
import torch

from test_torch_moe_route import ROUTE_CASES, route_capacities, route_ids
from test_torch_support import (BF16_TOL, F32_TOL,  # noqa: F401
                                assert_bitexact, assert_close,
                                reset_torch_state)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    import repro_torch
    caps = repro_torch.capabilities()
    if not caps.can_build_kernels:
        pytest.skip("needs an sm_90 CUDA device and nvcc")
    return torch.device("cuda", 0)


def _crossbar_case(case, dev, rng):
    """(plan, payload, merge, tol) of one edge case: tol None = bit-exact.
    Ragged widths take narrower vectors; scatter control of at most 256
    entries is inverted inside the kernel, larger control by the
    inversion passes."""
    from repro_torch.core import crossbar as txb
    from repro_torch.core.semiring import GF2

    def t(a):
        return torch.as_tensor(a, device=dev)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    kind, _, width = case.partition("_d")
    d = int(width) if width else 40
    dt = torch.bfloat16 if d == 4100 else torch.float32
    n = 300 if d == 4100 else 700
    if kind == "gather":
        plan = txb.gather_plan(t(rng.integers(-5, n + 5, (n, 3)).astype(
            np.int32)), n, weights=t(normal(n, 3)))
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        return plan, t(normal(n, d)).to(dt), None, tol
    if kind == "injective":
        dest = np.where(rng.random(n) < 0.2, -1, rng.permutation(2 * n)[:n])
        plan = txb.scatter_plan(t(dest.astype(np.int32)), 2 * n)
        merge = t(normal(2 * n, d)).to(dt)
        return plan, t(normal(n, d)).to(dt), merge, None
    if kind == "colliding":
        dest = rng.integers(-3, 1500, (1200, 2)).astype(np.int32)
        dest[(dest >= 256) & (dest < 768)] = 1500       # unvisited tiles
        plan = txb.scatter_plan(t(dest), 1500, weights=t(normal(1200, 2)))
        return plan, t(normal(1200, d)), None, None
    if kind == "small":                                  # 200 entries
        dest = rng.integers(-2, 600, (100, 2)).astype(np.int32)
        dest[(dest // 128) % 2 == 1] = -1               # odd tiles unvisited
        plan = txb.scatter_plan(t(dest), 600, weights=t(normal(100, 2)))
        return plan, t(normal(100, d)), None, None
    if kind == "hot":                                    # 131072 entries
        dest = rng.integers(-2, 4096, (65536, 2)).astype(np.int32)
        dest[:, 0] = 7                                  # one hot row
        plan = txb.scatter_plan(t(dest), 4096, weights=t(normal(65536, 2)))
        return plan, t(normal(65536, d)), None, None
    assert kind == "gf2"
    dest = rng.integers(-2, 700, (640, 3)).astype(np.int32)
    plan = txb.scatter_plan(t(dest), 700, semiring=GF2)
    return plan, t(rng.integers(0, 2, (640, d)).astype(np.int32)), None, None


@pytest.mark.parametrize("case", [
    "apply_plan", "gather_d1", "gather_d7", "gather_d4100", "injective_d1",
    "injective_d7", "injective_d4100", "colliding_d64", "small_d1",
    "gf2_d96", "hot_d16"])
def test_crossbar_kernels_match_plain_versions(dev, case):
    from repro_torch.core import crossbar as txb
    from repro_torch.kernels import launch_counts, ops, ref
    from repro_torch.kernels import crossbar_permute as xbk
    rng = np.random.default_rng(0)
    if case == "apply_plan":
        for mode in ("gather", "scatter"):
            idx = torch.as_tensor(rng.integers(-5, 700, (700, 3)).astype(
                np.int32), device=dev)
            w = torch.as_tensor(rng.standard_normal((700, 3)).astype(
                np.float32), device=dev)
            fn = txb.gather_plan if mode == "gather" else txb.scatter_plan
            plan = fn(idx, 700, weights=w)
            x = torch.as_tensor(rng.standard_normal((700, 40)).astype(
                np.float32), device=dev)
            want = txb.apply_plan(plan, x, backend="reference")
            for backend in ("kernel", "sparse"):
                assert_close(txb.apply_plan(plan, x, backend=backend), want)
        counts = launch_counts()
        assert counts["crossbar_dense"] > 0 and counts["crossbar_sparse"] > 0
        return
    plan, x, merge, tol = _crossbar_case(case, dev, rng)
    check = assert_bitexact if tol is None else (
        lambda got, want: assert_close(got, want, tol))

    def plain(fn, *args_, **kw_):
        # the hot row's plain sum runs on the CPU: one index_add_ in the
        # kernel's order, where the card takes a step per colliding entry
        if case != "hot_d16":
            return fn(*args_, **kw_)
        cpu = [a.cpu() if torch.is_tensor(a) else a for a in args_]
        return fn(*cpu, **{n: v.cpu() if torch.is_tensor(v) else v
                           for n, v in kw_.items()}).to(dev)

    idxp, xf, kw = ops.dense_operands(plan, x, merge=merge)
    check(xbk.crossbar_permute_cuda(idxp, xf, **kw),
          plain(ref.crossbar_dense, idxp, xf, **kw))
    args, kw = ops.sparse_operands(plan, x)
    kw["out"].fill_(-7.0)
    want = plain(ref.crossbar_sparse, *args,
                 **dict(kw, out=kw["out"].clone()))
    check(xbk.crossbar_permute_sparse_cuda(*args, **kw), want)
    # memset + 2 launches a radix pass (8 bits of the output row) + gather
    passes = max(1, -(-plan.n_out.bit_length() // 8))
    scatter_launches = 1 if plan.idx[:plan.n_in].numel() <= 256 \
        else 2 + 2 * passes
    assert xbk.DEVICE_LAUNCHES["crossbar_sparse"] == (
        1 if plan.mode == "gather" else scatter_launches)
    if merge is not None:
        assert_bitexact(txb.apply_plan(plan, x, merge=merge, backend="sparse"),
                        txb.apply_plan(plan, x, merge=merge,
                                       backend="reference"))


def test_sha3_on_every_backend(dev):
    from repro_torch.crypto import keccak
    for backend in ("einsum", "kernel", "sparse", "megakernel"):
        assert keccak.sha3_256(b"abc", backend=backend, device=dev) == \
            hashlib.sha3_256(b"abc").digest()
    s = torch.as_tensor(np.random.default_rng(1).integers(
        0, 2, (8, 1600)).astype(np.int32), device=dev)
    assert_bitexact(keccak.keccak_f1600(s, backend="megakernel"),
                    keccak.keccak_f1600(s.cpu(), backend="megakernel"))


def test_moe_route_kernel_matches_plain_version(dev):
    from repro_torch.kernels import launch_counts, ref, reset_launch_counts
    from repro_torch.kernels.moe_route import moe_route_cuda
    reset_launch_counts()
    rng = np.random.default_rng(2)
    for g, tk, e, c in ((2, 4096, 16, 384), (8, 2, 16, 2), (3, 2001, 5, 9)):
        ids = torch.as_tensor(rng.integers(-1, e + 2, (g, tk)).astype(
            np.int32), device=dev)
        for got, want in zip(moe_route_cuda(ids, num_experts=e, capacity=c),
                             ref.moe_route_transform(ids, num_experts=e,
                                                     capacity=c)):
            assert_bitexact(got, want)
    assert launch_counts()["moe_route"] == 3


@pytest.mark.parametrize("case", ROUTE_CASES + [
    (1, 32768, 2, 16, None, None, "mixed"),     # one long group
    (1, 32768, 2, 1024, None, None, "mixed"),   # 4 chunks a CTA
    (1, 2048, 2, 16, 16, 1024, "mixed"),        # 16 CTAs of 1024 threads
], ids=lambda c: "-".join(map(str, c)))
def test_moe_route_kernel_cases(dev, case):
    """The routing kernel on each geometry of the CPU decomposition tests
    (``tests/test_torch_moe_route.py``), bit-exact against the plain
    version; one launch a call."""
    from repro_torch.kernels import launch_counts, ref, reset_launch_counts
    from repro_torch.kernels import moe_route as mrk
    g, t, k, e, cluster, threads, _ = case
    ids = torch.as_tensor(route_ids(case, seed=g + t + e), device=dev)
    reset_launch_counts()
    caps = route_capacities(case)
    for cap in caps:
        got = mrk.moe_route_cuda(ids, num_experts=e, capacity=cap,
                                 cluster=cluster, threads=threads)
        for a, b in zip(got, ref.moe_route_transform(ids, num_experts=e,
                                                     capacity=cap)):
            assert_bitexact(a, b)
    torch.cuda.synchronize()
    assert launch_counts()["moe_route"] == len(caps)


def test_fused_vcompress_kernel_matches_plain_version(dev):
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(3)
    for n, d in ((2048, 4096), (5000, 7), (1, 1)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.as_tensor(rng.standard_normal((n, d)).astype(
                np.float32), device=dev).to(dtype)
            m = torch.as_tensor(rng.random(n) < 0.5, device=dev)
            for tail in ("zero", "bijective"):
                assert_bitexact(ops.fused_vcompress(m, x, tail=tail),
                                ref.fused_vcompress(m, x, tail=tail))
    for dtype, d in ((torch.int32, 6), (torch.int64, 3), (torch.uint8, 7)):
        x = torch.randint(0, 255, (300, d), device=dev).to(dtype) * 99991
        m = torch.as_tensor(rng.random(300) < 0.5, device=dev)
        for tail in ("zero", "bijective"):
            assert_bitexact(ops.fused_vcompress(m, x, tail=tail),
                            ref.fused_vcompress(m, x, tail=tail))


def _all_opcode_program(dev, n=256):
    """Every opcode over 3 rounds: a weighted ADD plan, a GF(2) plan run in
    place, per-round strided constants (word layout only)."""
    from repro_torch.core import crossbar as txb
    from repro_torch.core import plan_program as pp
    from repro_torch.core.semiring import GF2
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a.astype(np.int32), device=dev)

    b = pp.ProgramBuilder("all_ops", n, n_regs=4)
    rot = b.add_const_rows(rng.integers(0, 32, (3, n)))
    xc = b.add_const_rows(rng.integers(-2**31, 2**31, (3, n)))
    eqc = b.add_const_rows(rng.integers(0, 3, (3, n)))
    src3 = t(rng.integers(-4, n + 4, (n, 3)))
    b.permute(1, 0, txb.gather_plan(t(rng.permutation(n)), n))
    b.permute(2, 1, txb.gather_plan(src3, n, weights=t(
        rng.integers(-9, 9, (n, 3))).float()))
    b.xor(3, 3, 1)
    b.permute(3, 3, txb.gather_plan(src3, n, semiring=GF2))
    b.eq_const_at(3, 3, eqc)
    b.and_(1, 1, 2)
    b.andn(2, 3, 0)
    b.add(0, 0, 2)
    b.rotlv_at(0, 0, rot)
    b.xor_const_at(0, 0, xc)
    b.add(0, 0, 1)
    return b.build(rounds=3, const_stride=1)


def _vm(state, ctl):
    from repro_torch.core import plan_program as pp
    from repro_torch.kernels import ref
    return ref.plan_program_vm(state, *pp.vm_operands(ctl),
                               n_regs=ctl["n_regs"], rounds=ctl["rounds"],
                               const_stride=ctl["const_stride"])


@pytest.mark.parametrize("kind", ["bits", "int32"])
@pytest.mark.parametrize("d", [1, 31, 33, 1000, 1024])
def test_packed_megakernel_matches_plain_vm(dev, d, kind):
    """Keccak-f[1600] on 32 lanes a word against the plain VM and the
    packed layout's plain emulation, bit-exact; int32 states carry high
    bits that the program never reads."""
    from repro_torch.core import plan_program as pp
    from repro_torch.crypto import keccak
    from repro_torch.kernels import plan_program_kernel as ppk
    from repro_torch.kernels import ref, reset_launch_counts
    rng = np.random.default_rng(d)
    s = torch.as_tensor((rng.integers(0, 2, (1600, d)) if kind == "bits"
                         else rng.integers(-2**31, 2**31, (1600, d))).astype(
        np.int32), device=dev)
    reset_launch_counts()
    got = keccak.keccak_f1600(s.T.contiguous(), backend="megakernel").T
    assert ppk.LAYOUT_LAUNCHES == {"packed": 1, "word": 0,
                                   "word_global": 0}
    ctl = pp.control_for(keccak.megakernel_program(dev), dev)
    assert ctl["layout"] == "packed"
    assert_bitexact(got, _vm(s, ctl))
    assert_bitexact(ppk.plan_program_cuda(s, ctl), _vm(s, ctl))
    assert_bitexact(got, ref.plan_program_packed(s, ctl))


@pytest.mark.parametrize("case", ["keccak", "all_opcodes"])
def test_word_layout_matches_plain_vm(dev, case):
    from repro_torch.core import plan_program as pp
    from repro_torch.crypto import keccak
    from repro_torch.kernels import plan_program_kernel as ppk
    from repro_torch.kernels import reset_launch_counts
    rng = np.random.default_rng(9)
    if case == "keccak":
        prog = keccak.megakernel_program(dev)
        s = torch.as_tensor(rng.integers(-2**31, 2**31, (1600, 1000)).astype(
            np.int32), device=dev)
    else:
        prog = _all_opcode_program(dev)
        s = torch.as_tensor(rng.integers(0, 2**32, (256, 77), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32),
                            device=dev).view(torch.uint32)
    ctl = pp.control_for(prog, dev)
    reset_launch_counts()
    got = ppk.plan_program_cuda(s, ctl, layout="word")
    assert ppk.LAYOUT_LAUNCHES == {"packed": 0, "word": 1,
                                   "word_global": 0}
    assert_bitexact(got.view(torch.int32), _vm(s, ctl).view(torch.int32))
    if case == "all_opcodes":
        assert ctl["layout"] == "word"
        assert_bitexact(pp.run_program(prog, s).view(torch.int32),
                        got.view(torch.int32))
        assert ppk.LAYOUT_LAUNCHES == {"packed": 0, "word": 2,
                                       "word_global": 0}


@pytest.mark.parametrize("n", [1, 31, 2048, 5000, 100000])
def test_fused_vcompress_edge_cases(dev, n):
    """One kernel a call, bit-exact against the plain version: random,
    all-0 and all-1 masks, bool and int8, 7 float32 and 4100 bf16 a row,
    both tails."""
    from repro_torch.kernels import launch_counts, ref, reset_launch_counts
    from repro_torch.kernels.fused_compress import fused_vcompress_cuda
    rng = np.random.default_rng(n)
    reset_launch_counts()
    calls = 0
    for dt, d in ((torch.float32, 7), (torch.bfloat16, 4100)):
        x = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32),
                            device=dev).to(dt)
        for sel in (rng.random(n) < 0.5, np.zeros(n, bool), np.ones(n, bool)):
            for mdt in (torch.bool, torch.int8):
                m = torch.as_tensor(sel, device=dev).to(mdt)
                for tail in ("zero", "bijective"):
                    assert_bitexact(fused_vcompress_cuda(m, x, tail=tail),
                                    ref.fused_vcompress(m, x, tail=tail))
                    calls += 1
    assert launch_counts()["fused_vcompress"] == calls


def test_moe_layer_and_greedy_serving_match_the_cpu(dev):
    import dataclasses
    from repro_torch.configs import phi3_5_moe
    from repro_torch.configs.base import reduced
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model_zoo
    from repro_torch.models import moe as M
    from repro_torch.models import params as MP
    from repro_torch.serve import ServeOptions, ServingEngine
    cfg = reduced(phi3_5_moe.CONFIG)
    params = MP.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = MP.to_device(params, dev)
    reset_launch_counts()
    x = np.random.default_rng(4).standard_normal((2, 24, 64)).astype(
        np.float32)
    for backend in ("sparse", "kernel"):
        c = dataclasses.replace(cfg, dispatch_backend=backend)
        want, _ = M.moe_mlp_apply(params["blocks"][0]["moe"],
                                  torch.as_tensor(x), c)
        got, _ = M.moe_mlp_apply(on_card["blocks"][0]["moe"],
                                 torch.as_tensor(x, device=dev), c)
        assert_close(got, want, dict(rtol=1e-5, atol=1e-5))
    counts = launch_counts()
    assert counts["moe_route"] > 0 and counts["crossbar_sparse"] > 0
    assert counts["crossbar_dense"] > 0
    prompts = [[5, 17, 99, 3], [42], [7, 7, 120, 64, 1, 8]]
    outs = []
    for where, p in (("cpu", params), (dev, on_card)):
        api = model_zoo.build(dataclasses.replace(
            cfg, dispatch_backend="sparse"), device=where)
        engine = ServingEngine(api, ServeOptions(batch_slots=4,
                                                 max_new_tokens=6),
                               max_seq=16)
        outs.append(engine.generate(p, prompts))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("key", ["aes/shift_rows_mix_columns",
                                 "aes/inv_shift_rows_inv_mix_columns",
                                 "aes/mix_columns"])
@pytest.mark.parametrize("d", [1, 3, 4096])
def test_lifted_gf2_plans_on_both_crossbars(dev, key, d):
    """The GF(2^8) plans' bit lifts (128 bit rows, k = 32 selects, mostly
    DROP, GF(2) fold) through both kernels against their plain versions,
    and through apply_plan against the reference backend's field
    arithmetic; bit-exact."""
    from repro_torch.core import crossbar as txb
    from repro_torch.crypto import aes
    from repro_torch.crypto.registry import registry
    from repro_torch.kernels import crossbar_permute as xbk
    from repro_torch.kernels import ops, ref
    aes._ensure_plans(False, True, dev)
    aes._ensure_plans(True, True, dev)
    plan = registry(dev)[key]
    lifted = txb.lift_gf2_8(plan)
    assert (lifted.n_out, lifted.k) == (128, 32)
    rng = np.random.default_rng(d)
    bits = torch.as_tensor(rng.integers(0, 2, (128, d)).astype(np.int32),
                           device=dev)
    idxp, xf, kw = ops.dense_operands(lifted, bits)
    assert_bitexact(xbk.crossbar_permute_cuda(idxp, xf, **kw),
                    ref.crossbar_dense(idxp, xf, **kw))
    args, kws = ops.sparse_operands(lifted, bits)
    kws["out"].fill_(-7.0)
    kw_p = dict(kws, out=kws["out"].clone())
    assert_bitexact(xbk.crossbar_permute_sparse_cuda(*args, **kws),
                    ref.crossbar_sparse(*args, **kw_p))
    st = torch.as_tensor(rng.integers(0, 256, (16, d)).astype(np.int32),
                         device=dev)
    want = txb.apply_plan(plan, st, backend="reference")
    for backend in ("kernel", "sparse", "einsum"):
        assert_bitexact(txb.apply_plan(plan, st, backend=backend), want)


def test_aes_ctr_on_both_crossbars_matches_einsum(dev):
    """AES-128-CTR on the dense and the tile-skipping kernels equals the
    einsum path and SP 800-38A F.5.1, 20 crossbar passes a call."""
    from repro_torch.core import telemetry
    from repro_torch.crypto import aes
    from repro_torch.kernels import launch_counts, reset_launch_counts
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    iv = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
    plain = bytes.fromhex("6bc1bee22e409f96e93d7e117393172a")
    assert aes.aes128_ctr_xor(key, iv, plain, backend="kernel", device=dev) \
        == bytes.fromhex("874d6191b620e3261bef6864990db6ce")
    data = bytes(np.random.default_rng(0).integers(0, 256, 16 * 1000,
                                                   dtype=np.uint8))
    want = aes.aes128_ctr_xor(key, iv, data, backend="einsum", device=dev)
    reset_launch_counts()
    for backend, kernel in (("kernel", "crossbar_dense"),
                            ("sparse", "crossbar_sparse")):
        with telemetry.delta() as d:
            got = aes.aes128_ctr_xor(key, iv, data, backend=backend,
                                     fixed_latency=True, device=dev)
        assert got == want
        assert d()[f"apply_calls_{backend}"] == 20
        assert launch_counts()[kernel] == 20


def test_chacha20_word_layout_matches_plain_vm(dev):
    """ChaCha20's program (ADD/XOR/ROTLV/PERMUTE, n_regs 2) in the word
    layout at its default and narrower lanes a CTA against the plain VM,
    and through the entry point against RFC 8439 §2.3.2."""
    from repro_torch.core import plan_program as pp
    from repro_torch.crypto import chacha
    from repro_torch.kernels import plan_program_kernel as ppk
    from repro_torch.kernels import reset_launch_counts
    nonce = bytes.fromhex("000000090000004a00000000")
    host = chacha._setup_states(bytes(range(32)), 1, nonce, 3000).view(
        np.int32)
    words = torch.as_tensor(np.ascontiguousarray(host.T),
                            device=dev).view(torch.uint32)
    ctl = pp.control_for(chacha.megakernel_program(dev), dev)
    assert ctl["layout"] == "word"
    want = _vm(words, ctl).view(torch.int32)
    for lanes in (None, 32, 256):
        got = ppk.plan_program_cuda(words, ctl, lanes=lanes)
        assert_bitexact(got.view(torch.int32), want)
    reset_launch_counts()
    out = chacha.chacha20_blocks(bytes(range(32)), 1, nonce, 3000,
                                 backend="megakernel", device=dev)
    assert ppk.LAYOUT_LAUNCHES == {"packed": 0, "word": 1,
                                   "word_global": 0}
    assert out[:8] == bytes.fromhex("10f1e7e4d13b5915")
    assert out == chacha.chacha20_blocks(bytes(range(32)), 1, nonce, 3000,
                                         backend="einsum", device=dev)


@pytest.mark.parametrize("case", ["keccak", "all_opcodes", "chacha20"])
def test_word_layout_global_file_matches_plain_vm(dev, case):
    """The word kernel with its register file in global memory (forced
    here for programs that also fit shared memory) against the plain VM
    and the shared-memory placement, bit-exact."""
    from repro_torch.core import plan_program as pp
    from repro_torch.crypto import chacha, keccak
    from repro_torch.kernels import plan_program_kernel as ppk
    from repro_torch.kernels import reset_launch_counts
    rng = np.random.default_rng(11)
    if case == "keccak":
        prog = keccak.megakernel_program(dev)
        s = torch.as_tensor(rng.integers(-2**31, 2**31, (1600, 333)).astype(
            np.int32), device=dev)
    elif case == "all_opcodes":
        prog = _all_opcode_program(dev)
        s = torch.as_tensor(rng.integers(0, 2**32, (256, 77), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32),
                            device=dev).view(torch.uint32)
    else:
        prog = chacha.megakernel_program(dev)
        host = chacha._setup_states(bytes(range(32)), 1, bytes(12), 999)
        s = torch.as_tensor(np.ascontiguousarray(host.view(np.int32).T),
                            device=dev).view(torch.uint32)
    ctl = pp.control_for(prog, dev)
    want = _vm(s, ctl).view(torch.int32)
    reset_launch_counts()
    for lanes in (None, 1, 4):
        got = ppk.plan_program_cuda(s, ctl, layout="word", lanes=lanes,
                                    placement="global")
        assert_bitexact(got.view(torch.int32), want)
    assert_bitexact(ppk.plan_program_cuda(s, ctl, layout="word",
                                          placement="shared")
                    .view(torch.int32), want)
    assert ppk.LAYOUT_LAUNCHES == {"packed": 0, "word": 1,
                                   "word_global": 3}
    with pytest.raises(ValueError, match="placement"):
        ppk.plan_program_cuda(s, ctl, layout="word", placement="l2")


# (program, placement) of the row walk's card cases: GCM at the three
# record geometries of chip_smoke.py (a few records each), in every
# placement its register file fits
ROW_WALK_CASES = [("all_opcodes", "shared"), ("all_opcodes", "global"),
                  ("chacha20", "shared"), ("chacha20", "global"),
                  ("gcm_a", "shared"), ("gcm_a", "global"),
                  ("gcm_b", "shared"), ("gcm_b", "global"),
                  ("gcm_c", "global")]
GCM_ROW_GEOMETRIES = {"gcm_a": (64, 16), "gcm_b": (1024, 16),
                      "gcm_c": (1500, 13)}


@pytest.mark.parametrize("case,placement", ROW_WALK_CASES,
                         ids=[f"{c}-{p}" for c, p in ROW_WALK_CASES])
def test_word_row_walk_matches_plain_versions(dev, case, placement):
    """The word kernel's row walk (each step over the rows it may
    change, each row over its live selects) against its plain version on
    the same tables and the plain VM, bit-exact, at the default lanes a
    CTA and at 4 (V = 4 words a thread)."""
    from repro_torch.core import plan_program as pp
    from repro_torch.crypto import chacha, gcm
    from repro_torch.kernels import plan_program_kernel as ppk
    from repro_torch.kernels import ref
    rng = np.random.default_rng(13)
    if case == "all_opcodes":
        prog = _all_opcode_program(dev)
        s = torch.as_tensor(rng.integers(0, 2**32, (256, 77), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32),
                            device=dev).view(torch.uint32)
    elif case == "chacha20":
        prog = chacha.megakernel_program(dev)
        host = chacha._setup_states(bytes(range(32)), 1, bytes(12), 999)
        s = torch.as_tensor(np.ascontiguousarray(host.view(np.int32).T),
                            device=dev).view(torch.uint32)
    else:
        from test_torch_gcm import KEY, vecs
        pt_len, aad_len = GCM_ROW_GEOMETRIES[case]
        _, prog, lay = gcm.gcm_program(KEY, pt_len, aad_len, device=dev)
        s = torch.as_tensor(gcm._pack_records(lay, *vecs(pt_len, aad_len, 6),
                                              pt_len, aad_len), device=dev)
    ctl = pp.control_for(prog, dev)
    want = _vm(s, ctl).view(torch.int32)
    assert_bitexact(ref.plan_program_rows(s, ctl).view(torch.int32), want)
    fits = ctl["n_phys"] * prog.n * 4 * 4 <= ppk.smem_optin(dev)
    for lanes in (None, 4) if placement == "global" or fits else (None,):
        got = ppk.plan_program_cuda(s, ctl, layout="word", lanes=lanes,
                                    placement=placement)
        assert_bitexact(got.view(torch.int32), want)


@pytest.mark.parametrize("case", ["all_opcodes", "chacha20"])
def test_word_row_walk_past_the_unroll_limit(dev, monkeypatch, case):
    """Tables that keep the renaming's period (every row a step, the
    kernel adding the constant stride) against the plain VM."""
    from repro_torch.core import plan_program as pp
    from repro_torch.crypto import chacha
    from repro_torch.kernels import plan_program_kernel as ppk
    from repro_torch.kernels import ref
    rng = np.random.default_rng(15)
    if case == "all_opcodes":
        prog = _all_opcode_program(dev)
        s = torch.as_tensor(rng.integers(0, 2**32, (256, 77), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32),
                            device=dev).view(torch.uint32)
    else:
        prog = chacha.megakernel_program(dev)
        host = chacha._setup_states(bytes(range(32)), 5, bytes(12), 500)
        s = torch.as_tensor(np.ascontiguousarray(host.view(np.int32).T),
                            device=dev).view(torch.uint32)
    monkeypatch.setattr(pp, "UNROLL_STEPS", 8)
    ctl = pp.build_control(prog, dev)
    assert ctl["w_rounds"] == ctl["period"] < prog.rounds
    want = _vm(s, ctl).view(torch.int32)
    assert_bitexact(ref.plan_program_rows(s, ctl).view(torch.int32), want)
    for placement in ("shared", "global"):
        assert_bitexact(ppk.plan_program_cuda(s, ctl, placement=placement)
                        .view(torch.int32), want)


@pytest.mark.parametrize("geometry", [(64, 16, 37), (1024, 16, 5),
                                      (1500, 13, 3)],
                         ids=["64B-shared", "1KiB-shared", "1500B-global"])
def test_gcm_fused_seal_open_on_card(dev, geometry):
    """One megakernel launch a batch, in the placement the geometry
    takes, equal to the host oracle and the chained path on the card;
    open round-trips and names the tampered records."""
    from repro_torch.core import telemetry
    from repro_torch.crypto import gcm
    from repro_torch.kernels import plan_program_kernel as ppk
    from repro_torch.kernels import reset_launch_counts
    from test_torch_gcm import KEY, gcm_ref, vecs
    pt_len, aad_len, b = geometry
    ivs, pts, aads = vecs(pt_len, aad_len, b)
    _, prog, lay = gcm.gcm_program(KEY, pt_len, aad_len, device=dev)
    smem = ppk.smem_optin(dev)
    placement = ppk.register_file(lay["n"], prog.n_regs, smem,
                                  ppk.lanes_per_cta(lay["n"], prog.n_regs, b,
                                                    smem,
                                                    sms=ppk.sm_count(dev)))
    reset_launch_counts()
    with telemetry.delta() as d:
        sealed = gcm.aes128_gcm_seal_batch(KEY, ivs, pts, aads,
                                           fixed_latency=True, device=dev)
    assert d()["program_launches"] == 1 and d()["apply_calls"] == 0
    key = "word" if placement == "shared" else "word_global"
    assert ppk.LAYOUT_LAUNCHES[key] == 1 and sum(
        ppk.LAYOUT_LAUNCHES.values()) == 1
    for r in (0, b - 1):
        assert sealed[r] == b"".join(gcm_ref(KEY, ivs[r], pts[r], aads[r]))
    assert gcm.aes128_gcm_seal_batch(KEY, ivs[:1], pts[:1], aads[:1],
                                     backend="kernel",
                                     device=dev) == sealed[:1]
    assert gcm.aes128_gcm_open_batch(KEY, ivs, sealed, aads,
                                     device=dev) == pts
    bad = list(sealed)
    bad[1] = bad[1][:-1] + bytes([bad[1][-1] ^ 1])
    bad[-1] = bytes([bad[-1][0] ^ 1]) + bad[-1][1:]
    with pytest.raises(gcm.InvalidTagError) as ei:
        gcm.aes128_gcm_open_batch(KEY, ivs, bad, aads, device=dev)
    assert ei.value.indices == (1, b - 1)


@pytest.mark.parametrize("backend", ["fused", "einsum", "kernel", "sparse",
                                     "reference"])
def test_gcm_cavp_on_card(dev, backend):
    from repro_torch.crypto import gcm
    from test_torch_gcm import CAVP
    for key, iv, pt, aad, ct, tag in CAVP:
        sealed = gcm.aes128_gcm_seal(key, iv, pt, aad, backend=backend,
                                     device=dev)
        assert sealed == ct + tag
        assert gcm.aes128_gcm_open(key, iv, sealed, aad, backend=backend,
                                   device=dev) == pt


@pytest.mark.parametrize("mode", ["powers", "horner"])
def test_ghash_wide_lift_on_both_crossbars(dev, mode):
    """GHASH's lifted GF(2^128) passes on the dense and tile-skipping
    kernels equal the limb oracle ('reference') and the host oracle."""
    from repro_torch.core import telemetry
    from repro_torch.crypto import gcm
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from test_torch_gcm import KEY, aes_ref, ghash_ref
    h = gcm._hash_key(KEY)
    data = bytes(np.random.default_rng(7).integers(0, 256, 16 * 40,
                                                   dtype=np.uint8))
    want = gcm.ghash(h, data, mode=mode, backend="reference", device=dev)
    assert want == ghash_ref(aes_ref(KEY, bytes(16)), data)
    reset_launch_counts()
    for backend, kernel in (("kernel", "crossbar_dense"),
                            ("sparse", "crossbar_sparse")):
        with telemetry.delta() as d:
            assert gcm.ghash(h, data, mode=mode, backend=backend,
                             device=dev) == want
        passes = 1 if mode == "powers" else 40
        assert d()[f"apply_calls_{backend}"] == passes
        assert launch_counts()[kernel] == passes


def _serving_payloads(n, seed):
    rng = np.random.default_rng(seed)
    lengths = np.where(rng.random(n) < 0.85, rng.integers(1, 128, n),
                       rng.integers(140, 260, n))
    return [rng.bytes(int(n_)) for n_ in lengths]


def _launch_deltas(before):
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import plan_program_kernel as ppk
    kl, lay = launch_counts(), dict(ppk.LAYOUT_LAUNCHES)
    return ({k: v - before[0].get(k, 0) for k, v in kl.items()},
            {k: v - before[1].get(k, 0) for k, v in lay.items()})


def _launches_now():
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import plan_program_kernel as ppk
    return dict(launch_counts()), dict(ppk.LAYOUT_LAUNCHES)


@pytest.mark.parametrize("threaded", [False, True])
def test_batching_engine_serves_sha3_on_the_megakernel(dev, threaded):
    from repro_torch.core import telemetry
    from repro_torch.serve import BatchingEngine, BatchingOptions
    payloads = _serving_payloads(600, seed=1)
    eng = BatchingEngine(BatchingOptions(max_batch=128), device=dev,
                         start=threaded)
    before = _launches_now()
    reqs = [eng.submit(p) for p in payloads]
    if threaded:
        got = [r.result(timeout=120) for r in reqs]
        eng.close(timeout=60)
    else:
        while eng.run_once():
            pass
        got = [r.result(0) for r in reqs]
    assert got == [hashlib.sha3_256(p).digest() for p in payloads]
    kl, lay = _launch_deltas(before)
    log = list(eng.batch_log)
    assert {b for _, _, b, _ in log} == {"megakernel"}
    assert all(s[0] & (s[0] - 1) == 0 for _, s, _, _ in log)
    assert lay["packed"] == sum(s[1] for _, s, _, _ in log)
    assert lay["word"] == lay["word_global"] == 0
    assert kl["crossbar_dense"] == kl["crossbar_sparse"] == 0
    snap = telemetry.snapshot()
    assert snap.get("resilience_fallbacks", 0) == 0
    assert snap.get("resilience_retries", 0) == 0


def test_batching_engine_seals_gcm_in_one_word_launch(dev):
    from repro_torch.crypto import gcm as TG
    from repro_torch.serve import BatchingEngine, BatchingOptions
    from repro_torch.serve.batching import encode_aead_record
    from test_torch_gcm import KEY, gcm_ref
    rng = np.random.default_rng(5)
    recs = [(rng.bytes(12), rng.bytes(64), rng.bytes(16)) for _ in range(96)]
    eng = BatchingEngine(BatchingOptions(max_batch=128, aead_key=KEY),
                         device=dev, start=False)
    reqs = [eng.submit(encode_aead_record(*r), op="gcm_seal") for r in recs]
    before = _launches_now()
    assert eng.run_once() == len(recs)
    kl, lay = _launch_deltas(before)
    assert lay == {"packed": 0, "word": 1, "word_global": 0}
    got = [r.result(0) for r in reqs]
    assert eng.batch_log[-1] == ("gcm_seal", (128, 64, 16), "megakernel", 96)
    ivs, pts, aads = (list(x) for x in zip(*recs))
    assert got == TG.aes128_gcm_seal_batch(KEY, ivs, pts, aads,
                                           backend="fused", device=dev)
    for i in (0, 47, 95):
        assert got[i] == b"".join(gcm_ref(KEY, *recs[i]))


@pytest.mark.parametrize("op", ["sha3_256", "gcm_seal"])
def test_injected_megakernel_fault_lands_on_the_tile_skipping_kernel(dev,
                                                                     op):
    from repro_torch.core import faults, telemetry
    from repro_torch.core.resilience import (CARD_CHAIN, ResilientExecutor,
                                             RetryPolicy)
    from repro_torch.crypto import gcm as TG
    from repro_torch.crypto.registry import registry
    from repro_torch.serve import BatchingEngine, BatchingOptions
    from repro_torch.serve.batching import encode_aead_record
    from test_torch_gcm import KEY
    rng = np.random.default_rng(7)
    ex = ResilientExecutor(chain=CARD_CHAIN,
                           retry=RetryPolicy(max_attempts=1),
                           registry=registry(dev))
    eng = BatchingEngine(BatchingOptions(max_batch=16, aead_key=KEY),
                         executor=ex, device=dev, start=False)
    if op == "sha3_256":
        subs = [rng.bytes(int(n)) for n in rng.integers(1, 128, 16)]
        want = [hashlib.sha3_256(p).digest() for p in subs]
    else:
        recs = [(rng.bytes(12), rng.bytes(64), rng.bytes(16))
                for _ in range(4)]
        subs = [encode_aead_record(*r) for r in recs]
        ivs, pts, aads = (list(x) for x in zip(*recs))
        want = TG.aes128_gcm_seal_batch(KEY, ivs, pts, aads,
                                        backend="fused", device=dev)
    reqs = [eng.submit(p, op=op) for p in subs]
    before = _launches_now()
    with faults.inject_faults(seed=3, program_rate=1.0, sites=("program",),
                              max_faults=1) as inj:
        while eng.run_once():
            pass
    kl, _ = _launch_deltas(before)
    assert inj.count == 1
    assert [r.result(0) for r in reqs] == want
    assert {r.backend for r in reqs} == {"sparse"}
    assert telemetry.counter("resilience_fallbacks") == 1
    assert kl["crossbar_sparse"] > 0


def test_kernel_build_failure_escapes_the_chain_on_card(dev, monkeypatch):
    from repro_torch.core import telemetry
    from repro_torch.kernels import _build
    from repro_torch.kernels._build import KernelBuildError
    from repro_torch.serve import BatchingEngine, BatchingOptions

    def no_nvcc():
        raise KernelBuildError("nvcc not found (forced)")
    eng = BatchingEngine(BatchingOptions(max_batch=8), device=dev,
                         start=False)
    reqs = [eng.submit(bytes([i])) for i in range(8)]
    monkeypatch.setattr(_build, "library", no_nvcc)
    eng.run_once()
    for r in reqs:
        with pytest.raises(KernelBuildError):
            r.result(0)
    assert telemetry.counter("resilience_fallbacks") == 0
    assert telemetry.counter("resilience_faults") == 0
    assert not eng.batch_log


def test_exhausted_card_chain_raises_and_einsum_never_answers(dev):
    """A batch whose three kernel rungs all fail completes with the
    typed fault: the card's chain holds no plain PyTorch rung."""
    from repro_torch.core import faults, telemetry
    from repro_torch.core.resilience import CARD_CHAIN, LaunchFault
    from repro_torch.serve import BatchingEngine, BatchingOptions
    eng = BatchingEngine(BatchingOptions(max_batch=8), device=dev,
                         start=False)
    assert eng.chain == eng.executor.chain == CARD_CHAIN
    reqs = [eng.submit(bytes([i]) * 5) for i in range(8)]
    before = _launches_now()
    with faults.inject_faults(seed=0, program_rate=1.0, launch_rate=1.0,
                              sites=("program", "apply")) as inj:
        eng.run_once()
    kl, lay = _launch_deltas(before)
    for r in reqs:
        with pytest.raises(LaunchFault, match="'kernel' failed"):
            r.result(0)
    assert inj.count == 6                  # two attempts on each rung
    assert telemetry.counter("resilience_exhausted") == 1
    assert telemetry.counter("serve_failed") == 8
    for name in ("einsum", "reference"):
        assert telemetry.counter(f"resilience_backend_{name}") == 0
    assert not any(kl.values()) and not any(lay.values())
    assert not eng.batch_log


def _mesh_cases(dev, rng):
    """(name, plan on ``dev``, payload on ``dev``, tol) of the sharded
    crossbar cases: tol None = bit-exact."""
    from repro_torch.core import crossbar as txb
    from repro_torch.core import plan_algebra as tpa
    from repro_torch.crypto import keccak as TK

    def t(a):
        return torch.as_tensor(a, device=dev)

    cap, e_, n_tok = 24, 16, 256
    dest = rng.integers(-1, e_ * cap, n_tok).astype(np.int32)
    dest = np.where(np.arange(n_tok) % 7 == 0, -1, dest)
    _, first = np.unique(dest, return_index=True)
    keep = np.zeros(n_tok, bool)
    keep[first] = True
    dest = np.where(keep, dest, -1)                    # output-injective
    slide = txb.vslide_plan(512, 32, up=True, device=dev)
    return [
        ("rho_pi GF2 (1600, 64)", TK.rho_pi_plan(dev),
         t(rng.integers(0, 2, (1600, 64)).astype(np.int32)), None),
        ("MoE scatter (256 -> 384, 64) bf16",
         txb.scatter_plan(t(dest), e_ * cap),
         t(rng.standard_normal((n_tok, 64)).astype(np.float32)).to(
             torch.bfloat16), None),
        ("weighted vslide (512, 16) f32",
         tpa.with_weights(slide, t(rng.standard_normal(512).astype(
             np.float32))),
         t(rng.standard_normal((512, 16)).astype(np.float32)), F32_TOL),
    ]


@pytest.mark.parametrize("s", [2, 8])
@pytest.mark.parametrize("backend", ["kernel", "sparse"])
def test_sharded_crossbars_match_plain_versions(dev, backend, s):
    """Scheduled and naive executors on a mesh of ``s`` shards of cuda:0
    against the same executors on a CPU mesh (the kernels' plain
    versions); one crossbar launch a block that runs, and the block
    copies the schedule names."""
    from repro_torch.core import crossbar as txb
    from repro_torch.core import telemetry
    from repro_torch.dist import make_mesh
    from repro_torch.dist import mesh_exec as mx
    kernel = {"kernel": "crossbar_dense", "sparse": "crossbar_sparse"}
    mesh = make_mesh((s,), ("data",), devices=[dev] * s)
    cpu = make_mesh((s,), ("data",), devices=["cpu"] * s)
    for name, plan, x, tol in _mesh_cases(dev, np.random.default_rng(s)):
        fn = mx.sharded_apply_fn(plan, mesh, backend=backend)
        stats = mx.schedule_stats(fn.conn)
        before = _launches_now()
        with telemetry.delta() as d:
            got = torch.cat(fn(x))
        kl, _ = _launch_deltas(before)
        assert d().get("mesh_block_copies", 0) == stats[
            "scheduled_block_transfers"], name
        assert kl[kernel[backend]] >= len(fn.blocks) > 0, name
        cplan = txb.PermutePlan(plan.mode, plan.idx.cpu(), plan.n_in,
                                plan.n_out, None if plan.weights is None
                                else plan.weights.cpu(), plan.semiring)
        want = mx.apply_plan_sharded(cplan, x.cpu(), cpu, backend=backend)
        single = txb.apply_plan(cplan, x.cpu(), backend="reference")
        naive = mx.apply_plan_sharded_naive(plan, x, mesh, backend=backend)
        for out in (got, naive):
            if tol is None:
                assert_bitexact(out, want)
                assert_bitexact(out, single)
            else:
                assert_close(out, want, tol)
                assert_close(out, single, tol)


@pytest.mark.parametrize("which", ["keccak", "chacha20"])
def test_run_program_sharded_one_launch_a_shard(dev, which):
    """Column-sharded programs on 4 shards of cuda:0: the packed
    (Keccak-f) and word (ChaCha20) layouts, one launch a shard, no block
    copy, equal to the plain VM."""
    from repro_torch.core import plan_program as tpp
    from repro_torch.core import telemetry
    from repro_torch.crypto import chacha as TC
    from repro_torch.crypto import keccak as TK
    from repro_torch.dist import make_mesh
    from repro_torch.dist import mesh_exec as mx
    rng = np.random.default_rng(7)
    if which == "keccak":
        prog, layout = TK.megakernel_program(dev), "packed"
        x = torch.as_tensor(rng.integers(0, 2, (1600, 256)).astype(np.int32),
                            device=dev)
    else:
        prog, layout = TC.megakernel_program(dev), "word"
        x = torch.as_tensor(rng.integers(-2**31, 2**31, (16, 256),
                                         dtype=np.int64).astype(np.int32),
                            device=dev).view(torch.uint32)
    mesh = make_mesh((4,), ("data",), devices=[dev] * 4)
    before = _launches_now()
    with telemetry.delta() as d:
        got = mx.run_program_sharded(prog, x, mesh)
    kl, lay = _launch_deltas(before)
    assert d().get("mesh_block_copies", 0) == 0
    assert kl["plan_program"] == lay[layout] == 4
    cprog = (TK.megakernel_program("cpu") if which == "keccak"
             else TC.megakernel_program("cpu"))
    want = tpp.run_program(cprog, x.cpu())
    assert_bitexact(got.view(torch.int32), want.view(torch.int32))


def test_moe_train_step_on_card_equals_plain_routing(dev, monkeypatch):
    """One train step of a tiny MoE (4 experts, top-2, remat full) on the
    card with positions from the moe_route kernel equals the same step
    with the kernel's plain version (run on the card): the same routing
    bit for bit, so the same loss, gradients and parameters."""
    from repro_torch import _tree
    from repro_torch.configs.base import ModelConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import launch_counts, ops, ref
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import model_zoo
    from repro_torch.train import TrainOptions, make_train_step
    from repro_torch.train.trainer import init_state
    cfg = ModelConfig(name="tiny", family="moe", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                      head_dim=16, compute_dtype="float32", remat="full",
                      attn_chunk=8, num_experts=4, num_experts_per_tok=2)
    api = model_zoo.build(cfg, device=dev)
    params = api.init(torch.Generator(device=dev).manual_seed(0))
    batch = {k: v.to(dev) for k, v in SyntheticLM(
        vocab_size=128, seq_len=16, global_batch=4).batch(0).items()}
    opts = TrainOptions(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    with torch.no_grad():       # warm-up: the first forward is not compared
        api.loss_fn(params, batch)
    real = ops.moe_route_transform
    results = {}
    for which in ("kernel", "plain"):
        routed = []

        def route(ids, **kw):
            if which == "plain":
                shape = ids.shape
                rows = ids.reshape(-1, shape[-2] * shape[-1]).to(torch.int32)
                pos, dest = ref.moe_route_transform(rows, **kw)
                out = (pos.reshape(shape), dest.reshape(shape))
            else:
                out = real(ids, **kw)
            routed.append(tuple(t.clone() for t in out))
            return out

        monkeypatch.setattr(ops, "moe_route_transform", route)
        grads = {}
        step = make_train_step(api.loss_fn, opts, grad_hook=lambda p, g:
                               grads.update(g=_tree.tree_map(
                                   lambda t: t.detach().clone(), g)))
        reset_launch_counts()
        state, m = step(init_state(_tree.tree_map(torch.clone, params), 0),
                        batch)
        torch.cuda.synchronize()
        launches = launch_counts()["moe_route"]
        results[which] = (routed, m, grads["g"], state.params, launches)
    monkeypatch.setattr(ops, "moe_route_transform", real)
    k, p = results["kernel"], results["plain"]
    assert k[4] == 2 * cfg.num_layers and p[4] == 0  # forward + recompute
    assert len(k[0]) == len(p[0]) == 2 * cfg.num_layers
    for a, b in zip(k[0], p[0]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert float(k[1]["loss"]) == float(p[1]["loss"])
    assert np.isfinite(float(k[1]["loss"]))
    for a, b in zip(_tree.leaves(k[2]), _tree.leaves(p[2])):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)
    for blk in k[2]["blocks"]:
        assert float(blk["moe"]["router"]["w"].abs().sum()) > 0
    for a, b in zip(_tree.leaves(k[3]), _tree.leaves(p[3])):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)
