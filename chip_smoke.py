#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Builds the three CUDA kernels of ``src/repro_torch/kernels/csrc`` with
nvcc (into ``build/repro_torch_kernels/``), holds each kernel against its
plain PyTorch version at the main path's shapes, then drives the main
path through the entry points a user calls — batched SHA3-256 of 1024
one-KiB messages on the plan-program megakernel, Keccak-f[1600] on the
dense and tile-skipping crossbars, the RVV ops, the fixed-latency
contract — with every launch counter set to 0 just before and read just
after.  Then it times each kernel, its plain version and, where one
exists, a single PyTorch call computing the same function.

Any failed check raises and the run exits non-zero.  The second-to-last
line is the ``kernels`` JSON object; the last line is the contract line
``{"ok": true, "device": {...}}``.  Without a CUDA device (or without the
rest of the repository beside it) the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_NON_TENSOR_OPS_PER_S = 67e12

TOL_F32 = dict(rtol=1e-5, atol=1e-6)     # weighted REAL, colliding scatter
TOL_BF16 = dict(rtol=1e-2, atol=1e-2)    # bf16 payload, bf16-rounded weights


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import crossbar as xb
    from repro_torch.core import permute as P
    from repro_torch.core import plan_algebra as pa
    from repro_torch.core import plan_program as pp
    from repro_torch.core import telemetry
    from repro_torch.core.semiring import GF2
    from repro_torch.crypto import keccak as K
    from repro_torch.kernels import _build, launch_counts, ops, ref
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels import crossbar_permute as xbk
    from repro_torch.kernels import plan_program_kernel as ppk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({'cached' if _build.BUILD_INFO.get('cached') else 'nvcc'}) "
        f"-> {_build.BUILD_INFO['path']}")
    for line in _build.BUILD_INFO.get("report", "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  ptxas {line.strip()}")

    def t_int01(*shape):
        return torch.as_tensor(rng.integers(0, 2, shape, dtype=np.int32),
                               device=dev)

    err = {"crossbar_dense": 0.0, "crossbar_sparse": 0.0, "plan_program": 0.0}

    def compare(kernel, name, got, want, tol=None):
        got32, want32 = got.float(), want.float()
        diff = float((got32 - want32).abs().max()) if got.numel() else 0.0
        if tol is None:
            check(torch.equal(got, want), f"{name}: not bit-exact "
                  f"(max |diff| {diff})")
        else:
            check(torch.allclose(got32, want32, **tol),
                  f"{name}: max |diff| {diff} outside {tol}")
        err[kernel] = max(err[kernel], diff)
        log(f"  {name}: max |diff| {diff} "
            f"({'bit-exact' if tol is None else tol})")

    # ----------------------------------------------------------- dense ---
    log("dense crossbar vs plain version")
    rho_pi = K.rho_pi_plan(dev)
    trp = K.theta_rho_pi_plan(dev)
    x_bits = t_int01(1600, 1024)

    def dense_case(name, plan, x, merge=None, tol=None):
        idxp, xf, kw = ops.dense_operands(plan, x, merge=merge)
        got = xbk.crossbar_permute_cuda(idxp, xf, **kw)
        again = xbk.crossbar_permute_cuda(idxp, xf, **kw)
        want = ref.crossbar_dense(idxp, xf, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{name}: differs from run to run")
        compare("crossbar_dense", name, got, want, tol)

    dense_case("rho_pi (1600, 1024) int 0/1", rho_pi, x_bits)
    dense_case("theta_rho_pi k=11 GF2 fold (1600, 1024)", trp, x_bits)
    n_sc = 4096
    dest = torch.as_tensor(rng.integers(-8, n_sc // 2, (n_sc, 2),
                                        dtype=np.int32), device=dev)
    w_sc = torch.as_tensor(rng.standard_normal((n_sc, 2), np.float32),
                           device=dev)
    scat = xb.scatter_plan(dest, n_sc, weights=w_sc)
    x_f = torch.as_tensor(rng.standard_normal((n_sc, 256), np.float32),
                          device=dev)
    dense_case("weighted REAL scatter, collisions (4096, 256)", scat, x_f,
               tol=TOL_F32)
    src_m = torch.as_tensor(rng.integers(-512, 2048, 2048, dtype=np.int32),
                            device=dev)
    x_m = torch.as_tensor(rng.standard_normal((2048, 128), np.float32),
                          device=dev)
    merge = torch.as_tensor(rng.standard_normal((2048, 128), np.float32),
                            device=dev)
    dense_case("gather with DROPs + merge (2048, 128)",
               xb.gather_plan(src_m, 2048), x_m, merge=merge)
    src_w = torch.as_tensor(rng.integers(0, 2048, (2048, 3), dtype=np.int32),
                            device=dev)
    w_w = torch.as_tensor(rng.standard_normal((2048, 3), np.float32),
                          device=dev)
    wplan = xb.gather_plan(src_w, 2048, weights=w_w)
    x_bf = x_f[:2048].to(torch.bfloat16)
    dense_case("bf16 weighted gather k=3 (2048, 256)", wplan, x_bf,
               tol=TOL_BF16)

    # ---------------------------------------------------------- sparse ---
    log("sparse crossbar vs plain version")
    bd64 = pa.batch(rho_pi, 64)
    comp = xb.compile_plan(bd64)
    log(f"  batch(rho_pi, 64): n={bd64.n_out} active pairs "
        f"{comp.num_active}/{comp.n_pairs} density {comp.density:.4f}")
    x_bd = t_int01(bd64.n_in, 1)
    args, kw = ops.sparse_operands(bd64, x_bd)
    kw["out"].fill_(-7.0)
    got = xbk.crossbar_permute_sparse_cuda(*args, **kw)
    kw_p = dict(kw, out=torch.full_like(kw["out"], -7.0))
    want = ref.crossbar_sparse(*args, **kw_p)
    torch.cuda.synchronize()
    compare("crossbar_sparse", "batch(rho_pi, 64) (102400, 1)", got, want)
    src_u = torch.as_tensor(rng.integers(0, 4096, 4096, dtype=np.int32),
                            device=dev)
    src_u[1024:2560] = -1                      # 12 output tiles unvisited
    uplan = xb.gather_plan(src_u, 4096)
    ucomp = xb.compile_plan(uplan)
    check(not bool(ucomp.occupancy.any(dim=1).all()),
          "unvisited-tile plan visits every output tile")
    x_u = torch.as_tensor(rng.standard_normal((4096, 64), np.float32),
                          device=dev)
    compare("crossbar_sparse", "apply_plan sparse, unvisited tiles, no merge",
            xb.apply_plan(uplan, x_u, backend="sparse"),
            xb.apply_plan(uplan, x_u, backend="reference"))

    # ------------------------------------------------------ megakernel ---
    log("plan-program megakernel vs plain VM")
    prog = K.megakernel_program(dev)
    ctl = pp.build_control(prog, dev)

    def vm_operands(ctl_):
        return (ctl_["steps"], ctl_["plan_tbl"], ctl_["koff"], ctl_["kcnt"],
                ctl_["folds"], ctl_["w_flat"], ctl_["woff"], ctl_["consts"])

    st = t_int01(1600, 1024)
    mk_kw = dict(n_regs=prog.n_regs, rounds=prog.rounds,
                 const_stride=prog.const_stride)
    got = ppk.plan_program_cuda(st, *vm_operands(ctl), **mk_kw)
    want = ref.plan_program_vm(st, *vm_operands(ctl), **mk_kw)
    torch.cuda.synchronize()
    compare("plan_program", "keccak_f1600 program, 1024 lanes", got, want)

    n_syn = 256
    b = pp.ProgramBuilder("all_ops", n_syn, n_regs=4)
    perm = torch.as_tensor(rng.permutation(n_syn).astype(np.int32),
                           device=dev)
    src3 = torch.as_tensor(rng.integers(-4, n_syn + 4, (n_syn, 3),
                                        dtype=np.int32), device=dev)
    wts = torch.as_tensor(rng.integers(-9, 9, (n_syn, 3), dtype=np.int32),
                          device=dev)
    rot = b.add_const_rows(rng.integers(0, 32, (3, n_syn)))
    xc = b.add_const_rows(rng.integers(-2**31, 2**31, (3, n_syn)))
    eqc = b.add_const_rows(rng.integers(0, 3, (3, n_syn)))
    b.permute(1, 0, xb.gather_plan(perm, n_syn))
    b.permute(2, 1, xb.gather_plan(src3, n_syn, weights=wts.float()))
    b.xor(3, 3, 1)
    b.permute(3, 3, xb.gather_plan(src3, n_syn, semiring=GF2))  # in place
    b.eq_const_at(3, 3, eqc)
    b.and_(1, 1, 2)
    b.andn(2, 3, 0)
    b.add(0, 0, 2)
    b.rotlv_at(0, 0, rot)
    b.xor_const_at(0, 0, xc)
    b.add(0, 0, 1)
    syn = b.build(rounds=3, const_stride=1)
    ctl_syn = pp.build_control(syn, dev)
    su = torch.as_tensor(rng.integers(0, 2**32, (n_syn, 77), dtype=np.uint64)
                         .astype(np.uint32).view(np.int32),
                         device=dev).view(torch.uint32)
    syn_kw = dict(n_regs=syn.n_regs, rounds=syn.rounds,
                  const_stride=syn.const_stride)
    got = ppk.plan_program_cuda(su, *vm_operands(ctl_syn), **syn_kw)
    want = ref.plan_program_vm(su, *vm_operands(ctl_syn), **syn_kw)
    torch.cuda.synchronize()
    compare("plan_program", "all-opcode uint32 program, weighted ADD plan",
            got.view(torch.int32), want.view(torch.int32))
    chained = pp.run_program(syn, su, backend="chained",
                             pass_backend="einsum")
    compare("plan_program", "same program, megakernel vs chained",
            pp.run_program(syn, su).view(torch.int32),
            chained.view(torch.int32))

    # ------------------------------------------------ main path, counted ---
    log("main path (launch counters from 0)")
    msgs = [bytes(m) for m in rng.integers(0, 256, (1024, 1024),
                                           dtype=np.uint8)]
    states = t_int01(1024, 1600)
    states64 = states[:64].contiguous()
    telemetry.reset()
    reset_launch_counts()
    torch.cuda.synchronize()
    t_main = time.perf_counter()

    digests = K.sha3_256_batched(msgs, backend="megakernel", device=dev)
    check(digests == [hashlib.sha3_256(m).digest() for m in msgs],
          "sha3_256_batched(megakernel) differs from hashlib")
    log("  sha3_256_batched x1024 (1 KiB each), megakernel: all digests "
        "equal hashlib")
    mk_out = K.keccak_f1600(states, backend="megakernel")
    kern_out = K.keccak_f1600(states, backend="kernel", batch_mode="payload")
    check(torch.equal(kern_out, mk_out), "keccak kernel/payload != megakernel")
    sp_out = K.keccak_f1600(states64, backend="sparse",
                            batch_mode="block_diag")
    check(torch.equal(sp_out, mk_out[:64]),
          "keccak sparse/block_diag != megakernel")
    log("  keccak_f1600 kernel/payload B=1024 and sparse/block_diag B=64 "
        "equal the megakernel")
    zero = torch.zeros(1600, dtype=torch.int32, device=dev)
    lane0 = K.keccak_f1600(zero, backend="megakernel")[:64].cpu().numpy()
    check(int(sum(int(v) << i for i, v in enumerate(lane0)))
          == 0xF1258F7940E1DDE7, "Keccak-f[1600](0) first lane is wrong")

    n_v = 4096
    xv = torch.as_tensor(rng.integers(-2**20, 2**20, (n_v, 64),
                                      dtype=np.int32), device=dev)
    gidx = torch.as_tensor(rng.integers(-16, n_v + 16, n_v, dtype=np.int32),
                           device=dev)
    mask = torch.as_tensor(rng.integers(0, 2, n_v).astype(bool), device=dev)
    for backend in ("kernel", "sparse"):
        for name, fn in (
                ("vrgather", lambda be: P.vrgather(xv, gidx, backend=be)),
                ("vcompress", lambda be: P.vcompress(xv, mask, backend=be)),
                ("vslideup", lambda be: P.vslideup(xv, 37, merge=xv,
                                                   backend=be))):
            check(torch.equal(fn(backend), fn("reference")),
                  f"{name} on {backend} != reference")
    log("  vrgather / vcompress / vslideup on kernel and sparse equal "
        "reference")

    with telemetry.delta() as d:
        K.keccak_f1600(states, backend="megakernel", fixed_latency=True)
        K.keccak_f1600(states, backend="megakernel", fixed_latency=True)
    dd = d()
    check(dd["program_launches"] == 2 and dd["apply_calls"] == 0,
          f"megakernel fixed latency: {dd['program_launches']} launches, "
          f"{dd['apply_calls']} passes for two calls")
    with telemetry.delta() as d:
        K.keccak_f1600(states, backend="kernel", batch_mode="payload",
                       fixed_latency=True)
    check(d()["apply_calls_kernel"] == 24, "per-round path is not 24 passes")
    log("  fixed_latency: 1 launch / 0 passes a megakernel call, 24 passes "
        "a per-round call")

    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = dict(launch_counts())
    log(f"  main path: {main_s:.3f} s, launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    # ---------------------------------------------------------- timing ---
    log("timing (CUDA events, warm, after warm-up)")

    def time_ms(fn, iters):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    def bound(nbytes, ops_):
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = ops_ / FP32_NON_TENSOR_OPS_PER_S * 1e3
        return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")

    rows = []

    # dense at the per-round Keccak shape (rho_pi, 1024 payload lanes)
    idxp, xf, kw = ops.dense_operands(rho_pi, x_bits)
    src = rho_pi.idx[:, 0].long()
    ms = time_ms(lambda: xbk.crossbar_permute_cuda(idxp, xf, **kw), 50)
    plain = time_ms(lambda: ref.crossbar_dense(idxp, xf, **kw), 10)
    lib = time_ms(lambda: torch.index_select(xf, 0, src), 50)
    nb = rho_pi.idx.numel() * 4 + xf.numel() * 4 * 2
    bms, by = bound(nb, 2 * rho_pi.n_out * rho_pi.k * xf.shape[1])
    rows.append(dict(name="crossbar_dense", route="cuda",
                     source="src/repro_torch/kernels/csrc/crossbar_permute.cu",
                     replaces="src/repro/kernels/crossbar_permute.py:137",
                     launches=launches["crossbar_dense"],
                     max_abs_err=err["crossbar_dense"], ms=ms, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=lib))
    # weighted dense case beside a one-hot float32 matmul
    idxw, xw, kww = ops.dense_operands(wplan, x_f[:2048])
    ms_w = time_ms(lambda: xbk.crossbar_permute_cuda(idxw, xw, **kww), 50)
    onehot = xb.build_onehot(wplan)
    lib_w = time_ms(lambda: torch.matmul(onehot, xw), 50)
    log(f"  dense weighted k=3 (2048, 256) f32: kernel {ms_w:.4f} ms, "
        f"one-hot torch.matmul (float32, no TF32) {lib_w:.4f} ms")

    # sparse at the block-diagonal Keccak shape (batch(rho_pi, 64))
    args, kw = ops.sparse_operands(bd64, x_bd)
    ms = time_ms(lambda: xbk.crossbar_permute_sparse_cuda(*args, **kw), 50)
    plain = time_ms(lambda: ref.crossbar_sparse(*args, **kw), 10)
    src_bd = bd64.idx[:, 0].long()
    lib = time_ms(lambda: torch.index_select(args[4], 0, src_bd), 50)
    nb = (bd64.idx.numel() * 4 + args[4].numel() * 4 * 2
          + sum(t.numel() * 4 for t in args[:3]))
    bms, by = bound(nb, 2 * bd64.n_out * bd64.k * args[4].shape[1])
    rows.append(dict(name="crossbar_sparse", route="cuda",
                     source="src/repro_torch/kernels/csrc/crossbar_permute.cu",
                     replaces="src/repro/kernels/crossbar_permute.py:281",
                     launches=launches["crossbar_sparse"],
                     max_abs_err=err["crossbar_sparse"], ms=ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=lib))

    # megakernel: one Keccak-f[1600] over 1024 lanes
    stT = states.T.contiguous()
    ms = time_ms(lambda: ppk.plan_program_cuda(stT, *vm_operands(ctl),
                                               **mk_kw), 20)
    plain = time_ms(lambda: ref.plan_program_vm(stT, *vm_operands(ctl),
                                                **mk_kw), 2)
    lanes = stT.shape[1]
    permute_selects = sum(int(ctl["kcnt"][s.plan]) for s in prog.steps
                          if s.op == "permute")
    elementwise = sum(1 for s in prog.steps if s.op != "permute")
    n_ops = lanes * prog.rounds * prog.n * (permute_selects + elementwise)
    nb = 2 * stT.numel() * 4 + sum(
        t.numel() * 4 for t in vm_operands(ctl) if t is not None)
    bms, by = bound(nb, n_ops)
    rows.append(dict(name="plan_program", route="cuda",
                     source="src/repro_torch/kernels/csrc/plan_program.cu",
                     replaces="src/repro/kernels/plan_program_kernel.py:188",
                     launches=launches["plan_program"],
                     max_abs_err=err["plan_program"], ms=ms, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=None))
    smem_reads = lanes * prog.rounds * prog.n * (permute_selects
                                                 + 2 * elementwise)
    log(f"  megakernel: {smem_reads} shared-memory word reads "
        f"(gathers + elementwise operands) for 1024 lanes")

    t = time.perf_counter()
    digests = K.sha3_256_batched(msgs, backend="megakernel", device=dev)
    torch.cuda.synchronize()
    sha_s = time.perf_counter() - t
    log(f"  sha3_256_batched 1024 x 1 KiB (megakernel, 8 permutations): "
        f"{sha_s * 1e3:.2f} ms host clock, {1024 / sha_s:.1f} hashes/s")
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.5f} ms "
            f"by {r['bound_by']}), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']}")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
