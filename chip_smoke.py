#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py [--parent CHECKOUT] [--phases chacha,gcm]

Builds the five CUDA kernels of ``src/repro_torch/kernels/csrc`` with
nvcc (into ``build/repro_torch_kernels/``) and holds each kernel against
its plain PyTorch version at its path's shapes, the crossbars also on
edge cases (``crossbar_cases``: ragged widths, colliding, one-launch
and hot-row scatters, merge, GF(2)) with each call's device launches
printed, the MoE routing kernel on each form's edges (``route_cases``)
with one device kernel a call.  Then it drives each path through the entry points a user
calls, with every launch counter
set to 0 just before and read just after:

* SHA-3: batched SHA3-256 of 1024 one-KiB messages on the plan-program
  megakernel, Keccak-f[1600] on the dense and tile-skipping crossbars,
  the RVV ops, the fixed-latency contract;
* the fused vcompress through ``kernels.ops.fused_vcompress``;
* Phi-3.5-MoE at its published width, cut to 4 of 32 layers, on seeded
  random weights: per layer, every crossbar backend from the reference
  backend's layer input (dispatch bit-exact, combine, layer outputs and
  logits within the bf16 tolerance), then the counted prompt forward
  (2 x 2048 tokens) on the tile-skipping and the dense crossbar, and
  ``ServingEngine.generate`` answering 8 requests greedy and sampled;
* ChaCha20 over 1 MiB of keystream as one word-layout megakernel launch
  a call (``chacha_phase``), against the plain VM, RFC 8439, a
  plain-Python oracle and the per-round einsum path;
* AES-128-CTR over 1 MiB on the dense and tile-skipping crossbars
  (``aes_phase``): the S-box, lifted ShiftRows∘MixColumns and ShiftRows
  passes against the kernels' plain versions, 20 passes a call, SP
  800-38A and FIPS-197 fused and chained;
* AES-128-GCM seal/open (``gcm_phase``) at three record geometries — (a)
  1024 records of 64 B with 16 B AAD, (b) 256 of 1 KiB with 16 B AAD,
  (c) 64 of 1500 B with 13 B AAD — each batch one word-layout
  megakernel launch, (a) and (b) with the register file in shared
  memory, (c) in global memory: the row walk's counts a lane, the
  kernel against the plain VM on a prefix of each program and on the
  whole program, and against the row walk's plain version on a few
  lanes, seal under the fixed-latency contract against
  a host oracle and the chained path, open, tamper, NIST CAVP vectors on
  every backend, GHASH's wide lift on both crossbars; each launch's
  device ms beside PR 17's padded walk and its other geometries, its
  bound, the host
  clock of a seal call (records/s, ms per MiB) and a profiled call; the
  chained path's host clock at (a) for 16 records;
* the obs phase (``obs_phase``): with tracing on, one SHA-3 call and one
  GCM seal export a Chrome trace and Prometheus text that the port's
  validators accept, with the reference's span and metric names; the
  host clock of the same calls with tracing off and on.
* the mesh phase (``mesh_phase``, after the timing section): meshes of
  1, 2, 4 and 8 shards of the card — lane-parallel SHA3-256 through
  ``run_program_sharded``, cross-shard MoE dispatch at Phi-3.5-MoE's
  prompt routing group, a GF(2) and a weighted REAL plan, each on both
  crossbars, scheduled and naive, and ``BatchingEngine`` on an 8-shard
  mesh through a shard kill and replay; then the serving phase;
* the baselines phase (``baselines_phase``, after serving): the paper's
  separate datapaths (``core.baselines``: crossbar gather, log shifter,
  sequential vcompress, argsort MoE dispatch) against the unified one on
  both crossbars, the fused vcompress and moe_route-routed dispatch, at
  N = 32 and N = 4096 (D = 128), bit-exact, with each side's time;
* the audit phase (``audit_phase``): ``audit_constant_time`` over the
  Keccak-f round function, the megakernel Keccak program, an AES-128
  fused round and the GCM seal (53, 18) and open (32, 0) programs on
  fake CUDA tensors, the leaky and branchy regions refused, no fake
  tensor left in a cache, the regions then run for real against
  ``hashlib`` and the host oracles; the host-sync audit of ``execute``;
* the vlm phase (``vlm_phase``): InternVL2-26B at its published width,
  4 of 48 layers: 4 requests of 256 patch slots packed on the
  tile-skipping crossbar (and at B = 2 on the dense one), prefill and
  16 greedy decode steps against the parallel forward;
* the encdec phase (``encdec_phase``): SeamlessM4T-large-v2 whole: 4
  requests of 1024 frame slots packed by ``encode``, ``prime_cross``
  and 16 greedy decode steps against the teacher-forced decoder;
* the launcher phase (``launcher_phase``): ``launch.serve.main`` on
  SeamlessM4T, RWKV6-7B and Zamba2-2.7B at full width and on a reduced
  config of each family;
* the recurrent phase (``recurrent_phase``): RWKV6-7B and Zamba2-2.7B
  whole at published width: 4 x 64 tokens through the parallel forward
  and 64 decode steps (bf16 and float32 compute, logit rows against the
  parallel forward), 4 greedy requests through ``ServingEngine``,
  Zamba2's shared-attention ring of 32; no kernel on this path;
* the training phase (``train_phase``): Phi-3.5-MoE at full
  width, 2 of 32 layers, 4 train steps (remat, moe_route counted,
  routing equal to the plain version's, step ms, tokens/s, peak memory);
  reduced MiniCPM-2B through ``launch.train`` (loss falls, checkpoint
  resume); MiniCPM-2B at full width, 2 of 40 layers, prefill and greedy
  decode against the parallel forward;
* the train_families phase (``train_families_phase``): RWKV6-7B (2 of 32
  layers), Zamba2-2.7B (12 of 54), InternVL2-26B (2 of 48) and
  SeamlessM4T-large-v2 (whole) at published width, 4 train steps each
  (finite losses, every gradient leaf nonzero, InternVL2's patch pack on
  the tile-skipping crossbar once a forward and bit-equal to its plain
  version, step ms, tokens/s, peak memory, AdamW ms, a profiled step);
  one layer of each on the card against the CPU in float32 (loss,
  every gradient leaf); ``launch.train`` on each reduced config through
  a checkpoint resume;
* the examples phase (``examples_phase``): the eight scripts of
  ``examples_torch/`` through ``main([], device=dev)`` at their own
  configurations (train_moe_e2e's ~155 M-parameter MoE for its 300
  steps), failing on any of their assertions, with each one's output,
  wall seconds and kernel launches: the dense crossbar once
  (quickstart), the megakernel once a fused GCM call (crypto_aead) and
  on every serving batch (observe_serving), ``moe_route`` once a layer
  a microbatch (train_moe_e2e), none on the einsum examples;
* the sharding phase (``sharding_phase``): a model's state over a
  (2 data x 2 model) mesh of four shards of the card — Phi-3.5-MoE at
  full width, 1 of 32 layers, 2 steps of the sharded executor against
  the single-device step (loss, parameters, moe_route launches, the
  placement's bytes), MiniCPM-2B's 2 of 40 layers decoding 8 greedy
  steps on sharded caches against one device, Mixtral-8x22B's 5 of 56
  layers (48.1 GiB of float32 weights) decoding greedily over the mesh
  a layer at a time against one device on the same weights,
  InternVL2-26B's 1 of 48 layers training 2 steps split over the mesh
  against one device (its patch pack on the tile-skipping crossbar on
  every rank of a row), SeamlessM4T whole decoding 8 greedy steps on
  its sharded self and primed cross caches against one device,
  Zamba2-2.7B's 12 of 54 layers and RWKV6-7B's 4 of 32 training 2
  steps (bf16 and float32 compute, against a float32 witness on one
  device) and decoding 8 greedy steps (bf16) split over the mesh
  against one device, and the dry runs (``launch.dryrun``) of five
  production cells on 16 x 16 placeholders (each within 80 GB a device)
  and of the phase's own cell;
* the configs phase (``configs_phase``, last): the four configurations
  no earlier phase runs, at published width, one at a time.
  Mixtral-8x22B, 4 of 56 layers: layer 0's routing (the cluster form at
  (2, 10240) ids), dispatch and combine on the moe_route and both
  crossbar kernels against their plain versions (bit-exact), timed
  beside one library call that writes the same whole output
  (``library_permute``: ``index_select``, ``embedding_bag``); the prompt
  forward (2 x 5120 tokens, window 4096) under 'auto', 'kernel' and
  'sparse', counted, logit rows of the three within 1e-2 in L2;
  ``ServingEngine`` answering 4 greedy requests at a window cut to 32
  in bf16 and in float32 compute, every decode row within 3e-2 (bf16)
  or 6e-3 (float32) in L2 of the parallel forward teacher-forced on
  decode's tokens and experts (the free parallel forward's routing
  differences and rows printed beside it).  Qwen1.5-110B (2 of 80
  layers), StarCoder2-15B and StableLM-12B (4 of 40): ``transformer.prefill`` of 1 x 5120 tokens
  (StarCoder2's ring of 4096) and 16 greedy decode steps, each logit row
  within 1e-2 in L2 of the parallel forward.  Times, launches, peak
  memory and idle shares beside the card's name and power limit.

Then it times each kernel (device time by CUDA-graph replay, and the
eager call), its plain version and, where one exists, a single PyTorch
call computing the same function (at the MoE shapes ``index_copy_`` and
``embedding_bag``), the kernels' share of the prompt forward and of
decoding, and one forward on each crossbar under ``torch.profiler``
(device busy and idle share, the top kernels and host calls).  The
routing kernel is also timed at the prompt, decode, long-group and
E = 1024 shapes beside an empty kernel on the same geometry, with its
cluster-form alternatives (``route_timing``); ``--parent CHECKOUT``
builds another checkout's routing kernel and its padded word-layout
megakernel (``parent_word``) and times them there in turns (ChaCha20,
GCM's three geometries).
``--phases chacha,gcm`` runs only the named word-layout phases after the
build (their checks and times; no contract line).

Each late phase logs its wall seconds.

Any failed check raises and the run exits non-zero; a failed MoE layer
comparison first prints each stage's max |diff| (``moe_stage_diffs``).  The second-to-last
line is the ``kernels`` JSON object; the last line is the contract line
``{"ok": true, "device": {...}}``.  Without a CUDA device (or without the
rest of the repository beside it) the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import math
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

# Phi-3.5-MoE at its published width.  Depth is the one cut: 32 layers
# of float32 weights are ~168 GB, over the card's 80 GB; 4 are ~22 GB.
MOE_LAYERS = 4
MOE_BATCH, MOE_SEQ = 2, 2048                  # prompt forward
SERVE_SLOTS, SERVE_NEW, SERVE_MAX_SEQ = 8, 16, 256
KERNEL_OF = {"sparse": "crossbar_sparse", "kernel": "crossbar_dense"}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters):
    """Mean ms of one call: CUDA events around ``iters`` calls, after
    two warm-up calls."""
    import torch
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


def graph_ms(fn, iters):
    """Mean device ms of one call: ``iters`` calls captured in one CUDA
    graph and replayed between two CUDA events, so the host's launch path
    (Python, allocation, ctypes) is not in the time — ``time_ms`` of a
    kernel that runs for microseconds measures that path instead."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    graph.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def timed(fn, iters):
    """(device ms by graph replay, ms of eager calls by CUDA events)."""
    return graph_ms(fn, iters), time_ms(fn, iters)


def bound(nbytes, ops_):
    """The least time for the work: the larger of bytes over the memory
    rate and operations over the float32 rate, in ms."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops_ / FP32_NON_TENSOR_OPS_PER_S * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def crossbar_bound(plan, d, itemsize):
    """``bound`` of one crossbar pass of ``plan`` over (n_in, d) rows of
    ``itemsize`` bytes, from the bytes it must move: each payload row that
    a live select reads (once), every output row (once), the control and
    weights; a multiply-add a live select and column.  Returns (ms, by,
    rows read, bytes)."""
    import torch
    idx = plan.idx
    live = (idx >= 0) & (idx < (plan.n_out if plan.mode == "scatter"
                                else plan.n_in))
    rows_in = int(live.any(-1).sum() if plan.mode == "scatter"
                  else torch.unique(idx[live]).numel())
    nb = ((rows_in + plan.n_out) * d * itemsize
          + idx.numel() * idx.element_size()
          + (0 if plan.weights is None
             else plan.weights.numel() * plan.weights.element_size()))
    ms, by = bound(nb, 2 * int(live.sum()) * d)
    return ms, by, rows_in, nb


def host_s(fn):
    """Seconds of ``fn()`` on the host clock, ending in a synchronise."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t, out


def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def tree_leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from tree_leaves(v)
    else:
        yield tree


def close(name, got, want, tol):
    """A model-level check (not a kernel against its plain version)."""
    import torch
    got32, want32 = got.float(), want.float()
    diff = float((got32 - want32).abs().max()) if got.numel() else 0.0
    check(bool(torch.isfinite(got32).all()), f"{name}: not finite")
    check(torch.allclose(got32, want32, **tol),
          f"{name}: max |diff| {diff} outside {tol}")
    log(f"  {name}: max |diff| {diff} ({tol})")


def close_rows(name, got, want, rtol):
    """Each row (a token's logit vector) within ``rtol`` in L2 norm.  A
    float32 logit sums d_model bf16-rounded products, so one-ulp changes
    of the hidden state add up over the row: the elementwise difference
    is printed beside it, not bounded by the bf16 rtol."""
    import torch
    got32, want32 = got.float(), want.float()
    check(bool(torch.isfinite(got32).all()), f"{name}: not finite")
    rel = (torch.linalg.vector_norm(got32 - want32, dim=-1)
           / torch.linalg.vector_norm(want32, dim=-1))
    worst = float(rel.max())
    same = float((got32.argmax(-1) == want32.argmax(-1)).float().mean())
    check(worst <= rtol, f"{name}: row L2 relative error {worst} > {rtol}")
    log(f"  {name}: worst row L2 relative error {worst:.3e} (<= {rtol}); "
        f"max |diff| {float((got32 - want32).abs().max())}; argmax agrees on "
        f"{same:.4f} of rows")


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


WINDOW = "profiled window"


def profiled_window(fn, tries=5):
    """Run ``fn()`` once under ``torch.profiler``, inside a
    ``record_function`` range and between two sentinel kernels
    (``torch.cuda._sleep``).  Returns fn's result, the host events inside
    the range and the device events (kernels, copies, memsets) between
    the sentinels, in start order.

    The profiler can lose device records at the edges of a window
    (CUPTI had not delivered them when the profile stopped, or was not
    yet collecting): a pause and pad kernels come before the opening
    sentinel, pad kernels and a pause after the closing one, so that
    what is lost is padding.  (A Mixtral decode step late in a whole
    run lost its first 33 records, 16 pads, the sentinel and 16 of its
    own, in 5 windows of 5 before the opening pause.)  A window in which
    either sentinel is still missing proves nothing either way; it is
    taken again, at most ``tries`` times, and the run fails if none is
    whole."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    pad = torch.empty(16, device="cuda")
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(64):
                pad.fill_(0.0)
            torch.cuda.synchronize()
            torch.cuda._sleep(20000)
            with record_function(WINDOW):
                out = fn()
            torch.cuda._sleep(20000)
            for _ in range(16):
                pad.fill_(0.0)
            torch.cuda.synchronize()
            time.sleep(0.05)
        events = prof.events()
        on_dev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                         and e.name != WINDOW),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(on_dev) if "spin_kernel" in e.name]
        if len(marks) == 2:
            break
        log(f"  (profiler window {attempt} not whole: device records "
            f"{[e.name[:40] for e in on_dev]})")
    else:
        raise AssertionError(f"torch.profiler recorded no whole window in "
                             f"{tries} tries")
    win = next(e for e in events
               if e.device_type == DeviceType.CPU and e.name == WINDOW)
    lo, hi = win.time_range.start, win.time_range.end
    on_host = [e for e in events if e.device_type == DeviceType.CPU
               and e is not win and lo <= e.time_range.start
               and e.time_range.end <= hi]
    return out, on_host, on_dev[marks[0] + 1:marks[1]]


def _dev_us(e):
    if hasattr(e, "self_device_time_total"):
        return e.self_device_time_total
    return e.self_cuda_time_total


def _by_name(events, us):
    """{name: [count, us summed]} over ``events``."""
    out = {}
    for e in events:
        row = out.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += us(e)
    return out


def profile_call(label, fn, rows=12):
    """One call under ``torch.profiler``: wall ms, the device's busy and
    idle share of it (kernel time summed over the call), the host
    synchronisations, and the ops with the most device time and the most
    host time.  Returns wall and busy ms, the synchronisations and the
    device ms by kernel name."""
    import torch
    host_s(fn)
    (secs, _), on_host, on_dev = profiled_window(lambda: host_s(fn))
    # device rows are the kernels, memsets and copies themselves (an
    # operator's own row repeats the time of the kernels it launched)
    dev = _by_name(on_dev, _dev_us)
    host = _by_name(on_host, lambda e: e.self_cpu_time_total)
    busy = sum(us for _, us in dev.values()) / 1e3
    syncs = sum(host[k][0] for k in SYNC_CALLS if k in host)
    log(f"  profile, {label}: {secs * 1e3:.2f} ms wall (profiled), device "
        f"busy {busy:.2f} ms, idle share {1 - busy / (secs * 1e3):.4f}, "
        f"{syncs} host synchronisations")
    for table, what in ((dev, "device"), (host, "host")):
        top = sorted(table.items(), key=lambda kv: kv[1][1],
                     reverse=True)[:rows]
        log(f"    top {rows} by self {what} time (ms): " + "; ".join(
            f"{k[:60]} x{c} {us / 1e3:.3f}" for k, (c, us) in top))
    torch.cuda.synchronize()
    return dict(wall_ms=secs * 1e3, busy_ms=busy, syncs=syncs,
                kernels={k: (c, us / 1e3) for k, (c, us) in dev.items()})


def device_work(fn, calls=4):
    """(name, count) of every device kernel, copy and memset that
    ``calls`` calls of ``fn`` run, from ``torch.profiler`` (after a
    warm-up call)."""
    import torch

    def run():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    fn()
    torch.cuda.synchronize()
    _, _, on_dev = profiled_window(run)
    return [(k, c) for k, (c, _) in _by_name(on_dev, _dev_us).items()]


def cold_ms(fn, sets, iters):
    """Mean device ms of one call with its inputs out of L2: ``fn(i)``
    reads the i-th of ``sets`` input sets (together over the card's 50 MB
    L2), the calls rotate over them in one CUDA graph, so each call finds
    its inputs last touched ``sets - 1`` calls earlier."""
    return graph_ms(_Rotate(fn, sets), iters)


class _Rotate:
    def __init__(self, fn, sets):
        self.fn, self.sets, self.i = fn, sets, 0

    def __call__(self):
        self.i = (self.i + 1) % self.sets
        return self.fn(self.i)


def crossbar_cases(dev, rng):
    """Edge cases of both crossbar kernels: (name, plan, payload, merge,
    tolerance, plain version on the CPU).  Ragged widths (D = 1, D = 7
    float32, D = 4100 bf16) take the narrower vectors their alignment
    allows; scatter control of at most 256 entries is inverted inside the
    kernel (one launch), larger control by the inversion passes.  One hot
    row takes half of 131072 control entries: its plain version runs on
    the CPU, whose ``index_add_`` adds in the same order in one call (on
    the card the plain sum takes one step a colliding entry).  Bit-exact
    except weighted gathers (the plain version adds in the same order;
    the tolerance is the exactness rule's)."""
    import numpy as np
    import torch

    from repro_torch.core import crossbar as xb
    from repro_torch.core.semiring import GF2

    def t(a):
        return torch.as_tensor(a, device=dev)

    def normal(*shape):
        return rng.standard_normal(shape, np.float32)

    cases = []
    for d, dt, tol in ((1, torch.float32, TOL_F32),
                       (7, torch.float32, TOL_F32),
                       (4100, torch.bfloat16, TOL_BF16)):
        n = 700 if d < 4100 else 300
        src = t(rng.integers(-5, n + 5, (n, 2), dtype=np.int32))
        cases.append((f"D={d} {dt} weighted gather k=2",
                      xb.gather_plan(src, n, weights=t(normal(n, 2))),
                      t(normal(n, d)).to(dt), None, tol, False))
        dest = t(np.where(rng.random(n) < 0.2, -1, rng.permutation(2 * n)[:n])
                 .astype(np.int32))
        cases.append((f"D={d} {dt} injective scatter with DROPs",
                      xb.scatter_plan(dest, 2 * n), t(normal(n, d)).to(dt),
                      None, None, False))
    dest = t(rng.integers(-3, 1500, (1200, 2), dtype=np.int32))
    dest[(dest >= 256) & (dest < 768)] = 1500          # tiles 2-5 unvisited
    cases.append(("colliding weighted REAL scatter (1200, 64), unvisited "
                  "tiles", xb.scatter_plan(dest, 1500,
                                           weights=t(normal(1200, 2))),
                  t(normal(1200, 64)), None, None, False))
    dest = t(rng.integers(-2, 600, (100, 2), dtype=np.int32))
    dest[(dest // 128) % 2 == 1] = -1                   # odd tiles unvisited
    cases.append(("colliding weighted scatter, 200 entries (one launch), "
                  "D=1", xb.scatter_plan(dest, 600,
                                         weights=t(normal(100, 2))),
                  t(normal(100, 1)), None, None, False))
    dest = t(np.where(rng.random(800) < 0.3, -1, rng.permutation(900)[:800])
             .astype(np.int32))
    cases.append(("injective scatter, merge on uncovered rows (800, 33)",
                  xb.scatter_plan(dest, 900), t(normal(800, 33)),
                  t(normal(900, 33)), None, False))
    dest = t(rng.integers(-2, 700, (640, 3), dtype=np.int32))
    cases.append(("GF(2) fold scatter k=3 (640, 96)",
                  xb.scatter_plan(dest, 700, semiring=GF2),
                  t(rng.integers(0, 2, (640, 96), dtype=np.int32)), None,
                  None, False))
    dest = rng.integers(-2, 4096, (65536, 2), dtype=np.int32)
    dest[:, 0] = 7                                      # in-degree ~65 568
    cases.append(("weighted REAL scatter, one hot row, 131072 entries "
                  "(65536, 16)", xb.scatter_plan(t(dest), 4096,
                                                 weights=t(normal(65536, 2))),
                  t(normal(65536, 16)), None, None, True))
    return cases


def crossbar_library_call(plan, x2):
    """One PyTorch call that computes an MoE-shape crossbar pass, with its
    index preparation done ahead: the dispatch (a unique-destination
    scatter) as ``index_copy_`` of the kept rows, gathered ahead, into a
    zeroed buffer (uncovered rows are not rewritten); the gate-weighted
    combine as ``embedding_bag`` sums with per-sample weights over bags
    with their DROPs filtered out.  Returns (fn, name)."""
    import torch
    import torch.nn.functional as F
    idx = plan.idx
    if plan.mode == "scatter":
        valid = (idx >= 0) & (idx < plan.n_out)
        src = torch.arange(plan.n_in, device=idx.device)[:, None].expand_as(
            idx)[valid]
        rows, dest = x2[src].contiguous(), idx[valid].long()
        buf = torch.zeros((plan.n_out, x2.shape[1]), dtype=x2.dtype,
                          device=x2.device)
        return (lambda: buf.index_copy_(0, dest, rows)), "index_copy_"
    valid = (idx >= 0) & (idx < plan.n_in)
    flat = idx[valid].long()
    offsets = torch.zeros(plan.n_out, dtype=torch.long, device=idx.device)
    offsets[1:] = torch.cumsum(valid.sum(dim=1), 0)[:-1]
    psw = plan.weights[valid].to(x2.dtype)
    return (lambda: F.embedding_bag(flat, x2, offsets, mode="sum",
                                    per_sample_weights=psw)), "embedding_bag"


def library_permute(plan, x2):
    """One PyTorch call that writes the whole output of an MoE-shape
    crossbar pass over the (n_in, D) payload ``x2``, every row, as the
    dense kernel does, with its index preparation done ahead: the dispatch (a
    unique-destination scatter) as ``index_select`` of every output row
    from ``x2`` and a zero row after it, which an empty slot reads; the
    gate-weighted combine as ``embedding_bag`` sums over every output
    row's selects, a DROP reading the zero row.  Returns (fn, name)."""
    import torch
    import torch.nn.functional as F
    idx = plan.idx.long()
    padded = torch.cat([x2, x2.new_zeros((1, x2.shape[1]))])
    if plan.mode == "scatter":
        valid = (idx >= 0) & (idx < plan.n_out)
        dest = idx[valid]
        check(plan.weights is None
              and torch.unique(dest).numel() == dest.numel(),
              "library_permute: a weighted scatter or a repeated destination")
        src = torch.full((plan.n_out,), plan.n_in, dtype=torch.long,
                         device=x2.device)
        src[dest] = torch.nonzero(valid)[:, 0]
        return (lambda: torch.index_select(padded, 0, src)), "index_select"
    valid = (idx >= 0) & (idx < plan.n_in)
    bags = torch.where(valid, idx, plan.n_in)
    psw = plan.weights.to(x2.dtype)
    return (lambda: F.embedding_bag(bags, padded, mode="sum",
                                    per_sample_weights=psw)), "embedding_bag"


def route_cases(dev, rng):
    """Edge cases of the moe_route kernel: (name, ids, experts, capacity,
    geometry overrides for ``moe_route_cuda``).  Each form at its edges: one id
    (warp form), 33 ids (cluster form, one CTA), 300 groups of 2 (16
    groups a warp), one long group (65536 ids), E = 1024 (8 warps a
    CTA; at 65536 ids 4 chunks a CTA), E = 1, capacity 0, every id -1,
    and a forced cluster of 16."""
    import numpy as np
    import torch

    def ids(g, tk, e):
        return torch.as_tensor(rng.integers(-1, e + 2, (g, tk),
                                            dtype=np.int32), device=dev)
    return [
        ("(1, 1) E=16 C=1", ids(1, 1, 16), 16, 1, {}),
        ("(1, 33) E=16 C=4", ids(1, 33, 16), 16, 4, {}),
        ("(300, 2) E=16 C=2", ids(300, 2, 16), 16, 2, {}),
        ("(1, 65536) E=16 C=5120", ids(1, 65536, 16), 16, 5120, {}),
        ("(1, 65536) E=1024 C=80", ids(1, 65536, 1024), 1024, 80, {}),
        ("(2, 4096) E=1024 C=128", ids(2, 4096, 1024), 1024, 128, {}),
        ("(2, 4096) E=1 C=3000", ids(2, 4096, 1), 1, 3000, {}),
        ("(2, 4096) E=16 C=0", ids(2, 4096, 16), 16, 0, {}),
        ("(2, 4096) every id -1", torch.full((2, 4096), -1,
                                             dtype=torch.int32, device=dev),
         16, 384, {}),
        ("(2, 4096) E=16 C=384, cluster of 16", ids(2, 4096, 16), 16, 384,
         dict(cluster=16)),
    ]


# moe_route timing shapes: (name, groups, T*K, experts, capacity); the
# long group is S = 32768 tokens, K = 2, C = capacity_of
ROUTE_SHAPES = (("prompt", MOE_BATCH, 2 * MOE_SEQ, 16, 384),
                ("decode", SERVE_SLOTS, 2, 16, 2),
                ("long", 1, 65536, 16, 5120),
                ("prompt E=1024", MOE_BATCH, 2 * MOE_SEQ, 1024, 128))
# cluster-form alternatives timed at the prompt and long shapes:
# (cluster, threads), None for the default
ROUTE_VARIANTS = {"prompt": ((1, None), (2, None), (4, None), (8, None),
                             (8, 512), (16, 256), (16, 64)),
                  "long": ((8, None), (16, 512), (16, 256)),
                  "prompt E=1024": ((1, None), (4, None), (8, None),
                                    (16, None))}


def parent_route(parent: Path):
    """The moe_route kernel of another checkout (``--parent``; its C
    entry takes ids, pos, dest, groups, T*K, E, C, stream), built alone
    with nvcc from that checkout's source beside this tree's kernel
    build, as a callable (ids, E, C) -> (pos, dest).  Not counted: it is
    timed beside this tree's kernel, never on a path."""
    import ctypes

    import torch

    from repro_torch._device import find_nvcc
    from repro_torch.kernels import _build
    out = _build.build_root() / "parent_moe_route"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libparent_moe_route.so"
    subprocess.run([find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                    str(parent / "src/repro_torch/kernels/csrc/moe_route.cu"),
                    "-o", str(lib)], check=True, capture_output=True,
                   timeout=600)
    fn = ctypes.CDLL(str(lib)).moe_route
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]

    def call(ids, e, c):
        pos, dest = torch.empty_like(ids), torch.empty_like(ids)
        err = fn(ids.data_ptr(), pos.data_ptr(), dest.data_ptr(),
                 ids.shape[0], ids.shape[1], e, c,
                 _build.stream_handle(ids.device))
        check(err == 0, f"parent moe_route launch failed: cudaError {err}")
        return pos, dest
    return call


def parent_word(parent: Path):
    """The word-layout megakernel of another checkout (``--parent``; its C
    entry ``pp_megakernel`` walks the padded plan table: state, out, the
    renamed steps, n_steps, period, plan_tbl, koff, kcnt, folds, w_flat,
    woff, consts, n, d, n_phys, rounds, const_stride, lanes_log2, threads,
    out_reg, file, stream), built alone with nvcc from that checkout's
    source, as a callable (state, ctl) -> out at that checkout's default
    geometry (``parent_geometry``) on this tree's control tables (the
    padded ones are unchanged).  Not counted: it is timed beside this
    tree's kernel, never on a path."""
    import ctypes

    import torch

    from repro_torch._device import find_nvcc
    from repro_torch.kernels import _build
    from repro_torch.kernels import plan_program_kernel as ppk
    out = _build.build_root() / "parent_plan_program"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libparent_plan_program.so"
    subprocess.run([find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                    str(parent / "src/repro_torch/kernels/csrc/"
                        "plan_program.cu"), "-o", str(lib)],
                   check=True, capture_output=True, timeout=600)
    fn = ctypes.CDLL(str(lib)).pp_megakernel
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P_, P_, P_, I_, I_] + [P_] * 7 + [I_] * 8 + [P_, P_]

    def call(state, ctl):
        n, d = state.shape
        place, lanes, threads = parent_geometry(
            n, ctl["n_regs"], d, ppk.smem_optin(state.device),
            ppk.sm_count(state.device))
        res = torch.empty_like(state)
        file = None
        if place == "global":
            file = torch.empty(-(-d // lanes) * ctl["n_phys"] * n * lanes,
                               dtype=torch.int32, device=state.device)
        w_flat = ctl["w_flat"]
        err = fn(state.data_ptr(), res.data_ptr(),
                 ctl["phys_steps"].data_ptr(), ctl["n_steps"],
                 ctl["period"], ctl["plan_tbl"].data_ptr(),
                 ctl["koff"].data_ptr(), ctl["kcnt"].data_ptr(),
                 ctl["folds"].data_ptr(),
                 None if w_flat is None else w_flat.data_ptr(),
                 ctl["woff"].data_ptr(), ctl["consts"].data_ptr(), n, d,
                 ctl["n_phys"], ctl["rounds"], ctl["const_stride"],
                 lanes.bit_length() - 1, threads, ctl["out_reg"],
                 None if file is None else file.data_ptr(),
                 _build.stream_handle(state.device))
        check(err == 0, f"parent plan_program launch failed: cudaError {err}")
        return res
    return call


def parent_geometry(n, n_regs, d, smem, sms):
    """The padded word kernel's default geometry (PR 32's
    ``register_file``, ``lanes_per_cta`` and ``word_threads``): (placement,
    lanes a CTA, threads a CTA)."""
    words = (n_regs + 1) * n
    place = "shared" if words * 4 <= smem else "global"
    fit = smem // (words * 4) if place == "shared" else (2**31 - 1) // words
    lanes = 1
    while lanes * 2 <= fit and lanes < d and -(-d // (lanes * 2)) >= sms:
        lanes *= 2
    groups = n * lanes // min(lanes, 4)
    return place, lanes, min(1024, 32 * -(-max(groups, 1) // 32))


def in_turns(parent_fn, fn, iters):
    """Device ms of the parent's launch and this tree's, by graph replay
    in turns (parent, change, change, parent)."""
    p1 = graph_ms(parent_fn, iters)
    c1 = graph_ms(fn, iters)
    c2 = graph_ms(fn, iters)
    p2 = graph_ms(parent_fn, iters)
    return (p1, p2), (c1, c2)


def route_timing(dev, rng, parent):
    """moe_route at ROUTE_SHAPES on uniform ids: device ms by graph
    replay; an empty kernel's on the same grid, block and cluster (the
    practical floor) and the byte bound beside it; with ``parent`` (a
    callable from ``parent_route``) the parent's kernel in turns, parent,
    change, change, parent, after a bit-exact check of its output; then
    the cluster form's alternatives (ROUTE_VARIANTS)."""
    import numpy as np
    import torch

    from repro_torch.kernels import moe_route as mrk
    from repro_torch.kernels import ref
    for name, g, tk, e, c in ROUTE_SHAPES:
        ids = torch.as_tensor(rng.integers(0, e, (g, tk), dtype=np.int32),
                              device=dev)
        geo = mrk.launch_geometry(g, tk, e)

        def new():
            return mrk.moe_route_cuda(ids, num_experts=e, capacity=c)
        floor = graph_ms(lambda: mrk.floor_launch(geo, dev), 200)
        bms, by = bound(ids.numel() * 12, 2 * ids.numel())
        if parent is None:
            ms = [graph_ms(new, 200)]
            old = ""
        else:
            want = ref.moe_route_transform(ids, num_experts=e, capacity=c)
            for a, b in zip(parent(ids, e, c), want):
                check(torch.equal(a, b), f"parent moe_route {name}: not "
                      "bit-exact")
            p1 = graph_ms(lambda: parent(ids, e, c), 200)
            ms = [graph_ms(new, 200), graph_ms(new, 200)]
            p2 = graph_ms(lambda: parent(ids, e, c), 200)
            old = f"; parent {p1:.5f}, {p2:.5f} ms (in turns)"
        log(f"  moe_route {name} ({g}, {tk}) E={e} C={c}, {geo['form']} "
            f"form (cluster {geo['cluster']}, {geo['threads']} threads, "
            f"{geo['per_thread']} a thread, {geo['chunks']} chunks): "
            f"{', '.join(f'{m:.5f}' for m in ms)} ms{old}; empty kernel on "
            f"that geometry {floor:.5f} ms; bound {bms:.3g} ms ({by})")
        for cl, th in ROUTE_VARIANTS.get(name, ()):
            vgeo = mrk.launch_geometry(g, tk, e, cluster=cl, threads=th)
            got = mrk.moe_route_cuda(ids, num_experts=e, capacity=c,
                                     cluster=cl, threads=th)
            want = ref.moe_route_transform(ids, num_experts=e, capacity=c)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"moe_route {name} cluster {cl} threads {th}: not "
                  "bit-exact")
            vms = graph_ms(lambda: mrk.moe_route_cuda(
                ids, num_experts=e, capacity=c, cluster=cl, threads=th), 200)
            log(f"    cluster {vgeo['cluster']}, {vgeo['threads']} threads,"
                f" {vgeo['per_thread']} a thread, {vgeo['chunks']} chunks: "
                f"{vms:.5f} ms (bit-exact)")


def moe_stage_diffs(li, blk, h, cfgs, layer):
    """Bisect a failed layer comparison: run ``block_apply``'s stages
    again on each backend from the same layer input and print, against
    the reference backend, the max |diff| of the attention output, the
    router logits and the routing (positions, destinations, gates), the
    dispatch buffer, the experts' output, the combine (of the backend's
    own experts' output, and of the reference's, which isolates the
    combine pass), the recomputed layer output, and the recomputed
    output against the output that failed (a difference there is run to
    run, not backend to backend)."""
    import torch

    from repro_torch.core import moe_dispatch as md
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M

    def diff(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max()) if a.numel() else 0.0

    st = {}
    for b, c in cfgs.items():
        x1 = h + A.attn_apply(blk["attn"], L.apply_norm(blk["ln1"], h,
                                                        c.norm), c)
        u = L.apply_norm(blk["ln2"], x1, c.norm)
        logits = L.dense(blk["moe"]["router"], u, torch.bfloat16).float()
        rt = md.make_routing(logits, num_experts=c.num_experts,
                             k=c.num_experts_per_tok,
                             capacity=M.capacity_of(c, u.shape[1]))
        buf = md.dispatch(u, rt, backend=b)
        ex = M._experts_apply(blk["moe"], buf, u.dtype)
        y = md.combine(ex, rt, backend=b)
        st[b] = dict(attention=x1, router=logits, positions=rt.positions,
                     dest=rt.dest, gates=rt.gates, dispatch=buf, experts=ex,
                     combine=y, output=x1 + y.to(u.dtype))
    ref_ = st.pop("reference")
    log(f"  layer {li} failed: stage diffs against the reference backend")
    for b, s_ in st.items():
        rt_b = md.make_routing(ref_["router"], num_experts=cfgs[b].num_experts,
                               k=cfgs[b].num_experts_per_tok,
                               capacity=ref_["experts"].shape[2])
        on_ref = md.combine(ref_["experts"], rt_b, backend=b)
        parts = [f"{k} {diff(v, ref_[k])}" for k, v in s_.items()]
        parts.append(f"combine of the reference's experts "
                     f"{diff(on_ref, ref_['combine'])}")
        parts.append(f"recomputed output vs the failed one "
                     f"{diff(s_['output'], layer[b])}")
        log(f"    {b}: " + "; ".join(parts))


def moe_phases(dev, rng, compare):
    """Phi-3.5-MoE at full width and 4 layers on the card.

    Per layer, from the reference backend's layer input: the moe_route
    kernel against its plain version on the real routing ids; dispatch
    on the tile-skipping and the dense crossbar bit-exact against the
    reference backend; combine, the layer output and the logits within
    the bf16 tolerance.  The same for one decode step.  Then the counted
    paths: the prompt forward on each crossbar, and serving (greedy and
    sampled), each with the launch counters set to 0 just before and read
    just after; a greedy card-against-CPU check at reduced size; layer
    0's dispatch and combine through each crossbar kernel against its
    plain version (dispatch bit-exact, combine within ``TOL_F32``), at the
    prompt and the decode shape, with their times; and the kernels' share
    of the forward and of decoding.
    """
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import phi3_5_moe
    from repro_torch.configs.base import reduced
    from repro_torch.core import crossbar as xb
    from repro_torch.core import moe_dispatch as md
    from repro_torch.kernels import launch_counts, ops, ref
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels import crossbar_permute as xbk
    from repro_torch.kernels import moe_route as mrk
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import model_zoo
    from repro_torch.models import moe as M
    from repro_torch.models import params as MP
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeOptions, ServingEngine

    backends = ("reference", "sparse", "kernel")
    cfg = dataclasses.replace(phi3_5_moe.CONFIG, num_layers=MOE_LAYERS,
                              dispatch_backend="sparse")
    cfgs = {b: dataclasses.replace(cfg, dispatch_backend=b)
            for b in backends}
    e_, k_ = cfg.num_experts, cfg.num_experts_per_tok
    secs, params = host_s(lambda: MP.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev))
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"phi3.5-moe, full width, {MOE_LAYERS} of {phi3_5_moe.CONFIG.num_layers}"
        f" layers: {n_params / 1e9:.3f} B float32 parameters drawn on the "
        f"card in {secs:.2f} s; {torch.cuda.memory_allocated() / 2**30:.1f} "
        "GiB allocated")
    dtype = L.dtype_of(cfg.compute_dtype)
    cap = M.capacity_of(cfg, MOE_SEQ)
    check(cap == 384, f"capacity {cap} != 384 at S={MOE_SEQ}")
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (MOE_BATCH, MOE_SEQ)), device=dev)

    log(f"MoE layers ({MOE_BATCH} x {MOE_SEQ} tokens, E={e_}, C={cap}), "
        "every backend from the reference backend's layer input")
    h = L.embed_lookup(params["embed"], tokens, dtype)
    for li, blk in enumerate(params["blocks"]):
        x1 = h + A.attn_apply(blk["attn"],
                              L.apply_norm(blk["ln1"], h, cfg.norm), cfg)
        u = L.apply_norm(blk["ln2"], x1, cfg.norm)
        routing = md.make_routing(
            L.dense(blk["moe"]["router"], u, torch.bfloat16).float(),
            num_experts=e_, k=k_, capacity=cap)
        ids = routing.expert_ids.reshape(MOE_BATCH, -1)
        want = ref.moe_route_transform(ids, num_experts=e_, capacity=cap)
        for part, got, w in zip(("positions", "destinations"),
                                (routing.positions, routing.dest), want):
            compare("moe_route", f"layer {li} routing {part}",
                    got.reshape(MOE_BATCH, -1), w)
        bufs = {b: md.dispatch(u, routing, backend=b) for b in backends}
        y = torch.as_tensor(rng.standard_normal(tuple(bufs["reference"].shape),
                                                np.float32),
                            device=dev).to(dtype)
        outs = {b: md.combine(y, routing, backend=b) for b in backends}
        layer = {b: M.block_apply(blk, h, cfgs[b])[0] for b in backends}
        try:
            for b in ("sparse", "kernel"):
                compare(KERNEL_OF[b], f"layer {li} dispatch "
                        f"{tuple(bufs[b].shape)} {b} vs reference backend",
                        bufs[b], bufs["reference"])
            for b in ("sparse", "kernel"):
                close(f"layer {li} combine {b} vs reference backend",
                      outs[b], outs["reference"], TOL_BF16)
            for b in ("sparse", "kernel"):
                close(f"layer {li} output {b} vs reference backend",
                      layer[b], layer["reference"], TOL_BF16)
        except AssertionError:
            moe_stage_diffs(li, blk, h, cfgs, layer)
            raise
        if li == 0:
            first = dict(u=u, routing=routing, y=y, router=L.dense(
                blk["moe"]["router"], u, torch.bfloat16).float())
            log(f"  layer 0: {float(md.dropped_fraction(routing).mean()):.4f}"
                " of assignments over capacity")
        h = layer["reference"]
    heads = {b: T.lm_logits(params, L.apply_norm(params["final_norm"],
                                                 layer[b], cfg.norm), cfg)
             for b in backends}
    for b in ("sparse", "kernel"):
        close_rows(f"logits {tuple(heads[b].shape)} {b} vs reference backend",
                   heads[b], heads["reference"], TOL_BF16["rtol"])
    del heads, layer, bufs, outs, h, x1

    log(f"decode step ({SERVE_SLOTS} slots x 1 token), every backend from "
        "the reference backend's layer input")
    tok1 = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, 1)),
                           device=dev)
    caches = {b: M.init_caches(cfg, SERVE_SLOTS, SERVE_MAX_SEQ,
                               torch.float32, dev) for b in backends}
    x = L.embed_lookup(params["embed"], tok1, dtype)
    first_dec = L.apply_norm(params["blocks"][0]["ln2"], x, cfg.norm)
    for li, blk in enumerate(params["blocks"]):
        dec = {b: M.block_decode(blk, x, {n: c[li] for n, c in
                                          caches[b].items()}, 0, cfgs[b])[0]
               for b in backends}
        for b in ("sparse", "kernel"):
            close(f"decode layer {li} output {b} vs reference backend",
                  dec[b], dec["reference"], TOL_BF16)
        x = dec["reference"]
    del caches

    total = {}

    def forward(c):
        hid, _ = M.lm_hidden(params, tokens, c)
        return T.lm_logits(params, hid, c)

    fwd_s = {}
    for b in ("sparse", "kernel"):
        log(f"prompt forward on the {b} crossbar, counted (launch counters "
            "from 0)")
        reset_launch_counts()
        secs, logits = host_s(lambda: forward(cfgs[b]))
        counts = dict(launch_counts())
        check(tuple(logits.shape) == (MOE_BATCH, MOE_SEQ, cfg.padded_vocab)
              and bool(torch.isfinite(logits).all()),
              f"prompt forward ({b}): logits {tuple(logits.shape)} not finite"
              " or misshapen")
        for name in ("moe_route", KERNEL_OF[b]):
            check(counts[name] > 0, f"{name} not launched on the {b} forward")
        add_counts(total, counts)
        fwd_s[b] = [secs]
        for _ in range(2):
            fwd_s[b].append(host_s(lambda: forward(cfgs[b]))[0])
        log(f"  {MOE_BATCH} x {MOE_SEQ} tokens -> logits: "
            f"{[round(t * 1e3, 2) for t in fwd_s[b]]} ms (host clock, the "
            f"counted run first), launches {counts}")
        if b == "sparse":
            fwd_counts = counts
        del logits

    api = model_zoo.build(cfg, dev)
    lens = rng.integers(16, 129, SERVE_SLOTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    steps = int(lens.max()) - 1 + SERVE_NEW
    serve = {}
    for name, opt in (
            ("greedy", ServeOptions(batch_slots=SERVE_SLOTS,
                                    max_new_tokens=SERVE_NEW)),
            ("sampled", ServeOptions(batch_slots=SERVE_SLOTS,
                                     max_new_tokens=SERVE_NEW,
                                     temperature=1.0, top_k=8))):
        log(f"serving {len(prompts)} requests ({name}), counted (launch "
            "counters from 0)")
        engine = ServingEngine(api, opt, max_seq=SERVE_MAX_SEQ)
        reset_launch_counts()
        secs, out = host_s(lambda: engine.generate(
            params, prompts, generator=torch.Generator(
                device=dev).manual_seed(1)))
        counts = dict(launch_counts())
        check(len(out) == len(prompts)
              and all(len(o) == SERVE_NEW for o in out)
              and all(0 <= t < cfg.padded_vocab for o in out for t in o),
              f"serving ({name}) answered {[len(o) for o in out]}")
        for kname in ("moe_route", "crossbar_sparse"):
            check(counts[kname] > 0, f"{kname} not launched serving {name}")
        add_counts(total, counts)
        serve[name] = (secs, counts)
        log(f"  prompt lengths {lens.tolist()}, {SERVE_NEW} new tokens each:"
            f" {secs:.3f} s for {steps} decode steps ({secs / steps * 1e3:.2f}"
            f" ms a step), {len(prompts) * SERVE_NEW / secs:.2f} generated "
            f"tokens/s, launches {counts}")
        log(f"  first request's tokens: {out[0]}")

    log("greedy serving at reduced size: card against CPU (plain versions)")
    rcfg = dataclasses.replace(reduced(phi3_5_moe.CONFIG),
                               dispatch_backend="sparse")
    cpu_params = MP.init_params(rcfg, torch.Generator().manual_seed(1),
                                "cpu")
    small = [rng.integers(0, rcfg.vocab_size, n).tolist()
             for n in (5, 9, 3, 12)]
    got = {}
    for where, p in (("cpu", cpu_params),
                     ("card", MP.to_device(cpu_params, dev))):
        eng = ServingEngine(model_zoo.build(rcfg, "cpu" if where == "cpu"
                                            else dev),
                            ServeOptions(batch_slots=4, max_new_tokens=8),
                            max_seq=32)
        got[where] = eng.generate(p, small)
    check(got["card"] == got["cpu"],
          f"greedy tokens differ: card {got['card']} cpu {got['cpu']}")
    log(f"  4 requests x 8 tokens identical: {got['card'][0]} ...")

    log("MoE-shape kernels against their plain versions, and their times "
        "(CUDA events, warm)")
    ids_p = first["routing"].expert_ids.reshape(MOE_BATCH, -1).contiguous()
    routing_d = md.make_routing(
        L.dense(params["blocks"][0]["moe"]["router"], first_dec,
                torch.bfloat16).float(),
        num_experts=e_, k=k_, capacity=M.capacity_of(cfg, 1))
    ids_d = routing_d.expert_ids.reshape(SERVE_SLOTS, -1).contiguous()
    y_d = torch.as_tensor(rng.standard_normal(
        (SERVE_SLOTS, e_, routing_d.capacity, cfg.d_model), np.float32),
        device=dev).to(dtype)
    t_route = {}
    for shape, ids_, c in (("prompt", ids_p, cap),
                           ("decode", ids_d, routing_d.capacity)):
        t_route[shape], eager = timed(lambda: mrk.moe_route_cuda(
            ids_, num_experts=e_, capacity=c), 200)
        plain = time_ms(lambda: ref.moe_route_transform(
            ids_, num_experts=e_, capacity=c), 20)
        bms, _ = bound(ids_.numel() * 12, 2 * ids_.numel())
        log(f"  moe_route {shape} {tuple(ids_.shape)}: {t_route[shape]:.4f}"
            f" ms device [{eager:.4f} eager], plain {plain:.4f} ms, bound "
            f"{bms:.6f} ms (bytes)")
    t_xb = {}
    for shape, rt, u_, y_ in (("prompt", first["routing"], first["u"],
                               first["y"]),
                              ("decode", routing_d, first_dec, y_d)):
        for part, plan, xin in (
                ("dispatch", md.dispatch_plan(rt), u_),
                ("combine", md.combine_plan(rt), y_)):
            x2 = xin.reshape(-1, cfg.d_model).contiguous()
            # each kernel against its plain version on these operands
            tol = None if part == "dispatch" else TOL_F32
            args, kw = ops.sparse_operands(plan, x2)
            kw["out"].fill_(-7.0)
            kw_p = dict(kw, out=kw["out"].clone())
            compare("crossbar_sparse", f"{part} {shape} {plan.n_in}->"
                    f"{plan.n_out} kernel vs plain version",
                    xbk.crossbar_permute_sparse_cuda(*args, **kw),
                    ref.crossbar_sparse(*args, **kw_p), tol)
            idxp, xf, kwd = ops.dense_operands(plan, x2)
            compare("crossbar_dense", f"{part} {shape} {plan.n_in}->"
                    f"{plan.n_out} kernel vs plain version",
                    xbk.crossbar_permute_cuda(idxp, xf, **kwd),
                    ref.crossbar_dense(idxp, xf, **kwd), tol)
            sp, sp_e = timed(lambda: xbk.crossbar_permute_sparse_cuda(
                *args, **kw), 10)
            de, de_e = timed(lambda: xbk.crossbar_permute_cuda(idxp, xf,
                                                               **kwd), 10)
            launches = (xbk.DEVICE_LAUNCHES["crossbar_sparse"],
                         xbk.DEVICE_LAUNCHES["crossbar_dense"])
            lib_fn, lib_name = crossbar_library_call(plan, x2)
            lib_diff = float((lib_fn().float() - ref.crossbar_dense(
                idxp, xf, **kwd).float()).abs().max())
            lb_e = time_ms(lib_fn, 10)
            try:
                lb = graph_ms(lib_fn, 10)
            except RuntimeError as e:        # a call that cannot be captured
                log(f"  {lib_name}: no CUDA-graph capture ({e}); eager only")
                torch.cuda.synchronize()
                lb = float("nan")
            es = x2.element_size()
            nb = (x2.numel() * es + plan.n_out * cfg.d_model * es
                  + plan.idx.numel() * 4
                  + (0 if plan.weights is None else plan.weights.numel() * 4))
            bms, by = bound(nb, 2 * plan.idx.numel() * cfg.d_model)
            t_xb[(shape, part)] = sp
            log(f"  {part} {shape} ({plan.mode}, {plan.n_in}->{plan.n_out}, "
                f"k={plan.k}, D={cfg.d_model} bf16): sparse {sp:.4f} ms "
                f"[{sp_e:.4f} eager], dense {de:.4f} ms [{de_e:.4f} eager], "
                f"device launches a call {launches[0]} and {launches[1]}, "
                f"library {lib_name} {lb:.4f} ms [{lb_e:.4f} eager] (max "
                f"|diff| {lib_diff} from the plain version), bound "
                f"{bms:.5f} ms ({by})")
            if part == "dispatch" and shape == "prompt":
                profile_call("prompt dispatch, tile-skipping kernel",
                             lambda: xbk.crossbar_permute_sparse_cuda(
                                 *args, **kw), rows=6)
                profile_call("prompt dispatch, dense kernel",
                             lambda: xbk.crossbar_permute_cuda(idxp, xf,
                                                               **kwd), rows=6)
                md_ms = time_ms(lambda: md.dispatch(u_, rt, backend="sparse"),
                                10)
                log(f"  md.dispatch(backend='sparse') at the prompt shape, "
                    f"whole call: {md_ms:.4f} ms (CUDA events around eager "
                    f"calls) beside the kernel's {sp:.4f} ms device time")

    log("one layer's parts (host clock, each ending in a synchronise; "
        "mean of 3 after a warm-up)")
    blk0 = params["blocks"][0]
    p_disp = md.dispatch_plan(first["routing"])
    x_p = L.embed_lookup(params["embed"], tokens, dtype)
    x_d = L.embed_lookup(params["embed"], tok1, dtype)
    parts = {
        "attention, prompt (2 x 2048)": lambda: A.attn_apply(
            blk0["attn"], x_p, cfg),
        "MoE layer, prompt (2 x 2048)": lambda: M.moe_mlp_apply(
            blk0["moe"], first["u"], cfg),
        "MoE layer, prompt (2 x 2048), dense crossbar": lambda:
            M.moe_mlp_apply(blk0["moe"], first["u"], cfgs["kernel"]),
        "compile_plan of the prompt dispatch plan, cache cleared": lambda: (
            xb.clear_compile_cache(), xb.compile_plan(p_disp)),
        "logits head, prompt (2 x 2048)": lambda: T.lm_logits(params, x_p,
                                                              cfg),
        "MoE layer, decode (8 x 1)": lambda: M.moe_mlp_apply(
            blk0["moe"], first_dec, cfg),
        "expert weight casts of one layer (3 x f32->bf16, 2 x bf16->f32), "
        "as every MoE call makes them": lambda: [
            blk0["moe"][n].to(dtype).float() if n != "wo" else
            blk0["moe"][n].to(dtype) for n in ("wi", "wg", "wo")],
        "decode logits head (8 x 1)": lambda: T.lm_logits(params, x_d, cfg),
    }
    for name, fn in parts.items():
        host_s(fn)
        log(f"  {name}: "
            f"{sum(host_s(fn)[0] for _ in range(3)) / 3 * 1e3:.3f} ms")
    for b in ("sparse", "kernel"):
        profile_call(f"prompt forward on the {b} crossbar",
                     lambda: forward(cfgs[b]))
    profile_call("MoE layer, decode (8 x 1), tile-skipping crossbar",
                 lambda: M.moe_mlp_apply(blk0["moe"], first_dec, cfg))

    fwd_ms = min(fwd_s["sparse"]) * 1e3
    k_fwd = (fwd_counts["moe_route"] * t_route["prompt"]
             + fwd_counts["crossbar_sparse"] / 2
             * (t_xb[("prompt", "dispatch")] + t_xb[("prompt", "combine")]))
    log(f"prompt forward ({MOE_BATCH} x {MOE_SEQ}, sparse): {fwd_ms:.2f} ms; "
        f"kernels ~{k_fwd:.3f} ms of it ({100 * k_fwd / fwd_ms:.2f} %: "
        "launches x each kernel's time at that shape)")
    g_s, g_counts = serve["greedy"]
    k_dec = (g_counts["moe_route"] * t_route["decode"]
             + g_counts["crossbar_sparse"] / 2
             * (t_xb[("decode", "dispatch")] + t_xb[("decode", "combine")]))
    log(f"decode (greedy, {SERVE_SLOTS} slots): {len(prompts) * SERVE_NEW / g_s:.2f}"
        f" generated tokens/s, {g_s / steps * 1e3:.2f} ms a step; kernels "
        f"~{k_dec:.3f} ms of {g_s * 1e3:.1f} ms ({100 * k_dec / (g_s * 1e3):.2f}"
        " %)")
    # layer 0's first routing group (its normed input and router
    # logits) for the mesh phase's cross-shard dispatch
    return dict(launches=total, route_ids=ids_p, capacity=cap,
                group0=(first["u"][0].contiguous(),
                        first["router"][0].contiguous()))


# ChaCha20: RFC 8439 §2.3.2's key, nonce and first block; 1 MiB of
# keystream is 16384 blocks.
CHACHA_KEY = bytes(range(32))
CHACHA_NONCE = bytes.fromhex("000000090000004a00000000")
CHACHA_BLOCK1 = bytes.fromhex(
    "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
    "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")
CHACHA_BLOCKS = 16384
# word-layout lanes a CTA timed beside the default (1024: what fits)
CHACHA_LANES = (16, 32, 64, 128, 256, 512, 1024)

# AES-128: FIPS-197 Appendix B and C.1 (key, plaintext, ciphertext), NIST
# SP 800-38A F.5.1 (CTR-AES128); 1 MiB is 65536 counter blocks.
AES_FIPS = ((bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c"),
             bytes.fromhex("3243f6a8885a308d313198a2e0370734"),
             bytes.fromhex("3925841d02dc09fbdc118597196a0b32")),
            (bytes.fromhex("000102030405060708090a0b0c0d0e0f"),
             bytes.fromhex("00112233445566778899aabbccddeeff"),
             bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")))
CTR_KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
CTR_IV = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
CTR_PLAIN = bytes.fromhex(
    "6bc1bee22e409f96e93d7e117393172a" "ae2d8a571e03ac9c9eb76fac45af8e51"
    "30c81c46a35ce411e5fbc1191a0a52ef" "f69f2445df4f9b17ad2b417be66c3710")
CTR_CIPHER = bytes.fromhex(
    "874d6191b620e3261bef6864990db6ce" "9806f66b7970fdff8617187bb9fffdff"
    "5ae4df3edbd5d35e5b4f09020db03eab" "1e031dda2fbe03d1792170a0f3009cee")
AES_BLOCKS = 65536


def chacha_block_oracle(key: bytes, counter: int, nonce: bytes) -> bytes:
    """RFC 8439 §2.3 in plain Python: quarter-rounds on ints."""
    import struct

    def qr(s, a, b, c, d):
        for x, y, z, r in ((a, b, d, 16), (c, d, b, 12), (a, b, d, 8),
                           (c, d, b, 7)):
            s[x] = (s[x] + s[y]) & 0xFFFFFFFF
            v = s[z] ^ s[x]
            s[z] = ((v << r) & 0xFFFFFFFF) | (v >> (32 - r))

    s = (list(struct.unpack("<4I", b"expand 32-byte k"))
         + list(struct.unpack("<8I", key)) + [counter & 0xFFFFFFFF]
         + list(struct.unpack("<3I", nonce)))
    w = s[:]
    for _ in range(10):
        for q in ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14),
                  (3, 7, 11, 15), (0, 5, 10, 15), (1, 6, 11, 12),
                  (2, 7, 8, 13), (3, 4, 9, 14)):
            qr(w, *q)
    return struct.pack("<16I", *[(a + b) & 0xFFFFFFFF
                                 for a, b in zip(w, s)])


def chacha_phase(dev, compare, parent=None):
    """ChaCha20 over 1 MiB of keystream through the megakernel's word
    layout: the kernel against the plain VM on the program's control (at
    the default lanes a CTA and the alternatives timed), then the counted
    path — ``chacha20_blocks(backend="megakernel")`` under the
    fixed-latency contract (1 launch, 0 passes a call), against RFC 8439,
    the plain-Python oracle and the per-round einsum path in both batch
    modes — then the kernel's device time, the call's host time and the
    bound."""
    import numpy as np
    import torch

    from repro_torch.core import plan_program as pp
    from repro_torch.core import telemetry
    from repro_torch.crypto import chacha as CC
    from repro_torch.kernels import launch_counts, ref, reset_launch_counts
    from repro_torch.kernels import plan_program_kernel as ppk

    n = CHACHA_BLOCKS
    log(f"chacha20, {n} blocks ({64 * n} bytes of keystream), megakernel "
        "word layout")
    prog = CC.megakernel_program(dev)
    ctl = pp.control_for(prog, dev)
    check(ctl["layout"] == "word" and not pp.bit_sliceable(prog),
          f"chacha20 program takes the {ctl['layout']} layout")
    lanes = ppk.lanes_per_cta(prog.n, prog.n_regs, n, ppk.smem_optin(dev),
                              sms=ppk.sm_count(dev))
    log(f"  program: {len(prog.steps)} steps a double round x "
        f"{prog.rounds}, n_regs {prog.n_regs} (+1 staging), renaming "
        f"period {ctl['period']} rounds, "
        f"{int(ctl['phys_steps'][:, 6].sum())} barriers a period; "
        f"{lanes} lanes a CTA -> {-(-n // lanes)} CTAs of "
        f"{ppk.word_threads(prog.n, lanes)} threads")
    host = CC._setup_states(CHACHA_KEY, 1, CHACHA_NONCE, n).view(np.int32)
    words = torch.as_tensor(np.ascontiguousarray(host.T),
                            device=dev).view(torch.uint32)

    def vm(state):
        return ref.plan_program_vm(state, *pp.vm_operands(ctl),
                                   n_regs=ctl["n_regs"],
                                   rounds=ctl["rounds"],
                                   const_stride=ctl["const_stride"])

    want = vm(words).view(torch.int32)
    for l_ in (None,) + CHACHA_LANES:
        got = ppk.plan_program_cuda(words, ctl, lanes=l_)
        torch.cuda.synchronize()
        compare("plan_program", f"chacha20 program, word layout, {n} lanes"
                f" ({l_ or lanes} a CTA)", got.view(torch.int32), want)

    log("  counted path (launch counters from 0)")
    reset_launch_counts()
    with telemetry.delta() as d:
        mk = CC.chacha20_blocks(CHACHA_KEY, 1, CHACHA_NONCE, n,
                                backend="megakernel", fixed_latency=True,
                                device=dev)
        mk_next = CC.chacha20_blocks(CHACHA_KEY, 1 + n, CHACHA_NONCE, n,
                                     backend="megakernel",
                                     fixed_latency=True, device=dev)
    dd = d()
    check(dd["program_launches"] == 2 and dd["apply_calls"] == 0,
          f"chacha20 megakernel: {dd['program_launches']} launches, "
          f"{dd['apply_calls']} passes for two calls")
    layouts = dict(ppk.LAYOUT_LAUNCHES)
    check(layouts == {"packed": 0, "word": 2, "word_global": 0},
          f"chacha20 megakernel launches by layout: {layouts}")
    check(len(mk) == 64 * n and mk[:64] == CHACHA_BLOCK1,
          "chacha20 megakernel: block 1 differs from RFC 8439 §2.3.2")
    oracle = b"".join(chacha_block_oracle(CHACHA_KEY, c, CHACHA_NONCE)
                      for c in (1, 2, 3))
    check(mk[:192] == oracle and mk_next[:64] == chacha_block_oracle(
        CHACHA_KEY, 1 + n, CHACHA_NONCE),
        "chacha20 megakernel differs from the plain-Python oracle")
    check(mk[-64:] == chacha_block_oracle(CHACHA_KEY, n, CHACHA_NONCE),
          "chacha20 megakernel: last block differs from the oracle")
    for mode in ("payload", "block_diag"):
        with telemetry.delta() as d:
            per_round = CC.chacha20_blocks(
                CHACHA_KEY, 1, CHACHA_NONCE, n, backend="einsum",
                batch_mode=mode, fixed_latency=True, device=dev)
        check(per_round == mk, f"chacha20 einsum/{mode} != megakernel")
        check(d()["apply_calls_einsum"] == CC.PASSES_PER_BLOCK,
              f"chacha20 einsum/{mode}: not {CC.PASSES_PER_BLOCK} passes")
    counts = dict(launch_counts())
    check(counts["plan_program"] == 2, f"chacha20 path launches {counts}")
    log(f"  chacha20_blocks x{n}: megakernel (1 launch, 0 passes a call, "
        f"word layout) equals RFC 8439 §2.3.2, the Python oracle (blocks "
        f"1-3, {n}, {n + 1}) and the per-round einsum path (payload and "
        f"block_diag, {CC.PASSES_PER_BLOCK} passes); launches {counts}")

    if parent is not None:
        compare("plan_program", f"chacha20 program, the parent's padded "
                f"walk, {n} lanes", parent(words, ctl).view(torch.int32),
                want)
        (p1, p2), (c1, c2) = in_turns(
            lambda: parent(words, ctl),
            lambda: ppk.plan_program_cuda(words, ctl), 20)
        log(f"  megakernel, chacha20 x {n} lanes, in turns by graph replay:"
            f" parent {p1:.4f}, {p2:.4f} ms; this tree {c1:.4f}, {c2:.4f} "
            f"ms ({(c1 + c2) / (p1 + p2):.3f}x)")
    ms = graph_ms(lambda: ppk.plan_program_cuda(words, ctl), 20)
    alt = {(l_, t_): graph_ms(lambda: ppk.plan_program_cuda(
        words, ctl, lanes=l_, threads=t_), 20)
        for l_ in CHACHA_LANES for t_ in (None, 1024)}
    eager = time_ms(lambda: ppk.plan_program_cuda(words, ctl), 20)
    plain = time_ms(lambda: vm(words), 2)
    call_ms = [host_s(lambda: CC.chacha20_blocks(
        CHACHA_KEY, 1, CHACHA_NONCE, n, backend="megakernel",
        device=dev))[0] * 1e3 for _ in range(3)]
    einsum_ms = host_s(lambda: CC.chacha20_blocks(
        CHACHA_KEY, 1, CHACHA_NONCE, n, backend="einsum",
        batch_mode="payload", device=dev))[0] * 1e3
    nb = 2 * n * 64                    # states in, keystream out
    ops_ = 2 * CC._DOUBLE_ROUNDS * 4 * 12 * n
    bms, by = bound(nb, ops_)
    log(f"  megakernel, chacha20 x {n} lanes (word layout, {lanes} a CTA):"
        f" {ms:.4f} ms by graph replay [{eager:.4f} eager], "
        f"{ms / CC._DOUBLE_ROUNDS:.5f} ms a double round; lanes a CTA "
        "(threads: sized to the work / 1024) "
        + ", ".join(f"{l_} ({t_ or ppk.word_threads(prog.n, l_)}): {v:.4f}"
                    for (l_, t_), v in alt.items())
        + f" ms; bound {bms:.6f} ms ({by}: {nb} B, {ops_} ARX operations);"
        f" plain VM {plain:.4f} ms")
    log(f"  chacha20_blocks x{n}, megakernel, host clock: "
        f"{[round(t_, 3) for t_ in call_ms]} ms; per-round einsum "
        f"{einsum_ms:.2f} ms")
    profile_call(f"chacha20_blocks x{n}, megakernel",
                 lambda: CC.chacha20_blocks(CHACHA_KEY, 1, CHACHA_NONCE, n,
                                            backend="megakernel", device=dev),
                 rows=6)
    return counts


def aes_phase(dev, compare):
    """AES-128-CTR over 1 MiB on the dense and the tile-skipping crossbar.

    First each kernel against its plain version on the passes the cipher
    runs, at the call's shapes: the S-box pass (a 256-row k = 1 gather
    over a (256, 16 x 65536) 0/1 payload), the lifted ShiftRows∘MixColumns
    pass (128 bit rows, k = 32 selects, GF(2) fold) and ShiftRows (16 rows
    of bytes).  Then the counted path: ``aes128_ctr_xor`` on 'kernel' and
    'sparse' under the fixed-latency contract (20 passes a call,
    fingerprints invariant over two payloads) against the einsum path and
    SP 800-38A F.5.1; FIPS-197 B and C.1 encrypt and decrypt, fused (20)
    and chained (29).  Then host-clock ms, device busy and idle share and
    peak memory of a call on each backend, and the S-box and lifted passes'
    device ms beside their bound and ``index_select`` on the same rows."""
    import numpy as np
    import torch

    from repro_torch.core import crossbar as xb
    from repro_torch.core import telemetry
    from repro_torch.crypto import aes as AE
    from repro_torch.crypto.registry import registry
    from repro_torch.kernels import launch_counts, ops, ref
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels import crossbar_permute as xbk

    b = AES_BLOCKS
    rng = np.random.default_rng(5)
    log(f"aes-128-ctr, {b} counter blocks ({16 * b} bytes), dense and "
        "tile-skipping crossbars")
    for fuse in (True, False):
        AE._ensure_plans(False, fuse, dev)
        AE._ensure_plans(True, fuse, dev)
    reg = registry(dev)
    st = torch.as_tensor(rng.integers(0, 256, (16, b), dtype=np.int32),
                         device=dev)
    lifted = xb.lift_gf2_8(reg["aes/shift_rows_mix_columns"])
    check((lifted.n_out, lifted.k) == (128, 32),
          f"lifted round plan is ({lifted.n_out}, k={lifted.k})")
    live = int(((lifted.idx >= 0) & (lifted.idx < lifted.n_in)).sum())
    shifts = torch.arange(8, dtype=torch.int32, device=dev)
    bits = ((st[:, None, :] >> shifts[None, :, None]) & 1).reshape(128, b)
    passes = ((f"S-box, (256, 16 x {b}) one-hot int32", reg["aes/sbox"],
               AE._onehot_encode(st).reshape(256, -1)),
              (f"lifted ShiftRows∘MixColumns, k=32 ({live} live selects), "
               f"GF(2) fold, (128, {b}) bits", lifted, bits),
              (f"ShiftRows, (16, {b}) bytes", reg["aes/shift_rows"], st))
    for name, plan, x in passes:
        idxp, xf, kw = ops.dense_operands(plan, x)
        got = xbk.crossbar_permute_cuda(idxp, xf, **kw)
        compare("crossbar_dense", f"dense {name}", got,
                ref.crossbar_dense(idxp, xf, **kw))
        n_dense = xbk.DEVICE_LAUNCHES["crossbar_dense"]
        args, kws = ops.sparse_operands(plan, x)
        kws["out"].fill_(-7.0)
        kw_p = dict(kws, out=kws["out"].clone())
        got = xbk.crossbar_permute_sparse_cuda(*args, **kws)
        compare("crossbar_sparse", f"tile-skipping {name}", got,
                ref.crossbar_sparse(*args, **kw_p))
        log(f"    device launches a call: dense {n_dense}, tile-skipping "
            f"{xbk.DEVICE_LAUNCHES['crossbar_sparse']}")
        del got, args, kws, kw_p, idxp, xf
    torch.cuda.synchronize()

    data = bytes(rng.integers(0, 256, 16 * b, dtype=np.uint8))
    data2 = bytes(rng.integers(0, 256, 16 * b, dtype=np.uint8))
    want = AE.aes128_ctr_xor(CTR_KEY, CTR_IV, data, backend="einsum",
                             device=dev)
    check(want[:64] == bytes(x ^ y for x, y in zip(
        data[:64], AE.aes128_ctr_xor(CTR_KEY, CTR_IV, bytes(64),
                                     backend="reference", device=dev))),
          "aes ctr einsum keystream differs from the reference backend")
    log("  counted path (launch counters from 0)")
    reset_launch_counts()
    for backend in ("kernel", "sparse"):
        for payload in (data, data2):
            with telemetry.delta() as d:
                got = AE.aes128_ctr_xor(CTR_KEY, CTR_IV, payload,
                                        backend=backend, fixed_latency=True,
                                        device=dev)
            check(d()[f"apply_calls_{backend}"] == 20,
                  f"aes ctr on {backend}: not 20 passes a call")
            if payload is data:
                check(got == want, f"aes ctr 1 MiB on {backend} != einsum")
            else:
                check(AE.aes128_ctr_xor(CTR_KEY, CTR_IV, got,
                                        backend=backend, device=dev)
                      == payload, f"aes ctr on {backend} does not invert")
        check(AE.aes128_ctr_xor(CTR_KEY, CTR_IV, CTR_PLAIN, backend=backend,
                                device=dev) == CTR_CIPHER
              and AE.aes128_ctr_xor(CTR_KEY, CTR_IV, CTR_CIPHER,
                                    backend=backend, device=dev)
              == CTR_PLAIN, f"aes ctr on {backend} != SP 800-38A F.5.1/2")
        for fuse, n_pass in ((True, 20), (False, 29)):
            for key, plain, cipher in AES_FIPS:
                with telemetry.delta() as d:
                    enc = AE.aes128_encrypt(key, plain, backend=backend,
                                            fuse_layers=fuse,
                                            fixed_latency=True, device=dev)
                    dec = AE.aes128_decrypt(key, cipher, backend=backend,
                                            fuse_layers=fuse,
                                            fixed_latency=True, device=dev)
                check(enc == cipher and dec == plain,
                      f"aes on {backend} fuse={fuse} != FIPS-197")
                check(d()[f"apply_calls_{backend}"] == 2 * n_pass,
                      f"aes on {backend} fuse={fuse}: not {n_pass} passes")
    counts = dict(launch_counts())
    check(counts["crossbar_dense"] > 0 and counts["crossbar_sparse"] > 0,
          f"aes path launches {counts}")
    log(f"  aes128_ctr_xor 1 MiB on kernel and sparse: equal einsum, "
        f"20 passes a call, fingerprints invariant over two payloads; "
        f"SP 800-38A F.5.1/F.5.2 and FIPS-197 B, C.1 (fused 20, chained "
        f"29 passes) pass; launches {counts}")

    for backend in ("kernel", "sparse", "einsum"):
        call = (lambda be=backend: AE.aes128_ctr_xor(
            CTR_KEY, CTR_IV, data, backend=be, device=dev))
        call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        secs = [host_s(call)[0] * 1e3 for _ in range(3)]
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        log(f"  aes128_ctr_xor 1 MiB on {backend}, host clock: "
            f"{[round(t_, 2) for t_ in secs]} ms; peak memory above the "
            f"resting {peak:.3f} GiB")
        profile_call(f"aes128_ctr_xor 1 MiB, {backend}", call, rows=6)

    for name, plan, x in passes[:2]:
        idxp, xf, kw = ops.dense_operands(plan, x)
        args, kws = ops.sparse_operands(plan, x)
        ms_d = graph_ms(lambda: xbk.crossbar_permute_cuda(idxp, xf, **kw),
                        10)
        ms_s = graph_ms(lambda: xbk.crossbar_permute_sparse_cuda(
            *args, **kws), 10)
        valid = (plan.idx >= 0) & (plan.idx < plan.n_in)
        rows = plan.idx[valid].long()            # every row a select reads
        lib = graph_ms(lambda: torch.index_select(xf, 0, rows), 10)
        nb = plan.idx.numel() * 4 + xf.numel() * 4 + plan.n_out * \
            xf.shape[1] * 4
        bms, by = bound(nb, 2 * live * xf.shape[1] if plan is lifted
                        else plan.n_out * xf.shape[1])
        log(f"  {name}: dense {ms_d:.4f} ms, tile-skipping {ms_s:.4f} ms by "
            f"graph replay; bound {bms:.5f} ms ({by}); index_select of the "
            f"{rows.numel()} rows the selects read {lib:.4f} ms")
        del idxp, xf, args, kws
    return counts


# AES-128-GCM: the NIST CAVP vectors (McGrew-Viega test cases 1-4: key,
# IV, plaintext, AAD, ciphertext, tag) and three record geometries at
# serving batches: (name, plaintext bytes, AAD bytes, records).  (a) is
# the reference benchmark's geometry (4 blocks, 16 B AAD), (b) 1 KiB
# records, (c) one Ethernet MTU with TLS 1.2's 13-byte AEAD header.
_GCM_K = bytes.fromhex("feffe9928665731c6d6a8f9467308308")
_GCM_IV = bytes.fromhex("cafebabefacedbaddecaf888")
_GCM_PT = bytes.fromhex(
    "d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
    "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b391aafd255")
_GCM_CT = bytes.fromhex(
    "42831ec2217774244b7221b784d0d49ce3aa212f2c02a4e035c17e2329aca12e"
    "21d514b25466931c7d8f6a5aac84aa051ba30b396a0aac973d58e091473f5985")
GCM_CAVP = (
    (bytes(16), bytes(12), b"", b"", b"",
     bytes.fromhex("58e2fccefa7e3061367f1d57a4e7455a")),
    (bytes(16), bytes(12), bytes(16), b"",
     bytes.fromhex("0388dace60b6a392f328c2b971b2fe78"),
     bytes.fromhex("ab6e47d42cec13bdf53a67b21257bddf")),
    (_GCM_K, _GCM_IV, _GCM_PT, b"", _GCM_CT,
     bytes.fromhex("4d5c2af327cd64a62cf35abd2ba6fab4")),
    (_GCM_K, _GCM_IV, _GCM_PT[:60],
     bytes.fromhex("feedfacedeadbeeffeedfacedeadbeefabaddad2"),
     _GCM_CT[:60], bytes.fromhex("5bc94fbc3221a5db94fae95ae7121a47")),
)
GCM_KEY = bytes(range(16))
GCM_GEOMETRIES = (("a", 64, 16, 1024), ("b", 1024, 16, 256),
                  ("c", 1500, 13, 64))
GCM_CHAINED_RECORDS = 16
GCM_PREFIX_STEPS = 130       # d1, d2, trip 0 and half of trip 1
GCM_ROWS_LANES = 2           # lanes the row walk's plain version runs
GCM_LANES = (1, 2, 4, 8)     # lanes a CTA timed beside the default
GCM_THREADS = (None, 512)    # threads a CTA (None: word_threads')
# each geometry's launch with the padded walk (PR 17 run 3, graph replay,
# NVIDIA H100 80GB HBM3, 700.00 W)
GCM_PR17_MS = {"a": 3.1657, "b": 97.2257, "c": 100.6790}


def _xtime(a: int) -> int:
    return ((a << 1) ^ 0x11B) if a & 0x80 else a << 1


def _aes_sbox() -> list:
    """FIPS-197's S-box from the field inverse (log tables of the
    generator 3) and the affine map."""
    exp, log, x = [0] * 255, [0] * 256, 1
    for i in range(255):
        exp[i], log[x] = x, i
        x ^= _xtime(x)
    box = []
    for a in range(256):
        b = 0 if a == 0 else exp[(255 - log[a]) % 255]
        s_ = b
        for k in range(1, 5):
            s_ ^= ((b << k) | (b >> (8 - k))) & 0xFF
        box.append(s_ ^ 0x63)
    return box


_SBOX = _aes_sbox()


def aes128_oracle(key: bytes):
    """A plain-Python AES-128 block encryptor (FIPS-197), independent of
    the port: byte lists, the S-box from the field inverse, MixColumns
    by xtime."""
    rk = list(key)
    rcon = 1
    for i in range(4, 44):
        t = rk[4 * i - 4:4 * i]
        if i % 4 == 0:
            t = [_SBOX[t[1]] ^ rcon, _SBOX[t[2]], _SBOX[t[3]], _SBOX[t[0]]]
            rcon = _xtime(rcon)
        rk += [a ^ b for a, b in zip(rk[4 * i - 16:4 * i - 12], t)]

    def encrypt(block: bytes) -> bytes:
        st = [a ^ b for a, b in zip(block, rk[:16])]
        for rnd in range(1, 11):
            sb = [_SBOX[v] for v in st]
            st = [sb[r + 4 * ((c + r) % 4)] for c in range(4)
                  for r in range(4)]
            if rnd < 10:
                mixed = []
                for c in range(4):
                    a = st[4 * c:4 * c + 4]
                    t = a[0] ^ a[1] ^ a[2] ^ a[3]
                    mixed += [a[r] ^ t ^ _xtime(a[r] ^ a[(r + 1) % 4])
                              for r in range(4)]
                st = mixed
            st = [a ^ b for a, b in zip(st, rk[16 * rnd:16 * rnd + 16])]
        return bytes(st)
    return encrypt


def gcm_oracle(key: bytes, iv: bytes, pt: bytes, aad: bytes) -> bytes:
    """``ciphertext || tag`` by a plain-Python GCM on big-endian field
    ints (the FIPS bit order) over a plain-Python AES."""
    aes = aes128_oracle(key)

    def gmul(x, y):
        z, v = 0, x
        for i in range(127, -1, -1):
            if (y >> i) & 1:
                z ^= v
            v = (v >> 1) ^ (0xE1 << 120 if v & 1 else 0)
        return z

    def pad(x):
        return x + bytes((-len(x)) % 16)

    h = int.from_bytes(aes(bytes(16)), "big")
    ct = b"".join(
        bytes(a ^ b for a, b in zip(pt[16 * t:16 * t + 16],
                                    aes(iv + (t + 2).to_bytes(4, "big"))))
        for t in range(-(-len(pt) // 16)))
    data = (pad(aad) + pad(ct) + (8 * len(aad)).to_bytes(8, "big")
            + (8 * len(pt)).to_bytes(8, "big"))
    y = 0
    for i in range(0, len(data), 16):
        y = gmul(h, y ^ int.from_bytes(data[i:i + 16], "big"))
    tag = bytes(a ^ b for a, b in zip(y.to_bytes(16, "big"),
                                      aes(iv + b"\x00\x00\x00\x01")))
    return ct + tag


def gcm_phase(dev, compare, parent=None):
    """AES-128-GCM seal/open on the card at the three geometries.

    Per geometry: the program's placement and size; the row walk's
    counts a lane (select slots walked beside the live selects, row
    visits beside n x steps); the megakernel against the plain VM on a
    prefix of the program (both placements where the file fits shared
    memory) and on the whole program, and against the row walk's plain
    version on a few lanes; the counted path —
    ``aes128_gcm_seal_batch`` twice under the fixed-latency contract (1
    launch and 0 crossbar passes a call, in the geometry's placement),
    against the host oracle and the chained path on the dense crossbar,
    open round-tripping and naming a tampered tag and ciphertext; then
    the launch's device ms by graph replay (eager beside it) beside PR
    17's padded walk, the other geometries (placement, lanes a CTA,
    threads), the bound, the host clock of a seal call (records/s, ms
    per MiB sealed) and a profiled call.  Then the chained path at (a) for 16 records, the CAVP vectors
    on every backend and GHASH on both crossbars."""
    import numpy as np
    import torch

    from repro_torch.core import plan_program as pp
    from repro_torch.core import telemetry
    from repro_torch.crypto import gcm as G
    from repro_torch.kernels import launch_counts, ref, reset_launch_counts
    from repro_torch.kernels import plan_program_kernel as ppk

    rng = np.random.default_rng(17)
    smem = ppk.smem_optin(dev)
    sms = ppk.sm_count(dev)
    counts = {}
    stats = {}

    def vm(state, ctl_):
        return ref.plan_program_vm(state, *pp.vm_operands(ctl_),
                                   n_regs=ctl_["n_regs"],
                                   rounds=ctl_["rounds"],
                                   const_stride=ctl_["const_stride"])

    def records(b, pt_len, aad_len):
        def draw(n):
            return [bytes(r) for r in rng.integers(0, 256, (b, n),
                                                   dtype=np.uint8)]
        return draw(12), draw(pt_len), draw(aad_len)

    for name, pt_len, aad_len, b in GCM_GEOMETRIES:
        t = time.perf_counter()
        key_p, prog, lay = G.gcm_program(GCM_KEY, pt_len, aad_len,
                                         device=dev)
        ctl = pp.control_for(prog, dev)
        build_s = time.perf_counter() - t
        n = prog.n
        lanes = ppk.lanes_per_cta(n, prog.n_regs, b, smem, sms=sms)
        placement = ppk.register_file(n, prog.n_regs, smem, lanes)
        n_perm = sum(1 for s in prog.steps if s.op == "permute")
        selects = [int(((p.idx >= 0) & (p.idx < n)).sum())
                   for p in prog.plans]
        live = sum(selects[s.plan] for s in prog.steps if s.op == "permute")
        kcnt = ctl["kcnt"].tolist()
        slots = n * sum(kcnt[s.plan] for s in prog.steps
                        if s.op == "permute")
        ctl_bytes = sum(ctl[k].numel() * 4 for k in
                        ("plan_tbl", "consts", "phys_steps", "koff", "kcnt",
                         "folds", "woff") + (("w_flat",) if ctl["w_flat"]
                                             is not None else ()))
        walk_bytes = sum(ctl[k].numel() * 4 for k in pp.WORD_TABLES
                         if ctl[k] is not None)
        log(f"aes-128-gcm ({name}): {b} records of {pt_len} B, {aad_len} B "
            f"AAD: n = {n} rows, {prog.n_regs} registers (+1), "
            f"{len(prog.steps)} steps ({n_perm} PERMUTE), {len(prog.plans)} "
            f"plans ({ctl['plan_tbl'].shape[0]} select columns, "
            f"{ctl_bytes / 2**20:.1f} MiB of the VM's control; the row "
            f"walk's tables {walk_bytes / 2**20:.2f} MiB); register file "
            f"{ctl['n_phys'] * n * 4} B a lane -> {placement} placement, "
            f"{lanes} lanes a CTA, {-(-b // lanes)} CTAs of "
            f"{ppk.word_threads(n, lanes)} threads; program built and "
            f"encoded in {build_s:.2f} s")
        check(ctl["layout"] == "word", f"gcm ({name}) takes {ctl['layout']}")
        check(ctl["w_slots"] <= ctl["w_live"] == live,
              f"gcm ({name}) walks {ctl['w_slots']} select slots a lane "
              f"for {live} live selects")
        n_ranges = ctl["w_steps"].shape[0] + ctl["w_ranges"].shape[0]
        log(f"  row walk a lane: {ctl['w_slots']} select slots walked "
            f"(live selects {live}; the padded table {slots}, "
            f"{slots / ctl['w_slots']:.1f}x), {ctl['w_visits']} row visits "
            f"(n x steps {n * len(prog.steps)}, "
            f"{n * len(prog.steps) / ctl['w_visits']:.1f}x), {n_ranges} "
            f"row ranges, {int((ctl['w_steps'][:, 0] >> 8 & 1).sum())} "
            "barriers")
        ivs, pts, aads = records(b, pt_len, aad_len)
        bits = torch.as_tensor(G._pack_records(lay, ivs, pts, aads, pt_len,
                                               aad_len), device=dev)

        pre = prog.prefix(min(GCM_PREFIX_STEPS, len(prog.steps)))
        ctl_pre = pp.control_for(pre, dev)
        want = vm(bits, ctl_pre)
        # both placements where one lane's file fits shared memory, the
        # shared one at the most lanes that fit
        l_sh = lanes
        while l_sh > 1 and ctl["n_phys"] * n * 4 * l_sh > smem:
            l_sh //= 2
        for place, l_ in (("global", lanes), ("shared", l_sh)):
            if place == "shared" and ctl["n_phys"] * n * 4 * l_ > smem:
                continue
            compare("plan_program", f"gcm ({name}) program's first "
                    f"{len(pre.steps)} steps, {place} placement, {l_} lanes "
                    f"a CTA, {b} lanes",
                    ppk.plan_program_cuda(bits, ctl_pre, lanes=l_,
                                          placement=place), want)
        want = vm(bits, ctl)
        got = ppk.plan_program_cuda(bits, ctl)
        compare("plan_program", f"gcm ({name}) whole program, {placement} "
                f"placement, {b} lanes, against the plain VM", got, want)
        few = bits[:, :GCM_ROWS_LANES].contiguous()
        compare("plan_program", f"gcm ({name}) whole program, its first "
                f"{GCM_ROWS_LANES} lanes, against the row walk's plain "
                "version", got[:, :GCM_ROWS_LANES],
                ref.plan_program_rows(few, ctl))
        del got

        log("  counted path (launch counters from 0)")
        reset_launch_counts()
        sealed = None
        for payload in range(2):
            if payload:
                ivs2, pts2, aads2 = records(b, pt_len, aad_len)
            else:
                ivs2, pts2, aads2 = ivs, pts, aads
            with telemetry.delta() as d:
                out = G.aes128_gcm_seal_batch(GCM_KEY, ivs2, pts2, aads2,
                                              fixed_latency=True, device=dev)
            dd = d()
            check(dd["program_launches"] == 1 and dd["apply_calls"] == 0,
                  f"gcm ({name}) seal: {dd['program_launches']} launches, "
                  f"{dd['apply_calls']} passes")
            if not payload:
                sealed = out
        layouts = dict(ppk.LAYOUT_LAUNCHES)
        key_l = "word" if placement == "shared" else "word_global"
        check(layouts[key_l] == 2 and sum(layouts.values()) == 2,
              f"gcm ({name}) launches by layout: {layouts}")
        for r in sorted({0, b // 2, b - 1}):
            check(sealed[r] == gcm_oracle(GCM_KEY, ivs[r], pts[r], aads[r]),
                  f"gcm ({name}) record {r} differs from the host oracle")
        chained = G.aes128_gcm_seal_batch(GCM_KEY, ivs[:2], pts[:2], aads[:2],
                                          backend="kernel", device=dev)
        check(chained == sealed[:2],
              f"gcm ({name}) fused seal differs from the chained path")
        with telemetry.delta() as d:
            opened = G.aes128_gcm_open_batch(GCM_KEY, ivs, sealed, aads,
                                             device=dev)
        check(opened == pts and d()["program_launches"] == 1,
              f"gcm ({name}) open does not round-trip in one launch")
        bad = list(sealed)
        bad[1] = bad[1][:-1] + bytes([bad[1][-1] ^ 1])       # tag bit
        bad[-1] = bytes([bad[-1][0] ^ 0x80]) + bad[-1][1:]   # ciphertext bit
        try:
            G.aes128_gcm_open_batch(GCM_KEY, ivs, bad, aads, device=dev)
            raise AssertionError(f"gcm ({name}): tampered batch opened")
        except G.InvalidTagError as e:
            check(e.indices == (1, b - 1),
                  f"gcm ({name}) tamper named records {e.indices}")
        add_counts(counts, launch_counts())
        log(f"  seal x2 (fixed latency: 1 launch, 0 passes a call, "
            f"{placement} placement) equals the host oracle (records "
            f"{sorted({0, b // 2, b - 1})}) and the chained path on the "
            f"dense crossbar (2 records); open round-trips; a flipped tag "
            f"bit and ciphertext bit name records (1, {b - 1}); launches "
            f"{dict(launch_counts())}")

        iters = 20 if n < 4000 else 10
        ms, eager = timed(lambda: ppk.plan_program_cuda(bits, ctl), iters)
        old = GCM_PR17_MS[name]
        line = (f"  megakernel, gcm ({name}) x {b} lanes: {ms:.4f} ms by "
                f"graph replay [{eager:.4f} eager], "
                f"{ms / len(prog.steps) * 1e3:.3f} us a step; PR 17's "
                f"padded walk {old} ms ({old / ms:.1f}x)")
        if parent is not None:
            compare("plan_program", f"gcm ({name}) whole program, the "
                    f"parent's padded walk, {b} lanes", parent(bits, ctl),
                    want)
            (p1, p2), (c1, c2) = in_turns(
                lambda: parent(bits, ctl),
                lambda: ppk.plan_program_cuda(bits, ctl), 3)
            line += (f"; in turns: parent {p1:.4f}, {p2:.4f} ms, this tree "
                     f"{c1:.4f}, {c2:.4f} ms ({(p1 + p2) / (c1 + c2):.2f}x)")
        # the geometries beside the default: each placement the file fits,
        # lanes a CTA (V = min(lanes, 4) words a thread), threads a CTA
        # (fewer threads, more CTAs an SM)
        alt = {}
        for place in ("shared", "global"):
            room = smem if place == "shared" else 4 * ppk.GLOBAL_FILE_WORDS
            for l_ in GCM_LANES:
                if ctl["n_phys"] * n * 4 * l_ > room or l_ > b:
                    continue
                for t_ in GCM_THREADS:
                    alt[(place, l_, t_)] = graph_ms(
                        lambda: ppk.plan_program_cuda(
                            bits, ctl, lanes=l_, placement=place,
                            threads=t_), iters)
        line += ("; geometries (placement, lanes a CTA, threads): " + ", ".join(
            f"{p_} {l_} {t_ or ppk.word_threads(n, l_)}: {v:.4f}"
            for (p_, l_, t_), v in alt.items()) + " ms")
        nb = 2 * n * b * 4 + ctl_bytes
        ops_ = b * (live + n * (len(prog.steps) - n_perm))
        bms, by = bound(nb, ops_)
        log(line + f"; bound {bms:.5f} ms ({by}: {nb} B, {ops_} operations:"
            f" {live} live selects and {len(prog.steps) - n_perm} "
            f"elementwise steps of {n} rows a lane; the kernel walks "
            f"{ctl['w_slots']} select slots and {ctl['w_visits']} rows a "
            "lane)")

        def seal():
            return G.aes128_gcm_seal_batch(GCM_KEY, ivs, pts, aads,
                                           device=dev)
        secs = [host_s(seal)[0] for _ in range(3)]
        mib = b * pt_len / 2**20
        best = min(secs)
        log(f"  aes128_gcm_seal_batch ({name}), host clock: "
            f"{[round(s_ * 1e3, 2) for s_ in secs]} ms; best "
            f"{b / best:.1f} records/s, {best * 1e3 / mib:.2f} ms per MiB "
            f"sealed ({mib:.4f} MiB a call)")
        prof = profile_call(f"aes128_gcm_seal_batch ({name})", seal, rows=6)
        copies = {k: v for k, v in prof["kernels"].items() if "Memcpy" in k}
        log(f"    copies: " + "; ".join(
            f"{k} x{c} {t_:.3f} ms" for k, (c, t_) in copies.items()))
        stats[name] = dict(ms=ms, eager=eager, bound=bms, by=by,
                           placement=placement, lanes=lanes, steps=len(
                               prog.steps), geometries=alt,
                           records_s=b / best,
                           ms_per_mib=best * 1e3 / mib)
        del bits, want

    name, pt_len, aad_len, _ = GCM_GEOMETRIES[0]
    ivs, pts, aads = records(GCM_CHAINED_RECORDS, pt_len, aad_len)
    fused = G.aes128_gcm_seal_batch(GCM_KEY, ivs, pts, aads, device=dev)
    for backend in ("kernel", "sparse"):
        secs, out = host_s(lambda: G.aes128_gcm_seal_batch(
            GCM_KEY, ivs, pts, aads, backend=backend, device=dev))
        check(out == fused, f"gcm chained ({backend}) != fused at ({name})")
        log(f"  chained path ({backend}), ({name}) geometry, "
            f"{GCM_CHAINED_RECORDS} records: {secs * 1e3:.1f} ms host clock "
            f"({GCM_CHAINED_RECORDS / secs:.1f} records/s; fused, "
            f"{GCM_GEOMETRIES[0][3]} records: "
            f"{stats[name]['records_s']:.1f} records/s)")

    for backend in ("fused", "einsum", "kernel", "sparse", "reference"):
        for key, iv, pt, aad, ct, tag in GCM_CAVP:
            sealed = G.aes128_gcm_seal(key, iv, pt, aad, backend=backend,
                                       device=dev)
            check(sealed == ct + tag and G.aes128_gcm_open(
                key, iv, sealed, aad, backend=backend, device=dev) == pt,
                f"gcm CAVP vector fails on {backend}")
    h = G._hash_key(GCM_KEY)
    data = bytes(rng.integers(0, 256, 16 * 24, dtype=np.uint8))
    for mode in ("powers", "horner"):
        want_h = G.ghash(h, data, mode=mode, backend="reference", device=dev)
        for backend in ("kernel", "sparse"):
            check(G.ghash(h, data, mode=mode, backend=backend, device=dev)
                  == want_h, f"ghash {mode} on {backend} != reference")
    log("  CAVP test cases 1-4 seal and open on fused, einsum, kernel, "
        "sparse and reference; ghash (powers, horner) on kernel and sparse "
        "equals reference")
    return counts, stats


def obs_phase(dev, msgs):
    """Tracing on: one SHA-3 call on the tile-skipping crossbar (its
    schedules compiled afresh) and one fixed-latency GCM seal export a
    Chrome trace and Prometheus text that the port's validators accept,
    with the reference's span and metric names; the host clock of the
    same calls with tracing off and on."""
    import json as json_
    import tempfile

    import numpy as np

    from repro_torch import obs
    from repro_torch.core import crossbar as xb
    from repro_torch.crypto import gcm as G
    from repro_torch.crypto import keccak as K

    name, pt_len, aad_len, _ = GCM_GEOMETRIES[0]
    rng = np.random.default_rng(19)
    ivs = [bytes(r) for r in rng.integers(0, 256, (64, 12), dtype=np.uint8)]
    pts = [bytes(r) for r in rng.integers(0, 256, (64, pt_len),
                                          dtype=np.uint8)]
    aads = [bytes(r) for r in rng.integers(0, 256, (64, aad_len),
                                           dtype=np.uint8)]

    def calls():
        K.sha3_256(msgs[0], backend="sparse", device=dev)
        G.aes128_gcm_seal_batch(GCM_KEY, ivs, pts, aads, fixed_latency=True,
                                device=dev)

    log("obs: tracing on for one SHA-3 call (sparse) and one GCM seal")
    calls()
    xb.clear_compile_cache()
    obs.reset()
    obs.enable()
    try:
        calls()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            obs.export_chrome_trace(str(path))
            trace = json_.loads(path.read_text())
        text = obs.prometheus_text()
    finally:
        obs.disable()
    tsum = obs.validate_chrome_trace(trace)
    psum = obs.validate_prometheus_text(text)
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    need = {"compile_plan", "apply_plan", "registry_observe", "gcm_seal"}
    check(need <= names, f"trace spans {sorted(names)} lack "
          f"{sorted(need - names)}")
    for metric in ('repro_span_seconds_count{span="gcm_seal"} 1',
                   "repro_gcm_seal_calls_total", "repro_ghash_lift_cache",
                   "repro_compile_cache_size", "repro_integrity_verify_rate",
                   "repro_kernel_launches_plan_program_total"):
        check(metric in text, f"prometheus text lacks {metric}")
    log(f"  chrome trace: {tsum}; span names {sorted(names)}; prometheus "
        f"text: {psum}")
    off, on = [], []
    for _ in range(3):
        off.append(host_s(calls)[0] * 1e3)
        obs.enable()
        try:
            on.append(host_s(calls)[0] * 1e3)
        finally:
            obs.disable()
    obs.reset()
    log(f"  host clock of the two calls, tracing off {[round(t_, 2) for t_ in off]}"
        f" ms, on {[round(t_, 2) for t_ in on]} ms")


SERVE_REQUESTS = 10_000
SERVE_BATCHES = (128, 1024)      # the reference benchmark's, the card's
SERVE_FAULT_RATE = 0.01
SERVE_ORACLE_RECORDS = 64


def serving_payloads(n: int, seed: int) -> list:
    """The reference serving benchmark's traffic rule
    (``benchmarks/bench_serving.py::_payloads``): ~85 % payloads of
    1-127 B (one SHA3-256 sponge block), ~15 % of 140-259 B (two)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = np.where(rng.random(n) < 0.85,
                       rng.integers(1, 128, n),
                       rng.integers(140, 260, n))
    return [rng.bytes(int(n_)) for n_ in lengths]


def serving_phase(dev):
    """``BatchingEngine`` answering requests on the card.

    1. The reference serving benchmark's 10^4 SHA3-256 requests at
       max_batch 128 and 1024, drained with ``run_once`` and by the
       threaded, double-buffered engine: every digest equal to hashlib,
       every batch answered by the megakernel in a power-of-two lane
       count with one packed launch a sponge block, no fallback, retry
       or crossbar launch; requests/s, MiB/s, latency p50/p99/max,
       batches, padded-lane share, and one profiled batch.
    2. AES-128-GCM seal records of geometries (a) and (c) interleaved
       with SHA-3 in one engine: each record equal to a direct fused
       seal call and, for a seeded 64 of each geometry, to the host
       oracle; one word-layout launch a batch; records/s, ms per MiB.
    3. Degradation, each in its own engine and tuning table: an
       injected megakernel fault on a SHA-3 batch and a 16-record GCM
       batch falls to the tile-skipping crossbar, bit-exact; the
       reference benchmark's 1 % fault regime on the megakernel, every
       batch without an injected fault answered by it; drift
       quarantined and answered by the megakernel again; a corrupted
       constants block never served; a batch whose three kernel rungs
       all fail raises its typed fault and no plain rung answers; a
       kernel build failure escapes the chain.
    Returns the kernel launches of the clean drains of 1 and 2, each
    counted from 0 just before it and read just after; the degradation
    cases' launches are logged on their own line."""
    import numpy as np
    import torch

    from repro_torch.core import faults, integrity, telemetry
    from repro_torch.core import plan_program as pp
    from repro_torch.core.resilience import (CARD_CHAIN, LaunchFault,
                                             ResilientExecutor, RetryPolicy)
    from repro_torch.crypto import gcm as G
    from repro_torch.crypto import keccak as K
    from repro_torch.crypto.registry import registry
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts
    from repro_torch.kernels import plan_program_kernel as ppk
    from repro_torch.kernels._build import KernelBuildError
    from repro_torch.serve import BatchingEngine, BatchingOptions
    from repro_torch.serve.batching import encode_aead_record

    t_phase = time.perf_counter()
    payloads = serving_payloads(SERVE_REQUESTS, seed=0)
    want = [hashlib.sha3_256(p).digest() for p in payloads]
    mib = sum(len(p) for p in payloads) / 2**20
    reg = registry(dev)
    clean = {}                       # launches of the clean drains alone

    def add_clean():
        for k, v in launch_counts().items():
            clean[k] = clean.get(k, 0) + v

    def counters():
        return (dict(launch_counts()), dict(ppk.LAYOUT_LAUNCHES),
                telemetry.snapshot())

    def moved(before, after):
        """(kernel launches, launches by layout, counters) since before."""
        return tuple({k: v - b.get(k, 0) for k, v in a.items()}
                     for b, a in zip(before, after))

    def make(max_batch, *, start=False, executor=None, **opt):
        opt.setdefault("max_queue", SERVE_REQUESTS)
        opt.setdefault("batch_log_cap", SERVE_REQUESTS)
        return BatchingEngine(BatchingOptions(max_batch=max_batch, **opt),
                              executor=executor, device=dev, start=start)

    def check_clean(name, d, log_):
        kl, lay, tel = d
        check(all(b == "megakernel" for _, _, b, _ in log_),
              f"{name}: batches answered by "
              f"{sorted({b for _, _, b, _ in log_})}")
        check(all(s_[0] & (s_[0] - 1) == 0 for _, s_, _, _ in log_),
              f"{name}: a batch of a lane count not a power of two")
        for key in ("resilience_fallbacks", "resilience_retries",
                    "resilience_faults"):
            check(tel.get(key, 0) == 0, f"{name}: {key} {tel.get(key)}")
        check(kl["crossbar_dense"] == 0 and kl["crossbar_sparse"] == 0,
              f"{name}: crossbar launches {kl}")

    def report(name, reqs, wall, log_, tel):
        lat = np.asarray([r.latency_s for r in reqs]) * 1e3
        lanes = sum(s_[0] for _, s_, _, _ in log_)
        log(f"  {name}: {len(reqs) / wall:.1f} requests/s, {mib / wall:.3f} "
            f"MiB/s ({wall * 1e3:.1f} ms for {len(reqs)}); latency p50 "
            f"{np.percentile(lat, 50):.2f}, p99 {np.percentile(lat, 99):.2f},"
            f" max {lat.max():.2f} ms; {len(log_)} batches, padded-lane "
            f"share {tel.get('serve_padded_lanes', 0) / lanes:.4f}")
        return len(reqs) / wall

    # ------------------------------------------------- 1. SHA-3 traffic ---
    log("serving: the reference benchmark's 10^4 SHA3-256 requests "
        f"(85 % one-block, 15 % two-block), {mib:.4f} MiB")
    rates = {}
    for max_batch in SERVE_BATCHES:
        eng = make(max_batch)
        reqs = [eng.submit(p) for p in payloads]
        reset_launch_counts()
        before = counters()
        t0 = time.perf_counter()
        while True:
            b_ = counters()
            if not eng.run_once():
                break
            _, lay, _ = moved(b_, counters())
            op, shape, backend, live = eng.batch_log[-1]
            check(lay["packed"] == shape[1] and sum(lay.values())
                  == shape[1], f"batch {shape} ran megakernel launches "
                  f"{lay}, not {shape[1]} packed")
        wall = time.perf_counter() - t0
        d = moved(before, counters())
        add_clean()
        log_ = list(eng.batch_log)
        check([r.result(0) for r in reqs] == want,
              f"run_once drain at {max_batch}: a digest differs from "
              "hashlib")
        check_clean(f"run_once drain at {max_batch}", d, log_)
        check(sum(s_[1] for _, s_, _, _ in log_) == d[1]["packed"],
              "packed launches differ from the batches' sponge blocks")
        rates[("sync", max_batch)] = report(
            f"max_batch {max_batch}, run_once drain", reqs, wall, log_, d[2])

        eng = make(max_batch, start=True)
        reset_launch_counts()
        before = counters()
        t0 = time.perf_counter()
        reqs = [eng.submit(p) for p in payloads]
        got = [r.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t0
        eng.close(timeout=60)
        check(eng._worker is None and eng.check_workers() == [],
              "the worker threads did not stop cleanly")
        d = moved(before, counters())
        add_clean()
        log_ = list(eng.batch_log)
        check(got == want, f"threaded drain at {max_batch}: a digest "
              "differs from hashlib")
        check_clean(f"threaded drain at {max_batch}", d, log_)
        check(sum(s_[1] for _, s_, _, _ in log_) == d[1]["packed"]
              and sum(d[1].values()) == d[1]["packed"],
              f"threaded drain: launches by layout {d[1]} for "
              f"{sum(s_[1] for _, s_, _, _ in log_)} sponge blocks")
        rates[("threaded", max_batch)] = report(
            f"max_batch {max_batch}, threaded double-buffered", reqs, wall,
            log_, d[2])

        one = [p for p in payloads if len(p) < 136][:max_batch]
        eng = make(max_batch)

        def batch():
            for p in one:
                eng.submit(p)
            eng.run_once()
        profile_call(f"one serving batch, {len(one)} one-block requests "
                     "(pack, copy, 1 megakernel launch, digests to host)",
                     batch, rows=6)

    # -------------------------------------------- 2. AEAD interleaved ---
    log("serving: AES-128-GCM seal records interleaved with SHA-3 "
        "(engine key bytes(range(16)), max_batch 1024)")
    rng = np.random.default_rng(23)
    geos = {g[0]: g for g in GCM_GEOMETRIES if g[0] in ("a", "c")}
    recs = {}
    for name, (_, pt_len, aad_len, b) in geos.items():
        recs[name] = [(bytes(rng.integers(0, 256, 12, dtype=np.uint8)),
                       bytes(rng.integers(0, 256, pt_len, dtype=np.uint8)),
                       bytes(rng.integers(0, 256, aad_len, dtype=np.uint8)))
                      for _ in range(b)]
    eng = make(SERVE_BATCHES[1], aead_key=GCM_KEY)
    n_a, n_c = geos["a"][3], geos["c"][3]
    sha = payloads[:2 * n_a]
    order = []                       # (kind, index) in submission order
    for i in range(n_a):
        order.append(("a", i))
        if i < n_c:
            order.append(("c", i))
        order.extend(("sha", 2 * i + j) for j in range(2))
    reqs = {}
    for kind, i in order:
        if kind == "sha":
            reqs[kind, i] = eng.submit(sha[i])
        else:
            reqs[kind, i] = eng.submit(encode_aead_record(*recs[kind][i]),
                                       op="gcm_seal")
    reset_launch_counts()
    before = counters()
    per_gcm = {}
    while True:
        b_ = counters()
        t0 = time.perf_counter()
        if not eng.run_once():
            break
        secs = time.perf_counter() - t0
        _, lay, _ = moved(b_, counters())
        op, shape, backend, live = eng.batch_log[-1]
        if op == "gcm_seal":
            name = "a" if shape[1] == geos["a"][1] else "c"
            # the placement the wrapper picks for the batch's lanes
            m_, _, a_ = G._geometry(shape[1], shape[2])
            n_ = G._layout(m_, a_)["n"]
            smem_ = ppk.smem_optin(dev)
            key_l = ("word" if ppk.register_file(
                n_, 4, smem_, ppk.lanes_per_cta(
                    n_, 4, shape[0], smem_, sms=ppk.sm_count(dev)))
                == "shared" else "word_global")
            check(lay[key_l] == 1 and sum(lay.values()) == 1,
                  f"gcm batch {shape}: launches by layout {lay}")
            per_gcm[name] = (secs, live, shape, key_l)
    d = moved(before, counters())
    add_clean()
    check_clean("interleaved SHA-3 + GCM", d, list(eng.batch_log))
    check(sorted(per_gcm) == ["a", "c"] and all(
        v[1] == geos[k][3] for k, v in per_gcm.items()),
        f"gcm batches {per_gcm}")
    check([reqs["sha", i].result(0) for i in range(len(sha))]
          == want[:len(sha)], "interleaved SHA-3 digests differ")
    for name, (_, pt_len, aad_len, b) in geos.items():
        ivs, pts, aads = (list(x) for x in zip(*recs[name]))
        direct = G.aes128_gcm_seal_batch(GCM_KEY, ivs, pts, aads,
                                         backend="fused", device=dev)
        got = [reqs[name, i].result(0) for i in range(b)]
        check(got == direct, f"gcm ({name}) served records differ from the "
              "direct fused seal")
        pick = np.random.default_rng(29).choice(
            b, size=min(SERVE_ORACLE_RECORDS, b), replace=False)
        for i in pick:
            check(got[i] == gcm_oracle(GCM_KEY, *recs[name][i]),
                  f"gcm ({name}) served record {i} differs from the oracle")
        secs, live, shape, key_l = per_gcm[name]
        log(f"  gcm ({name}) {b} x {pt_len} B, {aad_len} B AAD: one batch "
            f"{shape}, one {key_l} "
            f"launch, {secs * 1e3:.2f} ms run_once: {live / secs:.1f} "
            f"records/s, {secs * 1e3 / (live * pt_len / 2**20):.2f} ms per "
            f"MiB; equal to the direct fused seal, {len(pick)} to the host "
            "oracle")

    # ---------------------------------------------------- 3. degradation ---
    log("serving: degradation, each case in its own engine and tuning table")
    reset_launch_counts()

    def one_shot():
        return ResilientExecutor(chain=CARD_CHAIN,
                                 retry=RetryPolicy(max_attempts=1),
                                 registry=reg)

    ones = [i for i, p in enumerate(payloads) if len(p) < 136][:128]
    sha128, want128 = [payloads[i] for i in ones], [want[i] for i in ones]
    for name, subs in (
            ("sha3_256 batch", [(p, "sha3_256") for p in sha128]),
            ("gcm (a) batch of 16", [(encode_aead_record(*r), "gcm_seal")
                                     for r in recs["a"][:16]])):
        eng = make(128, executor=one_shot(), aead_key=GCM_KEY)
        rq = [eng.submit(p, op=op) for p, op in subs]
        before = counters()
        t0 = time.perf_counter()
        with faults.inject_faults(seed=3, program_rate=1.0,
                                  sites=("program",), max_faults=1) as inj:
            while eng.run_once():
                pass
        secs = time.perf_counter() - t0
        kl, _, tel = moved(before, counters())
        vals = [r.result(0) for r in rq]
        if subs[0][1] == "sha3_256":
            exact = vals == want128
        else:
            ivs, pts, aads = (list(x) for x in zip(*recs["a"][:16]))
            exact = vals == G.aes128_gcm_seal_batch(
                GCM_KEY, ivs, pts, aads, backend="fused", device=dev)
        check(inj.count == 1 and exact
              and all(r.backend == "sparse" for r in rq)
              and tel.get("resilience_fallbacks", 0) == 1
              and kl["crossbar_sparse"] > 0,
              f"{name} under one injected megakernel fault: injected "
              f"{inj.injected}, exact {exact}, backends "
              f"{sorted({r.backend for r in rq})}, fallbacks "
              f"{tel.get('resilience_fallbacks')}, launches {kl}")
        log(f"  {name}: injected {inj.injected} -> answered by sparse, "
            f"bit-exact, 1 fallback, {kl['crossbar_sparse']} tile-skipping "
            f"crossbar launches, {secs * 1e3:.1f} ms")

    eng = make(SERVE_BATCHES[0])
    reqs = [eng.submit(p) for p in payloads]
    before = counters()
    t0 = time.perf_counter()
    hit_batches = 0
    with faults.inject_faults(seed=0, program_rate=SERVE_FAULT_RATE) as inj:
        while True:
            c0 = inj.count
            if not eng.run_once():
                break
            if inj.count == c0:
                check(eng.batch_log[-1][2] == "megakernel",
                      f"1 % fault regime: batch {eng.batch_log[-1]} took "
                      "no injected fault and was not answered by the "
                      "megakernel")
            else:
                hit_batches += 1
    wall = time.perf_counter() - t0
    kl, _, tel = moved(before, counters())
    check([r.result(0) for r in reqs] == want,
          "1 % fault regime: a digest differs from hashlib")
    check(tel.get("resilience_faults", 0) == inj.count,
          f"1 % fault regime: {inj.count} injected, "
          f"{tel.get('resilience_faults', 0)} faults absorbed")
    rate = report(f"max_batch {SERVE_BATCHES[0]}, run_once drain, "
                  f"{SERVE_FAULT_RATE:.0%} injected megakernel faults",
                  reqs, wall, list(eng.batch_log), tel)
    log(f"    {inj.count} faults injected in {hit_batches} batches and "
        f"absorbed, every other batch answered by megakernel (retries "
        f"{tel.get('resilience_retries', 0)}, fallbacks "
        f"{tel.get('resilience_fallbacks', 0)}, backends "
        f"{sorted({r.backend for r in reqs})}, crossbar launches {kl}); "
        f"{rate / rates[('sync', SERVE_BATCHES[0])]:.4f} of the clean "
        "run_once drain's requests/s")

    eng = make(128)
    for p in sha128:
        eng.submit(p)
    eng.run_once()
    q0 = reg.quarantine_count(K.MEGAKERNEL_PROGRAM_KEY)
    poisoned = faults.poison_observations(reg, site="keccak")
    rq = [eng.submit(p) for p in sha128]
    before = counters()
    eng.run_once()
    _, _, tel = moved(before, counters())
    check(poisoned > 0 and [r.result(0) for r in rq] == want128
          and all(r.backend == "megakernel" for r in rq)
          and reg.quarantine_count(K.MEGAKERNEL_PROGRAM_KEY) == q0 + 1
          and tel.get("resilience_quarantines", 0) == 1,
          f"drift: poisoned {poisoned}, backends "
          f"{sorted({r.backend for r in rq})}, quarantines "
          f"{tel.get('resilience_quarantines')}")
    log(f"  drift: {poisoned} keccak signatures poisoned -> one quarantine, "
        "the next batch answered by megakernel, bit-exact")

    pp.clear_program_cache()
    eng = make(128)
    for p in sha128:
        eng.submit(p)
    eng.run_once()
    hit = faults.corrupt_cache(np.random.default_rng(5), target="const")
    rq = [eng.submit(p) for p in sha128]
    before = counters()
    with integrity.always_verify():
        eng.run_once()
    _, _, tel = moved(before, counters())
    check(hit is not None and hit[0] == "const"
          and [r.result(0) for r in rq] == want128
          and tel.get("integrity_faults", 0) >= 1,
          f"corrupt_cache: {hit}, integrity faults "
          f"{tel.get('integrity_faults')}, backends "
          f"{sorted({r.backend for r in rq})}")
    log(f"  corrupt_cache {hit[0]} (keccak program's constants and its "
        f"control on the card): {tel['integrity_faults']} integrity "
        f"faults, answered by {sorted({r.backend for r in rq})}, bit-exact")

    eng = make(8)
    check(eng.chain == CARD_CHAIN, f"the card's chain is {eng.chain}")
    rq = [eng.submit(p) for p in sha128[:8]]
    before = counters()
    with faults.inject_faults(seed=0, program_rate=1.0, launch_rate=1.0,
                              sites=("program", "apply")) as inj:
        eng.run_once()
    kl, lay, tel = moved(before, counters())
    check(all(isinstance(r._exc, LaunchFault) for r in rq)
          and inj.count == 2 * len(CARD_CHAIN)
          and tel.get("resilience_exhausted", 0) == 1
          and not any(tel.get(f"resilience_backend_{b}", 0)
                      for b in ("einsum", "reference"))
          and not any(kl.values()) and not any(lay.values())
          and not eng.batch_log,
          f"every kernel rung failing: request errors "
          f"{sorted({type(r._exc).__name__ for r in rq})}, injected "
          f"{inj.count}, counters {tel}, launches {kl}")
    log(f"  every kernel rung failing ({inj.count} injected faults): the "
        "batch's requests failed with LaunchFault, no einsum or reference "
        "answer")

    eng = make(128)
    rq = [eng.submit(p) for p in sha128]
    real_library = _build.library

    def no_nvcc():
        raise KernelBuildError("nvcc not found (forced by chip_smoke.py)")
    before = counters()
    _build.library = no_nvcc
    try:
        eng.run_once()
    finally:
        _build.library = real_library
    kl, _, tel = moved(before, counters())
    errs = [type(r._exc).__name__ for r in rq]
    check(all(isinstance(r._exc, KernelBuildError) for r in rq)
          and tel.get("resilience_fallbacks", 0) == 0
          and tel.get("resilience_faults", 0) == 0
          and not eng.batch_log and not any(kl.values()),
          f"build failure: request errors {sorted(set(errs))}, fallbacks "
          f"{tel.get('resilience_fallbacks')}, launches {kl}")
    log("  a KernelBuildError inside the megakernel's run escaped the chain: "
        "every request of the batch failed with it, no fallback, no "
        "launch")
    log(f"  degradation cases' launches (not in the kernels line) "
        f"{dict(launch_counts())}")
    log(f"  clean serving launches {clean}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return clean


MESH_SHARDS = (1, 2, 4, 8)
# Phi-3.5-MoE's prompt routing group: T tokens, E experts, capacity C,
# top-2; the cross-shard dispatch runs over 8 shards.
MESH_T, MESH_E, MESH_C, MESH_K, MESH_S = 2048, 16, 384, 2, 8
MESH_LOCALITY = 0.9
MESH_SLIDE_ROWS, MESH_SLIDE_D = 65536, 128


def locality_dest(t_tokens, n_experts, capacity, s, *, locality, seed):
    """The reference mesh benchmark's capacity-slotted MoE dispatch
    (``benchmarks/bench_mesh_sharded.py::_moe_dispatch_plan``, its rule
    copied): a token routes to an expert of its own shard with
    probability ``locality``, else to any; slots fill in token order and
    overflow drops.  Returns the destinations (T,) int32."""
    import numpy as np
    rng = np.random.default_rng(seed)
    dest = np.full((t_tokens,), -1, np.int32)
    fill = np.zeros((n_experts,), np.int32)
    for t in range(t_tokens):
        my_shard = t // (t_tokens // s)
        if rng.random() < locality:
            e = my_shard * (n_experts // s) + rng.integers(0, n_experts // s)
        else:
            e = rng.integers(0, n_experts)
        if fill[e] < capacity:
            dest[t] = e * capacity + fill[e]
            fill[e] += 1
    return dest


def mesh_phase(dev, msgs, group0, compare):
    """Mesh execution (``dist/``) on meshes of shards of the one card.

    1. Lane-parallel SHA3-256 of the SHA-3 phase's 1024 x 1 KiB messages
       through ``run_program_sharded`` at S = 1, 2, 4, 8: digests equal
       hashlib, no block copy, S packed megakernel launches a permutation
       (counters and ``torch.profiler``); wall and device ms at each S.
    2. Cross-shard MoE dispatch at Phi-3.5-MoE's prompt width (T = 2048,
       E = 16, C = 384, D = 4096 bf16, top-2) over 8 shards, for layer 0's
       top-2 routing (``make_routing``, so the moe_route kernel) and the
       reference benchmark's locality-0.9 routing: the scheduled and the
       naive executor on both crossbars bit-exact against single-device
       ``apply_plan``, block copies equal to the schedule's and to
       S(S - 1), one crossbar launch a block that runs; rounds, copies,
       bytes moved and device ms.
    3. A GF(2) (Keccak's rho-pi over 1600 x 1024) and a weighted REAL (a
       gated vslide of half a shard over 65536 x 128 float32) cross-shard
       plan at S = 8, the same way.
    4. ``BatchingEngine`` on ``make_mesh((8,), ("data",))`` with partial
       results: the serving benchmark's 10^4 SHA3-256 requests at
       max_batch 1024, a clean drain (every shard on the megakernel),
       then a drain with shard 3 killed after three batches (one drop,
       the survivor mesh of 4, the lost lanes replayed, every digest
       exact, no plain rung); an armed collective site on a cross-shard
       plan raises ``InjectedCollectiveFailure``.
    Returns the kernel launches of the counted runs (each counted from 0
    just before it and read just after); comparison launches and the
    faulted drain's are not among them.
    """
    import numpy as np
    import torch

    from repro_torch.core import crossbar as xb
    from repro_torch.core import faults, telemetry
    from repro_torch.core import moe_dispatch as md
    from repro_torch.core import plan_algebra as pa
    from repro_torch.core.resilience import LaunchFault, classify
    from repro_torch.crypto import keccak as K
    from repro_torch.dist import make_mesh
    from repro_torch.dist import mesh_exec as mx
    from repro_torch.dist.fault import survivor_mesh_shape
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import plan_program_kernel as ppk
    from repro_torch.serve import BatchingEngine, BatchingOptions

    counted = {}

    def on_card(mesh):
        devs = list(mesh.devices.reshape(-1))
        check(all(d == dev for d in devs),
              f"a shard is not on {dev}: {[str(d) for d in devs]}")
        return mesh

    def mesh_of(s):
        return on_card(make_mesh((s,), ("data",), devices=[dev] * s))

    # ------------------------------------------- 1. lane-parallel SHA-3 ---
    prog = K.megakernel_program(dev)
    blocks = np.stack([K._pad101(m, 136, 0x06) for m in msgs])
    b, nb = blocks.shape[:2]
    tail = np.zeros((b, nb, K.STATE_BITS - blocks.shape[2]), np.int32)
    dev_blocks = torch.as_tensor(np.concatenate([blocks, tail], axis=2),
                                 device=dev)            # (B, blocks, 1600)
    want = [hashlib.sha3_256(m).digest() for m in msgs]
    log(f"mesh: lane-parallel SHA3-256 of {b} x {len(msgs[0])} B messages "
        f"({nb} permutations), run_program_sharded over S shards of {dev}")

    def sponge(mesh, s):
        cols = [dev_blocks[lo:hi].permute(1, 2, 0).contiguous()
                for lo, hi in mx.shard_bounds(b, s)]  # (blocks, 1600, B/S)
        states = [torch.zeros((K.STATE_BITS, b // s), dtype=torch.int32,
                              device=dev) for _ in range(s)]
        for i in range(nb):
            states = [st ^ c[i] for st, c in zip(states, cols)]
            states = mx.run_program_sharded(prog, states, mesh)
        return states

    for s in MESH_SHARDS:
        mesh = mesh_of(s)
        sponge(mesh, s)
        reset_launch_counts()
        with telemetry.delta() as d:
            secs, states = host_s(lambda: sponge(mesh, s))
        kl, lay, dd = dict(launch_counts()), dict(ppk.LAYOUT_LAUNCHES), d()
        add_counts(counted, kl)
        host = torch.cat(states, dim=1).T.cpu().numpy()
        check([K._squeeze(host[i], 136)[:32] for i in range(b)] == want,
              f"lane-parallel SHA3-256 at S={s}: a digest differs from "
              "hashlib")
        check(dd.get("mesh_block_copies", 0) == 0,
              f"S={s}: {dd.get('mesh_block_copies')} block copies")
        check(lay["packed"] == kl["plan_program"] == s * nb
              and kl["crossbar_dense"] == kl["crossbar_sparse"] == 0,
              f"S={s}: launches {kl}, by layout {lay}")
        work = device_work(lambda: mx.run_program_sharded(prog, states,
                                                          mesh), calls=1)
        packed = sum(c for k, c in work if "pp_packed_kernel" in k)
        check(packed == s, f"S={s}: one permutation ran {work}")
        prof = profile_call(f"lane-parallel SHA3-256, S={s}",
                            lambda: sponge(mesh, s), rows=4)
        mk_ms = sum(t_ for k, (_, t_) in prof["kernels"].items()
                    if "pp_packed_kernel" in k)
        log(f"  S={s}: digests equal hashlib, 0 block copies, {packed} "
            f"packed megakernel launches a permutation (profiler), "
            f"{lay['packed']} in all: held; absorb wall {secs * 1e3:.2f} "
            f"ms (blocks already on the card, states left there; "
            f"{b / secs:.1f} hashes/s), device busy {prof['busy_ms']:.3f}"
            f" ms of which megakernels {mk_ms:.3f} ms (shards of one card "
            "run one after another: no speed-up is expected)")

    # ----------------------------- 2-3. cross-shard plans at S = 8 shards ---
    mesh8 = mesh_of(MESH_S)
    u0, router0 = group0
    check(tuple(u0.shape) == (MESH_T, 4096) and u0.dtype == torch.bfloat16
          and tuple(router0.shape) == (MESH_T, MESH_E),
          f"layer 0 group 0: u {tuple(u0.shape)} {u0.dtype}, router "
          f"{tuple(router0.shape)}")
    reset_launch_counts()
    routing = md.make_routing(router0, num_experts=MESH_E, k=MESH_K,
                              capacity=MESH_C)
    torch.cuda.synchronize()
    kl = dict(launch_counts())
    add_counts(counted, kl)
    check(kl["moe_route"] == 1, f"make_routing launched {kl}")
    rng = np.random.default_rng(31)
    n_sl = MESH_SLIDE_ROWS
    slide = xb.vslide_plan(n_sl, n_sl // MESH_S // 2, up=True, device=dev)
    gates = torch.as_tensor(rng.random(n_sl, dtype=np.float32), device=dev)
    cases = (
        ("MoE dispatch, layer 0's top-2 routing", md.dispatch_plan(routing),
         u0, None),
        (f"MoE dispatch, locality-{MESH_LOCALITY} routing",
         xb.scatter_plan(torch.as_tensor(locality_dest(
             MESH_T, MESH_E, MESH_C, MESH_S, locality=MESH_LOCALITY,
             seed=7), device=dev), MESH_E * MESH_C), u0, None),
        ("GF(2) Keccak rho-pi (1600, 1024) int32", K.rho_pi_plan(dev),
         torch.as_tensor(rng.integers(0, 2, (1600, 1024), dtype=np.int32),
                         device=dev), None),
        (f"weighted REAL gated vslide by {n_sl // MESH_S // 2} "
         f"({n_sl}, {MESH_SLIDE_D}) f32", pa.with_weights(slide, gates),
         torch.as_tensor(rng.standard_normal((n_sl, MESH_SLIDE_D),
                                             np.float32), device=dev),
         TOL_F32),
    )
    for name, plan, x, tol in cases:
        stats = mx.schedule_stats(mx.shard_connectivity(plan, MESH_S))
        block_b = x.numel() // MESH_S * x.element_size()
        log(f"mesh: {name} over {MESH_S} shards ({plan.n_in} -> "
            f"{plan.n_out} rows, {x.shape[1]} columns): "
            f"{stats['off_diag_edges']} cross-shard blocks in "
            f"{stats['schedule_rounds']} rounds (naive: "
            f"{stats['naive_block_transfers']} in {stats['naive_rounds']})")
        for backend in ("kernel", "sparse"):
            kname = KERNEL_OF[backend]
            single = xb.apply_plan(plan, x, backend=backend)
            plain = xb.apply_plan(plan, x, backend="reference")
            compare(kname, f"{name}: single-device {backend} vs plain",
                    single, plain, tol)
            fn = mx.sharded_apply_fn(plan, mesh8, backend=backend)
            naive = mx.sharded_apply_naive_fn(plan, mesh8, backend=backend)
            for label, ex, copies, calls in (
                    ("scheduled", fn, stats["scheduled_block_transfers"],
                     len(fn.blocks)),
                    ("naive", naive, stats["naive_block_transfers"],
                     MESH_S)):
                ex(x)
                torch.cuda.synchronize()
                reset_launch_counts()
                with telemetry.delta() as d:
                    out = torch.cat(ex(x))
                torch.cuda.synchronize()
                kl, moved = dict(launch_counts()), d().get(
                    "mesh_block_copies", 0)
                add_counts(counted, kl)
                compare(kname, f"{name}: {backend}, {label} executor vs "
                        "single-device apply_plan", out, single, tol)
                check(moved == copies, f"{name} {backend} {label}: {moved} "
                      f"block copies, expected {copies}")
                check(kl[kname] == calls, f"{name} {backend} {label}: "
                      f"launches {kl}, expected {calls} {kname}")
                eager = time_ms(lambda: ex(x), 10)
                _, _, on_dev = profiled_window(lambda: ex(x))
                busy = sum(_dev_us(e) for e in on_dev) / 1e3
                kern = sum(_dev_us(e) for e in on_dev
                           if "crossbar" in e.name) / 1e3
                log(f"  {backend} {label}: {moved} block copies ({moved} x "
                    f"{block_b} B = {moved * block_b / 2**20:.1f} MiB moved), "
                    f"{kl[kname]} {kname} launches: held; device busy "
                    f"{busy:.3f} ms (crossbar kernels {kern:.3f}), eager "
                    f"{eager:.3f} ms a call")

    # --------------------------------------------------- 4. mesh serving ---
    payloads = serving_payloads(SERVE_REQUESTS, seed=0)
    want = [hashlib.sha3_256(p).digest() for p in payloads]

    def make():
        mesh = on_card(make_mesh((MESH_S,), ("data",)))
        return BatchingEngine(BatchingOptions(
            max_batch=SERVE_BATCHES[1], max_queue=SERVE_REQUESTS,
            batch_log_cap=SERVE_REQUESTS, mesh=mesh, partial_results=True),
            device=dev, start=False)

    log(f"mesh serving: {SERVE_REQUESTS} SHA3-256 requests, max_batch "
        f"{SERVE_BATCHES[1]}, make_mesh(({MESH_S},), ('data',)), partial "
        "results")
    eng = make()
    reqs = [eng.submit(p) for p in payloads]
    reset_launch_counts()
    before = telemetry.snapshot()
    t0 = time.perf_counter()
    while eng.run_once():
        pass
    wall = time.perf_counter() - t0
    kl, lay = dict(launch_counts()), dict(ppk.LAYOUT_LAUNCHES)
    add_counts(counted, kl)
    tel = {k: v - before.get(k, 0) for k, v in telemetry.snapshot().items()}
    log_ = list(eng.batch_log)
    check([r.result(0) for r in reqs] == want,
          "mesh serving, clean drain: a digest differs from hashlib")
    check(tel.get("serve_shard_launches", 0) == MESH_S * len(log_)
          == tel.get("resilience_backend_megakernel", 0),
          f"clean drain: {tel.get('serve_shard_launches')} shard runs, "
          f"{tel.get('resilience_backend_megakernel')} on the megakernel, "
          f"{len(log_)} batches")
    check(lay["packed"] == MESH_S * sum(s_[1] for _, s_, _, _ in log_)
          and kl["crossbar_dense"] == kl["crossbar_sparse"] == 0
          and all(tel.get(k, 0) == 0 for k in (
              "resilience_fallbacks", "resilience_retries",
              "resilience_faults")), f"clean drain: launches {kl}, {lay}")
    log(f"  clean drain: every digest equals hashlib, {len(log_)} batches x "
        f"{MESH_S} shards all on the megakernel ({lay['packed']} packed "
        f"launches, no fallback): held; {len(reqs) / wall:.1f} requests/s "
        f"({wall * 1e3:.1f} ms)")

    eng = make()
    reqs = [eng.submit(p) for p in payloads]
    for _ in range(3):
        eng.run_once()
    served = sum(live for *_, live in eng.batch_log)
    before = telemetry.snapshot()
    t0 = time.perf_counter()
    with faults.inject_device_fault(3, max_fires=64) as state:
        while eng.run_once():
            pass
    wall = time.perf_counter() - t0
    tel = {k: v - before.get(k, 0) for k, v in telemetry.snapshot().items()}
    survivor = eng._active_mesh()
    want_size = survivor_mesh_shape({"data": MESH_S}, 1)["data"]
    check([r.result(0) for r in reqs] == want,
          "mesh serving, shard 3 killed: a digest differs from hashlib")
    check(tel.get("serve_mesh_device_drops", 0) == 1
          and eng.stats()["mesh_lost"] == [3],
          f"shard 3 killed: drops {tel.get('serve_mesh_device_drops')}, "
          f"lost {eng.stats()['mesh_lost']}")
    check(survivor is not None and survivor.size == want_size == 4
          and 3 not in survivor.ids.tolist(),
          f"survivor mesh {survivor}, survivor_mesh_shape gives {want_size}")
    on_card(survivor)
    check(tel.get("lanes_replayed", 0) > 0
          and tel.get("serve_shards_salvaged", 0) == MESH_S - 1,
          f"replay: {tel.get('lanes_replayed')} lanes, "
          f"{tel.get('serve_shards_salvaged')} shards salvaged")
    check(all(tel.get(f"resilience_backend_{b_}", 0) == 0
              for b_ in ("einsum", "reference"))
          and {r.backend for r in reqs} == {"megakernel"},
          f"shard 3 killed: answered by {sorted({r.backend for r in reqs})}")
    log(f"  shard 3 killed after 3 batches ({state['fired']} injected "
        f"faults): 1 drop, survivor mesh of {survivor.size} (ids "
        f"{survivor.ids.tolist()}), {tel['lanes_replayed']} lost lanes "
        f"replayed on a survivor, {tel['serve_shards_salvaged']}"
        " shards salvaged, every digest exact, only the megakernel "
        f"answered: held; {(len(reqs) - served) / wall:.1f} requests/s "
        f"over the {len(reqs) - served} requests after the kill "
        f"({wall * 1e3:.1f} ms)")

    with faults.inject_faults(seed=0, collective_rate=1.0,
                              sites=("collective",)) as inj:
        try:
            mx.sharded_apply_fn(K.rho_pi_plan(dev), mesh8, backend="sparse")
        except faults.InjectedCollectiveFailure as e:
            raised = e
        else:
            raised = None
    check(raised is not None and inj.injected == [("collective", 0)]
          and classify(raised) is LaunchFault,
          f"collective site: raised {raised!r}, ledger {inj.injected}")
    log("  collective_rate=1.0 on the rho-pi plan: InjectedCollectiveFailure"
        " (a launch-class fault) at round 0: held")
    log(f"  mesh phase launches (counted runs): {counted}")
    return counted


# The paper's Table 1 comparison on the card: the unified datapath
# (crossbar kernels, fused vcompress, moe_route-routed dispatch) against
# the baseline's separate datapaths (``core.baselines``), at the
# reference benchmark's geometry (VL = 256 b at SEW = 8 b: N = 32, D =
# 128) and one large shape.
BASELINE_SHAPES = ((32, 128), (4096, 128))


def baselines_phase(dev, compare):
    """The baseline datapaths against the unified one on the card.

    Not counted: each kernel against its plain version at these shapes.
    Counted (launch counters from 0): ``gather_baseline`` and
    ``slide_baseline`` (up and down; offsets 0, 1, n - 1, n and a random
    one) against ``permute.vrgather`` / ``vslideup`` / ``vslidedown`` on
    the dense and tile-skipping crossbars, ``compress_baseline_sequential``
    against ``ops.fused_vcompress`` and ``permute.vcompress`` on both,
    ``moe_dispatch_argsort_baseline`` against top-1 ``md.dispatch``
    routed by the moe_route kernel: all bit-exact.  Then each side's time
    (eager, CUDA events) and the sequential baseline's step count.
    Returns the counted launches.
    """
    import numpy as np
    import torch

    from repro_torch.core import baselines as B
    from repro_torch.core import crossbar as xb
    from repro_torch.core import moe_dispatch as md
    from repro_torch.core import permute as P
    from repro_torch.kernels import launch_counts, ops, ref
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels import crossbar_permute as xbk
    from repro_torch.kernels import fused_compress as fck
    from repro_torch.kernels import moe_route as mrk

    rng = np.random.default_rng(5)
    cases = []
    for n, d in BASELINE_SHAPES:
        e = 4 if n <= 32 else 16
        cases.append(dict(
            n=n, d=d, e=e, cap=max(1, int(1.25 * n / e)),
            x=torch.as_tensor(rng.standard_normal((n, d), np.float32),
                              device=dev),
            idx=torch.as_tensor(rng.integers(-2, n + 2, n, dtype=np.int32),
                                device=dev),
            mask=torch.as_tensor(rng.random(n) < 0.5, device=dev),
            off=5 if n == 32 else int(rng.integers(2, n - 1)),
            logits=torch.as_tensor(rng.standard_normal((n, e), np.float32),
                                   device=dev)))

    log("baselines phase: each kernel vs its plain version at the Table 1 "
        "shapes")
    for c in cases:
        n, d, x = c["n"], c["d"], c["x"]
        plan = xb.vrgather_plan(c["idx"], n)
        idxp, xf, kw = ops.dense_operands(plan, x)
        compare("crossbar_dense", f"vrgather ({n}, {d})",
                xbk.crossbar_permute_cuda(idxp, xf, **kw),
                ref.crossbar_dense(idxp, xf, **kw))
        args, kw = ops.sparse_operands(plan, x)
        kw["out"].fill_(-7.0)
        kw_p = dict(kw, out=kw["out"].clone())
        compare("crossbar_sparse", f"vrgather ({n}, {d})",
                xbk.crossbar_permute_sparse_cuda(*args, **kw),
                ref.crossbar_sparse(*args, **kw_p))
        compare("fused_vcompress", f"vcompress ({n}, {d})",
                fck.fused_vcompress_cuda(c["mask"], x),
                ref.fused_vcompress(c["mask"], x))
        ids = md.topk_route(c["logits"], 1)[0].reshape(1, n)
        got = mrk.moe_route_cuda(ids, num_experts=c["e"], capacity=c["cap"])
        want = ref.moe_route_transform(ids, num_experts=c["e"],
                                       capacity=c["cap"])
        for part, a, b in zip(("pos", "dest"), got, want):
            compare("moe_route", f"top-1 ids (1, {n}) E={c['e']} "
                    f"C={c['cap']}: {part}", a, b)

    log("baselines phase, unified = separate (launch counters from 0)")
    torch.cuda.synchronize()
    reset_launch_counts()
    for c in cases:
        n, x, idx, e, cap = c["n"], c["x"], c["idx"], c["e"], c["cap"]
        mask = c["mask"].to(torch.int32)
        offs = sorted({0, 1, n - 1, n, c["off"]})
        gather = B.gather_baseline(x, idx)
        seq = B.compress_baseline_sequential(x, c["mask"])
        check(torch.equal(ops.fused_vcompress(c["mask"], x), seq),
              f"N={n}: fused vcompress != sequential baseline")
        routing = md.make_routing(c["logits"], num_experts=e, k=1,
                                  capacity=cap)
        argsort = B.moe_dispatch_argsort_baseline(x, routing.expert_ids, e,
                                                  cap)
        for be in ("kernel", "sparse"):
            check(torch.equal(P.vrgather(x, idx, backend=be), gather),
                  f"N={n}: vrgather on {be} != gather baseline")
            for off in offs:
                for up in (True, False):
                    fn = P.vslideup if up else P.vslidedown
                    check(torch.equal(fn(x, off, backend=be),
                                      B.slide_baseline(x, off, up=up)),
                          f"N={n}: vslide{'up' if up else 'down'} {off} on "
                          f"{be} != log shifter")
            check(torch.equal(P.vcompress(x, mask, backend=be), seq),
                  f"N={n}: vcompress on {be} != sequential baseline")
            check(torch.equal(md.dispatch(x, routing, backend=be), argsort),
                  f"N={n}: top-1 dispatch on {be} != argsort baseline")
        log(f"  N={n}, D={c['d']} f32: vrgather, vslideup/down at offsets "
            f"{offs}, vcompress (fused and both crossbars) and top-1 "
            f"dispatch (E={e}, C={cap}, dropped "
            f"{int((routing.dest < 0).sum())}) on both crossbars equal the "
            "baselines bit for bit")
    torch.cuda.synchronize()
    counts = dict(launch_counts())
    for name in ("crossbar_dense", "crossbar_sparse", "fused_vcompress",
                 "moe_route"):
        check(counts[name] > 0,
              f"kernel {name} was not launched on the baselines path")
    log(f"  baselines path launches {counts}")

    log("baselines phase timing (eager ms a call, CUDA events): unified "
        "dense / tile-skipping crossbar vs separate datapath")
    for c in cases:
        n, x, idx, e, cap = c["n"], c["x"], c["idx"], c["e"], c["cap"]
        mask, off = c["mask"], c["off"]
        routing = md.make_routing(c["logits"], num_experts=e, k=1,
                                  capacity=cap)
        it = 20
        seq_iters = 20 if n <= 256 else 2

        def both(fn):
            return "/".join(f"{time_ms(lambda be=be: fn(be), it):.4f}"
                            for be in ("kernel", "sparse"))

        m32 = mask.to(torch.int32)
        ids = routing.expert_ids
        t = dict(
            gather=both(lambda be: P.vrgather(x, idx, backend=be)),
            gather_b=time_ms(lambda: B.gather_baseline(x, idx), it),
            slide=both(lambda be: P.vslideup(x, off, backend=be)),
            slide_b=time_ms(lambda: B.slide_baseline(x, off, up=True), it),
            comp=both(lambda be: P.vcompress(x, m32, backend=be)),
            fused=time_ms(lambda: ops.fused_vcompress(mask, x), it),
            comp_b=time_ms(lambda: B.compress_baseline_sequential(x, mask),
                           seq_iters),
            disp=both(lambda be: md.dispatch(x, routing, backend=be)),
            disp_b=time_ms(lambda: B.moe_dispatch_argsort_baseline(
                x, ids, e, cap), it))
        log(f"  N={n}, D={c['d']}: vrgather {t['gather']} vs crossbar "
            f"baseline (einsum) {t['gather_b']:.4f}; vslideup {off} "
            f"{t['slide']} vs log shifter ({max(n - 1, 1).bit_length()} "
            f"stages) {t['slide_b']:.4f}; vcompress {t['comp']}, fused "
            f"{t['fused']:.4f} vs sequential {t['comp_b']:.4f} ({n} steps, "
            f"{t['comp_b'] / n * 1e3:.2f} us a step); top-1 dispatch "
            f"{t['disp']} vs argsort {t['disp_b']:.4f}")
    return counts


# Training on the card.  (a) Phi-3.5-MoE at its published width, float32
# master weights and bf16 compute, remat "full" as the config says; depth
# is the one cut: 2 of 32 layers (~2.86 B parameters: with gradients and
# both AdamW moments ~46 GB).  At 512 tokens a sequence capacity_of
# rounds the expert capacity up to 128 (int(1.25 * 512 * 2 / 16) = 80).
# (b) the dense family through launch.train's code path, reduced
# MiniCPM-2B.  (c) MiniCPM-2B at full width cut to 2 of 40 layers:
# prefill and greedy decode against the parallel forward.
TRAIN_LAYERS = 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 4
DENSE_STEPS, DENSE_CKPT_EVERY, DENSE_RESUME_STEPS = 30, 10, 3
DENSE_RESUME_TOL = dict(rtol=1e-5, atol=0.0)
SMOKE_LAYERS, SMOKE_BATCH, SMOKE_PROMPT, SMOKE_NEW = 2, 2, 256, 8


def train_phase(dev):
    """Training through the normal entry points on the card.

    (a) ``model_zoo.build(...).loss_fn`` and ``make_train_step`` on
    Phi-3.5-MoE (see above), 4 steps at batch 4 x 512 from
    ``SyntheticLM``: step 1's loss first again under ``no_grad`` with
    routing from the moe_route kernel and from its plain version on the
    card (routing bit-equal, loss equal); then, counted, the 4 steps:
    finite loss and grad norm each step, moe_route launches = layers x
    (forward + recompute) x steps, and in step 0, whose gradient hook
    takes them, a nonzero gradient on every layer's router and every
    expert weight that received tokens.  Steps 1-3 are timed without the
    checks (their hook records one CUDA event between the gradients and
    the update): step ms, tokens/s and their peak memory.  (b) ``launch.train.main`` on reduced
    MiniCPM-2B with ``SyntheticLM`` data: the loss falls by 0.5 over 30
    steps; the checkpoint of step 30 is restored into a second trainer
    and both go on for 3 steps, their losses equal within
    ``DENSE_RESUME_TOL`` (CUDA's atomic adds in an embedding or scatter
    backward may reorder sums from run to run, so the check does not ask
    for bit-equality; it prints whether they were bit-equal).  (c)
    MiniCPM-2B at full width, 2 layers: ``prefill`` of 2 x 256 tokens and
    8 greedy decode steps against the parallel forward, each logit row
    within ``TOL_BF16``'s rtol in L2.  Returns the counted launches of
    (a).
    """
    import dataclasses
    import tempfile

    import torch

    from repro_torch import _tree
    from repro_torch.configs import minicpm_2b, phi3_5_moe
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import launch_counts, ops, ref
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model_zoo
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.train import TrainOptions, Trainer, make_train_step
    from repro_torch.train.trainer import init_state

    # ------------------------------------------------ (a) Phi-3.5-MoE ---
    cfg = dataclasses.replace(phi3_5_moe.CONFIG, num_layers=TRAIN_LAYERS)
    e_, cap = cfg.num_experts, M.capacity_of(cfg, TRAIN_SEQ)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    api = model_zoo.build(cfg, device=dev)
    secs, params = host_s(lambda: api.init(
        torch.Generator(device=dev).manual_seed(0)))
    n_params = sum(t.numel() for t in _tree.leaves(params))
    log(f"training phase (a): phi3.5-moe, full width, {TRAIN_LAYERS} of "
        f"{phi3_5_moe.CONFIG.num_layers} layers, {n_params / 1e9:.3f} B "
        f"float32 parameters drawn in {secs:.2f} s; batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, E={e_} top-{cfg.num_experts_per_tok}, C={cap}, "
        f"remat={cfg.remat}, dispatch {cfg.dispatch_backend}, compute "
        f"{cfg.compute_dtype}")
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH)
    batches = [{k: v.to(dev) for k, v in data.batch(s).items()}
               for s in range(TRAIN_STEPS)]
    real_route = ops.moe_route_transform
    routed = []

    def route_with(fn):
        def route(ids, **kw):
            out = fn(ids, **kw)
            routed.append(tuple(t.clone() for t in out))
            return out
        return route

    def plain_route(ids, num_experts, capacity):
        shape = ids.shape
        rows = ids.reshape(-1, shape[-2] * shape[-1]).to(torch.int32)
        pos, dest = ref.moe_route_transform(rows, num_experts=num_experts,
                                            capacity=capacity)
        return pos.reshape(shape), dest.reshape(shape)

    losses0 = {}
    try:
        for which, fn in (("kernel", real_route), ("plain", plain_route)):
            routed.clear()
            ops.moe_route_transform = route_with(fn)
            with torch.no_grad():
                losses0[which] = (api.loss_fn(params, batches[0])[0],
                                  list(routed))
    finally:
        ops.moe_route_transform = real_route
    (lk, rk), (lp, rp) = losses0["kernel"], losses0["plain"]
    check(len(rk) == len(rp) == TRAIN_LAYERS and all(
        torch.equal(a, b) for x, y in zip(rk, rp) for a, b in zip(x, y)),
        "training routing: moe_route kernel != its plain version")
    check(torch.equal(lk, lp), f"step 1 loss with kernel routing {float(lk)}"
          f" != with plain routing {float(lp)}")
    log(f"  step 1 loss, no_grad: {float(lk):.6f} with the moe_route kernel "
        "and with its plain version on the card (routing bit-equal, "
        f"{TRAIN_LAYERS} layers)")
    del losses0, rk, rp

    opts = TrainOptions(warmup_steps=0, total_steps=TRAIN_STEPS)
    grad_stats = []

    def check_grads(_, grads):
        grad_stats.append([
            (float(blk["moe"]["router"]["w"].abs().sum()),
             torch.stack([blk["moe"][w].abs().sum(dim=(1, 2))
                          for w in ("wi", "wg", "wo")]).cpu())
            for blk in grads["blocks"]])

    marks = []

    def mark(*_):               # forward + backward enqueued: one event
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()

    # step 0 runs the gradient checks in its hook and is not timed; steps
    # 1.. are timed and only record a CUDA event between the gradients and
    # the update; the profiled step has no hook
    checked = make_train_step(api.loss_fn, opts, grad_hook=check_grads)
    timed = make_train_step(api.loss_fn, opts, grad_hook=mark)
    plain_step = make_train_step(api.loss_fn, opts)
    state = init_state(params, 0)
    del params
    received = []               # step 0's forward: tokens an expert
    calls = [0] * TRAIN_STEPS
    at = [0]

    def record(ids, **kw):
        out = real_route(ids, **kw)
        if at[0] == 0 and calls[0] < TRAIN_LAYERS:
            dest = out[1]
            received.append(torch.bincount(
                (dest[dest >= 0] // cap).flatten(), minlength=e_))
        calls[at[0]] += 1
        return out

    hist = []
    torch.cuda.synchronize()
    reset_launch_counts()
    ops.moe_route_transform = record
    try:
        for s in range(TRAIN_STEPS):
            at[0] = s
            if s == 1:
                torch.cuda.synchronize()
                peak0 = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            state, m = (checked if s == 0 else timed)(state, batches[s])
            end.record()
            m = {k: float(v) for k, v in m.items()}
            m["step_s"] = time.perf_counter() - t0
            if s:
                end.synchronize()
                m["grads_ms"] = start.elapsed_time(marks[-1])
                m["update_ms"] = marks[-1].elapsed_time(end)
            hist.append(m)
    finally:
        ops.moe_route_transform = real_route
    torch.cuda.synchronize()
    counts = dict(launch_counts())
    peak = torch.cuda.max_memory_allocated()
    want = TRAIN_LAYERS * 2 * TRAIN_STEPS
    check(counts["moe_route"] == want,
          f"training launched moe_route {counts['moe_route']} times, not "
          f"{want} (layers x (forward + recompute) x steps)")
    check(calls == [2 * TRAIN_LAYERS] * TRAIN_STEPS,
          f"routing calls a step {calls}, not {2 * TRAIN_LAYERS}")
    for s, m in enumerate(hist):
        check(all(math.isfinite(m[k]) for k in ("loss", "grad_norm", "ce")),
              f"training step {s}: loss {m['loss']} grad norm "
              f"{m['grad_norm']}")
    received = [r.cpu() for r in received]
    for li, (router, experts) in enumerate(grad_stats[0]):
        got = received[li]
        check(router > 0, f"step 0 layer {li}: router gradient is zero")
        zero = [(w, int(ex)) for w, row in zip(("wi", "wg", "wo"), experts)
                for ex in torch.nonzero((row == 0) & (got > 0))[:, 0]]
        check(not zero, f"step 0 layer {li}: zero gradient on expert "
              f"weights that received tokens {zero}")
    check(len(grad_stats) == 1, f"{len(grad_stats)} checked steps")
    tok = TRAIN_BATCH * TRAIN_SEQ
    for s, m in enumerate(hist):
        split = (f"{m['step_s'] * 1e3:.1f} ms ({tok / m['step_s']:.1f} "
                 f"tokens/s; device: forward, recompute and backward "
                 f"{m['grads_ms']:.1f} ms, AdamW {m['update_ms']:.1f} ms)"
                 if s else "gradient checks in the step, not timed")
        log(f"  step {s}: loss {m['loss']:.6f} (ce {m['ce']:.6f}, lb "
            f"{m['lb_loss']:.4f}, z {m['z_loss']:.4f}, dropped "
            f"{m['dropped']:.4f}), grad norm {m['grad_norm']:.4f}, lr "
            f"{m['lr']:.2e}, {split}")
    warm = sorted(m["step_s"] for m in hist[1:])
    med = warm[len(warm) // 2]
    log(f"  phi3.5-moe training: step {med * 1e3:.1f} ms median of steps "
        f"1-{TRAIN_STEPS - 1} ({warm[0] * 1e3:.1f}-{warm[-1] * 1e3:.1f}; "
        f"host clock ending in the metrics' host read), {tok / med:.1f} "
        f"tokens/s at the median ({tok / warm[-1]:.1f}-{tok / warm[0]:.1f});"
        f" max_memory_allocated over steps 1-{TRAIN_STEPS - 1} "
        f"{peak / 2**30:.2f} GiB (step 0 with its checks "
        f"{peak0 / 2**30:.2f} GiB); received tokens a layer and expert "
        f"(step 0) {[r.tolist() for r in received]}; moe_route launches "
        f"{counts['moe_route']}")
    log(f"  step 1's loss in the train step (grad, remat) minus its no_grad "
        f"value: {hist[0]['loss'] - float(lk):.3e}")
    # one more step (and its warm-up) under torch.profiler, after the
    # counters were read
    prof = profile_call(f"phi3.5-moe train step ({TRAIN_BATCH} x "
                        f"{TRAIN_SEQ}, {TRAIN_LAYERS} layers, remat)",
                        lambda: plain_step(state, batches[0]), rows=10)
    gemm = sum(t_ for k, (_, t_) in prof["kernels"].items()
               if "gemm" in k.lower() or "xmma" in k.lower())
    log(f"  matrix-product kernels (names with gemm / xmma) {gemm:.2f} ms "
        f"of {prof['busy_ms']:.2f} ms busy")
    del state, checked, timed, plain_step, batches, grad_stats
    torch.cuda.empty_cache()

    # --------------------------------------------- (b) dense, launcher ---
    log("training phase (b): launch.train on reduced minicpm-2b, "
        "SyntheticLM data")
    with tempfile.TemporaryDirectory() as d:
        out = launch_train.main(
            ["--arch", "minicpm", "--steps", str(DENSE_STEPS), "--data",
             "synthetic", "--lr", "3e-3", "--ckpt-dir", d, "--ckpt-every",
             str(DENSE_CKPT_EVERY)], device=dev, log_fn=lambda s: log("  " + s))
        hist_b = out["history"]
        check(hist_b[-1]["loss"] < hist_b[0]["loss"] - 0.5,
              f"dense loss {hist_b[0]['loss']} -> {hist_b[-1]['loss']}: "
              "fell by less than 0.5")
        tr_a = out["trainer"]
        tr_b = Trainer(tr_a.api, tr_a.options, pipeline=tr_a.pipeline,
                       ckpt_dir=d)
        state_b = tr_b.init_or_restore(0)
        check(int(state_b.step) == DENSE_STEPS,
              f"restored step {int(state_b.step)} != {DENSE_STEPS}")
        same = all(torch.equal(a.detach(), b.detach()) for a, b in zip(
            _tree.leaves(out["state"]), _tree.leaves(state_b)))
        check(same, "the restored state differs from the trainer's")
        _, ha = tr_a.run(out["state"], steps=DENSE_RESUME_STEPS, log_every=0)
        _, hb = tr_b.run(state_b, steps=DENSE_RESUME_STEPS, log_every=0)
    la, lb = [h["loss"] for h in ha], [h["loss"] for h in hb]
    step_b = sorted(h["step_time_s"] for h in hist_b)[len(hist_b) // 2]
    check(all(math.isclose(a, b, rel_tol=DENSE_RESUME_TOL["rtol"],
                           abs_tol=DENSE_RESUME_TOL["atol"])
              for a, b in zip(la, lb)),
          f"resumed losses {lb} != continued {la}")
    log(f"  loss {hist_b[0]['loss']:.4f} -> {hist_b[-1]['loss']:.4f} over "
        f"{DENSE_STEPS} steps; step {DENSE_STEPS} restored, 3 more steps: "
        f"continued {la}, resumed {lb} "
        f"({'bit-equal' if la == lb else f'within {DENSE_RESUME_TOL}'}); "
        f"step {step_b * 1e3:.2f} ms median")
    del out, tr_a, tr_b, state_b

    # ----------------------------------- (c) dense serving, full width ---
    cfg_c = dataclasses.replace(minicpm_2b.CONFIG, num_layers=SMOKE_LAYERS)
    params_c = T.lm_init(torch.Generator(device=dev).manual_seed(1), cfg_c,
                         dev)
    g = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg_c.vocab_size, (SMOKE_BATCH, SMOKE_PROMPT),
                           generator=g, device=dev, dtype=torch.int32)
    max_seq = SMOKE_PROMPT + SMOKE_NEW
    with torch.inference_mode():
        T.prefill(params_c, prompt, cfg_c, max_seq=max_seq)    # warm-up
        t_pre, (logits, caches) = host_s(lambda: T.prefill(
            params_c, prompt, cfg_c, max_seq=max_seq))
        steps_logits = [logits[:, -1]]
        fed = []
        t0 = time.perf_counter()
        for j in range(SMOKE_NEW):
            tok = steps_logits[-1].argmax(-1).to(torch.int32)[:, None]
            fed.append(tok)
            logits, caches = T.decode_step(params_c, tok, caches,
                                           SMOKE_PROMPT + j, cfg_c)
            steps_logits.append(logits[:, -1])
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        full = torch.cat([prompt] + fed, dim=1)
        parallel = T.lm_logits(params_c, T.lm_hidden(params_c, full, cfg_c),
                               cfg_c)
    # logits by the rule moe_phases holds them to: each row within the
    # bf16 rtol in L2 (the elementwise max printed beside it)
    for j, lg in enumerate(steps_logits[:SMOKE_NEW + 1]):
        close_rows(f"minicpm-2b {'prefill' if j == 0 else 'decode'} logits"
                   f" at position {SMOKE_PROMPT - 1 + j} vs the parallel "
                   "forward", lg, parallel[:, SMOKE_PROMPT - 1 + j],
                   TOL_BF16["rtol"])
    agree = sum(int(torch.equal(f[:, 0], parallel[:, SMOKE_PROMPT - 1 + j]
                                .argmax(-1).to(torch.int32)))
                for j, f in enumerate(fed))
    n_c = sum(t.numel() for t in _tree.leaves(params_c))
    log(f"training phase (c): minicpm-2b full width (d_model "
        f"{cfg_c.d_model}, {cfg_c.num_heads} heads, vocab "
        f"{cfg_c.vocab_size}, tied), {SMOKE_LAYERS} of "
        f"{minicpm_2b.CONFIG.num_layers} layers, {n_c / 1e9:.3f} B params: "
        f"prefill {SMOKE_BATCH} x {SMOKE_PROMPT} {t_pre * 1e3:.2f} ms "
        f"(warm), {SMOKE_NEW} greedy decode steps {t_dec / SMOKE_NEW * 1e3:.2f} ms "
        f"a step; greedy tokens equal the parallel argmax at {agree} of "
        f"{SMOKE_NEW} steps")
    del params_c, caches, parallel
    torch.cuda.empty_cache()
    return counts


# Slice 11's phases.  InternVL2-26B at its published width (d_model 6144,
# 48 heads, 8 kv heads, head_dim 128, d_ff 16384 SwiGLU, vocab 92553),
# float32 master weights and bf16 compute; depth is the one cut: 4 of 48
# layers (~2.72 B parameters, ~10.9 GB; all 48 would be ~19.9 B, ~80 GB,
# the whole card).  SeamlessM4T-large-v2 whole: 24 + 24 layers, d_model
# 1024 (~1.64 B parameters, ~6.6 GB).  Four requests each, their frontend
# slots partly valid; the pack at B = 4 takes the tile-skipping crossbar
# under ``auto`` (tile density 0.25), the one at B = 2 runs the dense
# crossbar (``backend="kernel"``; ``auto`` takes the batched contraction
# there, as the reference does).
VLM_LAYERS, VLM_SLOTS, VLM_TEXT = 4, 256, 32
VLM_VALID = (256, 192, 128, 64)
ENCDEC_SLOTS, ENCDEC_VALID = 1024, (1024, 768, 512, 256)
# SeamlessM4T decode logits against the teacher-forced decoder, worst row
# L2 relative error.  bf16 compute: the H100 read 1.08-1.38e-2 and the
# JAX reference on a CPU reads the same order (tests/torch_decode_drift.py);
# a decode step at a wrong position reads far above.  float32 compute:
# the H100 read below 1e-6.
ENCDEC_BF16_DRIFT, ENCDEC_F32_DRIFT = 3e-2, 1e-4
FRONT_NEW = 16
LAUNCH_ARCHS = (("dense", "minicpm-2b"), ("moe", "phi3.5-moe-42b-a6.6b"),
                ("vlm", "internvl2-26b"), ("encdec", "seamless-m4t-large-v2"),
                ("rwkv", "rwkv6-7b"), ("hybrid", "zamba2-2.7b"))


def audit_phase(dev):
    """The fixed-latency audit on the card.

    ``audit_constant_time`` over five regions on fake CUDA tensors — the
    Keccak-f round function, the megakernel Keccak program, an AES-128
    fused round, ``gcm.seal_device_fn(GCM_KEY, 53, 18)`` and the open
    program at (32, 0) — each giving its output's shape; the "leaky"
    (``int()`` of the payload) and "branchy" regions raise
    ``FixedLatencyError``.  No cache holds a fake tensor after them, and
    the same regions then run for real on the card and equal ``hashlib``,
    a plain-Python AES and the host GCM oracle.  ``execute(...,
    fixed_latency=True, audit_host_syncs=True)`` of a registered plan on a
    CUDA payload passes on einsum and on the dense crossbar; on the
    tile-skipping one, with every cache hit re-digested, the guard's copy
    of the schedule to the host raises ``FixedLatencyError``.
    ``int(x.sum())`` under ``no_host_sync()`` raises ``HostSyncError``.  Returns the launch
    counts of the real runs."""
    import torch

    from repro_torch.core import abstract, integrity
    from repro_torch.core import plan_program as pp
    from repro_torch.core import telemetry
    from repro_torch.core.static_registry import FixedLatencyError
    from repro_torch.crypto import aes as TA
    from repro_torch.crypto import gcm as G
    from repro_torch.crypto import keccak as K
    from repro_torch.crypto.registry import registry
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reg = registry(dev)
    TA._ensure_plans(False, True, dev)
    rks = torch.as_tensor(TA.key_expansion(GCM_KEY), dtype=torch.int32,
                          device=dev)
    prog = K.megakernel_program(dev)
    seal_fn, seal_lay = G.seal_device_fn(GCM_KEY, 53, 18, device=dev)
    open_fn, open_lay = G.seal_device_fn(GCM_KEY, 32, 0, open_mode=True,
                                         device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    regions = (
        ("keccak-f1600 round function", K.keccak_f1600, zeros(1600)),
        ("keccak-f1600 megakernel program", lambda x: pp.run_program(
            prog, x, backend="megakernel"), zeros(1600, 4)),
        ("aes128 fused round", lambda s: TA._cipher_state(
            s, rks, inverse=False, fuse_layers=True, backend="einsum"),
         zeros(16, 1)),
        ("gcm seal (53, 18)", seal_fn, zeros(seal_lay["n"], 8)),
        ("gcm open (32, 0)", open_fn, zeros(open_lay["n"], 2)),
    )
    log("audit phase: audit_constant_time on fake CUDA tensors")
    for name, fn, example in regions:
        secs, out = host_s(lambda: reg.audit_constant_time(name, fn, example))
        check(out.shape == tuple(example.shape) and out.dtype == torch.int32,
              f"audit of {name}: output {out}")
        log(f"  {name}: passes, output {out.shape} {out.dtype} "
            f"({secs:.2f} s)")

    def leaky(x):
        return x * int(torch.sum(x))

    def branchy(x):
        return x if torch.sum(x) > 0 else -x

    for name, fn in (("leaky", leaky), ("branchy", branchy)):
        try:
            reg.audit_constant_time(name, fn, zeros(4))
        except FixedLatencyError as e:
            check("host sync" in str(e), f"{name}: {e}")
            log(f"  {name}: FixedLatencyError ({str(e)[:90]}...)")
        else:
            raise AssertionError(f"the {name} region passed the audit")
    fakes = abstract.fake_cache_entries()
    check(not fakes, f"caches hold fake tensors after the audits: {fakes}")
    log("  no cache holds a fake tensor")

    msg = bytes(range(200))
    iv = bytes(range(12))
    pt, aad = bytes(range(53)), bytes(range(100, 118))
    sealed = gcm_oracle(GCM_KEY, iv, pt, aad)
    opened_pt = bytes(range(7, 39))
    opened = gcm_oracle(GCM_KEY, iv, opened_pt, b"")
    block = bytes(range(16))
    torch.cuda.synchronize()
    reset_launch_counts()
    for backend in ("einsum", "megakernel"):
        check(K.sha3_256(msg, backend=backend, device=dev)
              == hashlib.sha3_256(msg).digest(),
              f"sha3_256 on {backend} after the audits != hashlib")
    check(TA.aes128_encrypt(GCM_KEY, block, device=dev)
          == aes128_oracle(GCM_KEY)(block),
          "aes128 after the audit != the plain-Python AES")
    check(G.aes128_gcm_seal(GCM_KEY, iv, pt, aad, device=dev) == sealed,
          "gcm seal (53, 18) after the audit != the host oracle")
    check(G.aes128_gcm_open(GCM_KEY, iv, opened, b"", device=dev)
          == opened_pt, "gcm open (32, 0) after the audit != the plaintext")
    torch.cuda.synchronize()
    counts = dict(launch_counts())
    log(f"  real runs after the audits: sha3_256 (einsum, megakernel) = "
        f"hashlib, aes128 = FIPS-197 oracle, gcm seal (53, 18) and open "
        f"(32, 0) = host oracle; launches {counts}")

    x = torch.randn(1600, 64, device=dev)
    for backend in ("einsum", "kernel"):
        want = reg.execute("keccak/rho_pi", x, backend=backend)
        for _ in range(2):
            got = reg.execute("keccak/rho_pi", x, backend=backend,
                              fixed_latency=True, audit_host_syncs=True)
            check(torch.equal(got, want),
                  f"audited execute on {backend} != unaudited")
    log("  execute(keccak/rho_pi, fixed_latency=True, audit_host_syncs=True)"
        " on a (1600, 64) float32 CUDA payload passes on einsum and kernel "
        "(twice each)")
    # The tile-skipping path fetches its pinned schedule inside the pass;
    # a sampled re-digest of that cache hit copies the schedule to the
    # host (the reference's guard reads np.asarray of the plan's control
    # there too).  Forced on every hit, the audit must see that copy.
    try:
        with integrity.always_verify():
            reg.execute("keccak/rho_pi", x, backend="sparse",
                        fixed_latency=True, audit_host_syncs=True)
    except FixedLatencyError as e:
        check(isinstance(e.__cause__, telemetry.HostSyncError),
              f"sparse audited execute: {e!r} has cause {e.__cause__!r}")
        log(f"  ... on sparse with every cache hit re-digested: "
            f"FixedLatencyError from the integrity guard's copy of the "
            f"schedule to the host ({str(e.__cause__)[:100]}...)")
    else:
        raise AssertionError("the sparse pass's forced re-digest of its "
                             "schedule escaped the host-sync audit")
    try:
        with telemetry.no_host_sync():
            int(x.sum())
    except telemetry.HostSyncError as e:
        log(f"  int(x.sum()) under no_host_sync: HostSyncError "
            f"({str(e)[:80]}...)")
    else:
        raise AssertionError("int(x.sum()) on the card passed no_host_sync")
    check(torch.cuda.get_sync_debug_mode() == 0,
          "no_host_sync left the sync debug mode set")
    return counts


def _valid_mask(counts, slots, rng, dev):
    """(B, slots) bool, row b with counts[b] valid slots at seeded random
    places."""
    import torch
    m = torch.zeros((len(counts), slots), dtype=torch.bool)
    for b, c in enumerate(counts):
        m[b, torch.as_tensor(rng.permutation(slots)[:c])] = True
    return m.to(dev)


def _pack_checks(label, x, valid, compare):
    """The pack of x (B, N, D) by ``valid`` on ``auto``, ``kernel`` and
    ``einsum``: bit-equal; the flattened plan's crossbar kernels against
    their plain versions on its operands.  Returns the auto pack, the
    device ms of the kernel ``auto`` launches (graph replay, the plan and
    schedule built ahead) and the eager ms of the whole pack."""
    import torch

    from repro_torch.core import crossbar as xb
    from repro_torch.core import permute as P
    from repro_torch.core import plan_algebra as pa
    from repro_torch.core import transform as tr
    from repro_torch.kernels import crossbar_permute as xbk
    from repro_torch.kernels import ops, ref
    b, n = valid.shape
    packs = {be: P.vcompress_batched(x, valid, tail="zero", backend=be)
             for be in ("auto", "kernel", "einsum")}
    for be in ("kernel", "einsum"):
        check(torch.equal(packs[be], packs["auto"]),
              f"{label}: pack on {be} != auto")
    plan = pa.batched_scatter_plan(tr.compress_destinations(valid), n)
    compiled = xb.compile_plan(plan)
    x2 = x.reshape(b * n, -1).contiguous()
    args, kw = ops.sparse_operands(plan, x2, compiled=compiled)
    kw["out"].fill_(-7.0)
    kw_p = dict(kw, out=kw["out"].clone())
    compare("crossbar_sparse", f"{label}: tile-skipping kernel vs plain "
            "version", xbk.crossbar_permute_sparse_cuda(*args, **kw),
            ref.crossbar_sparse(*args, **kw_p))
    idxp, xf, kwd = ops.dense_operands(plan, x2)
    compare("crossbar_dense", f"{label}: dense kernel vs plain version",
            xbk.crossbar_permute_cuda(idxp, xf, **kwd),
            ref.crossbar_dense(idxp, xf, **kwd))
    sparse = xb._choose_backend(plan) == "sparse"
    dev_ms = graph_ms((lambda: xbk.crossbar_permute_sparse_cuda(*args, **kw))
                      if sparse else
                      (lambda: xbk.crossbar_permute_cuda(idxp, xf, **kwd)),
                      50)
    eager = time_ms(lambda: P.vcompress_batched(x, valid, tail="zero",
                                                backend="auto"), 20)
    # tail="zero": the valid rows are read, every row is written
    nbytes = (int(valid.sum()) + b * n) * x.shape[-1] * x.element_size()
    bms, _ = bound(nbytes, 0)
    log(f"  {label}: auto (tile density {compiled.density:.4f}: "
        f"{'tile-skipping crossbar' if sparse else 'batched contraction'})"
        f", kernel and einsum packs bit-equal; the "
        f"{'tile-skipping' if sparse else 'dense'} kernel {dev_ms:.4f} ms "
        f"by graph replay against its bound {bms:.5f} ms ({nbytes} B: "
        f"valid rows read, all rows written, at 3.35 TB/s); the whole pack "
        f"{eager:.4f} ms eager")
    return packs["auto"], dev_ms, eager


def vlm_phase(dev, compare):
    """InternVL2-26B at its published width, 4 of 48 layers, on the card:
    4 requests of 256 patch slots (256, 192, 128, 64 valid; seeded
    embeddings x 0.02) and 32 text tokens each.  ``vlm.pack_patches``
    (auto: the tile-skipping crossbar), then ``vlm.prefill`` of the packed
    prefix and the text, then 16 greedy ``decode_step``s — counted; each
    logit row within 1e-2 in L2 of the parallel forward over the same
    tokens.  The pack also on ``kernel`` and ``einsum`` (bit-equal), and
    at B = 2 forced onto ``kernel`` (the dense crossbar: ``auto`` takes the
    batched contraction there).  Returns the counted launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.configs import internvl2_26b
    from repro_torch.core import permute as P
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import layers as L
    from repro_torch.models import params as MP
    from repro_torch.models import transformer as T
    from repro_torch.models import vlm as V

    cfg = dataclasses.replace(internvl2_26b.CONFIG, num_layers=VLM_LAYERS)
    secs, params = host_s(lambda: MP.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev))
    n_params = sum(t.numel() for t in _tree.leaves(params))
    rng = np.random.default_rng(21)
    b = len(VLM_VALID)
    dtype = L.dtype_of(cfg.compute_dtype)
    g = torch.Generator(device=dev).manual_seed(22)
    embeds = (torch.randn((b, VLM_SLOTS, cfg.d_model), generator=g,
                          device=dev) * 0.02).to(dtype)
    valid = _valid_mask(VLM_VALID, VLM_SLOTS, rng, dev)
    text = torch.randint(0, cfg.vocab_size, (b, VLM_TEXT), generator=g,
                         device=dev, dtype=torch.int32)
    log(f"vlm phase: internvl2-26b, full width, {VLM_LAYERS} of "
        f"{internvl2_26b.CONFIG.num_layers} layers, {n_params / 1e9:.3f} B "
        f"float32 parameters drawn in {secs:.2f} s; {b} requests x "
        f"{VLM_SLOTS} patch slots ({VLM_VALID} valid) + {VLM_TEXT} text")
    max_seq = VLM_SLOTS + VLM_TEXT + FRONT_NEW
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.inference_mode():
        packed = V.pack_patches(embeds, valid)
        half = P.vcompress_batched(embeds[:2], valid[:2], tail="zero",
                                   backend="kernel")
        t0 = time.perf_counter()
        logits, caches = V.prefill(params, text, cfg, frontend_embeds=packed,
                                   max_seq=max_seq)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        steps, fed = [logits[:, -1]], []
        t0 = time.perf_counter()
        for j in range(FRONT_NEW):
            tok = steps[-1].argmax(-1).to(torch.int32)[:, None]
            fed.append(tok)
            logits, caches = V.decode_step(params, tok, caches,
                                           VLM_SLOTS + VLM_TEXT + j, cfg)
            steps.append(logits[:, -1])
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0) / FRONT_NEW
    counts = dict(launch_counts())
    check(counts["crossbar_sparse"] >= 1 and counts["crossbar_dense"] >= 1,
          f"vlm path launches {counts}: the B = 4 pack must take the "
          "tile-skipping crossbar and the forced B = 2 kernel pack the "
          "dense crossbar")
    with torch.inference_mode():
        full = torch.cat([text] + fed, dim=1)
        parallel = T.lm_logits(params, T.lm_hidden(
            params, full, cfg, extra_embeds=packed), cfg)
        auto, pack_ms, pack_eager = _pack_checks(
            f"vlm pack B = {b}, ({VLM_SLOTS}, {cfg.d_model}) bf16", embeds,
            valid, compare)
        check(torch.equal(auto, packed), "vlm: pack_patches != its rerun")
        half2, _, _ = _pack_checks(
            f"vlm pack B = 2, ({VLM_SLOTS}, {cfg.d_model}) bf16", embeds[:2],
            valid[:2], compare)
        check(torch.equal(half2, half), "vlm: B = 2 pack != its rerun")
    for j, lg in enumerate(steps[:FRONT_NEW + 1]):
        pos = VLM_SLOTS + VLM_TEXT - 1 + j
        close_rows(f"internvl2 {'prefill' if j == 0 else 'decode'} logits "
                   f"at position {pos} vs the parallel forward", lg,
                   parallel[:, pos], TOL_BF16["rtol"])
    agree = sum(int(torch.equal(f[:, 0], parallel[:, VLM_SLOTS + VLM_TEXT
                                                  - 1 + j].argmax(-1)
                                .to(torch.int32))) for j, f in enumerate(fed))
    def one_step():
        with torch.inference_mode():
            return V.decode_step(params, fed[-1], caches, max_seq - 1, cfg)
    prof = profile_call("internvl2 decode step (4 slots)", one_step, rows=6)
    log(f"  internvl2: pack {pack_ms:.4f} ms device ({pack_eager:.4f} "
        f"eager), prefill {b} x {VLM_SLOTS + VLM_TEXT} {t_pre * 1e3:.2f} ms"
        f" (first call), decode {t_dec * 1e3:.2f} ms a step (mean of "
        f"{FRONT_NEW}), decode step idle share "
        f"{1 - prof['busy_ms'] / prof['wall_ms']:.4f}; greedy tokens equal "
        f"the parallel argmax at {agree} of {FRONT_NEW} steps; launches "
        f"{counts}")
    del params, caches, parallel
    torch.cuda.empty_cache()
    return counts


def encdec_phase(dev, compare):
    """SeamlessM4T-large-v2 whole on the card: 4 requests of 1024 frame
    slots (1024, 768, 512, 256 valid; seeded embeddings x 0.02).
    ``encdec.encode`` packs them (auto: the tile-skipping crossbar on a
    4096-row plan), then ``prime_cross`` and 16 greedy ``decode_step``s
    from BOS 0 — counted, in the config's bf16 compute.  Against the
    teacher-forced parallel decoder over the same tokens, each bf16 logit
    row is held to ``ENCDEC_BF16_DRIFT`` in L2: a bf16 product's rounding
    depends on its row count (a step's 4 rows against the decoder's 64),
    and 24 decoder layers carry that past 1e-2.  The same weights, frames
    and tokens in float32 compute are held to ``ENCDEC_F32_DRIFT``.  The
    pack also on ``kernel`` and ``einsum`` (bit-equal), and at B = 2
    forced onto ``kernel`` (the dense crossbar: ``auto`` takes the
    tile-skipping one there).  Returns the counted launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.configs import seamless_m4t_large_v2
    from repro_torch.core import permute as P
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import encdec as E
    from repro_torch.models import layers as L
    from repro_torch.models import params as MP

    cfg = seamless_m4t_large_v2.CONFIG
    secs, params = host_s(lambda: MP.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev))
    n_params = sum(t.numel() for t in _tree.leaves(params))
    rng = np.random.default_rng(31)
    b = len(ENCDEC_VALID)
    dtype = L.dtype_of(cfg.compute_dtype)
    g = torch.Generator(device=dev).manual_seed(32)
    frames = (torch.randn((b, ENCDEC_SLOTS, cfg.d_model), generator=g,
                          device=dev) * 0.02).to(dtype)
    valid = _valid_mask(ENCDEC_VALID, ENCDEC_SLOTS, rng, dev)
    log(f"encdec phase: seamless-m4t-large-v2 whole ({cfg.encoder_layers} "
        f"+ {cfg.num_layers} layers), {n_params / 1e9:.3f} B float32 "
        f"parameters drawn in {secs:.2f} s; {b} requests x {ENCDEC_SLOTS} "
        f"frame slots ({ENCDEC_VALID} valid)")
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.inference_mode():
        half = P.vcompress_batched(frames[:2], valid[:2], tail="zero",
                                   backend="kernel")
        t0 = time.perf_counter()
        enc = E.encode(params, frames, cfg, frame_valid=valid)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        cross = E.prime_cross(params, enc, cfg, torch.float32)
        caches = E.init_caches(cfg, b, FRONT_NEW, torch.float32, dev)
        tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        steps, fed = [], []
        t0 = time.perf_counter()
        for j in range(FRONT_NEW):
            logits, caches = E.decode_step(params, tok, caches, j, cfg,
                                           cross=cross)
            steps.append(logits[:, -1])
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            fed.append(tok)
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0) / FRONT_NEW
    counts = dict(launch_counts())
    check(counts["crossbar_sparse"] >= 1 and counts["crossbar_dense"] >= 1,
          f"encdec path launches {counts}: the B = 4 pack must take the "
          "tile-skipping crossbar and the forced B = 2 kernel pack the "
          "dense crossbar")
    with torch.inference_mode():
        targets = torch.cat(fed, dim=1)
        hidden = E.decode_hidden(params, targets, enc, cfg)
        parallel = L.logits_projection(params["lm_head"], hidden,
                                       hidden.dtype)
        auto, pack_ms, pack_eager = _pack_checks(
            f"encdec pack B = {b}, ({ENCDEC_SLOTS}, {cfg.d_model}) bf16",
            frames, valid, compare)
        half2, _, _ = _pack_checks(
            f"encdec pack B = 2, ({ENCDEC_SLOTS}, {cfg.d_model}) bf16",
            frames[:2], valid[:2], compare)
        check(torch.equal(half2, half), "encdec: B = 2 pack != its rerun")
    for j, lg in enumerate(steps):
        close_rows(f"seamless bf16 decode logits at step {j} vs the "
                   "teacher-forced parallel decoder", lg, parallel[:, j],
                   ENCDEC_BF16_DRIFT)
    # float32 compute: the same weights, frames and tokens
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.inference_mode():
        enc32 = E.encode(params, frames.float(), cfg32, frame_valid=valid)
        cross32 = E.prime_cross(params, enc32, cfg32, torch.float32)
        caches32 = E.init_caches(cfg32, b, FRONT_NEW, torch.float32, dev)
        parallel32 = L.logits_projection(
            params["lm_head"], E.decode_hidden(params, targets, enc32, cfg32),
            torch.float32)
        tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        for j in range(FRONT_NEW):
            lg, caches32 = E.decode_step(params, tok, caches32, j, cfg32,
                                         cross=cross32)
            close_rows(f"seamless float32 decode logits at step {j} vs the "
                       "teacher-forced parallel decoder", lg[:, -1],
                       parallel32[:, j], ENCDEC_F32_DRIFT)
            tok = fed[j]
    del enc32, cross32, caches32, parallel32
    def one_step():
        with torch.inference_mode():
            return E.decode_step(params, fed[-1], caches, FRONT_NEW - 1, cfg,
                                 cross=cross)
    prof = profile_call("seamless decode step (4 slots)", one_step, rows=6)
    log(f"  seamless: pack {pack_ms:.4f} ms device ({pack_eager:.4f} "
        f"eager), encode {b} x {ENCDEC_SLOTS} {t_enc * 1e3:.2f} ms (first "
        f"call), decode {t_dec * 1e3:.2f} ms a step (mean of {FRONT_NEW}), "
        f"decode step idle share {1 - prof['busy_ms'] / prof['wall_ms']:.4f}"
        f"; launches {counts}")
    del params, caches, cross, enc, parallel
    torch.cuda.empty_cache()
    return counts


def launcher_phase(dev):
    """``launch.serve.main`` on the card: SeamlessM4T-large-v2, RWKV6-7B
    and Zamba2-2.7B at full width with the reference's defaults (4 slots,
    16 new tokens, max_seq 128), then one reduced config of each of the
    six families.  Every token in the padded vocabulary the engine
    samples over.  Returns the launches (counted over all nine runs)."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as launch_serve

    runs = [(f"{fam}, full", arch, ["--full"]) for fam, arch in
            (("encdec", "seamless-m4t-large-v2"), ("rwkv", "rwkv6-7b"),
             ("hybrid", "zamba2-2.7b"))]
    runs += [(f"{fam}, reduced", arch, []) for fam, arch in LAUNCH_ARCHS]
    torch.cuda.synchronize()
    reset_launch_counts()
    for label, arch, extra in runs:
        cfg = get_config(arch) if extra else reduced(get_config(arch))
        secs, outs = host_s(lambda: launch_serve.main(
            ["--arch", arch] + extra, device=dev,
            log_fn=lambda s: log("    " + s)))
        check(len(outs) == 4 and all(
            len(o) == 16 and all(0 <= t < cfg.padded_vocab for t in o)
            for o in outs), f"launch.serve {arch} {extra}: tokens {outs}")
        log(f"  launch.serve --arch {arch} {' '.join(extra)} ({label}): "
            f"{secs:.2f} s, 4 x 16 tokens in [0, {cfg.padded_vocab})")
        torch.cuda.empty_cache()
    counts = dict(launch_counts())
    log(f"  launcher launches {counts}")
    return counts


# Slice 12's phase.  RWKV6-7B (configs/rwkv6_7b.py, arXiv:2404.05892: 32
# layers, d_model 4096, 64 heads of 64, d_ff 14336, vocab 65536; ~7.5 B
# parameters, ~30 GB in float32) and Zamba2-2.7B (configs/zamba2_2_7b.py,
# arXiv:2411.15242: 54 Mamba2 layers, one shared attention block every
# 6th, d_model 2560, 32 heads of 80, d_ff 10240, SSM state 64, head dim
# 64, expand 2, conv 4, vocab 32000; ~2.4 B parameters, ~10 GB), whole,
# float32 master weights and bf16 compute.  Neither reaches a kernel: the
# WKV and SSD chunks, the conv and the shared attention are plain PyTorch,
# as the reference's are plain JAX.
REC_ARCHS = (("rwkv", "rwkv6-7b"), ("hybrid", "zamba2-2.7b"))
REC_BATCH, REC_TOKENS, REC_NEW = 4, 64, 16
REC_PROMPTS = (64, 48, 32, 16)
REC_WINDOW = 32
# Decode logits against the parallel forward, worst row L2 relative error,
# held on the first REC_DRIFT_LAYERS layers of the same weights (RWKV6-7B's
# first 2, Zamba2-2.7B's first group): float32 compute to 1e-4; bf16
# compute to 2x the larger reading of the JAX reference's own bf16 drift
# on a CPU at that depth (tests/torch_decode_drift.py, published widths;
# PERF.md section 6).  The whole model's drift is printed beside its floor,
# the parallel forward of the first REC_FLOOR tokens against that of all
# 64 (no decode step in it): the seeded whole RWKV6-7B amplifies a
# float32 rounding difference about 2x a layer (the reference's package
# as much as the port, on the same weights on a CPU), so on the card its
# parallel forward disagrees with itself by ~0.2 across batch shapes.
REC_DRIFT_LAYERS = {"rwkv": 2, "hybrid": 6}
REC_LIMITS = {"bfloat16": 5.066e-2, "float32": 1e-4}
REC_FLOOR = 4
REC_RING_TOL = dict(rtol=1e-5, atol=1e-5)


def _row_drift(steps, parallel):
    """The worst row's L2 relative error of each step's logits (B, V)
    against the parallel forward's position j, as floats."""
    import torch
    out = []
    for j, lg in enumerate(steps):
        got, want = lg.float(), parallel[:, j].float()
        check(bool(torch.isfinite(got).all()), f"decode step {j}: not finite")
        out.append(float((torch.linalg.vector_norm(got - want, dim=-1)
                          / torch.linalg.vector_norm(want, dim=-1)).max()))
    return out


def _decode_all(api, params, toks, caches):
    """Feed (B, S) tokens through S decode steps; the last-position logits
    of each step."""
    steps = []
    for j in range(toks.shape[1]):
        logits, caches = api.decode_fn(params, toks[:, j:j + 1], caches, j)
        steps.append(logits[:, -1])
    return steps


def _first_layers(family, params, cfg, layers):
    """The model of ``cfg``'s first ``layers`` layers, on the same
    weights (the hybrid's cut at a group boundary)."""
    import dataclasses
    if family == "rwkv":
        cut = dict(params, blocks=params["blocks"][:layers])
    else:
        groups = layers // cfg.shared_attn_period
        cut = dict(params, mamba=params["mamba"][:groups],
                   lora=params["lora"][:groups])
    return cut, dataclasses.replace(cfg, num_layers=layers)


def _state_bytes(caches, batch):
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(caches) if t is not None) / batch


def _drift(M, api, params, toks):
    """Decode against the parallel forward on one model: the per-step
    worst-row drift, the floor (the first ``REC_FLOOR`` tokens' parallel
    forward against the whole sequence's) and the decode steps."""
    import torch
    cfg = api.cfg
    with torch.inference_mode():
        parallel = M.lm_logits(params, M.lm_hidden(params, toks, cfg))
        prefix = M.lm_logits(params, M.lm_hidden(params, toks[:, :REC_FLOOR],
                                                 cfg))
        caches = api.init_caches(REC_BATCH, REC_TOKENS, torch.float32)
        steps = _decode_all(api, params, toks, caches)
    floor = _row_drift(list(prefix.unbind(1)), parallel)
    return _row_drift(steps, parallel), max(floor), steps


def recurrent_phase(dev, smi):
    """RWKV6-7B and Zamba2-2.7B whole at published width on the card, each
    through ``model_zoo.build``, on seeded weights and 4 x 64 seeded
    tokens.  In bf16 and in float32 compute: the tokens through
    ``lm_hidden`` and the logits projection, then through 64 ``decode_step``
    calls, each step's logit rows against the parallel forward's in L2 —
    held to ``REC_LIMITS`` on the first ``REC_DRIFT_LAYERS`` layers of the
    same weights, printed for the whole model beside its floor.
    ``ServingEngine`` answers 4 greedy requests of 64/48/32/16 prompt
    tokens with 16 new tokens each, every token in the padded vocabulary.
    Zamba2's shared-attention ring (``init_caches(..., window=32)``)
    decodes 64 steps, every logit finite in bf16 and float32, its first 32
    float32 steps within ``REC_RING_TOL`` of the unwindowed decode on the
    first group (printed for the whole model).
    Prints the parallel forward's ms, the decode ms a step, its idle share
    and device kernels (``profile_call``) and the decode state bytes a
    slot, each with the card's name and power limit.  The families reach
    no kernel: every counter stays 0.  Returns the counted launches."""
    import dataclasses

    import torch

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import hybrid, model_zoo, rwkv
    from repro_torch.serve import ServeOptions, ServingEngine

    module = {"rwkv": rwkv, "hybrid": hybrid}
    torch.cuda.synchronize()
    reset_launch_counts()
    for family, arch in REC_ARCHS:
        M = module[family]
        cfg = get_config(arch)
        api = model_zoo.build(cfg, device=dev)
        secs, params = host_s(lambda: api.init(
            torch.Generator(device=dev).manual_seed(0)))
        n_params = sum(t.numel() for t in _tree.leaves(params))
        g = torch.Generator(device=dev).manual_seed(61)
        toks = torch.randint(0, cfg.vocab_size, (REC_BATCH, REC_TOKENS),
                             generator=g, device=dev, dtype=torch.int32)
        log(f"recurrent phase: {arch} whole ({cfg.num_layers} layers, "
            f"d_model {cfg.d_model}), {n_params / 1e9:.3f} B float32 "
            f"parameters drawn in {secs:.2f} s; {REC_BATCH} x {REC_TOKENS} "
            "tokens")

        def forward():
            return M.lm_logits(params, M.lm_hidden(params, toks, cfg))

        with torch.inference_mode():
            first, _ = host_s(forward)
            fwd_ms = time_ms(forward, 3)
            caches = api.init_caches(REC_BATCH, REC_TOKENS, torch.float32)
            t_dec, _ = host_s(lambda: _decode_all(api, params, toks, caches))

        layers = REC_DRIFT_LAYERS[family]
        cut, cut_cfg = _first_layers(family, params, cfg, layers)
        steps32 = {}
        for compute, limit in REC_LIMITS.items():
            whole_api = model_zoo.build(
                dataclasses.replace(cfg, compute_dtype=compute), device=dev)
            cut_api = model_zoo.build(
                dataclasses.replace(cut_cfg, compute_dtype=compute),
                device=dev)
            drift, floor, steps = _drift(M, whole_api, params, toks)
            cut_drift, cut_floor, cut_steps = _drift(M, cut_api, cut, toks)
            check(max(cut_drift) <= limit,
                  f"{arch} {compute} decode, first {layers} layers: worst "
                  f"row L2 relative error {max(cut_drift)} > {limit}")
            log(f"  {arch} {compute} decode vs the parallel forward, worst "
                f"row L2 relative error a step: first {layers} layers max "
                f"{max(cut_drift):.3e} (step "
                f"{cut_drift.index(max(cut_drift))}; <= {limit}; floor "
                f"{cut_floor:.3e}); whole model max {max(drift):.3e} (step "
                f"{drift.index(max(drift))}), last {drift[-1]:.3e}, floor "
                f"{floor:.3e} ({smi})")
            if compute == "float32":
                steps32 = {"whole": (whole_api, params, steps),
                           "cut": (cut_api, cut, cut_steps)}

        if family == "hybrid":
            # The ring against the full cache: every logit finite in both
            # precisions; the first REC_WINDOW float32 steps held on the
            # first group, printed for the whole model (only the
            # attention's key length differs, and the seeded model
            # amplifies a float32 rounding difference with depth).
            with torch.inference_mode():
                ring = _decode_all(api, params, toks, api.init_caches(
                    REC_BATCH, REC_TOKENS, torch.float32, window=REC_WINDOW))
                diffs = {}
                for name, (a, p, full) in steps32.items():
                    ring32 = _decode_all(a, p, toks, a.init_caches(
                        REC_BATCH, REC_TOKENS, torch.float32,
                        window=REC_WINDOW))
                    check(all(bool(torch.isfinite(t).all())
                              for t in ring + ring32),
                          f"{arch} ring of {REC_WINDOW} ({name}): a logit "
                          "not finite")
                    diffs[name] = [float((r - f).abs().max())
                                   for r, f in zip(ring32, full)]
                    if name == "cut":
                        for j in range(REC_WINDOW):
                            check(torch.allclose(ring32[j], full[j],
                                                 **REC_RING_TOL),
                                  f"{arch} ring step {j}, first {layers} "
                                  f"layers: max |diff| {diffs[name][j]} "
                                  "from the unwindowed decode, outside "
                                  f"{REC_RING_TOL}")
            log(f"  {arch} ring of {REC_WINDOW}: {REC_TOKENS} steps finite "
                f"(bf16 and float32); the first {REC_WINDOW} float32 steps' "
                f"max |diff| from the unwindowed decode: first {layers} "
                f"layers {max(diffs['cut'][:REC_WINDOW]):.3e} "
                f"({REC_RING_TOL}), whole model "
                f"{max(diffs['whole'][:REC_WINDOW]):.3e}; after the wrap "
                f"{max(diffs['whole'][REC_WINDOW:]):.3e} ({smi})")
            del ring, ring32
        del steps32, cut

        prompts = [toks[i, :n].tolist() for i, n in enumerate(REC_PROMPTS)]
        engine = ServingEngine(api, ServeOptions(batch_slots=REC_BATCH,
                                                 max_new_tokens=REC_NEW),
                               max_seq=REC_TOKENS + REC_NEW)
        t_serve, outs = host_s(lambda: engine.generate(
            params, prompts, generator=torch.Generator(device=dev)))
        check(len(outs) == REC_BATCH and all(
            len(o) == REC_NEW and all(0 <= t < cfg.padded_vocab for t in o)
            for o in outs), f"{arch} serving: tokens {outs}")
        n_steps = max(REC_PROMPTS) - 1 + REC_NEW
        log(f"  {arch} serving: {REC_BATCH} greedy requests of "
            f"{REC_PROMPTS} prompt tokens, {REC_NEW} new each in [0, "
            f"{cfg.padded_vocab}): {t_serve:.2f} s, {n_steps} decode steps, "
            f"{REC_BATCH * REC_NEW / t_serve:.1f} new tokens/s ({smi})")
        del engine

        def one_step():
            with torch.inference_mode():
                return api.decode_fn(params, toks[:, -1:], caches,
                                     REC_TOKENS - 1)
        prof = profile_call(f"{arch} decode step ({REC_BATCH} slots)",
                            one_step, rows=6)
        kernels = sum(c for c, _ in prof["kernels"].values())
        state = _state_bytes(caches, REC_BATCH)
        kv = _state_bytes([caches.get("attn_k"), caches.get("attn_v")],
                          REC_BATCH)
        log(f"  {arch}: parallel forward {REC_BATCH} x {REC_TOKENS} "
            f"{first * 1e3:.2f} ms (first call), {fwd_ms:.2f} ms (warm, CUDA "
            f"events); decode {t_dec * 1e3 / REC_TOKENS:.2f} ms a step (mean "
            f"of {REC_TOKENS}), idle share "
            f"{1 - prof['busy_ms'] / prof['wall_ms']:.4f}, {kernels} device "
            f"kernels a step; decode state {state / 2**20:.2f} MiB a slot "
            f"in float32 caches ({(state - kv) / 2**20:.2f} MiB recurrent, "
            f"constant in length; {kv / 2**20:.2f} MiB of K/V at "
            f"{REC_TOKENS} positions) ({smi})")
        del params, caches
        torch.cuda.empty_cache()
    counts = dict(launch_counts())
    check(sum(counts.values()) == 0, f"recurrent path launches {counts}: "
          "rwkv and hybrid reach no kernel")
    log(f"  recurrent launches {counts}")
    return counts


# Slice 14: the vlm, encdec, rwkv and hybrid families train on the card.
# (a) Published width, float32 master weights, the config's bf16 compute,
# remat "full" and AdamW; depth is the one cut (None: whole).  RWKV6-7B 2
# of 32 layers (~0.94 B parameters, ~15 GB with gradients and moments),
# Zamba2-2.7B 12 of 54 (two groups: the shared block sums both groups'
# gradients; ~0.77 B), InternVL2-26B 2 of 48 (~1.94 B, ~31 GB; its two
# vocabulary tables are ~1.14 B), SeamlessM4T-large-v2 whole (24 + 24
# layers, ~1.64 B).  Batch 4 x 512 from ``api.make_batch``: InternVL2 256
# patch slots (~0.9 valid) + 256 text tokens, SeamlessM4T 256 frames +
# 256 tokens.  (b) The card against the CPU, float32 compute with TF32
# off: one layer (the hybrid one group, encdec one encoder and one
# decoder layer), 1 x 64 text tokens (InternVL2 + 256 patch slots,
# SeamlessM4T + 64 frames).  (c) ``launch.train.main`` on each reduced
# config, a checkpoint at step 10 of 12, a resume.
FAMILY_TRAIN = (("rwkv", "rwkv6-7b", 2), ("hybrid", "zamba2-2.7b", 12),
                ("vlm", "internvl2-26b", 2),
                ("encdec", "seamless-m4t-large-v2", None))
FAM_BATCH, FAM_SEQ, FAM_STEPS = 4, 512, 4
FAM_CMP_SEQ = {"vlm": 256 + 64, "encdec": 2 * 64}    # make_batch's seq
FAM_CMP_TEXT = 64
FAM_LOSS_RTOL, FAM_GRAD_L2 = 1e-5, 1e-4
FAM_LAUNCH_STEPS, FAM_LAUNCH_CKPT, FAM_RESUME_STEPS = 12, 10, 3


def init_zero_grad(family, path):
    """A leaf whose gradient is zero by construction at init: the
    hybrid's LoRA ``a`` (each LoRA's ``b`` starts at zero)."""
    return family == "hybrid" and path[0] == "lora" and path[-1] == "a"


def host_rss_gib():
    """(current, peak) resident set of this process in GiB."""
    import resource
    with open("/proc/self/status") as f:
        rss = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS:"))
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return rss / 2**20, peak / 2**20


def train_families_phase(dev, compare):
    """The vlm, encdec, rwkv and hybrid families train on the card through
    ``model_zoo.build(...).loss_fn``, ``make_train_step``, ``Trainer`` and
    ``launch.train`` (the families above), one family at a time with the
    card emptied between them: (a) ``family_steps``, (b)
    ``family_vs_cpu``, (c) ``family_launcher``.  Returns the counted
    launches of all three.
    """
    total, rows = {}, []
    for family, arch, layers in FAMILY_TRAIN:
        counts, row = family_steps(dev, compare, family, arch, layers)
        add_counts(total, counts)
        rows.append(row)
    for family, arch, _ in FAMILY_TRAIN:
        add_counts(total, family_vs_cpu(dev, family, arch))
    for _, arch, _ in FAMILY_TRAIN:
        add_counts(total, family_launcher(dev, arch))
    for arch, ms, tps, gib, adamw, idle, kernels in rows:
        log(f"  train_families {arch}: step {ms:.1f} ms, {tps:.1f} tokens/s, "
            f"peak {gib:.2f} GiB, AdamW {adamw:.1f} ms, idle share "
            f"{idle:.4f}, {kernels} kernels a step")
    log(f"  train_families launches {total}")
    return total


def family_steps(dev, compare, family, arch, layers):
    """(a) ``FAM_STEPS`` train steps at ``FAM_BATCH`` x ``FAM_SEQ``,
    counted: finite loss and grad norm each step; in step 0's gradient
    hook a nonzero gradient on every leaf but the ones zero by
    construction at init (``init_zero_grad``), which the last step's hook
    finds nonzero; InternVL2's patch pack on the tile-skipping crossbar
    once a forward (the pack is outside the checkpointed layers, so the
    recompute adds none), step 0's packed embeddings bit-equal to the
    plain version's; no kernel launched by the other families.  Steps
    1.. timed: step ms, tokens/s, peak memory, AdamW ms by a CUDA event;
    one more step profiled (idle share, device kernels a step).  Returns
    the counted launches and (arch, step ms, tokens/s, peak GiB, AdamW
    ms, idle share, kernels a step)."""
    import dataclasses

    import torch

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.core import permute as P
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model_zoo
    from repro_torch.models import vlm as V
    from repro_torch.train import TrainOptions, make_train_step
    from repro_torch.train.trainer import init_state

    t_fam = time.perf_counter()
    base = get_config(arch)
    cfg = dataclasses.replace(base, num_layers=layers) if layers else base
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    api = model_zoo.build(cfg, device=dev)
    secs, params = host_s(lambda: api.init(
        torch.Generator(device=dev).manual_seed(0)))
    n_params = sum(t.numel() for t in _tree.leaves(params))
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [api.make_batch(gen, FAM_BATCH, FAM_SEQ)
               for _ in range(FAM_STEPS)]
    shapes = {k: tuple(v.shape) for k, v in batches[0].items()}
    log(f"train_families (a): {arch}, full width, {cfg.num_layers} of "
        f"{base.num_layers} layers"
        f"{f' + {cfg.encoder_layers} encoder' if cfg.encoder_layers else ''}"
        f", {n_params / 1e9:.3f} B float32 parameters drawn in {secs:.2f} s;"
        f" batch {shapes}, remat={cfg.remat}, compute {cfg.compute_dtype}")
    paths = [p for p, _ in _tree.leaves_with_path(params)]
    nonzero, marks = {}, []

    def nonzero_at(step):
        def hook(_, grads):           # enqueued: read after the step
            nonzero[step] = torch.stack(
                [g.ne(0).any() for g in _tree.leaves(grads)])
        return hook

    def mark(*_):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()

    def mark_and_check(p, g):
        mark()
        nonzero_at(FAM_STEPS - 1)(p, g)

    # step 0 checks its gradients and is not timed; steps 1.. record a CUDA
    # event between the gradients and the update, the last also checks
    # the leaves that were zero at init
    opts = TrainOptions(warmup_steps=0, total_steps=FAM_STEPS)
    steps = ([make_train_step(api.loss_fn, opts, grad_hook=nonzero_at(0))]
             + [make_train_step(api.loss_fn, opts, grad_hook=mark)]
             * (FAM_STEPS - 2)
             + [make_train_step(api.loss_fn, opts, grad_hook=mark_and_check)])
    state = init_state(params, 0)
    del params
    packs = []
    real_pack = V.pack_patches

    def capture(x, valid):
        out = real_pack(x, valid)
        if not packs:
            packs.append((x, valid, out))
        return out

    hist = []
    torch.cuda.synchronize()
    reset_launch_counts()
    V.pack_patches = capture
    try:
        for s, step in enumerate(steps):
            if s == 1:
                torch.cuda.synchronize()
                peak0 = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            state, m = step(state, batches[s])
            end.record()
            m = {k: float(v) for k, v in m.items()}
            m["step_s"] = time.perf_counter() - t0
            if s:
                end.synchronize()
                m["grads_ms"] = start.elapsed_time(marks[-1])
                m["update_ms"] = marks[-1].elapsed_time(end)
            hist.append(m)
    finally:
        V.pack_patches = real_pack
    torch.cuda.synchronize()
    counts = dict(launch_counts())
    peak = torch.cuda.max_memory_allocated()
    for s, m in enumerate(hist):
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"{arch} step {s}: loss {m['loss']} grad norm {m['grad_norm']}")
    first = nonzero[0].cpu().tolist()
    last = nonzero[FAM_STEPS - 1].cpu().tolist()
    excepted = [p for p in paths if init_zero_grad(family, p)]
    zero = [p for p, nz in zip(paths, first)
            if not nz and not init_zero_grad(family, p)]
    check(not zero, f"{arch} step 0: zero gradient on {zero}")
    still = [p for p, nz in zip(paths, last)
             if not nz and init_zero_grad(family, p)]
    check(not still, f"{arch} step {FAM_STEPS - 1}: the leaves zero at init "
          f"still have zero gradient: {still}")
    zero_at_init = [p for p, nz in zip(paths, first)
                    if not nz and init_zero_grad(family, p)]
    want = {}
    if family == "vlm":
        want = {"crossbar_sparse": FAM_STEPS}
        x, valid, out = packs[0]
        plain = P.vcompress_batched(x.cpu(), valid.cpu(), tail="zero",
                                    backend="sparse")
        compare("crossbar_sparse", f"{arch} train step 0: the patch pack "
                f"{tuple(x.shape)} {x.dtype} (tile-skipping kernel) vs its "
                "plain version", out, plain.to(dev))
    check({k: v for k, v in counts.items() if v} == want,
          f"{arch} training launches {counts}, not {want}")
    tok = FAM_BATCH * FAM_SEQ
    for s, m in enumerate(hist):
        split = (f"{m['step_s'] * 1e3:.1f} ms (device: forward, recompute "
                 f"and backward {m['grads_ms']:.1f} ms, AdamW "
                 f"{m['update_ms']:.1f} ms)" if s else
                 "gradient checks in the step, not timed")
        log(f"  step {s}: loss {m['loss']:.6f}, grad norm "
            f"{m['grad_norm']:.4f}, lr {m['lr']:.2e}, {split}")
    warm = sorted(m["step_s"] for m in hist[1:])
    med = warm[len(warm) // 2]
    adamw = sorted(m["update_ms"] for m in hist[1:])
    plain_step = make_train_step(api.loss_fn, opts)
    prof = profile_call(f"{arch} train step ({FAM_BATCH} x {FAM_SEQ})",
                        lambda: plain_step(state, batches[0]), rows=8)
    kernels = sum(c for c, _ in prof["kernels"].values())
    idle = 1 - prof["busy_ms"] / prof["wall_ms"]
    log(f"  {arch} training: step {med * 1e3:.1f} ms median of steps "
        f"1-{FAM_STEPS - 1} ({warm[0] * 1e3:.1f}-{warm[-1] * 1e3:.1f}), "
        f"{tok / med:.1f} tokens/s ({tok} positions a step); AdamW "
        f"{adamw[0]:.1f}-{adamw[-1]:.1f} ms; max_memory_allocated over steps"
        f" 1-{FAM_STEPS - 1} {peak / 2**30:.2f} GiB (step 0 with its checks "
        f"{peak0 / 2**30:.2f} GiB); a profiled step: idle share {idle:.4f}, "
        f"{kernels} device kernels; every gradient leaf of {len(paths)} "
        f"nonzero at step 0 but the leaves zero by construction at init "
        f"{excepted} (zero at step 0: {zero_at_init}), nonzero at step "
        f"{FAM_STEPS - 1}; launches {counts}; "
        f"{time.perf_counter() - t_fam:.1f} s")
    del state, steps, plain_step, batches, packs, nonzero
    torch.cuda.empty_cache()
    return counts, (arch, med * 1e3, tok / med, peak / 2**30,
                    adamw[len(adamw) // 2], idle, kernels)


def family_vs_cpu(dev, family, arch):
    """(b) One layer (the hybrid one group; encdec one encoder and one
    decoder layer) at published width, float32 compute: loss and every
    gradient of the card (TF32 off) against the CPU from the same weights
    and batch, the loss within ``FAM_LOSS_RTOL``, each leaf within
    ``FAM_GRAD_L2`` of the CPU's in relative L2; the host's resident
    memory.  Returns the counted launches of the card's side."""
    import dataclasses

    import torch

    from repro_torch import _tree
    from repro_torch._device import no_tf32
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model_zoo
    from repro_torch.models import params as MP

    t_fam = time.perf_counter()
    base = get_config(arch)
    one = dict(num_layers=base.shared_attn_period or 1,
               compute_dtype="float32")
    if family == "encdec":
        one["encoder_layers"] = 1
    cfg = dataclasses.replace(base, **one)
    torch.cuda.empty_cache()
    api = model_zoo.build(cfg, device=dev)
    params = api.init(torch.Generator(device=dev).manual_seed(2))
    batch = api.make_batch(torch.Generator(device=dev).manual_seed(3), 1,
                           FAM_CMP_SEQ.get(family, FAM_CMP_TEXT))
    shapes = {k: tuple(v.shape) for k, v in batch.items()}

    def loss_and_grads(a, p, b):
        leaves = _tree.leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = a.loss_fn(p, b)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    torch.cuda.synchronize()
    reset_launch_counts()
    with no_tf32():
        loss_d, grads_d = loss_and_grads(api, params, batch)
        torch.cuda.synchronize()
    counts = dict(launch_counts())
    params_c = MP.to_device(_tree.tree_map(lambda t: t.detach(), params),
                            "cpu")
    del params
    t_cpu = time.perf_counter()
    loss_c, grads_c = loss_and_grads(
        model_zoo.build(cfg, device="cpu"), params_c,
        {k: v.cpu() for k, v in batch.items()})
    t_cpu = time.perf_counter() - t_cpu
    rss, rss_peak = host_rss_gib()
    rel_loss = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    check(rel_loss <= FAM_LOSS_RTOL, f"{arch}: card loss {float(loss_d)} vs "
          f"CPU {float(loss_c)}: {rel_loss:.3e} > {FAM_LOSS_RTOL}")
    worst, worst_path = 0.0, None
    paths = [p for p, _ in _tree.leaves_with_path(params_c)]
    for path, gd, gc in zip(paths, grads_d, grads_c):
        norm = float(torch.linalg.vector_norm(gc.double()))
        diff = float(torch.linalg.vector_norm(gd.cpu().double()
                                              - gc.double()))
        check(math.isfinite(diff), f"{arch}: gradient {path} not finite")
        if norm == 0.0:
            check(diff == 0.0, f"{arch}: gradient {path} zero on the CPU, "
                  f"{diff} on the card")
            continue
        if diff / norm > worst:
            worst, worst_path = diff / norm, path
        check(diff / norm <= FAM_GRAD_L2, f"{arch}: gradient {path} relative"
              f" L2 {diff / norm:.3e} > {FAM_GRAD_L2}")
    log(f"train_families (b): {arch} published width, one "
        f"{'group' if family == 'hybrid' else 'layer'}"
        f"{' each side' if family == 'encdec' else ''}, float32, batch "
        f"{shapes}: loss card {float(loss_d):.7f} CPU {float(loss_c):.7f} "
        f"({rel_loss:.3e} relative); {len(paths)} gradient leaves, worst "
        f"relative L2 {worst:.3e} at {worst_path}; CPU forward and backward "
        f"{t_cpu:.1f} s; host RSS {rss:.2f} GiB (peak {rss_peak:.2f}); "
        f"launches {counts}; {time.perf_counter() - t_fam:.1f} s")
    del grads_d, grads_c, params_c
    torch.cuda.empty_cache()
    return counts


def family_launcher(dev, arch):
    """(c) ``launch.train.main`` with ``device=None`` (the card) on the
    reduced config: ``FAM_LAUNCH_STEPS`` steps, a checkpoint at step
    ``FAM_LAUNCH_CKPT`` restored into a second trainer, whose
    ``FAM_RESUME_STEPS`` steps' losses equal the first trainer's at the
    same steps within ``DENSE_RESUME_TOL`` (bit-equality printed).
    Returns the counted launches."""
    import tempfile

    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as launch_train
    from repro_torch.train import Trainer

    t_fam = time.perf_counter()
    torch.cuda.synchronize()
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as d:
        out = launch_train.main(
            ["--arch", arch, "--steps", str(FAM_LAUNCH_STEPS), "--ckpt-dir",
             d, "--ckpt-every", str(FAM_LAUNCH_CKPT)],
            device=None, log_fn=lambda s: log("    " + s))
        tr_a, hist = out["trainer"], out["history"]
        check(tr_a.api.device == dev, f"{arch}: launch.train ran on "
              f"{tr_a.api.device}, not the card")
        check(all(math.isfinite(h["loss"]) for h in hist),
              f"{arch}: launch.train losses {[h['loss'] for h in hist]}")
        tr_b = Trainer(tr_a.api, tr_a.options, pipeline=tr_a.pipeline,
                       ckpt_dir=d)
        state_b = tr_b.init_or_restore(0)
        check(int(state_b.step) == FAM_LAUNCH_CKPT,
              f"{arch}: restored step {int(state_b.step)}")
        _, ha = tr_a.run(out["state"], steps=FAM_RESUME_STEPS, log_every=0)
        _, hb = tr_b.run(state_b, steps=FAM_RESUME_STEPS, log_every=0)
    torch.cuda.synchronize()
    counts = dict(launch_counts())
    # the first trainer's steps 10, 11 from its run, 12 from the 3 more
    la = [h["loss"] for h in (hist + ha)[FAM_LAUNCH_CKPT:]][:FAM_RESUME_STEPS]
    lb = [h["loss"] for h in hb]
    check(len(la) == len(lb) and all(
        math.isclose(a, b, rel_tol=DENSE_RESUME_TOL["rtol"],
                     abs_tol=DENSE_RESUME_TOL["atol"])
        for a, b in zip(la, lb)),
        f"{arch}: resumed losses {lb} != the first trainer's {la}")
    log(f"train_families (c): launch.train --arch {arch} (reduced) on the "
        f"card: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} over "
        f"{FAM_LAUNCH_STEPS} steps; step {FAM_LAUNCH_CKPT} restored into a "
        f"second trainer, steps {FAM_LAUNCH_CKPT}-"
        f"{FAM_LAUNCH_CKPT + FAM_RESUME_STEPS - 1}: first {la}, resumed {lb} "
        f"({'bit-equal' if la == lb else f'within {DENSE_RESUME_TOL}'}); "
        f"launches {counts}; {time.perf_counter() - t_fam:.1f} s")
    del out, tr_a, tr_b, state_b
    torch.cuda.empty_cache()
    return counts


# Slice 13: a model's state over a mesh.  (a) Phi-3.5-MoE at its published
# width, 1 of 32 layers (1.569 B parameters: 6.27 GB of float32 weights,
# 18.82 GB with both AdamW moments), its TrainState placed by
# ``param_shardings`` on make_host_mesh(data=2, model=2), four shards of
# the card, and trained 2 steps at 4 x 512 by the sharded executor against
# the single-device make_train_step from the same state and batches.  The
# card holds the single-device state and the four shards at once (2 x
# 18.82 GB) and, in a sharded step, the gathered layer, its gradient and
# the float32 accumulators (~3 x 6 GB: the one layer is most of the
# model): ~60 GB with the activations, inside 80 GB, so the batch stays
# 4 x 512.  (b) MiniCPM-2B
# at its published width, 2 of 40 layers: a prompt of 4 x 64 prefilled on
# one device, its caches placed by ``cache_shardings``, then 8 greedy
# decode steps sharded against single-device ``decode_fn``.  (c) The dry
# runs on the 16 x 16 mesh of placeholders, and (a)'s own cell on (a)'s
# mesh of placeholders.
SHARD_LAYERS, SHARD_BATCH, SHARD_SEQ, SHARD_STEPS = 1, 4, 512, 2
SHARD_PARAM_TOL = dict(rtol=2e-4, atol=2e-5)      # the reference test's
SHARD_DEC_LAYERS, SHARD_DEC_PROMPT, SHARD_DEC_STEPS = 2, 64, 8
DRYRUN_CELLS = (("phi3.5-moe-42b-a6.6b", "train_4k"),
                ("minicpm-2b", "decode_32k"),
                ("seamless-m4t-large-v2", "prefill_32k"),
                ("internvl2-26b", "train_4k"),
                ("zamba2-2.7b", "prefill_32k"))
# The bar each cell's peak a device (GiB) meets: the CPU dry runs read
# 7.705 (seamless prefill_32k) and 2.731 (internvl2 train_4k) once their
# layers split over "model" (115.400 and 20.803 computed whole), and
# 58.010 (zamba2 prefill_32k: 903.082 whole, its shared block's scores
# of all 32 heads at once).  RWKV6-7B's cells are not here: its WKV chunk
# loop runs 256 chunks a layer at train_4k under ``FakeTensorMode``, 26
# min on a CPU for the memory run alone (``launch.dryrun --skip-cost``).
DRYRUN_PEAK_GIB = {"phi3.5-moe-42b-a6.6b": 40.0, "minicpm-2b": 25.0,
                   "seamless-m4t-large-v2": 10.0, "internvl2-26b": 5.0,
                   "zamba2-2.7b": 60.0}
# (d) A model that only a layer-at-a-time executor can hold on the card.
# Mixtral-8x22B at its published width, 5 of 56 layers (2.504 B
# parameters a layer; 12.92 B, 48.1 GiB of float32 weights, one copy in
# shards over (2, 2) of the card), seeded, float32 master and bf16
# compute: greedy decode of 4 slots x (16 prompt + 16 new) tokens at a
# window of 32 (``MIXTRAL_WINDOW``), single-device ``decode_fn`` first
# (the whole model, ~57 GiB), then the weights placed a leaf at a time
# and the same decode through ``sharded_decode_step`` (the shards, one
# layer gathered and its casts: ~69 GiB; a whole-tree gather beside the
# shards would need ~96 GiB more).
SHARD_MIX_LAYERS, SHARD_MIX_SLOTS = 5, 4
SHARD_MIX_PROMPT, SHARD_MIX_NEW = 16, 16
# (e) InternVL2-26B at its published width, 1 of 48 layers (1.55 B
# parameters, 18.6 GB with both AdamW moments, held twice: the single
# device's state and the shards), trained 2 steps at 8 x 512 from
# ``make_batch`` (256 patch slots, ~90 % valid, + 256 text tokens) over
# (2, 2) of the card: each data window holds the 4 rows at which ``auto``
# packs on the tile-skipping crossbar, once a rank of its row a forward.
SHARD_VLM_LAYERS, SHARD_VLM_BATCH, SHARD_VLM_SEQ = 1, 8, 512
# (f) SeamlessM4T-large-v2 whole (24 + 24 layers): 4 requests of 256
# frames encoded and their cross K/V primed on one device, then 8 greedy
# decode steps from BOS on one device and over (2, 2) of the card.
SHARD_ENC_SLOTS, SHARD_ENC_FRAMES, SHARD_ENC_STEPS = 4, 256, 8
# (g) Zamba2-2.7B at its published width, 12 of 54 layers (2 groups: two
# applications of the shared block, 12 Mamba2 layers; ~0.77 B parameters,
# 9.3 GB with both AdamW moments), remat "full" as published, trained 2
# steps at 4 x 512 from ``make_batch`` over (2, 2) of the card from one
# state and batches, in the published bf16 and in float32.  The float32
# step on one device is the witness: the float32 split is held to it
# (``held_to_single``), the bf16 split is held to it as far as one bf16
# device is (``held_to_witness``): two bf16 runs round differently (a
# data window's 1024 rows alone move the embedding's first moment 1.6e-2
# in L2 from one device's 2048, past ``TOL_BF16``), so a bf16 split's
# distance from the witness is held to ``SHARD_WITNESS_RATIO`` times one
# bf16 device's, plus ``SHARD_WITNESS_FLOOR`` (``DENSE_RESUME_TOL``'s
# rtol: a float32 agreement).  The ratio: on the H100 the split's first
# moments lie at most 1.18x, its parameters 1.51x and its losses 0.72x
# (of one device's largest) as far from the witness as one device's
# (``tests/torch_hybrid_bf16_split.py``).  (h) The same 12 layers in bf16: 8 greedy
# decode steps of 4 slots on one device and over (2, 2).
SHARD_HYB_LAYERS, SHARD_HYB_BATCH, SHARD_HYB_SEQ = 12, 4, 512
SHARD_HYB_SLOTS, SHARD_HYB_STEPS = 4, 8
# (i) RWKV6-7B at its published width, 4 of 32 layers (~1.42 B
# parameters, untied embedding and head: 5.7 GB float32, 17.0 GB with
# both AdamW moments), remat "full" as published, trained 2 steps at 4 x
# 512 over (2, 2) of the card as (g) trains Zamba2 (the float32 witness,
# ``held_to_single`` and ``held_to_witness``).  (j) The same 4 layers in
# bf16: 8 greedy decode steps of 4 slots on one device and over (2, 2).
SHARD_RWKV_LAYERS, SHARD_RWKV_BATCH, SHARD_RWKV_SEQ = 4, 4, 512
SHARD_RWKV_SLOTS, SHARD_RWKV_STEPS = 4, 8
SHARD_WITNESS_RATIO, SHARD_WITNESS_FLOOR = 3.0, 1e-5
ALLOC_GRANULE = 512        # the CUDA caching allocator rounds to 512 bytes


# The eight scripts of examples_torch/, each the port of its counterpart in
# examples/.  Their own assertions hold what they compute (digests against
# hashlib, the FIPS-197 and NIST GCM vectors, InvalidTagError(3,), the
# drift report); the phase holds their kernel launches.
EXAMPLES = ("quickstart", "paper_fig1_demo", "crypto_hash", "crypto_block",
            "crypto_aead", "serving", "observe_serving", "train_moe_e2e")
# Examples whose path runs no kernel: the einsum backend throughout.
EINSUM_EXAMPLES = ("paper_fig1_demo", "crypto_hash", "crypto_block",
                   "serving")
# crypto_aead's fused calls, one megakernel launch each: the NIST vector's
# seal, the batch seal, its open, the tampered open, two fixed-latency
# seals.
AEAD_FUSED_CALLS = 6


def load_example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(dev):
    """Every script of ``examples_torch/`` through ``main([], device=dev)``
    at its own configuration, with launch counters set to 0 before each:
    quickstart launches the dense crossbar once; crypto_aead the
    megakernel once a fused seal or open; observe_serving the megakernel
    (no crossbar: no fallback rung answered); train_moe_e2e trains its
    ~155 M-parameter MoE for its default 300 steps and launches
    ``moe_route`` once a layer a microbatch; the rest run on the einsum
    backend and launch nothing.  observe_serving's exports and
    train_moe_e2e's checkpoints go to a temporary directory.  Logs each
    example's output, wall seconds and launches; returns the launches."""
    import tempfile

    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in EXAMPLES:
            mod = load_example(name)
            argv, kw = [], {}
            if name == "observe_serving":
                kw["out_dir"] = tmp
            if name == "train_moe_e2e":
                argv = ["--ckpt-dir", str(Path(tmp) / "ckpt")]
            lines = []
            torch.cuda.synchronize()
            reset_launch_counts()
            secs, out = host_s(lambda: mod.main(
                argv, device=dev, log_fn=lines.append, **kw))
            counts = {k: v for k, v in launch_counts().items() if v}
            for line in "\n".join(lines).splitlines():
                log(f"    {line}")
            log(f"  example {name}: {secs:.2f} s wall, launches {counts}")
            if name == "quickstart":
                check(counts == {"crossbar_dense": 1},
                      f"quickstart launched {counts}, not one dense crossbar")
            elif name == "crypto_aead":
                check(counts == {"plan_program": AEAD_FUSED_CALLS},
                      f"crypto_aead launched {counts}, not "
                      f"{AEAD_FUSED_CALLS} megakernels")
            elif name == "observe_serving":
                check(set(counts) == {"plan_program"},
                      f"observe_serving launched {counts}")
                check(len(out) == len(mod.PAYLOADS), "observe_serving "
                      f"answered {len(out)} of {len(mod.PAYLOADS)}")
            elif name == "train_moe_e2e":
                cfg = mod.CONFIG
                steps = len(out)
                want = cfg.num_layers * steps * mod.GRAD_ACCUM
                check(counts == {"moe_route": want},
                      f"train_moe_e2e launched {counts}, not moe_route "
                      f"{want} times ({cfg.num_layers} layers x {steps} "
                      f"steps x {mod.GRAD_ACCUM} microbatches)")
                losses = [h["loss"] for h in out]
                check(all(math.isfinite(x) for x in losses)
                      and losses[-1] < losses[0],
                      f"train_moe_e2e losses {losses[0]} -> {losses[-1]}")
                step_ms = sorted(h["step_time_s"] * 1e3 for h in out[1:])
                tokens = mod.SEQ_LEN * mod.GLOBAL_BATCH
                med = step_ms[len(step_ms) // 2]
                log(f"  train_moe_e2e: loss {losses[0]:.4f} -> "
                    f"{losses[-1]:.4f} in {steps} steps; step ms median "
                    f"{med:.2f} (min {step_ms[0]:.2f}, max "
                    f"{step_ms[-1]:.2f}; step 0 "
                    f"{out[0]['step_time_s'] * 1e3:.2f}), "
                    f"{tokens / med * 1e3:.1f} tokens/s")
            else:
                check(name in EINSUM_EXAMPLES and not counts,
                      f"{name} launched {counts}")
            add_counts(total, counts)
            torch.cuda.empty_cache()
    log(f"  examples launches {total}")
    return total


def alloc_slack():
    """Bytes that ``memory_allocated`` counts beyond the live blocks'
    requests at the allocator's 512-byte granule: a cached block handed out
    whole because what it would leave is too small to split off (up to 1
    MiB of a large block).  It depends on what earlier phases freed."""
    import torch
    return sum(b["size"] - -(-b["requested_size"] // ALLOC_GRANULE)
               * ALLOC_GRANULE
               for seg in torch.cuda.memory_snapshot() for b in seg["blocks"]
               if b["state"] == "active_allocated")


def moved(transfers, steps) -> str:
    """The transfer record a step, every mesh index: weight gathers
    (count), and by kind of move the results' GB received and the ring
    model's GB moved (``Transfer.traffic``), the activations' by op."""
    got, ring, acts = {}, {}, {}
    for t in transfers:
        got[t.kind] = got.get(t.kind, 0.0) + t.nbytes
        ring[t.kind] = ring.get(t.kind, 0.0) + t.traffic
        if t.kind == "activation":
            acts[t.op] = acts.get(t.op, 0.0) + t.traffic
    gathers = sum(t.kind == "weight" for t in transfers)
    gb = lambda d: {k: round(v / steps / 1e9, 6) for k, v in d.items()}
    return (f"{gathers / steps:.0f} weight gathers a step; GB a step "
            f"received {gb(got)}, moved {gb(ring)}; activations over "
            f"\"model\" moved by op {gb(acts)}")


def sharding_phase(dev, compare):
    """A model's state over a mesh of four shards of the card.

    (a) ``spmd.make_sharded_train_step`` on Phi-3.5-MoE (above) with the
    reference test's options (``TrainOptions(peak_lr=1e-3)``), routed to
    the single-device step's experts (``nearest_experts``), its own top-k
    off them only at near-ties (``MIXTRAL_NEAR_TIE``,
    ``MIXTRAL_MAX_FLIPS``): each step's
    loss within ``DENSE_RESUME_TOL`` of the single-device step's, every
    parameter after 2 steps within ``SHARD_PARAM_TOL`` and every first
    moment (the gradient's trace) within ``TOL_BF16``'s rtol in L2;
    moe_route launches = data shards x model ranks x (forward +
    recompute) x steps;
    the bytes the placement asks of the allocator equal to every shard's
    bytes, and ``memory_allocated``'s growth equal to them at the
    allocator's 512-byte granule plus the cached blocks it handed out
    whole (``alloc_slack``).
    Each window runs on both indices of its model row, every product
    split over "model" (``dist.annotate``'s group): moe_route launches
    once a rank too, and each phase prints the transfer record a step
    (``moved``: weights gathered over "data", activations moved over
    "model").
    Prints the step ms of both, the peak memory and the replicas' bytes;
    the routing of one sharded forward against the kernel's plain version
    (``compare``, after the counters are read).  (b)
    ``spmd.sharded_decode_step`` against ``decode_fn``, both fed the
    single device's greedy tokens: each logit row within ``TOL_BF16``'s
    rtol in L2, the sharded run's own greedy choice off those tokens only
    at near-ties (``SHARD_TOKEN_NEAR_TIE``).  (d)
    ``sharded_mixtral``: Mixtral-8x22B, 5 of 56 layers, which the card
    holds only a layer at a time beside its shards, its dispatch and
    combine on the dense crossbar.  (e) ``sharded_internvl2``: the vlm
    family's training split, its patch pack on the tile-skipping
    crossbar on every rank.  (f) ``sharded_seamless``: the encdec
    family's decode split, the cross caches primed on one device.  (g)
    and (h) ``sharded_recurrent_train`` and ``sharded_recurrent_decode``
    on Zamba2-2.7B: the hybrid family's training and decode split, no
    kernel; (i) and (j) the same on RWKV6-7B: the rwkv family's.  (c)
    ``launch.dryrun.run_cell`` for ``DRYRUN_CELLS`` (per_device, roofline,
    wall seconds), each within 80 GB and its ``DRYRUN_PEAK_GIB`` a device, and
    ``dryrun.analyse`` of (a)'s cell on (a)'s mesh of
    placeholders: its argument bytes over the mesh equal to (a)'s placed
    bytes, its temp bytes and step-time bound printed beside (a)'s peak
    and step.  Returns (a)'s, (d)'s, (e)'s, (f)'s, (g)'s, (h)'s, (i)'s
    and (j)'s counted launches."""
    import dataclasses

    import torch

    from repro_torch import _tree
    from repro_torch.configs import minicpm_2b, phi3_5_moe, rwkv6_7b
    from repro_torch.configs import zamba2_2_7b
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import spmd
    from repro_torch.kernels import launch_counts, ops, ref
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.train import TrainOptions, make_train_step
    from repro_torch.train.trainer import init_state

    # ------------------------------------- (a) sharded MoE training ---
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(phi3_5_moe.CONFIG, num_layers=SHARD_LAYERS)
    mesh = make_host_mesh(data=2, model=2)
    check(all(d == dev for d in mesh.devices.reshape(-1)),
          f"host mesh devices {mesh}")
    api = model_zoo.build(cfg, device=dev)
    state = init_state(api.init(torch.Generator(device=dev).manual_seed(0)))
    n_params = sum(t.numel() for t in _tree.leaves(state.params))
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SHARD_SEQ,
                       global_batch=SHARD_BATCH)
    batches = [{k: v.to(dev) for k, v in data.batch(s).items()}
               for s in range(SHARD_STEPS)]
    # the placement: the state and the first batch
    args = (state, batches[0])
    sh = (spmd.train_state_shardings(state, mesh, cfg),
          shd.batch_shardings(batches[0], mesh))
    shard_bytes = [shd.shard_nbytes(t.shape, t.dtype, s)
                   for t, s in zip(_tree.leaves(args), _tree.leaves(sh))]
    exact = mesh.size * sum(shard_bytes)
    rounded = mesh.size * sum(-(-b // ALLOC_GRANULE) * ALLOC_GRANULE
                              for b in shard_bytes)
    replicas = sum((mesh.size - len(s.blocks(t.shape))) * b for t, s, b in
                   zip(_tree.leaves(args), _tree.leaves(sh), shard_bytes))
    log(f"sharding phase (a): phi3.5-moe, full width, {SHARD_LAYERS} of "
        f"{phi3_5_moe.CONFIG.num_layers} layers, {n_params / 1e9:.4f} B "
        f"float32 parameters; mesh {dict(mesh.shape)} of {dev}; batch "
        f"{SHARD_BATCH} x {SHARD_SEQ}, {SHARD_STEPS} steps; the placement "
        f"(TrainState and the first batch): {len(shard_bytes) * mesh.size} "
        f"shards, {exact} bytes ({rounded} at the allocator's granule), of "
        f"which replicas {replicas} bytes")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    asked = torch.cuda.memory_stats()["requested_bytes.all.current"]
    slack = alloc_slack()
    placed, batch0 = shd.device_put(args, sh)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    asked = torch.cuda.memory_stats()["requested_bytes.all.current"] - asked
    slack = alloc_slack() - slack
    check(asked == exact, f"placement asked the allocator for {asked} "
          f"bytes, not the shards' {exact}")
    check(grown == rounded + slack, f"placement grew memory_allocated by "
          f"{grown}, not the shards' {rounded} bytes at the 512-byte granule"
          f" ({exact} unrounded) + {slack} of unsplit cached blocks")
    log(f"  placement: the allocator was asked for {asked} bytes = the "
        f"shards' bytes; memory_allocated grew by {grown} = {rounded} at the"
        f" 512-byte granule + {slack} of cached blocks too small to split")
    opts = TrainOptions(peak_lr=1e-3)
    single = make_train_step(api.loss_fn, opts)
    hist_1, seen_1 = [], []
    for s in range(SHARD_STEPS):
        with recorded_routing() as seen:
            secs, (state, m) = host_s(lambda: single(state, batches[s]))
        hist_1.append((secs, {k: float(v) for k, v in m.items()}))
        seen_1.append(seen)

    transfers = []
    step = spmd.make_sharded_train_step(api.loss_fn, opts, mesh, *sh,
                                        transfers=transfers)
    real_route = ops.moe_route_transform
    first_route = []

    def record(ids, **kw):
        if not first_route:
            first_route.append((ids.clone(), kw))
        return real_route(ids, **kw)

    hist_s, seen_s, near = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ops.moe_route_transform = record
    try:
        for s in range(SHARD_STEPS):
            with recorded_routing(nearest_experts(seen_1[s], near)) as seen:
                secs, (placed, m) = host_s(lambda: step(
                    placed, batch0 if s == 0 else batches[s]))
            hist_s.append((secs, {k: float(v) for k, v in m.items()}))
            seen_s += seen
    finally:
        ops.moe_route_transform = real_route
    torch.cuda.synchronize()
    counts = dict(launch_counts())
    peak = torch.cuda.max_memory_allocated()
    want = (mesh.shape["data"] * mesh.shape["model"] * 2 * SHARD_LAYERS
            * SHARD_STEPS)
    check(counts["moe_route"] == want,
          f"the sharded steps launched moe_route {counts['moe_route']} "
          f"times, not {want} (data shards x model ranks x (forward + "
          "recompute) x steps)")
    check(all(d < second / 4 for d, second in near),
          f"a sharded routing call's nearest single-device window is not "
          f"clear of the next: {near}")
    flips, choices, gap = expert_flips(seen_s, cfg.num_experts_per_tok)
    check(flips <= MIXTRAL_MAX_FLIPS * choices and gap <= MIXTRAL_NEAR_TIE,
          f"sharded training: its own top-k differs from the single-device "
          f"experts at {flips} of {choices} choices, by up to {gap}")
    worst_p, worst_mu = held_to_single("phi3.5-moe", hist_1, hist_s,
                                       placed, state)
    by_op = {}
    for t in transfers:
        by_op[t.op] = by_op.get(t.op, 0.0) + t.traffic
    step_ms = hist_s[-1][0] * 1e3
    log(f"  parameters after {SHARD_STEPS} steps: max |diff| {worst_p:.3e} "
        f"({SHARD_PARAM_TOL}); first moments worst L2 relative "
        f"{worst_mu:.3e} (<= {TOL_BF16['rtol']}); routed to the single "
        f"device's experts (each call's window matched at router-logit "
        f"distance <= {max(d for d, _ in near):.6f}, the next window's >= "
        f"{min(sec for _, sec in near):.6f}), its own top-k off them at "
        f"{flips} of {choices} choices (gap {gap:.6f}); moe_route launches "
        f"{counts['moe_route']}; sharded step {step_ms:.1f} ms (step 1, host "
        f"clock ending in a synchronise), single-device "
        f"{hist_1[-1][0] * 1e3:.1f} ms; "
        f"max_memory_allocated over the sharded steps {peak / 2**30:.2f} GiB"
        " (the single-device state and the four shards on one card); "
        f"launches {counts}; transfers recorded (ring "
        f"bytes, every mesh index) {by_op}; "
        f"{moved(transfers, SHARD_STEPS)}")
    ids, kw = first_route[0]
    rows = ids.reshape(-1, ids.shape[-2] * ids.shape[-1]).to(torch.int32)
    compare("moe_route", f"sharded step's routing {tuple(ids.shape)}, E="
            f"{kw['num_experts']}, C={kw['capacity']}",
            torch.stack(ops.moe_route_transform(ids, **kw)),
            torch.stack([t.reshape(ids.shape) for t in
                         ref.moe_route_transform(rows, **kw)]))
    a_bytes = exact
    del state, placed, step, single, batches, batch0, args, first_route
    del seen, seen_1, seen_s
    torch.cuda.empty_cache()

    # ------------------------------------------- (b) sharded decode ---
    cfg_b = dataclasses.replace(minicpm_2b.CONFIG,
                                num_layers=SHARD_DEC_LAYERS)
    api_b = model_zoo.build(cfg_b, device=dev)
    params_b = api_b.init(torch.Generator(device=dev).manual_seed(1))
    g = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg_b.vocab_size, (SHARD_BATCH,
                                                 SHARD_DEC_PROMPT),
                           generator=g, device=dev, dtype=torch.int32)
    max_seq = SHARD_DEC_PROMPT + SHARD_DEC_STEPS
    meta = model_zoo.build(cfg_b, device="meta")
    dims = spmd.cache_batch_dims(lambda b: meta.init_caches(b, max_seq))
    with torch.inference_mode():
        logits, caches = T.prefill(params_b, prompt, cfg_b, max_seq=max_seq)
        pc = shd.device_put(params_b, shd.param_shardings(params_b, mesh))
        cc = shd.device_put(caches, shd.cache_shardings(caches, mesh))
        specs = [c.sharding.spec for c in _tree.leaves(cc)]
    t1 = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    reset_launch_counts()
    line = decode_held_to_single("minicpm-2b (b)", api_b.decode_fn, mesh,
                                 params_b, caches, pc, cc, dims, t1,
                                 SHARD_DEC_PROMPT, SHARD_DEC_STEPS)
    log(f"sharding phase (b): minicpm-2b full width, {SHARD_DEC_LAYERS} of "
        f"{minicpm_2b.CONFIG.num_layers} layers, {SHARD_BATCH} slots, prompt "
        f"{SHARD_DEC_PROMPT}, caches {specs[0]} on {dict(mesh.shape)}: "
        f"{line}; launches {launch_counts()}")
    del params_b, pc, cc, caches
    torch.cuda.empty_cache()

    # ------------------------- (d) Mixtral-8x22B, a layer at a time ---
    add_counts(counts, sharded_mixtral(dev, compare))

    # -------------------- (e) InternVL2-26B training split over (2, 2) ---
    add_counts(counts, sharded_internvl2(dev, compare))

    # --------------------- (f) SeamlessM4T decode split over (2, 2) ---
    add_counts(counts, sharded_seamless(dev))

    # -------------- (g), (h) Zamba2-2.7B training and decode split ---
    add_counts(counts, sharded_recurrent_train(
        dev, "g", zamba2_2_7b.CONFIG, SHARD_HYB_LAYERS, SHARD_HYB_BATCH,
        SHARD_HYB_SEQ))
    add_counts(counts, sharded_recurrent_decode(
        dev, "h", zamba2_2_7b.CONFIG, SHARD_HYB_LAYERS, SHARD_HYB_SLOTS,
        SHARD_HYB_STEPS))

    # -------------- (i), (j) RWKV6-7B training and decode split ---
    add_counts(counts, sharded_recurrent_train(
        dev, "i", rwkv6_7b.CONFIG, SHARD_RWKV_LAYERS, SHARD_RWKV_BATCH,
        SHARD_RWKV_SEQ))
    add_counts(counts, sharded_recurrent_decode(
        dev, "j", rwkv6_7b.CONFIG, SHARD_RWKV_LAYERS, SHARD_RWKV_SLOTS,
        SHARD_RWKV_STEPS))

    # -------------------------------------------------- (c) dry runs ---
    for arch, shape in DRYRUN_CELLS:
        secs, r = host_s(lambda: dryrun.run_cell(arch, shape, verbose=False))
        check(r["status"] == "ok", f"dry run {arch} x {shape}: {r}")
        pd = r["per_device"]
        check(pd["fits_hbm"] and pd["peak_hbm_gib"] <= DRYRUN_PEAK_GIB[arch],
              f"dry run {arch} x {shape}: peak {pd['peak_hbm_gib']} GiB a "
              f"device (bar {DRYRUN_PEAK_GIB[arch]}), fits {pd['fits_hbm']}")
        log(f"sharding phase (c): dry run {arch} x {shape} on {r['mesh']} "
            f"placeholders, {secs:.1f} s wall: peak {pd['peak_hbm_gib']} GiB "
            f"a device (<= {DRYRUN_PEAK_GIB[arch]}), collectives "
            f"{json.dumps(r['collectives'])}; per_device "
            f"{json.dumps(pd)}; roofline {json.dumps(r['roofline'])}")
    cell = ShapeCell("sharding_a", SHARD_SEQ, SHARD_BATCH, "train")
    place = make_host_mesh(data=2, model=2, devices=["meta"] * 4)
    secs, r = host_s(lambda: dryrun.analyse(cfg, cell, place, grad_accum=1,
                                            arch="phi3.5-moe (1 layer)"))
    pd, rf = r["per_device"], r["roofline"]
    check(pd["mesh_argument_bytes"] == a_bytes,
          f"the dry run's argument bytes over the mesh "
          f"{pd['mesh_argument_bytes']} != (a)'s placed {a_bytes}")
    log(f"sharding phase (c): dry run of (a)'s cell on (a)'s mesh of "
        f"placeholders, {secs:.1f} s wall: argument bytes a device "
        f"{pd['argument_bytes']}, over the mesh {pd['mesh_argument_bytes']}"
        f" = (a)'s placed {a_bytes}; temp bytes a device {pd['temp_bytes']} "
        f"(peak {pd['peak_hbm_gib']} GiB a device; (a) held every shard on "
        f"one card: {peak / 2**30:.2f} GiB); step-time bound "
        f"{rf['step_time_bound_s'] * 1e3:.2f} ms ({rf['dominant']}; compute "
        f"{rf['compute_s'] * 1e3:.3f}, memory {rf['memory_s'] * 1e3:.2f}, "
        f"collective {rf['collective_s'] * 1e3:.3f} ms) beside (a)'s "
        f"measured {step_ms:.1f} ms for the mesh's 4 shards on one card")
    return counts


def held_to_single(label, hist_1, hist_s, placed, state):
    """Sharded training against one device from the same state and
    batches (``hist_*``: [(host s, metrics)] a step): each sharded loss
    within ``DENSE_RESUME_TOL`` of the single device's (logged a step),
    every parameter after the steps within ``SHARD_PARAM_TOL``, every
    first moment within ``TOL_BF16``'s rtol in L2.  Returns (the worst
    parameter |diff|, the worst moment's L2 relative error)."""
    import torch

    from repro_torch import _tree
    from repro_torch.dist import sharding as shd

    for s, ((t1, m1), (ts, ms)) in enumerate(zip(hist_1, hist_s)):
        check(all(math.isfinite(ms[k]) for k in ("loss", "grad_norm")),
              f"sharded {label} step {s}: loss {ms['loss']}")
        check(math.isclose(ms["loss"], m1["loss"],
                           rel_tol=DENSE_RESUME_TOL["rtol"],
                           abs_tol=DENSE_RESUME_TOL["atol"]),
              f"{label} step {s}: sharded loss {ms['loss']} != "
              f"single-device {m1['loss']} ({DENSE_RESUME_TOL})")
        log(f"  step {s}: loss sharded {ms['loss']:.7f} single "
            f"{m1['loss']:.7f} (diff {ms['loss'] - m1['loss']:.3e}); grad "
            f"norm {ms['grad_norm']:.6f} / {m1['grad_norm']:.6f}; lr "
            f"{ms['lr']:.2e}; host ms sharded {ts * 1e3:.1f}, single "
            f"{t1 * 1e3:.1f} ({card()})")
    worst_p = worst_mu = 0.0
    for got, want_p in zip(_tree.leaves(placed.params),
                           _tree.leaves(state.params)):
        g = shd.gather(got)
        worst_p = max(worst_p, float((g - want_p.detach()).abs().max()))
        check(torch.allclose(g, want_p.detach(), **SHARD_PARAM_TOL),
              f"{label}: a parameter {tuple(g.shape)} differs beyond "
              f"{SHARD_PARAM_TOL}: {worst_p}")
        del g
    for got, want_m in zip(_tree.leaves(placed.opt.mu),
                           _tree.leaves(state.opt.mu)):
        g = shd.gather(got)
        worst_mu = max(worst_mu, float(
            torch.linalg.vector_norm(g - want_m)
            / torch.clamp(torch.linalg.vector_norm(want_m), min=1e-30)))
        del g
    check(worst_mu <= TOL_BF16["rtol"], f"{label}: first moments differ by "
          f"{worst_mu} in L2 (> {TOL_BF16['rtol']})")
    return worst_p, worst_mu


def decode_held_to_single(label, decode_fn, mesh, params, caches, pc, cc,
                          dims, tok, pos0, steps, tr=None,
                          across_data=False) -> str:
    """``steps`` greedy decode steps from ``tok`` at position ``pos0``, on
    one device (``params``, ``caches``) and through
    ``spmd.sharded_decode_step`` (``pc``, ``cc``), both fed the single
    device's tokens: each logit row within ``TOL_BF16``'s rtol in L2,
    the sharded run's own greedy choice off those tokens only at
    near-ties (``SHARD_TOKEN_NEAR_TIE``), no cache row moved (with
    ``across_data``, none across "model": the hybrid's Mamba2 caches put
    "data" on their period, reference quirk R8).  ``tr`` takes the
    transfer record.  Returns the line to log: the choices, the rows,
    the medians of ms a step (host clock), the peak and the transfer
    record a step."""
    import torch

    from repro_torch.dist import spmd

    ms_1, ms_s, rows_1, rows_s = [], [], [], []
    tr = [] if tr is None else tr
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for j in range(steps):
            pos = pos0 + j
            s1, (l1, caches) = host_s(lambda: decode_fn(params, tok, caches,
                                                        pos))
            # teacher-forced: both runs are fed the single device's token
            s2, (l2, cc) = host_s(lambda: spmd.sharded_decode_step(
                decode_fn, mesh, pc, tok, cc, pos, batch_dims=dims,
                transfers=tr))
            ms_1.append(s1 * 1e3)
            ms_s.append(s2 * 1e3)
            close_rows(f"sharded {label} decode step {j} logits vs "
                       "single-device", l2[:, -1], l1[:, -1],
                       TOL_BF16["rtol"])
            rows_1.append(l1[:, -1].float())
            rows_s.append(l2[:, -1].float())
            tok = l1[:, -1].argmax(-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    moved_rows = [t for t in tr if t.kind == "cache" and (
        not across_data or len({mesh_coords(mesh, i)["model"]
                                for i in t.group}) > 1)]
    check(not moved_rows, f"sharded {label} decode moved cache rows"
          + (' across "model"' if across_data else ""))
    tflips, tokens, tgap = token_flips(torch.stack(rows_s),
                                       torch.stack(rows_1))
    check(tflips <= MIXTRAL_MAX_FLIPS * tokens
          and tgap <= SHARD_TOKEN_NEAR_TIE, f"sharded {label} decode: its "
          f"greedy choice differs from the single device's token at "
          f"{tflips} of {tokens}, the single device's logits {tgap} apart")
    return (f"{steps} greedy steps fed the single device's tokens, its own "
            f"greedy choice off them at {tflips} of {tokens} (the single "
            f"device's logits {tgap:.3e} apart there); rows within "
            f"{max(row_err(a, w) for a, w in zip(rows_s, rows_1)):.3e} in "
            f"L2; decode ms a step sharded {sorted(ms_s)[len(ms_s) // 2]:.2f}"
            f", single-device {sorted(ms_1)[len(ms_1) // 2]:.2f} (medians, "
            f"host clock); peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"{moved(tr, steps)}")


@functools.lru_cache(maxsize=None)
def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def mesh_coords(mesh, mesh_id) -> dict:
    """A mesh id's coordinates, by axis name."""
    import numpy as np
    p = list(mesh.ids.reshape(-1)).index(mesh_id)
    return dict(zip(mesh.axis_names,
                    (int(c) for c in np.unravel_index(p, mesh.ids.shape))))


def sharded_recurrent_train(dev, phase, config, layers, batch, seq):
    """Sharding phase (g) or (i): a recurrent family's ``config`` (Zamba2-
    2.7B, RWKV6-7B) at its published width, ``layers`` of its layers,
    remat "full" as published, trained ``SHARD_STEPS`` steps of ``batch``
    x ``seq`` from one state and batches (``TrainOptions(peak_lr=1e-3)``)
    on one device in float32 compute (the witness), over (2, 2) of the
    card in float32 (``held_to_single``'s bars against the witness), on
    one device in the published bf16 and over (2, 2) in bf16
    (``held_to_witness``); no kernel launched (the reference's hybrid and
    rwkv reach none).  Prints the step ms of each, the bf16 split's peak,
    transfer record a step and weight gathers across "model" (row blocks;
    the hybrid's ``in_proj`` block: its heads' columns of z, x and dt and
    B and C whole, several spans).  Returns the sharded steps' counted
    launches."""
    import dataclasses

    import torch

    from repro_torch import _tree
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import spmd
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo
    from repro_torch.train import TrainOptions, make_train_step
    from repro_torch.train.trainer import init_state

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_part = time.perf_counter()
    cfg = dataclasses.replace(config, num_layers=layers)
    name = config.name
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    mesh = make_host_mesh(data=2, model=2)
    api, api32 = (model_zoo.build(c, device=dev) for c in (cfg, f32))
    # the starting parameters alone are kept: each run starts from a
    # fresh state around a copy of them (zero moments, step 0)
    params0 = api.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in _tree.leaves(params0))
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [api.make_batch(gen, batch, seq) for _ in range(SHARD_STEPS)]
    copy = lambda: init_state(_tree.tree_map(lambda t: t.clone(), params0))
    state = copy()
    sh = (spmd.train_state_shardings(state, mesh, cfg),
          shd.batch_shardings(batches[0], mesh))
    del state
    placed_batches = [shd.device_put(b, sh[1]) for b in batches]
    opts = TrainOptions(peak_lr=1e-3)
    log(f"sharding phase ({phase}): {name}, full width, {layers} of "
        f"{config.num_layers} layers, remat {cfg.remat}, "
        f"{n_params / 1e9:.4f} B float32 parameters; mesh "
        f"{dict(mesh.shape)} of {dev}; batch {batch} x {seq}, "
        f"{SHARD_STEPS} steps; one device and the split in float32 (the "
        f"witness: one device) and in {cfg.compute_dtype}")

    def one_device(loss_fn):
        st, hist = copy(), []
        step = make_train_step(loss_fn, opts)
        for b in batches:
            secs, (st, m) = host_s(lambda: step(st, b))
            hist.append((secs, {k: float(v) for k, v in m.items()}))
        return st, hist

    def split(loss_fn, transfers):
        placed, hist = shd.device_put(copy(), sh[0]), []
        step = spmd.make_sharded_train_step(loss_fn, opts, mesh, *sh,
                                            transfers=transfers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        for b in placed_batches:
            secs, (placed, m) = host_s(lambda: step(placed, b))
            hist.append((secs, {k: float(v) for k, v in m.items()}))
        torch.cuda.synchronize()
        counts = dict(launch_counts())
        check(not any(counts.values()), f"sharded {name} launched "
              f"{counts}: the {cfg.family} family's path reaches no kernel")
        return placed, hist, counts, torch.cuda.max_memory_allocated()

    witness, hist_w = one_device(api32.loss_fn)
    placed, hist_s, counts, _ = split(api32.loss_fn, [])
    worst_p, worst_mu = held_to_single(f"{name} ({phase}) float32", hist_w,
                                       hist_s, placed, witness)
    log(f"  float32: parameters after {SHARD_STEPS} steps max |diff| "
        f"{worst_p:.3e} ({SHARD_PARAM_TOL}); first moments worst L2 "
        f"relative {worst_mu:.3e} (<= {TOL_BF16['rtol']}); step 1 sharded "
        f"{hist_s[-1][0] * 1e3:.1f} ms, one device {hist_w[-1][0] * 1e3:.1f}"
        f" ms (host clock ending in a synchronise; {card()})")
    del placed
    one, hist_1 = one_device(api.loss_fn)
    transfers = []
    placed, hist_b, bf_counts, peak = split(api.loss_fn, transfers)
    add_counts(counts, bf_counts)
    line = held_to_witness(f"{name} ({phase}) {cfg.compute_dtype}", hist_w,
                           hist_1, hist_b, witness, one, placed, params0)
    cross = [t for t in transfers if t.kind == "weight" and len(
        {mesh_coords(mesh, i)["model"] for i in t.group}) > 1]
    check(cross, f"sharded {name}: no weight gather crossed \"model\" (a "
          "row block spans both model shards of its columns)")
    log(f"  {cfg.compute_dtype}: {line}; step 1 sharded "
        f"{hist_b[-1][0] * 1e3:.1f} ms, one device {hist_1[-1][0] * 1e3:.1f}"
        f" ms (host clock ending in a synchronise; {card()}); "
        f"max_memory_allocated over the sharded steps {peak / 2**30:.2f} GiB "
        f"(the initial parameters, the witness and one-device states and "
        f"the four shards on one card); launches {counts}; "
        f"{moved(transfers, SHARD_STEPS)}; "
        f"weight gathers across \"model\" {len(cross) / SHARD_STEPS:.0f} a "
        f"step, {sum(t.nbytes for t in cross) / SHARD_STEPS / 1e9:.6f} GB "
        f"received a step (largest {max(t.nbytes for t in cross):.0f} "
        f"bytes)")
    log(f"  ({phase}) {time.perf_counter() - t_part:.1f} s ({card()})")
    del placed, placed_batches, witness, one, params0, batches
    torch.cuda.empty_cache()
    return counts


def held_to_witness(label, hist_w, hist_1, hist_s, witness, one, placed,
                    start) -> str:
    """A sharded run in a low-precision compute (``placed``, ``hist_s``)
    held to a float32 run on one device (``witness``, ``hist_w``) as far
    as the same low-precision run on one device (``one``, ``hist_1``)
    is, all from the parameters ``start``.  Its distance from the witness
    is at most ``SHARD_WITNESS_RATIO`` times one device's plus
    ``SHARD_WITNESS_FLOOR``, for every parameter (L2 of the difference
    over the L2 of the witness's update from ``start``) and every first
    moment (relative L2), and for each step's loss (relative) against
    one device's largest over the steps: a loss is one number, and one
    device's may fall near the witness's by chance (NVIDIA H100: 1.987e-5
    at step 0, 1.309e-4 at step 1).  Returns the line to log: the
    losses' distances, the largest and median ratios."""
    import torch

    from repro_torch import _tree
    from repro_torch.dist import sharding as shd

    def dist(a, w, base):
        return float(torch.linalg.vector_norm((a - w).detach())) / max(
            float(torch.linalg.vector_norm(base.detach())), 1e-30)

    loss_1 = max(abs(m1["loss"] / mw["loss"] - 1)
                 for (_, mw), (_, m1) in zip(hist_w, hist_1))
    rows = [(f"loss step {s}", loss_1, abs(ms["loss"] / mw["loss"] - 1))
            for s, ((_, mw), (_, ms)) in enumerate(zip(hist_w, hist_s))]
    for kind, trees in (("", (witness.params, one.params, placed.params,
                              start)),
                        (" mu", (witness.opt.mu, one.opt.mu,
                                 placed.opt.mu, None))):
        w_leaves = _tree.leaves_with_path(trees[0])
        starts = (_tree.leaves(trees[3]) if trees[3] is not None
                  else [None] * len(w_leaves))
        for (path, w), a1, a_s, p0 in zip(w_leaves, _tree.leaves(trees[1]),
                                          _tree.leaves(trees[2]), starts):
            base = w if p0 is None else w - p0
            g = shd.gather(a_s)
            rows.append(("/".join(map(str, path)) + kind, dist(a1, w, base),
                         dist(g, w, base)))
            del g
    ratio, floor = SHARD_WITNESS_RATIO, SHARD_WITNESS_FLOOR
    bad = [r for r in rows if r[2] > ratio * r[1] + floor]
    check(not bad, f"{label}: further from the float32 witness than "
          f"{ratio} x one device's + {floor}: " + ", ".join(
              f"{n} {d_s:.3e} against {d_1:.3e}" for n, d_1, d_s in bad[:8]))
    by = sorted(((d_s / d_1 if d_1 else math.inf if d_s else 1.0), n, d_1,
                 d_s) for n, d_1, d_s in rows)
    return (f"distances from the float32 witness, split against one "
            f"device: " + ", ".join(
                f"loss step {s} {abs(ms['loss'] / mw['loss'] - 1):.3e} / "
                f"{abs(m1['loss'] / mw['loss'] - 1):.3e}"
                for s, ((_, mw), (_, m1), (_, ms)) in enumerate(
                    zip(hist_w, hist_1, hist_s)))
            + f"; {len(rows)} held within {ratio} x + {floor}; the largest "
            f"ratios " + ", ".join(f"{n} {r:.2f} ({d_s:.3e} / {d_1:.3e})"
                                   for r, n, d_1, d_s in by[::-1][:3])
            + f"; median ratio {by[len(by) // 2][0]:.3f}")


def sharded_recurrent_decode(dev, phase, config, layers, slots, steps):
    """Sharding phase (h) or (j): a recurrent family's ``config`` at its
    published width, ``layers`` of its layers, ``steps`` greedy decode
    steps of ``slots`` slots from seeded tokens on one device and over
    (2, 2) of the card, the sharded run fed the single device's tokens
    (``decode_held_to_single``): each logit row within ``TOL_BF16``'s
    rtol in L2, its own greedy choice off those tokens only at near-ties;
    no cache row crosses "model" (the hybrid's Mamba2 rows cross "data":
    R8; the rwkv token-shift rows: R9); no kernel.  Prints the ms a step
    of both and the states' all-to-all bytes a step (a Mamba2 state from
    the cache's P block to the heads' and back, a WKV state from its key
    rows).  Returns the sharded run's counted launches."""
    import dataclasses

    import torch

    from repro_torch import _tree
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import spmd
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_part = time.perf_counter()
    cfg = dataclasses.replace(config, num_layers=layers)
    name = config.name
    mesh = make_host_mesh(data=2, model=2)
    api = model_zoo.build(cfg, device=dev)
    params = api.init(torch.Generator(device=dev).manual_seed(0))
    with torch.inference_mode():
        caches = api.init_caches(slots, steps)
        meta = model_zoo.build(cfg, device="meta")
        dims = spmd.cache_batch_dims(lambda n: meta.init_caches(n, steps))
        pc = shd.device_put(params, shd.param_shardings(params, mesh))
        cc = shd.device_put(caches, shd.cache_shardings(caches, mesh))
    specs = {"/".join(map(str, path)): tuple(leaf.sharding.spec)
             for path, leaf in _tree.leaves_with_path(cc)}
    log(f"sharding phase ({phase}): {name}, full width, {layers} of "
        f"{config.num_layers} layers; {slots} slots, {steps} greedy steps; "
        f"caches {specs} on {dict(mesh.shape)}")
    tok = torch.randint(0, cfg.vocab_size, (slots, 1), dtype=torch.int32,
                        generator=torch.Generator(device=dev).manual_seed(2),
                        device=dev)
    tr = []
    reset_launch_counts()
    line = decode_held_to_single(f"{name} ({phase})", api.decode_fn, mesh,
                                 params, caches, pc, cc, dims, tok, 0, steps,
                                 tr=tr, across_data=True)
    counts = dict(launch_counts())
    check(not any(counts.values()), f"sharded {name} decode launched "
          f"{counts}: the {cfg.family} family's path reaches no kernel")
    a2a = [t for t in tr if t.kind == "activation" and t.op == "all-to-all"]
    check(a2a, f"sharded {name} decode: no all-to-all of the states")
    log(f"  {line}; the states' all-to-all {len(a2a) / steps:.0f} "
        f"results a step, {sum(t.nbytes for t in a2a) / steps / 1e9:.6f} "
        f"GB received, {sum(t.traffic for t in a2a) / steps / 1e9:.6f} GB "
        f"moved a step; launches {counts}; "
        f"{time.perf_counter() - t_part:.1f} s ({card()})")
    del params, pc, cc, caches
    torch.cuda.empty_cache()
    return counts


def sharded_internvl2(dev, compare):
    """Sharding phase (e): InternVL2-26B, ``SHARD_VLM_LAYERS`` of 48
    layers, trained ``SHARD_STEPS`` steps on one device and over (2, 2)
    of the card from the same state and batches
    (``TrainOptions(peak_lr=1e-3)``): each sharded loss within
    ``DENSE_RESUME_TOL`` of the single device's, every parameter after
    the steps within ``SHARD_PARAM_TOL`` (the first moments' worst L2
    printed); the patch pack on the tile-skipping crossbar once a rank
    of each window's row a forward (the recompute repacks nothing), no
    other kernel; the first rank's first pack held to the plain version
    (``compare``, after the counters are read).  Prints the step ms of
    both, the peak and the transfer record a step.  Returns the sharded
    steps' counted launches."""
    import dataclasses

    import torch

    from repro_torch import _tree
    from repro_torch.configs import internvl2_26b
    from repro_torch.core import permute as P
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import spmd
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo
    from repro_torch.models import vlm as V
    from repro_torch.train import TrainOptions, make_train_step
    from repro_torch.train.trainer import init_state

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_part = time.perf_counter()
    cfg = dataclasses.replace(internvl2_26b.CONFIG,
                              num_layers=SHARD_VLM_LAYERS)
    mesh = make_host_mesh(data=2, model=2)
    api = model_zoo.build(cfg, device=dev)
    state = init_state(api.init(torch.Generator(device=dev).manual_seed(0)))
    n_params = sum(t.numel() for t in _tree.leaves(state.params))
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [api.make_batch(gen, SHARD_VLM_BATCH, SHARD_VLM_SEQ)
               for _ in range(SHARD_STEPS)]
    sh = (spmd.train_state_shardings(state, mesh, cfg),
          shd.batch_shardings(batches[0], mesh))
    placed, batch0 = shd.device_put((state, batches[0]), sh)
    log(f"sharding phase (e): internvl2-26b, full width, "
        f"{SHARD_VLM_LAYERS} of {internvl2_26b.CONFIG.num_layers} layers, "
        f"{n_params / 1e9:.4f} B float32 parameters; mesh "
        f"{dict(mesh.shape)} of {dev}; batch "
        f"{ {k: tuple(v.shape) for k, v in batches[0].items()} }, "
        f"{SHARD_STEPS} steps")
    opts = TrainOptions(peak_lr=1e-3)
    single = make_train_step(api.loss_fn, opts)
    hist_1 = []
    for s in range(SHARD_STEPS):
        secs, (state, m) = host_s(lambda: single(state, batches[s]))
        hist_1.append((secs, {k: float(v) for k, v in m.items()}))

    transfers, packs = [], []
    step = spmd.make_sharded_train_step(api.loss_fn, opts, mesh, *sh,
                                        transfers=transfers)
    real_pack = V.pack_patches

    def capture(x, valid):
        out = real_pack(x, valid)
        if not packs:
            packs.append((x.t[0], valid.t[0], out.t[0]))
        return out
    hist_s = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    V.pack_patches = capture
    try:
        for s in range(SHARD_STEPS):
            secs, (placed, m) = host_s(lambda: step(
                placed, batch0 if s == 0 else batches[s]))
            hist_s.append((secs, {k: float(v) for k, v in m.items()}))
    finally:
        V.pack_patches = real_pack
    torch.cuda.synchronize()
    counts = dict(launch_counts())
    peak = torch.cuda.max_memory_allocated()
    want = {"crossbar_sparse": (mesh.shape["data"] * mesh.shape["model"]
                                * SHARD_STEPS)}
    check({k: v for k, v in counts.items() if v} == want,
          f"sharded internvl2 launched {counts}, not {want} (the pack on "
          "the tile-skipping crossbar, data windows x model ranks x "
          "forwards)")
    worst_p, worst_mu = held_to_single("internvl2", hist_1, hist_s, placed,
                                       state)
    log(f"  parameters after {SHARD_STEPS} steps: max |diff| {worst_p:.3e} "
        f"({SHARD_PARAM_TOL}); first moments worst L2 relative "
        f"{worst_mu:.3e} (<= {TOL_BF16['rtol']}); sharded step {hist_s[-1][0] * 1e3:.1f} ms (step "
        f"1, host clock ending in a synchronise), single-device "
        f"{hist_1[-1][0] * 1e3:.1f} ms; max_memory_allocated over the "
        f"sharded steps {peak / 2**30:.2f} GiB (the single-device state and "
        f"the four shards on one card); launches {counts}; "
        f"{moved(transfers, SHARD_STEPS)}")
    x, valid, out = packs[0]
    plain = P.vcompress_batched(x.cpu(), valid.cpu(), tail="zero",
                                backend="sparse")
    compare("crossbar_sparse", f"sharded internvl2 step 0, rank 0: the patch"
            f" pack {tuple(x.shape)} {x.dtype} (tile-skipping kernel) vs its "
            "plain version", out, plain.to(dev))
    log(f"  (e) {time.perf_counter() - t_part:.1f} s")
    del state, placed, batch0, batches, step, single, packs
    torch.cuda.empty_cache()
    return counts


def sharded_seamless(dev):
    """Sharding phase (f): SeamlessM4T-large-v2 whole, its decoder's
    greedy decode of ``SHARD_ENC_STEPS`` steps from BOS on one device
    and over (2, 2) of the card on the same weights and primed cross
    caches (``prime_cross`` of one encode on one device, placed by
    ``cache_shardings``), the sharded run fed the single device's
    tokens: each logit row within ``TOL_BF16``'s rtol in L2, its own
    greedy choice off those tokens only at near-ties
    (``SHARD_TOKEN_NEAR_TIE``); no cache row crosses "model".  Prints
    the ms a step of both, the peak and the transfer record a step.
    Returns the sharded run's counted launches."""
    import torch

    from repro_torch import _tree
    from repro_torch.configs import seamless_m4t_large_v2
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import spmd
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import encdec as E
    from repro_torch.models import layers as L
    from repro_torch.models import model_zoo

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_part = time.perf_counter()
    cfg = seamless_m4t_large_v2.CONFIG
    mesh = make_host_mesh(data=2, model=2)
    api = model_zoo.build(cfg, device=dev)
    params = api.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in _tree.leaves(params))
    b, steps = SHARD_ENC_SLOTS, SHARD_ENC_STEPS
    g = torch.Generator(device=dev).manual_seed(2)
    frames = (torch.randn((b, SHARD_ENC_FRAMES, cfg.d_model), generator=g,
                          device=dev) * 0.02).to(L.dtype_of(cfg.compute_dtype))
    with torch.inference_mode():
        caches = api.init_caches(b, steps)
        caches["cross"] = E.prime_cross(params, E.encode(params, frames, cfg),
                                        cfg)
        meta = model_zoo.build(cfg, device="meta")
        dims = spmd.cache_batch_dims(lambda n: meta.init_caches(n, steps))
        pc = shd.device_put(params, shd.param_shardings(params, mesh))
        cc = shd.device_put(caches, shd.cache_shardings(caches, mesh))
    specs = {k: tuple(v["k"].sharding.spec) for k, v in cc.items()}
    log(f"sharding phase (f): seamless-m4t-large-v2 whole "
        f"({cfg.encoder_layers} + {cfg.num_layers} layers), "
        f"{n_params / 1e9:.3f} B float32 parameters; {b} requests x "
        f"{SHARD_ENC_FRAMES} frames encoded and primed on one device; "
        f"caches {specs} on {dict(mesh.shape)}")
    tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    reset_launch_counts()
    line = decode_held_to_single("seamless (f)", api.decode_fn, mesh, params,
                                 caches, pc, cc, dims, tok, 0, steps)
    counts = dict(launch_counts())
    log(f"  {line}; launches {counts}; {time.perf_counter() - t_part:.1f} s")
    del params, pc, cc, caches
    torch.cuda.empty_cache()
    return counts


def place_leafwise(tree, shardings):
    """``sharding.device_put`` of a tree of dicts and lists a leaf at a
    time, in place: each leaf's source tensor leaves ``tree`` as soon as
    its shards exist, so the card never holds a whole tree beside its
    shards."""
    from repro_torch.dist import sharding as shd
    for k in (list(tree) if isinstance(tree, dict) else range(len(tree))):
        if isinstance(tree[k], (dict, list)):
            place_leafwise(tree[k], shardings[k])
        else:
            tree[k] = shd.device_put(tree[k], shardings[k])
    return tree


def sharded_mixtral(dev, compare):
    """Sharding phase (d): Mixtral-8x22B, ``SHARD_MIX_LAYERS`` of 56
    layers, dispatch and combine on the dense crossbar kernel
    (``dispatch_backend="kernel"``), greedy decode on one device, then
    over (2, 2) of the card through ``sharded_decode_step`` on the same
    weights, fed the single device's tokens and routed to its experts
    (``recorded_routing``, as the configs phase holds Mixtral): each
    logit row within ``TOL_BF16``'s rtol in L2, the sharded run's own
    greedy choices and top-k off the single device's only at near-ties
    (``SHARD_TOKEN_NEAR_TIE``, ``MIXTRAL_NEAR_TIE``,
    ``MIXTRAL_MAX_FLIPS``); the first sharded dispatch and combine held
    to the crossbar's plain version (``compare``, after the counters are
    read).  Prints each run's peak memory and the transfer record a step.
    Returns the sharded run's counted launches."""
    import dataclasses

    import torch

    from repro_torch import _tree
    from repro_torch.configs import mixtral_8x22b
    from repro_torch.core import moe_dispatch as md
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import spmd
    from repro_torch.kernels import crossbar_permute as xbk
    from repro_torch.kernels import launch_counts, ops, ref
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo
    from repro_torch.models import params as MP

    cfg = dataclasses.replace(mixtral_8x22b.CONFIG,
                              num_layers=SHARD_MIX_LAYERS,
                              sliding_window=MIXTRAL_WINDOW,
                              dispatch_backend="kernel")
    n_l, slots = SHARD_MIX_LAYERS, SHARD_MIX_SLOTS
    max_seq = SHARD_MIX_PROMPT + SHARD_MIX_NEW
    steps = max_seq - 1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resting = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    secs, params = host_s(lambda: MP.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev))
    n_params = sum(t.numel() for t in _tree.leaves(params))
    api = model_zoo.build(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (slots, SHARD_MIX_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    log(f"sharding phase (d): mixtral-8x22b, full width, {n_l} of "
        f"{mixtral_8x22b.CONFIG.num_layers} layers, {n_params / 1e9:.3f} B "
        f"float32 parameters drawn in {secs:.2f} s; {slots} slots x "
        f"({SHARD_MIX_PROMPT} prompt + {SHARD_MIX_NEW} new) tokens, window "
        f"{MIXTRAL_WINDOW}, dispatch and combine on the dense crossbar; "
        f"{resting / 2**30:.2f} GiB allocated before it")

    def run(step_fn, forced=None, feed=None):
        """Greedy decode: the prompt fed a token a step, then its own
        argmax (``feed``'s tokens where given).  Returns (logit rows (B,
        steps, V), new tokens, routing calls)."""
        rows, new, tok = [], [], prompt[:, :1]
        with torch.inference_mode(), recorded_routing(forced) as seen:
            for pos in range(steps):
                logits = step_fn(tok, pos)
                rows.append(logits[:, -1].float())
                if pos + 1 < SHARD_MIX_PROMPT:
                    tok = prompt[:, pos + 1:pos + 2]
                else:
                    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
                    new.append(tok)
                    if feed is not None:
                        tok = feed[:, len(new) - 1:len(new)]
        return torch.stack(rows, dim=1), torch.cat(new, dim=1), seen

    # ---- one device: the whole model ----
    caches = api.init_caches(slots, max_seq)

    def single(tok, pos):
        logits, _ = api.decode_fn(params, tok, caches, pos)
        return logits
    secs1, (rows1, toks1, seen1) = host_s(lambda: run(single))
    peak1 = torch.cuda.max_memory_allocated()
    del caches
    log(f"  single device: {secs1 / steps * 1e3:.2f} ms a step (host clock), "
        f"peak {peak1 / 2**30:.2f} GiB")

    # ---- the shards, placed a leaf at a time ----
    mesh = make_host_mesh(data=2, model=2)
    torch.cuda.reset_peak_memory_stats()
    secs, placed = host_s(lambda: place_leafwise(
        params, shd.param_shardings(params, mesh, cfg)))
    del params
    held = torch.cuda.memory_allocated() - resting
    log(f"  placed over {dict(mesh.shape)} a leaf at a time in {secs:.2f} s: "
        f"{held / 2**30:.2f} GiB of shards, placement peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    caches = api.init_caches(slots, max_seq)
    cc = shd.device_put(caches, shd.cache_shardings(caches, mesh))
    del caches
    meta = model_zoo.build(cfg, device="meta")
    dims = spmd.cache_batch_dims(lambda b: meta.init_caches(b, max_seq))
    windows, ranks = mesh.shape["data"], mesh.shape["model"]
    per = slots // windows
    # the sharded run's routing calls come a window at a time, each
    # layer's once a rank of the window's model row: step, window,
    # layer, rank
    forced = [seen1[pos * n_l + li][0][w * per:(w + 1) * per]
              for pos in range(steps) for w in range(windows)
              for li in range(n_l) for _ in range(ranks)]
    transfers, first = [], {}

    def sharded(tok, pos):
        logits, _ = spmd.sharded_decode_step(
            api.decode_fn, mesh, placed, tok, cc, pos, batch_dims=dims,
            transfers=transfers)
        return logits

    def kept(name, fn):
        """``fn`` with its first call's (plan, payload) kept."""
        plan_of = md.dispatch_plan if name == "dispatch" else md.combine_plan

        def call(x, routing, **kw):
            if name not in first:
                first[name] = (plan_of(routing),
                               x.reshape(-1, x.shape[-1]).clone())
            return fn(x, routing, **kw)
        return call
    real = md.dispatch, md.combine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    md.dispatch, md.combine = kept("dispatch", real[0]), kept("combine",
                                                              real[1])
    try:
        secs2, (rows2, toks2, seen2) = host_s(lambda: run(sharded, forced,
                                                          toks1))
    finally:
        md.dispatch, md.combine = real
    counts = dict(launch_counts())
    peak2 = torch.cuda.max_memory_allocated()
    calls = steps * windows * n_l * ranks
    check(counts["moe_route"] == calls,
          f"sharded mixtral launched moe_route {counts['moe_route']} times, "
          f"not steps x windows x layers x ranks = {calls}")
    check(counts["crossbar_dense"] == 2 * calls,
          f"sharded mixtral launched the dense crossbar "
          f"{counts['crossbar_dense']} times, not a dispatch and a combine "
          f"a routing call = {2 * calls}")
    check(all(torch.equal(ids, f) for (ids, _), f in zip(seen2, forced))
          and len(seen2) == len(forced),
          "the sharded run did not take the single-device run's experts")
    flips, choices, gap = expert_flips(seen2, cfg.num_experts_per_tok)
    check(flips <= MIXTRAL_MAX_FLIPS * choices and gap <= MIXTRAL_NEAR_TIE,
          f"sharded mixtral: its own top-k differs from the single-device "
          f"experts at {flips} of {choices} choices, by up to {gap}")
    chose = slice(SHARD_MIX_PROMPT - 1, steps)
    tflips, tokens, tgap = token_flips(rows2[:, chose], rows1[:, chose])
    check(tflips <= MIXTRAL_MAX_FLIPS * tokens
          and tgap <= SHARD_TOKEN_NEAR_TIE, f"sharded mixtral: its greedy "
          f"choice differs from the single device's token at {tflips} of "
          f"{tokens}, the single device's logits {tgap} apart")
    close_rows(f"sharded mixtral decode rows ({steps} steps) vs single "
               "device, on its tokens and experts", rows2, rows1,
               TOL_BF16["rtol"])
    check(peak2 < 80e9, f"sharded mixtral peak {peak2} bytes")
    log(f"  sharded over {dict(mesh.shape)}: {secs2 / steps * 1e3:.2f} ms a "
        f"step (host clock), peak {peak2 / 2**30:.2f} GiB "
        f"({peak1 / 2**30:.2f} on one device); {len(transfers) / steps:.0f}"
        f" transfers recorded; {moved(transfers, steps)}; fed the single "
        f"device's {toks1.numel()} greedy tokens, its own greedy choice off "
        f"them at {tflips} of {tokens} (logits {tgap:.3e} apart); own "
        f"top-k off the single-device experts at {flips} of {choices} "
        f"choices (gap {gap:.6f}); launches {counts}")
    for part, (plan, x2) in first.items():
        idxp, xf, kwd = ops.dense_operands(plan, x2)
        compare("crossbar_dense", f"sharded mixtral's first {part} "
                f"{plan.n_in}->{plan.n_out} D={x2.shape[-1]} "
                f"{str(x2.dtype)[6:]}, dense kernel vs plain version",
                xbk.crossbar_permute_cuda(idxp, xf, **kwd),
                ref.crossbar_dense(idxp, xf, **kwd))
    del placed, cc, rows1, rows2, seen1, seen2, forced, first
    torch.cuda.empty_cache()
    return counts


# Slice 16: the four configurations no earlier phase ran, at published
# width with seeded weights (float32 master, bf16 compute); depth is the
# one cut, so that each model fits the card one at a time.  Parameters by
# ``ModelConfig.param_count``: Mixtral-8x22B 4 of 56 layers 10.42 B
# (~41.7 GB), Qwen1.5-110B 2 of 80 5.23 B (~20.9 GB), StarCoder2-15B and
# StableLM-12B 4 of 40 2.14 B each (~8.6 GB).  The prompt length is a
# multiple of every attn_chunk (1024, Qwen's 512): a ragged length would
# take one chunk, a (B, H, S, S) float32 score tensor.
CONFIG_SEQ = 5120
MIXTRAL_LAYERS, MIXTRAL_BATCH = 4, 2
# Serving decode: 4 requests of 16 prompt tokens, 48 greedy steps.  The
# window is cut to 32 (a second cut) so that the ring wraps in the run.
MIXTRAL_SLOTS, MIXTRAL_PROMPT, MIXTRAL_NEW, MIXTRAL_WINDOW = 4, 16, 48, 32
# Decode rows against the parallel forward, each in L2 relative to the
# row: bf16 compute rounds differently in a decode step's few rows than
# in the parallel forward's many, 1.15e-2 at worst over 4 layers on the
# H100 (as SeamlessM4T's decoder, ``ENCDEC_BF16_DRIFT``); float32
# compute reads 2.9e-3, and is held to 6e-3, which the bf16 reading
# fails.
MIXTRAL_BF16_DRIFT, MIXTRAL_F32_DRIFT = 3e-2, 6e-3
# Decode's experts may differ from the parallel forward's own top-k on
# the same history only at near-ties: the parallel forward's router
# logits of the two experts at most ``MIXTRAL_NEAR_TIE`` apart (a few
# bf16 ulps of a router logit), at no more than ``MIXTRAL_MAX_FLIPS`` of
# the (step, layer, slot) choices.
MIXTRAL_NEAR_TIE, MIXTRAL_MAX_FLIPS = 0.0625, 1 / 32
DENSE_CONFIGS = (("qwen1.5-110b", 2), ("starcoder2-15b", 4),
                 ("stablelm-12b", 4))
DENSE_NEW = 16


# A teacher-forced sharded decode is fed the single device's tokens; its
# own greedy choice may differ from them only where the single device's
# logits of the two tokens lie within ``SHARD_TOKEN_NEAR_TIE``, at no more
# than ``MIXTRAL_MAX_FLIPS`` of the tokens.
SHARD_TOKEN_NEAR_TIE = 2e-2


def row_err(got, want) -> float:
    """The worst row's L2 relative error (``close_rows``'s measure)."""
    import torch
    got, want = got.float(), want.float()
    return float((torch.linalg.vector_norm(got - want, dim=-1)
                  / torch.linalg.vector_norm(want, dim=-1)).max())


def token_flips(rows, want_rows):
    """Greedy choices of ``rows`` (..., V) against ``want_rows``': (how
    many differ, how many there are, the largest gap of ``want_rows``'
    logits between its choice and the other's where they differ)."""
    import torch
    a, b = want_rows.argmax(-1), rows.argmax(-1)
    off = a != b
    gap = 0.0
    if off.any():
        w = want_rows[off].float()
        gap = float((w.gather(-1, a[off][:, None])
                     - w.gather(-1, b[off][:, None])).max())
    return int(off.sum()), a.numel(), gap


def nearest_experts(seen, near):
    """A ``recorded_routing`` ``forced`` for a run whose routing calls
    take a window of the recorded run's groups: each call takes the
    experts of the recorded call and window whose router logits lie
    nearest its own (largest |difference|).  Appends (that distance, the
    nearest of the candidates that route otherwise) to ``near`` a call."""
    import torch

    def pick(router_logits):
        lg = router_logits.detach().float()
        n = lg.shape[0]
        found = sorted(
            (float((full[lo:lo + n] - lg).abs().max()), i, lo)
            for i, (_, full) in enumerate(seen)
            for lo in range(0, full.shape[0] - n + 1, n))
        d, i, lo = found[0]
        ids = seen[i][0][lo:lo + n]
        near.append((d, min((f for f, j, lo2 in found[1:] if not
                             torch.equal(seen[j][0][lo2:lo2 + n], ids)),
                            default=math.inf)))
        return ids
    return pick


def expert_flips(seen, k):
    """For ``recorded_routing``'s calls (experts taken, router logits):
    (the choices whose own top-k differs from the experts taken, the
    choices, the largest router-logit gap between an expert of its own
    top-k it did not take and one it took)."""
    flips, choices, gap = 0, 0, 0.0
    for ids, lg in seen:
        own = lg.topk(k, dim=-1).indices
        a, b = own.sort(-1).values, ids.long().sort(-1).values
        lg, a, b = (t.reshape(-1, t.shape[-1]) for t in (lg, a, b))
        choices += a.shape[0]
        for slot in (a != b).any(-1).nonzero().flatten().tolist():
            flips += 1
            mine, took = a[slot].tolist(), b[slot].tolist()
            only_own = [e for e in mine if e not in took]
            only_taken = [e for e in took if e not in mine]
            gap = max(gap, float(lg[slot, only_own].max()
                                 - lg[slot, only_taken].min()))
    return flips, choices, gap


@contextlib.contextmanager
def recorded_routing(forced=None):
    """Record every ``moe_dispatch.make_routing`` call's (expert ids,
    router logits), in call order (the model code calls it through the
    module).  With ``forced``, a list of expert ids (G, T, K) a call, the
    i-th call routes to the i-th entry instead of its own top-k (a
    callable: to ``forced(router_logits)``): gates the softmax of its
    router logits at those experts, then the capacity check, as
    ``make_routing`` does."""
    import torch

    from repro_torch.core import moe_dispatch as md
    from repro_torch.kernels import ops
    make, seen = md.make_routing, []

    def recording(router_logits, *, num_experts, k, capacity, **kw):
        if forced is None:
            routing = make(router_logits, num_experts=num_experts, k=k,
                           capacity=capacity, **kw)
        else:
            ids = (forced(router_logits) if callable(forced)
                   else forced[len(seen)])
            gates = torch.softmax(torch.gather(
                router_logits, -1, ids.long()).float(), dim=-1)
            pos, dest = ops.moe_route_transform(
                ids, num_experts=num_experts, capacity=capacity)
            routing = md.Routing(
                ids, torch.where(pos < capacity, gates, 0.0), pos, dest,
                torch.softmax(router_logits.float(), dim=-1), num_experts,
                capacity)
        seen.append((routing.expert_ids.clone(),
                     router_logits.detach().float().clone()))
        return routing
    md.make_routing = recording
    try:
        yield seen
    finally:
        md.make_routing = make


def peak_gib():
    import torch
    return torch.cuda.max_memory_allocated() / 2**30


def mixtral_config(dev, compare, smi):
    """Mixtral-8x22B, 4 of 56 layers.  Layer 0's routing on the moe_route
    kernel and its dispatch and combine on both crossbar kernels against
    their plain versions (bit-exact); the prompt forward (2 x 5120 tokens,
    window 4096) under 'auto', 'kernel' and 'sparse', counted, logit rows
    of the three within 1e-2 in L2; ``ServingEngine`` at a window of 32,
    in bf16 and in float32 compute, every decode row within
    ``MIXTRAL_BF16_DRIFT`` / ``MIXTRAL_F32_DRIFT`` in L2 of the parallel
    forward at that window, teacher-forced on decode's tokens and
    experts, where decode's experts differ from that forward's own top-k
    only at near-ties (``MIXTRAL_NEAR_TIE``, ``MIXTRAL_MAX_FLIPS``).
    Returns the counted launches (the bf16 serving run's)."""
    import dataclasses

    import torch

    from repro_torch import _tree
    from repro_torch.configs import mixtral_8x22b
    from repro_torch.core import moe_dispatch as md
    from repro_torch.kernels import launch_counts, ops, ref
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels import crossbar_permute as xbk
    from repro_torch.kernels import moe_route as mrk
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import model_zoo
    from repro_torch.models import moe as M
    from repro_torch.models import params as MP
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeOptions, ServingEngine

    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(mixtral_8x22b.CONFIG,
                              num_layers=MIXTRAL_LAYERS,
                              dispatch_backend="auto")
    e_, k_, d = cfg.num_experts, cfg.num_experts_per_tok, cfg.d_model
    secs, params = host_s(lambda: MP.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev))
    n_params = sum(t.numel() for t in _tree.leaves(params))
    log(f"configs phase: mixtral-8x22b, full width (d_model {d}, "
        f"{cfg.num_heads} heads, {cfg.num_kv_heads} kv, d_ff {cfg.d_ff}, "
        f"{e_} experts top-{k_}, window {cfg.sliding_window}), "
        f"{MIXTRAL_LAYERS} of {mixtral_8x22b.CONFIG.num_layers} layers: "
        f"{n_params / 1e9:.3f} B float32 parameters (param_count "
        f"{cfg.param_count() / 1e9:.3f} B) drawn on the card in {secs:.2f} s"
        f"; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    dtype = L.dtype_of(cfg.compute_dtype)
    cap = M.capacity_of(cfg, CONFIG_SEQ)
    g = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (MIXTRAL_BATCH, CONFIG_SEQ),
                           generator=g, device=dev, dtype=torch.int32)

    # ---- layer 0's kernels against their plain versions ----
    blk = params["blocks"][0]
    h = L.embed_lookup(params["embed"], tokens, dtype)
    x1 = h + A.attn_apply(blk["attn"], L.apply_norm(blk["ln1"], h,
                                                    cfg.norm), cfg)
    u = L.apply_norm(blk["ln2"], x1, cfg.norm)
    routing = md.make_routing(
        L.dense(blk["moe"]["router"], u, torch.bfloat16).float(),
        num_experts=e_, k=k_, capacity=cap)
    ids = routing.expert_ids.reshape(MIXTRAL_BATCH, -1).contiguous()
    geo = mrk.launch_geometry(*ids.shape, e_)
    want = ref.moe_route_transform(ids, num_experts=e_, capacity=cap)
    got = mrk.moe_route_cuda(ids, num_experts=e_, capacity=cap)
    for part, a, b, c in zip(("positions", "destinations"), got, want,
                             (routing.positions, routing.dest)):
        compare("moe_route", f"mixtral layer 0 routing {part} "
                f"{tuple(ids.shape)} E={e_} C={cap}, {geo['form']} form "
                f"(cluster {geo['cluster']}, {geo['threads']} threads, "
                f"{geo['chunks']} chunks)", a, b)
        compare("moe_route", f"mixtral layer 0 routing {part} through "
                "make_routing", c.reshape(MIXTRAL_BATCH, -1), b)
    route_ms = graph_ms(lambda: mrk.moe_route_cuda(
        ids, num_experts=e_, capacity=cap), 50)
    y = torch.randn((MIXTRAL_BATCH, e_, cap, d), generator=g,
                    device=dev).to(dtype)
    xb_ms, xb_bound, lib_ms = {}, {}, {}
    for part, plan, xin in (("dispatch", md.dispatch_plan(routing), u),
                            ("combine", md.combine_plan(routing), y)):
        x2 = xin.reshape(-1, d).contiguous()
        xb_bound[part] = crossbar_bound(plan, d, x2.element_size())
        args, kw = ops.sparse_operands(plan, x2)
        kw["out"].fill_(-7.0)
        kw_p = dict(kw, out=kw["out"].clone())
        compare("crossbar_sparse", f"mixtral layer 0 {part} "
                f"{plan.n_in}->{plan.n_out} D={d} bf16, tile-skipping "
                "kernel vs plain version",
                xbk.crossbar_permute_sparse_cuda(*args, **kw),
                ref.crossbar_sparse(*args, **kw_p))
        idxp, xf, kwd = ops.dense_operands(plan, x2)
        compare("crossbar_dense", f"mixtral layer 0 {part} "
                f"{plan.n_in}->{plan.n_out} D={d} bf16, dense kernel "
                "vs plain version",
                xbk.crossbar_permute_cuda(idxp, xf, **kwd),
                ref.crossbar_dense(idxp, xf, **kwd))
        xb_ms[part] = (
            graph_ms(lambda: xbk.crossbar_permute_sparse_cuda(*args,
                                                              **kw), 10),
            graph_ms(lambda: xbk.crossbar_permute_cuda(idxp, xf, **kwd),
                     10))
        # the library yardstick: one call that writes the pass's whole
        # output, as the dense kernel does (library_permute); held to the
        # dense kernel's plain version, which writes every row (the
        # tile-skipping kernel leaves unvisited tiles to apply_plan)
        lib_fn, lib_name = library_permute(plan, x2)
        want = ref.crossbar_dense(idxp, xf, **kwd)
        lib_diff = float((lib_fn().float() - want.float()).abs().max())
        check(part == "combine" or lib_diff == 0.0,
              f"mixtral layer 0 {part}: {lib_name} is {lib_diff} off the "
              "plain version")
        lib_ms[part] = (graph_ms(lib_fn, 10), lib_name, lib_diff)
    log(f"  mixtral layer 0 at the prompt shape, device ms by graph "
        f"replay: moe_route {route_ms:.4f}; dispatch tile-skipping "
        f"{xb_ms['dispatch'][0]:.4f}, dense {xb_ms['dispatch'][1]:.4f}; "
        f"combine tile-skipping {xb_ms['combine'][0]:.4f}, dense "
        f"{xb_ms['combine'][1]:.4f}; "
        f"{float(md.dropped_fraction(routing).mean()):.4f} of "
        f"assignments over capacity ({smi})")
    for part, (bms, by, rows_in, nb) in xb_bound.items():
        check(min(xb_ms[part]) >= bms, f"mixtral layer 0 {part}: "
              f"{min(xb_ms[part])} ms under its bound {bms} ms")
        log(f"  mixtral layer 0 {part} bound {bms:.4f} ms by {by} ({nb} B: "
            f"{rows_in} payload rows read, each output row written once); "
            f"tile-skipping {xb_ms[part][0] / bms:.2f}x, dense "
            f"{xb_ms[part][1] / bms:.2f}x of it; {lib_ms[part][1]} of the "
            f"whole output {lib_ms[part][0]:.4f} ms by graph replay (max "
            f"|diff| {lib_ms[part][2]:.3g} from the plain version) ({smi})")
    del h, x1, u, routing, y, args, kw, kw_p, idxp, xf, kwd, lib_fn, want

    with torch.inference_mode():
        # ---- the prompt forward under each backend, counted ----
        def forward(c):
            hid, aux = M.lm_hidden(params, tokens, c)
            return T.lm_logits(params, hid, c), aux

        total, heads = {}, {}
        for b in ("auto", "kernel", "sparse"):
            cb = dataclasses.replace(cfg, dispatch_backend=b)
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            first, (logits, aux) = host_s(lambda: forward(cb))
            counts = dict(launch_counts())
            check(tuple(logits.shape) == (MIXTRAL_BATCH, CONFIG_SEQ,
                                          cfg.padded_vocab)
                  and bool(torch.isfinite(logits).all()),
                  f"mixtral prompt forward ({b}): logits "
                  f"{tuple(logits.shape)} not finite or misshapen")
            crossbars = counts["crossbar_dense"] + counts["crossbar_sparse"]
            check(counts["moe_route"] == MIXTRAL_LAYERS
                  and crossbars == 2 * MIXTRAL_LAYERS
                  and (b == "auto" or counts[KERNEL_OF[b]] == crossbars),
                  f"mixtral prompt forward ({b}): launches {counts}, not "
                  f"one routing, one dispatch and one combine a layer")
            add_counts(total, counts)
            warm, _ = host_s(lambda: forward(cb))
            log(f"  mixtral prompt forward {MIXTRAL_BATCH} x {CONFIG_SEQ} "
                f"({b}): {first * 1e3:.2f} ms (counted, first), "
                f"{warm * 1e3:.2f} ms (warm); launches {counts}; dropped "
                f"{float(aux['dropped']):.4f}; peak {peak_gib():.2f} GiB "
                f"({smi})")
            heads[b] = logits
            del logits, aux
        for b in ("kernel", "sparse"):
            close_rows(f"mixtral prompt logits {b} vs auto", heads[b],
                       heads["auto"], TOL_BF16["rtol"])
        del heads
        prof = profile_call("mixtral prompt forward (auto)",
                            lambda: forward(cfg), rows=8)
        log(f"  mixtral prompt forward (auto): idle share "
            f"{1 - prof['busy_ms'] / prof['wall_ms']:.4f}, "
            f"{sum(c for c, _ in prof['kernels'].values())} device kernels "
            f"({smi})")
        torch.cuda.empty_cache()

    # ---- serving at a window of 32 against the parallel forward ----
    # The router's logits are bf16, so a near-tie between two experts
    # can order them one way in decode and the other in the parallel
    # forward, whose inputs differ in the last bits: such a token takes
    # another expert, and its row differs by far more than rounding.  So
    # the rows are held to the parallel forward teacher-forced on decode's
    # tokens and on its experts (``recorded_routing(forced)``); the free
    # parallel forward's routing and rows are printed beside it.  Decode
    # routes one token a group at capacity 2 and drops nothing; the
    # parallel forward gets the capacity factor E / K, so that nothing
    # drops there either.
    cfg_w = dataclasses.replace(cfg, sliding_window=MIXTRAL_WINDOW)
    prompts = torch.randint(0, cfg.vocab_size, (MIXTRAL_SLOTS, MIXTRAL_PROMPT),
                            generator=g, device=dev).tolist()
    steps = MIXTRAL_PROMPT - 1 + MIXTRAL_NEW

    def serve(c):
        """4 greedy requests through ``ServingEngine`` on ``c``: seconds,
        tokens, decode logit rows (B, steps, V), each routing call's
        (expert ids, router logits), launches, the model API."""
        api = model_zoo.build(c, dev)
        rows = []

        def recording_decode(p, t1, caches, pos):
            logits, caches = api.decode_fn(p, t1, caches, pos)
            rows.append(logits[:, -1].clone())
            return logits, caches

        engine = ServingEngine(
            dataclasses.replace(api, decode_fn=recording_decode),
            ServeOptions(batch_slots=MIXTRAL_SLOTS,
                         max_new_tokens=MIXTRAL_NEW),
            max_seq=MIXTRAL_PROMPT + MIXTRAL_NEW)
        reset_launch_counts()
        with recorded_routing() as seen:
            secs, outs = host_s(lambda: engine.generate(params, prompts))
        counts = dict(launch_counts())
        check(len(outs) == MIXTRAL_SLOTS and all(
            len(o) == MIXTRAL_NEW and all(0 <= t < cfg.padded_vocab
                                          for t in o) for o in outs)
            and len(rows) == steps,
            f"mixtral serving: {[len(o) for o in outs]} tokens, "
            f"{len(rows)} decode steps")
        check(counts["moe_route"] == MIXTRAL_LAYERS * steps,
              f"mixtral serving launches {counts}: not one routing a layer "
              "a step")
        return secs, outs, torch.stack(rows, dim=1), seen, counts, api

    def against_parallel(c, outs, decoded, seen, limit):
        """Hold decode's rows to the parallel forward on its tokens and
        experts within ``limit``; print the free parallel forward's
        routing differences and rows."""
        label = f"mixtral {c.compute_dtype} decode"
        c_par = dataclasses.replace(c, capacity_factor=e_ / k_)
        full = torch.as_tensor([p + o for p, o in zip(prompts, outs)],
                               device=dev)
        with torch.inference_mode(), recorded_routing() as par:
            hid, aux = M.lm_hidden(params, full, c_par)
            free = T.lm_logits(params, hid, c_par)
        check(float(aux["dropped"]) == 0.0,
              f"{label}: the parallel forward dropped {float(aux['dropped'])}")
        dec = [[seen[j * MIXTRAL_LAYERS + li] for j in range(steps)]
               for li in range(MIXTRAL_LAYERS)]
        forced = [torch.cat([i_ for i_, _ in dec[li]]
                            + [par[li][0][:, steps:]], dim=1)
                  for li in range(MIXTRAL_LAYERS)]
        with torch.inference_mode(), recorded_routing(forced) as took:
            hid, aux = M.lm_hidden(params, full, c_par)
            parallel = T.lm_logits(params, hid, c_par)
        check(float(aux["dropped"]) == 0.0 and all(
            torch.equal(a, f) for (a, _), f in zip(took, forced)),
            f"{label}: the parallel forward did not take decode's experts")

        def swaps(chosen_of, logits_of):
            """(step, layer, slot) choices where decode's experts differ
            from ``chosen_of``, and the largest gap there in
            ``logits_of``'s router logits between an expert only it chose
            and one only decode chose."""
            n, worst = 0, 0.0
            for li in range(MIXTRAL_LAYERS):
                for j in range(steps):
                    pl = logits_of(li, j)
                    a = dec[li][j][0][:, 0].sort(-1).values
                    b = chosen_of(li, j).sort(-1).values
                    for slot in torch.nonzero(
                            (a != b).any(-1)).flatten().tolist():
                        n += 1
                        only_d = [e for e in a[slot].tolist()
                                  if e not in b[slot].tolist()]
                        only_p = [e for e in b[slot].tolist()
                                  if e not in a[slot].tolist()]
                        worst = max(worst, float(pl[slot, only_p].max()
                                                 - pl[slot, only_d].min()))
            return n, worst

        def drift(logits_of):
            return max(float((dec[li][j][1][:, 0] - logits_of(li, j))
                             .abs().max())
                       for li in range(MIXTRAL_LAYERS) for j in range(steps))

        choices = steps * MIXTRAL_LAYERS * MIXTRAL_SLOTS
        # the free parallel forward, whose history differs once a choice
        # flips (a flip changes later layers' and positions' inputs)
        flips, gap = swaps(lambda li, j: par[li][0][:, j],
                           lambda li, j: par[li][1][:, j])
        # on decode's history: its own top-k of its router logits
        own, own_gap = swaps(
            lambda li, j: took[li][1][:, j].topk(k_, dim=-1).indices,
            lambda li, j: took[li][1][:, j])
        log(f"  {label}: the parallel forward on decode's experts would "
            f"itself pick others at {own} of {choices} (step, layer, slot) "
            f"choices, its router logits of the swapped experts at most "
            f"{own_gap:.6f} apart (limits {MIXTRAL_MAX_FLIPS:.4f} of the "
            f"choices, {MIXTRAL_NEAR_TIE}); its router logits and decode's "
            f"at most {drift(lambda li, j: took[li][1][:, j]):.6f} apart")
        free_rel = (torch.linalg.vector_norm(decoded - free[:, :steps], dim=-1)
                    / torch.linalg.vector_norm(free[:, :steps], dim=-1))

        def agree(logits):
            return sum(int(o[t] == int(logits[i, MIXTRAL_PROMPT - 1 + t]
                                       .argmax()))
                       for i, o in enumerate(outs) for t in range(MIXTRAL_NEW))
        log(f"  {label}: the free parallel forward picks other experts than "
            f"decode at {flips} of {choices} (step, layer, slot); the "
            f"swapped experts' router logits differ by at most {gap:.6f} "
            f"there, the two paths' router logits by at most "
            f"{drift(lambda li, j: par[li][1][:, j]):.6f}; rows against the "
            f"free parallel forward: worst L2 relative error "
            f"{float(free_rel.max()):.3e}, "
            f"{int((free_rel > limit).sum())} rows over {limit}; greedy "
            f"tokens equal its argmax at {agree(free)} of "
            f"{MIXTRAL_SLOTS * MIXTRAL_NEW}, the forced parallel argmax at "
            f"{agree(parallel)}")
        check(own <= MIXTRAL_MAX_FLIPS * choices and own_gap
              <= MIXTRAL_NEAR_TIE, f"{label}: decode's experts differ from "
              f"the parallel forward's own top-k at {own} of {choices} "
              f"choices, by up to {own_gap} in router logit: not near-ties")
        close_rows(f"{label} rows (positions 0-{steps - 1}, window "
                   f"{MIXTRAL_WINDOW}) vs the parallel forward on decode's "
                   "experts", decoded, parallel[:, :steps], limit)

    torch.cuda.reset_peak_memory_stats()
    secs, outs, decoded, seen, counts, api = serve(cfg_w)
    add_counts(total, counts)
    log(f"  mixtral serving, window {MIXTRAL_WINDOW}: {MIXTRAL_SLOTS} greedy "
        f"requests of {MIXTRAL_PROMPT} prompt tokens, {MIXTRAL_NEW} new each: "
        f"{secs:.3f} s for {steps} decode steps ({secs / steps * 1e3:.2f} ms "
        f"a step), launches {counts}; peak {peak_gib():.2f} GiB ({smi})")
    against_parallel(cfg_w, outs, decoded, seen, MIXTRAL_BF16_DRIFT)
    # the same requests in float32 compute on the same weights, held to
    # 6e-3 a row, which bf16 rounding over 4 layers exceeds
    cfg_32 = dataclasses.replace(cfg_w, compute_dtype="float32")
    secs32, outs32, decoded32, seen32, _, _ = serve(cfg_32)
    log(f"  mixtral serving in float32 compute: {secs32 / steps * 1e3:.2f} "
        f"ms a step ({smi})")
    against_parallel(cfg_32, outs32, decoded32, seen32, MIXTRAL_F32_DRIFT)
    del decoded32, seen32
    caches = api.init_caches(MIXTRAL_SLOTS, MIXTRAL_PROMPT + MIXTRAL_NEW,
                             torch.float32)
    tok1 = torch.as_tensor([p[:1] for p in prompts], device=dev)

    def one_step():
        with torch.inference_mode():
            return api.decode_fn(params, tok1, caches, 0)
    prof = profile_call(f"mixtral decode step ({MIXTRAL_SLOTS} slots)",
                        one_step, rows=6)
    log(f"  mixtral decode step: idle share "
        f"{1 - prof['busy_ms'] / prof['wall_ms']:.4f}, "
        f"{sum(c for c, _ in prof['kernels'].values())} device kernels a "
        f"step ({smi})")
    del params, decoded, seen, caches
    torch.cuda.empty_cache()
    return total


def dense_config(dev, arch, layers, smi):
    """One dense config at published width, ``layers`` of its depth:
    ``transformer.prefill`` of 1 x ``CONFIG_SEQ`` tokens, then
    ``DENSE_NEW`` greedy decode steps, each logit row (the prefill's
    included) within 1e-2 in L2 of the parallel forward's."""
    import dataclasses

    import torch

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import params as MP
    from repro_torch.models import transformer as T

    torch.cuda.reset_peak_memory_stats()
    full_cfg = get_config(arch)
    cfg = dataclasses.replace(full_cfg, num_layers=layers)
    secs, params = host_s(lambda: MP.init_params(
        cfg, torch.Generator(device=dev).manual_seed(1), dev))
    n_params = sum(t.numel() for t in _tree.leaves(params))
    g = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (1, CONFIG_SEQ), generator=g,
                           device=dev, dtype=torch.int32)
    max_seq = CONFIG_SEQ + DENSE_NEW
    reset_launch_counts()
    with torch.inference_mode():
        T.prefill(params, prompt, cfg, max_seq=max_seq)        # warm-up
        t_pre, (logits, caches) = host_s(lambda: T.prefill(
            params, prompt, cfg, max_seq=max_seq))
        ring = caches["k"].shape[2]
        steps_logits, fed = [logits[:, -1]], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(DENSE_NEW):
            tok = steps_logits[-1].argmax(-1).to(torch.int32)[:, None]
            fed.append(tok)
            logits, caches = T.decode_step(params, tok, caches,
                                           CONFIG_SEQ + j, cfg)
            steps_logits.append(logits[:, -1])
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        # The parallel forward over the prompt and the fed tokens, padded
        # to a whole number of attention chunks (a ragged length would be
        # one chunk): causal attention keeps the padding out of every
        # compared row.  Logits only for the compared rows.
        full = torch.cat([prompt] + fed, dim=1)
        chunk = min(cfg.attn_chunk, full.shape[1])
        padded = torch.nn.functional.pad(full, (0, -full.shape[1] % chunk))
        hid = T.lm_hidden(params, padded, cfg)
        parallel = T.lm_logits(params, hid[:, CONFIG_SEQ - 1:max_seq], cfg)
    counts = dict(launch_counts())
    check(sum(counts.values()) == 0,
          f"{arch}: launches {counts}; the dense family reaches no kernel")
    close_rows(f"{arch} prefill and decode logits (positions "
               f"{CONFIG_SEQ - 1}-{max_seq - 1}) vs the parallel forward",
               torch.stack(steps_logits, dim=1), parallel, TOL_BF16["rtol"])
    agree = sum(int(torch.equal(f[:, 0], parallel[:, j].argmax(-1)
                                .to(torch.int32)))
                for j, f in enumerate(fed))
    tok1 = fed[-1]

    def one_step():
        with torch.inference_mode():
            return T.decode_step(params, tok1, caches, max_seq - 1, cfg)
    prof = profile_call(f"{arch} decode step (1 slot)", one_step, rows=6)
    log(f"  {arch} full width (d_model {cfg.d_model}, {cfg.num_heads} heads"
        f", {cfg.num_kv_heads} kv, head_dim {cfg.hd}, d_ff {cfg.d_ff} "
        f"{cfg.act}, {cfg.norm}, vocab {cfg.vocab_size}, window "
        f"{cfg.sliding_window or 'none'}, rotary {cfg.rotary_pct}, qkv bias "
        f"{cfg.qkv_bias}), {layers} of {full_cfg.num_layers} layers: "
        f"{n_params / 1e9:.3f} B float32 parameters (param_count "
        f"{cfg.param_count() / 1e9:.3f} B) drawn in {secs:.2f} s; prefill "
        f"1 x {CONFIG_SEQ} {t_pre * 1e3:.2f} ms (warm), K/V cache of "
        f"{ring} slots; {DENSE_NEW} greedy decode steps "
        f"{t_dec / DENSE_NEW * 1e3:.2f} ms a step, idle share "
        f"{1 - prof['busy_ms'] / prof['wall_ms']:.4f}, "
        f"{sum(c for c, _ in prof['kernels'].values())} device kernels a "
        f"step; greedy tokens equal the parallel argmax at {agree} of "
        f"{DENSE_NEW}; peak {peak_gib():.2f} GiB ({smi})")
    del params, caches, parallel, hid
    torch.cuda.empty_cache()
    return counts


def configs_phase(dev, compare, smi):
    """The four configurations no earlier phase ran, one at a time:
    Mixtral-8x22B (``mixtral_config``), then Qwen1.5-110B, StarCoder2-15B
    and StableLM-12B (``dense_config``).  Returns the counted launches."""
    total = dict(mixtral_config(dev, compare, smi))
    for arch, layers in DENSE_CONFIGS:
        add_counts(total, dense_config(dev, arch, layers, smi))
    log(f"  configs launches {total}")
    return total


def main(argv) -> int:
    import torch
    opts = dict(zip(argv[::2], argv[1::2]))
    if len(argv) % 2 or set(opts) - {"--parent", "--phases"}:
        print("usage: chip_smoke.py [--parent CHECKOUT] [--phases "
              "chacha,gcm]", file=sys.stderr)
        return 2
    parent = Path(opts["--parent"]).resolve() if "--parent" in opts \
        else None
    phases = opts["--phases"].split(",") if "--phases" in opts else None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch._device import no_tf32
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
    from repro_torch.kernels import fused_compress as fck
    from repro_torch.kernels import moe_route as mrk

    t_start = time.perf_counter()
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

    err = {"crossbar_dense": 0.0, "crossbar_sparse": 0.0, "plan_program": 0.0,
           "moe_route": 0.0, "fused_vcompress": 0.0}

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

    word_parent = None if parent is None else parent_word(parent)
    if phases is not None:
        # the megakernel's word-layout phases alone (for timing them)
        for ph in phases:
            {"chacha": chacha_phase, "gcm": gcm_phase}[ph](
                dev, compare, word_parent)
        log(f"phases {phases}: done in {time.perf_counter() - t_start:.1f} s")
        return 0

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
    dense_case("weighted REAL scatter, collisions (4096, 256)", scat, x_f)
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

    log("both crossbars vs plain versions: edge cases")

    def plain_on(cpu, fn, *args_, **kw_):
        """fn's result on the card, or on CPU copies of its operands."""
        if not cpu:
            return fn(*args_, **kw_)
        host = [a.cpu() if torch.is_tensor(a) else a for a in args_]
        return fn(*host, **{n: v.cpu() if torch.is_tensor(v) else v
                            for n, v in kw_.items()})

    # a generator of their own: the later paths draw the inputs they drew
    # before these cases existed
    for name, plan, x, merge, tol, cpu in crossbar_cases(
            dev, np.random.default_rng(1)):
        idxp, xf, kw = ops.dense_operands(plan, x, merge=merge)
        got = xbk.crossbar_permute_cuda(idxp, xf, **kw)
        compare("crossbar_dense", f"dense {name}", got.cpu() if cpu else got,
                plain_on(cpu, ref.crossbar_dense, idxp, xf, **kw), tol)
        n_dense = xbk.DEVICE_LAUNCHES["crossbar_dense"]
        args, kw = ops.sparse_operands(plan, x)
        kw["out"].fill_(-7.0)
        kw_p = dict(kw, out=kw["out"].clone())
        got = xbk.crossbar_permute_sparse_cuda(*args, **kw)
        compare("crossbar_sparse", f"tile-skipping {name}",
                got.cpu() if cpu else got,
                plain_on(cpu, ref.crossbar_sparse, *args, **kw_p), tol)
        log(f"    device launches a call: dense {n_dense}, tile-skipping "
            f"{xbk.DEVICE_LAUNCHES['crossbar_sparse']}")
        if merge is not None:
            compare("crossbar_sparse", f"apply_plan sparse {name}",
                    xb.apply_plan(plan, x, merge=merge, backend="sparse"),
                    xb.apply_plan(plan, x, merge=merge, backend="reference"))

    # ------------------------------------------------------ megakernel ---
    log("plan-program megakernel vs plain VM, both layouts")
    prog = K.megakernel_program(dev)
    ctl = pp.control_for(prog, dev)
    check(ctl["layout"] == "packed" and pp.bit_sliceable(prog),
          f"keccak_f1600 program takes the {ctl['layout']} layout")
    chunk = ppk.packed_chunk(prog.n, ctl["n_phys"], ctl["blob_words"],
                             ppk.smem_optin(dev))
    smem_words = ppk.packed_smem_words(prog.n, ctl["n_phys"],
                                       ctl["blob_words"]) + 32 * chunk
    log(f"  keccak_f1600 program: packed layout, {ctl['n_steps']} steps a "
        f"round ({int(ctl['phys_steps'][:, 6].sum())} barriers), renaming "
        f"period {ctl['period']} rounds, control blob "
        f"{ctl['blob_words'] * 4} B, {smem_words * 4} B of shared memory a "
        f"CTA of 32 lanes ({chunk} staged rows)")

    def vm(state, ctl_):
        return ref.plan_program_vm(state, *pp.vm_operands(ctl_),
                                   n_regs=ctl_["n_regs"],
                                   rounds=ctl_["rounds"],
                                   const_stride=ctl_["const_stride"])

    st = t_int01(1600, 1024)
    want = vm(st, ctl)
    for layout in ("packed", "word"):
        got = ppk.plan_program_cuda(st, ctl, layout=layout)
        torch.cuda.synchronize()
        compare("plan_program", f"keccak_f1600 program, {layout} layout, "
                "1024 lanes 0/1", got, want)
    compare("plan_program", "keccak_f1600 program, packed layout's plain "
            "emulation, 1024 lanes", ref.plan_program_packed(st, ctl), want)
    # ragged widths and int32 states whose high bits the program never
    # reads, from a generator of their own (the later paths draw the
    # inputs they drew before these cases existed)
    rng_mk = np.random.default_rng(2)
    for d in (1, 31, 33, 1000):
        for kind in ("0/1", "int32"):
            hi = 2 if kind == "0/1" else 2**31
            sd = torch.as_tensor(rng_mk.integers(-hi if hi > 2 else 0, hi,
                                                 (1600, d), dtype=np.int32),
                                 device=dev)
            want_d = vm(sd, ctl)
            for layout in ("packed", "word"):
                compare("plan_program", f"keccak_f1600 program, {layout} "
                        f"layout, {d} lanes {kind}",
                        ppk.plan_program_cuda(sd, ctl, layout=layout),
                        want_d)

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
    ctl_syn = pp.control_for(syn, dev)
    check(ctl_syn["layout"] == "word" and not pp.bit_sliceable(syn),
          f"all-opcode program takes the {ctl_syn['layout']} layout")
    su = torch.as_tensor(rng.integers(0, 2**32, (n_syn, 77), dtype=np.uint64)
                         .astype(np.uint32).view(np.int32),
                         device=dev).view(torch.uint32)
    got = ppk.plan_program_cuda(su, ctl_syn)
    want = vm(su, ctl_syn)
    torch.cuda.synchronize()
    compare("plan_program", "all-opcode uint32 program, weighted ADD plan, "
            "word layout", got.view(torch.int32), want.view(torch.int32))
    chained = pp.run_program(syn, su, backend="chained",
                             pass_backend="einsum")
    compare("plan_program", "same program, megakernel vs chained",
            pp.run_program(syn, su).view(torch.int32),
            chained.view(torch.int32))

    # ------------------------------------------------ moe_route kernel ---
    log("moe_route kernel vs plain version")
    for g, t, e_, c in ((MOE_BATCH, MOE_SEQ, 16, 384),    # prompt forward
                        (SERVE_SLOTS, 1, 16, 2),          # decode step
                        (3, 1000, 7, 50)):                 # ragged chunks
        ids = torch.as_tensor(rng.integers(-1, e_ + 2, (g, t * 2),
                                           dtype=np.int32), device=dev)
        got = mrk.moe_route_cuda(ids, num_experts=e_, capacity=c)
        want = ref.moe_route_transform(ids, num_experts=e_, capacity=c)
        torch.cuda.synchronize()
        for part, a, b in zip(("pos", "dest"), got, want):
            compare("moe_route", f"({g}, {t}x2) ids in [-1, {e_ + 2}), "
                    f"E={e_} C={c}: {part}", a, b)
    # the forms' edges, from a generator of their own (the later paths
    # draw the inputs they drew before these cases existed)
    for name, ids, e_, c, over in route_cases(dev, np.random.default_rng(3)):
        geo = mrk.launch_geometry(*ids.shape, e_, **over)
        got = mrk.moe_route_cuda(ids, num_experts=e_, capacity=c, **over)
        want = ref.moe_route_transform(ids, num_experts=e_, capacity=c)
        torch.cuda.synchronize()
        for part, a, b in zip(("pos", "dest"), got, want):
            compare("moe_route", f"{name}, {geo['form']} form (cluster "
                    f"{geo['cluster']}, {geo['threads']} threads, "
                    f"{geo['chunks']} chunks): {part}", a, b)
        if name.startswith(("(300, 2)", "(1, 65536)", "(2, 4096) E=1024")):
            work = device_work(lambda: mrk.moe_route_cuda(
                ids, num_experts=e_, capacity=c, **over), calls=4)
            check(len(work) == 1 and work[0][1] == 4
                  and "route_" in work[0][0],
                  f"moe_route {name}: device work of 4 calls {work}, not "
                  "one kernel a call")
            log(f"    one device kernel a call ({work[0][0][:60]})")

    # ------------------------------------------ fused vcompress kernel ---
    log("fused vcompress kernel vs plain version")
    for dt in (torch.bfloat16, torch.float32):
        xc = torch.as_tensor(rng.standard_normal((2048, 4096), np.float32),
                             device=dev).to(dt)
        mc = torch.as_tensor(rng.random(2048) < 0.4, device=dev)
        for tail in ("zero", "bijective"):
            got = fck.fused_vcompress_cuda(mc, xc, tail=tail)
            compare("fused_vcompress", f"(2048, 4096) {dt} tail={tail}",
                    got, ref.fused_vcompress(mc, xc, tail=tail))
    xo = torch.as_tensor(rng.standard_normal((5000, 7), np.float32),
                         device=dev)
    mo = torch.as_tensor(rng.random(5000) < 0.5, device=dev)
    compare("fused_vcompress", "(5000, 7) f32, N over one TPU block",
            fck.fused_vcompress_cuda(mo, xo), ref.fused_vcompress(mo, xo))
    for mdt in (torch.int8, torch.int32, torch.float32):
        m_ = mo.to(mdt)
        for tail in ("zero", "bijective"):
            compare("fused_vcompress", f"(5000, 7) f32, {mdt} mask, "
                    f"tail={tail}", fck.fused_vcompress_cuda(m_, xo,
                                                             tail=tail),
                    ref.fused_vcompress(m_, xo, tail=tail))

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
    for name in ("crossbar_dense", "crossbar_sparse", "plan_program"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the SHA-3 path")
    layouts = dict(ppk.LAYOUT_LAUNCHES)
    check(layouts["packed"] == launches["plan_program"]
          and layouts["word"] == 0,
          f"the SHA-3 path's megakernel launches by layout: {layouts}")
    log(f"  megakernel launches by layout: {layouts}")

    # ------------------------------------------ fused vcompress, counted ---
    log("fused vcompress path, its entry point (launch counters from 0)")
    reset_launch_counts()
    vc_x = torch.as_tensor(rng.standard_normal((2048, 4096), np.float32),
                           device=dev).to(torch.bfloat16)
    vc_mask = torch.as_tensor(rng.random(2048) < 0.5, device=dev)
    for tail in ("zero", "bijective"):
        got = ops.fused_vcompress(vc_mask, vc_x, tail=tail)
        check(torch.equal(got, ref.fused_vcompress(vc_mask, vc_x, tail=tail)),
              f"ops.fused_vcompress tail={tail} != plain version")
    vc_counts = dict(launch_counts())
    check(vc_counts["fused_vcompress"] == 2,
          f"fused vcompress path launched {vc_counts['fused_vcompress']}")
    log(f"  ops.fused_vcompress (2048, 4096) bf16, both tails: equal the "
        f"plain version; launches {vc_counts}")
    add_counts(launches, vc_counts)
    for mdt in (torch.bool, torch.int8, torch.int32):
        m_ = vc_mask.to(mdt)
        for tail in ("zero", "bijective"):
            work = device_work(lambda: ops.fused_vcompress(m_, vc_x,
                                                           tail=tail),
                               calls=4)
            check(len(work) == 1 and work[0][1] == 4
                  and "fused_vcompress" in work[0][0],
                  f"fused vcompress, {mdt} mask, tail={tail}: device work "
                  f"of 4 calls {work}, not one kernel a call")
        log(f"  {mdt} mask: one device kernel a call, both tails "
            f"({work[0][0][:70]})")

    moe = moe_phases(dev, rng, compare)
    add_counts(launches, moe["launches"])
    add_counts(launches, chacha_phase(dev, compare, word_parent))
    add_counts(launches, aes_phase(dev, compare))
    gcm_counts, gcm_stats = gcm_phase(dev, compare, word_parent)
    add_counts(launches, gcm_counts)
    obs_phase(dev, msgs)
    log(f"  launches over every counted path: {launches}")

    # ---------------------------------------------------------- timing ---
    log("timing (warm, after warm-up): device ms by CUDA-graph replay; "
        "eager ms (CUDA events around Python calls) in brackets")
    rows, eager, lib_eager = [], {}, {}

    # dense at the per-round Keccak shape (rho_pi, 1024 payload lanes)
    idxp, xf, kw = ops.dense_operands(rho_pi, x_bits)
    src = rho_pi.idx[:, 0].long()
    ms, eager["crossbar_dense"] = timed(
        lambda: xbk.crossbar_permute_cuda(idxp, xf, **kw), 50)
    plain = time_ms(lambda: ref.crossbar_dense(idxp, xf, **kw), 10)
    lib, lib_eager["crossbar_dense"] = timed(
        lambda: torch.index_select(xf, 0, src), 50)
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
    ms_w = graph_ms(lambda: xbk.crossbar_permute_cuda(idxw, xw, **kww), 50)
    onehot = xb.build_onehot(wplan)
    with no_tf32():
        lib_w = graph_ms(lambda: torch.matmul(onehot, xw), 50)
    log(f"  dense weighted k=3 (2048, 256) f32: kernel {ms_w:.4f} ms, "
        f"one-hot torch.matmul (float32, no TF32) {lib_w:.4f} ms")

    # sparse at the block-diagonal Keccak shape (batch(rho_pi, 64))
    args, kw = ops.sparse_operands(bd64, x_bd)
    ms, eager["crossbar_sparse"] = timed(
        lambda: xbk.crossbar_permute_sparse_cuda(*args, **kw), 50)
    plain = time_ms(lambda: ref.crossbar_sparse(*args, **kw), 10)
    src_bd = bd64.idx[:, 0].long()
    lib, lib_eager["crossbar_sparse"] = timed(
        lambda: torch.index_select(args[4], 0, src_bd), 50)
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

    # megakernel: one Keccak-f[1600] over 1024 lanes, in the layout the
    # entry point takes (packed); the word layout and the all-opcode
    # program beside it
    stT = states.T.contiguous()
    ms, eager["plan_program"] = timed(
        lambda: ppk.plan_program_cuda(stT, ctl), 20)
    ms_word = graph_ms(lambda: ppk.plan_program_cuda(stT, ctl,
                                                     layout="word"), 20)
    ms_syn = graph_ms(lambda: ppk.plan_program_cuda(su, ctl_syn), 20)
    word_alt = {l_: graph_ms(lambda: ppk.plan_program_cuda(
        stT, ctl, layout="word", lanes=l_), 20) for l_ in (2, 4, 8)}
    log("  megakernel, keccak_f1600 word layout at other lanes a CTA: "
        + ", ".join(f"{k} ({ppk.word_threads(prog.n, k)} threads): {v:.4f}"
                    for k, v in word_alt.items()) + " ms")
    # the packed layout's fixed cost (state in and out, control staged)
    # and its cost a round: the same launch with 0 and 1 rounds
    st32 = stT[:, :32].contiguous()
    ms_r = [graph_ms(lambda: ppk.plan_program_cuda(
        x_, dict(ctl, rounds=r_)), 20)
        for x_ in (stT, st32) for r_ in (0, 1, prog.rounds)]
    plain = time_ms(lambda: vm(stT, ctl), 2)
    lanes = stT.shape[1]
    permute_selects = sum(int(ctl["kcnt"][s.plan]) for s in prog.steps
                          if s.op == "permute")
    elementwise = sum(1 for s in prog.steps if s.op != "permute")
    n_ops = lanes * prog.rounds * prog.n * (permute_selects + elementwise)
    words = -(-lanes // 32)
    packed_ops = words * prog.rounds * prog.n * (permute_selects
                                                 + elementwise)
    # the packed kernel reads the state and its control blob and writes
    # the state; the word layout's bound counts one operation a lane
    nb = 2 * stT.numel() * 4 + ctl["blob_words"] * 4
    bms, by = bound(nb, packed_ops)
    old_b, old_by = bound(2 * stT.numel() * 4 + sum(
        t.numel() * 4 for t in pp.vm_operands(ctl) if t is not None), n_ops)
    log(f"  megakernel, keccak_f1600 x {lanes} lanes: packed {ms:.4f} ms "
        f"[{eager['plan_program']:.4f} eager], word layout {ms_word:.4f} ms;"
        f" bound {bms:.5f} ms ({by}: {nb} B, {packed_ops} word operations);"
        f" the word layout's yardstick, one operation a lane: {old_b:.5f} ms"
        f" ({old_by}, {n_ops} operations)")
    log(f"  megakernel, all-opcode program (256 rows, 77 lanes, 3 rounds, "
        f"word layout): {ms_syn:.4f} ms")
    for i, lanes_ in ((0, lanes), (3, 32)):
        log(f"  megakernel, packed, keccak_f1600 program at {lanes_} lanes "
            f"cut to 0, 1 and {prog.rounds} rounds: {ms_r[i]:.4f}, "
            f"{ms_r[i + 1]:.4f}, {ms_r[i + 2]:.4f} ms; "
            f"{(ms_r[i + 2] - ms_r[i]) / prog.rounds:.5f} ms a round")
    rows.append(dict(name="plan_program", route="cuda",
                     source="src/repro_torch/kernels/csrc/plan_program.cu",
                     replaces="src/repro/kernels/plan_program_kernel.py:188",
                     launches=launches["plan_program"],
                     max_abs_err=err["plan_program"], ms=ms, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=None))
    # moe_route at the prompt forward's shape, on layer 0's routing ids
    ids_p = moe["route_ids"]
    kw_r = dict(num_experts=16, capacity=moe["capacity"])
    ms, eager["moe_route"] = timed(
        lambda: mrk.moe_route_cuda(ids_p, **kw_r), 200)
    plain = time_ms(lambda: ref.moe_route_transform(ids_p, **kw_r), 20)
    bms, by = bound(ids_p.numel() * 4 * 3, 2 * ids_p.numel())
    rows.append(dict(name="moe_route", route="cuda",
                     source="src/repro_torch/kernels/csrc/moe_route.cu",
                     replaces="src/repro/kernels/moe_route.py:51",
                     launches=launches["moe_route"],
                     max_abs_err=err["moe_route"], ms=ms, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=None))
    route_timing(dev, rng, None if parent is None else parent_route(parent))

    # fused vcompress, (2048, 4096) bf16, bijective tail; the library
    # yardstick is one index_select with the packed order computed ahead.
    # Warm: the same inputs every call (33.5 MB, resident in the 50 MB L2
    # across replays); cold: inputs rotated over 4 sets (67 MB of inputs).
    order = torch.argsort((~vc_mask).to(torch.int8), stable=True)
    ms, eager["fused_vcompress"] = timed(
        lambda: fck.fused_vcompress_cuda(vc_mask, vc_x, tail="bijective"),
        200)
    ms_zero = graph_ms(lambda: fck.fused_vcompress_cuda(vc_mask, vc_x), 200)
    plain = time_ms(lambda: ref.fused_vcompress(vc_mask, vc_x,
                                                tail="bijective"), 20)
    lib, lib_eager["fused_vcompress"] = timed(
        lambda: torch.index_select(vc_x, 0, order), 200)
    sets = [(vc_mask, vc_x, order)]
    for _ in range(3):
        m_ = torch.as_tensor(rng.random(2048) < 0.5, device=dev)
        sets.append((m_, torch.randn_like(vc_x),
                     torch.argsort((~m_).to(torch.int8), stable=True)))
    ms_cold = cold_ms(lambda i: fck.fused_vcompress_cuda(
        sets[i][0], sets[i][1], tail="bijective"), len(sets), 200)
    lib_cold = cold_ms(lambda i: torch.index_select(sets[i][1], 0,
                                                    sets[i][2]),
                       len(sets), 200)
    ms_warm2 = graph_ms(lambda: fck.fused_vcompress_cuda(
        vc_mask, vc_x, tail="bijective"), 200)
    lib_warm2 = graph_ms(lambda: torch.index_select(vc_x, 0, order), 200)
    nb = vc_mask.numel() + 2 * vc_x.numel() * vc_x.element_size()
    bms, by = bound(nb, vc_mask.numel())
    rows.append(dict(name="fused_vcompress", route="cuda",
                     source="src/repro_torch/kernels/csrc/fused_compress.cu",
                     replaces="src/repro/kernels/fused_compress.py:62",
                     launches=launches["fused_vcompress"],
                     max_abs_err=err["fused_vcompress"], ms=ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=lib))
    log(f"  fused_vcompress (2048, 4096) bf16: warm {ms:.4f}, {ms_warm2:.4f}"
        f" ms (tail=zero {ms_zero:.4f}), L2-cold {ms_cold:.4f} ms; "
        f"index_select warm {lib:.4f}, {lib_warm2:.4f} ms, L2-cold "
        f"{lib_cold:.4f} ms; bound {bms:.5f} ms ({by})")
    del sets

    smem_reads = lanes * prog.rounds * prog.n * (permute_selects
                                                 + 2 * elementwise)
    log(f"  megakernel: {smem_reads} shared-memory word reads (gathers + "
        f"elementwise operands) for {lanes} lanes in the word layout, "
        f"{smem_reads // lanes * words} in the packed layout (plus its "
        f"{words * prog.rounds * prog.n * permute_selects} int16 plan "
        "reads)")

    t = time.perf_counter()
    digests = K.sha3_256_batched(msgs, backend="megakernel", device=dev)
    torch.cuda.synchronize()
    sha_s = time.perf_counter() - t
    log(f"  sha3_256_batched 1024 x 1 KiB (megakernel, 8 permutations): "
        f"{sha_s * 1e3:.2f} ms host clock, {1024 / sha_s:.1f} hashes/s")
    sha_more = [host_s(lambda: K.sha3_256_batched(
        msgs, backend="megakernel", device=dev))[0] * 1e3 for _ in range(3)]
    log(f"  sha3_256_batched again: {[round(t_, 2) for t_ in sha_more]} ms")
    prof = profile_call("sha3_256_batched 1024 x 1 KiB, megakernel",
                        lambda: K.sha3_256_batched(msgs, backend="megakernel",
                                                   device=dev), rows=8)
    mk = [(k, c, t_) for k, (c, t_) in prof["kernels"].items()
          if "pp_packed_kernel" in k or "pp_word_kernel" in k]
    mk_ms = sum(t_ for _, _, t_ in mk)
    check(sum(c for _, c, _ in mk) == 8,
          f"sha3_256_batched ran megakernels {mk}, not 8 launches")
    log(f"  sha3_256_batched: the 8 megakernel launches {mk_ms:.3f} ms of "
        f"{prof['wall_ms']:.2f} ms wall; the host time outside them "
        f"{prof['wall_ms'] - mk_ms:.2f} ms; other device work "
        f"{prof['busy_ms'] - mk_ms:.3f} ms; {prof['syncs']} host "
        "synchronisations")
    # The mesh phase, then serving last: serving's engines, threads and
    # pinned staging come after every earlier phase's profiler windows,
    # which ran as before it.
    log(f"before the mesh phase: {time.perf_counter() - t_start:.1f} s "
        "since the start")
    mesh_counts = mesh_phase(dev, msgs, moe["group0"], compare)
    add_counts(launches, mesh_counts)
    for r in rows:
        r["launches"] += mesh_counts.get(r["name"], 0)
        r["max_abs_err"] = err[r["name"]]
    log(f"before the serving phase: {time.perf_counter() - t_start:.1f} s "
        "since the start")
    serving = serving_phase(dev)
    add_counts(launches, serving)
    for r in rows:
        r["launches"] += serving.get(r["name"], 0)
    # The serving phases' MoE weights went with moe_phases; release what
    # the mesh phase kept of them before training takes the card.
    del moe
    torch.cuda.empty_cache()
    for name, run in (("baselines", lambda: baselines_phase(dev, compare)),
                      ("audit", lambda: audit_phase(dev)),
                      ("vlm", lambda: vlm_phase(dev, compare)),
                      ("encdec", lambda: encdec_phase(dev, compare)),
                      ("launcher", lambda: launcher_phase(dev)),
                      ("recurrent", lambda: recurrent_phase(dev, smi)),
                      ("training", lambda: train_phase(dev)),
                      ("train_families",
                       lambda: train_families_phase(dev, compare)),
                      ("examples", lambda: examples_phase(dev)),
                      ("sharding", lambda: sharding_phase(dev, compare)),
                      ("configs", lambda: configs_phase(dev, compare, smi))):
        t_phase = time.perf_counter()
        phase = run()
        log(f"phase {name}: {time.perf_counter() - t_phase:.1f} s wall "
            f"({time.perf_counter() - t_start:.1f} s since the start)")
        add_counts(launches, phase)
        for r in rows:
            r["launches"] += phase.get(r["name"], 0)
            r["max_abs_err"] = err[r["name"]]
    log(f"  launches over every counted path, serving included: {launches}")
    for r in rows:
        lib_txt = ("none" if r["library_ms"] is None else
                   f"{r['library_ms']:.4f} [{lib_eager[r['name']]:.4f}] ms")
        log(f"  {r['name']}: {r['ms']:.4f} [{eager[r['name']]:.4f}] ms "
            f"(bound {r['bound_ms']:.5f} ms by {r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms, library {lib_txt}")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
