"""Multi-pod dry run: a cell's per-device memory, cost and roofline on a
mesh of placeholder devices, for the NVIDIA H100.

Port of ``repro.launch.dryrun``.  For every (architecture x input shape
x mesh) cell the reference lowers and compiles the sharded step against
256 (single-pod) or 512 (2-pod) placeholder devices and reads XLA's
memory and cost analyses.  PyTorch has no compiler to lower against, so
the port runs the step itself, abstractly, and counts; each result's
``cost_method`` states the counters:

* **Abstract execution.**  The cell's state (and caches) and batch are
  meta tensors, given the reference's shardings
  (``dist.sharding.param_shardings`` / ``cache_shardings`` /
  ``batch_shardings``) on the production mesh of ``"meta"`` placeholder
  devices, one a shard.  One mesh index's share of the step — a
  device's share: every index does the same work — runs through the
  sharded executor (``dist.spmd``, ``only=0``: window 0's first index;
  on a mesh with a "model" axis, its model rank's share of the window,
  the other ranks' contributions to its collectives zeros) under
  ``FakeTensorMode``:
  shapes and dtypes, no data.  A fake tensor never launches a kernel, so
  a kernel counts at its plain version's operations.  Placeholders hold
  no data: every mesh index of a leaf holds the same fake shard-shaped
  tensor.
* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` (matrix
  products and convolutions; XLA's ``cost_analysis`` also counts
  elementwise work).
* **Bytes**: every dispatched op's input and output bytes (views move
  nothing), from a ``TorchDispatchMode``.  The port runs eager, with
  nothing fused, so this is the traffic an eager step moves.
* **Collective bytes**: the executor's transfer record for that mesh
  index under the ring model (``spmd.ring_bytes``), by op and by what
  moved (``Transfer.kind``: weights, gradients, activations over
  "model", cache rows, batch rows); a group within one node of 8 mesh
  indices rides NVLink, a wider one InfiniBand.
* **Per-device memory**: ``argument_bytes`` is the exact sum of one
  device's shard bytes of the state (or parameters and caches) and the
  batch; ``temp_bytes`` the peak of live fake-storage bytes the step
  allocates, less the new outputs still live at its end; the outputs of
  an in-place update alias the arguments.
* **Depth and microbatches**, as the reference counts them: a
  full-depth run proves memory; the costs come from shallow runs at
  depth d1 and d2 extrapolated affinely in depth (``_cost_depths``,
  ``_extrapolate``; bilinear in layers x sequence for rwkv training and
  prefill, ``_cost_rwkv_bilinear``; ``tokens //= 2`` for encdec).  Every
  microbatch piece of a window has the same shapes: the full-depth run
  runs one (its peak is every piece's), a cost run one and two,
  extrapolated affinely to the window's count.

The roofline's constants are the NVIDIA H100 SXM5 datasheet's figures,
not measurements: 989.4 TFLOP/s dense bf16, 3.35 TB/s of HBM3, 450 GB/s
a direction over NVLink within a node of 8, 50 GB/s a GPU across nodes
(400 Gb/s InfiniBand).

Usage:
    python -m repro_torch.launch.dryrun --arch mixtral-8x22b --shape train_4k \\
        [--multi-pod] [--grad-accum 1] [--out out.json]
    python -m repro_torch.launch.dryrun --all [--multi-pod]   # every cell
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import _tree
from repro_torch.configs import SHAPES, cell_applicable, get_config, list_archs
from repro_torch.dist import sharding as shd
from repro_torch.dist import spmd
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.models import model_zoo
from repro_torch.models.params import family_module
from repro_torch.train import TrainOptions
from repro_torch.train.trainer import init_state

# NVIDIA H100 SXM5 datasheet figures (not measurements)
HARDWARE = "NVIDIA H100 SXM5 (datasheet)"
PEAK_FLOPS = 989.4e12      # dense bf16 FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
HBM_BYTES = 80e9           # HBM3 capacity
NVLINK_BW = 450e9          # bytes/s a direction, within a node of 8
IB_BW = 50e9               # bytes/s a GPU across nodes (400 Gb/s)


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class _Traffic(TorchDispatchMode):
    """Bytes every dispatched op reads and writes (views excluded), and
    the live bytes of the storages allocated under the mode: their peak,
    and what is live now."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._sizes = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        seen = {t.untyped_storage()._cdata for t in ins}
        aliased = any(t.untyped_storage()._cdata in seen for t in outs)
        # a metadata query returns no tensor, and a view (or an unsafe
        # view) moves nothing; an in-place write does move its bytes
        if outs and not func.is_view and (func._schema.is_mutable
                                          or not aliased):
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._sizes:
                continue            # a view, an in-place write, or known
            self._sizes[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out

    def _free(self, key):
        self.live -= self._sizes.pop(key, 0)


def _coll(transfers, dst) -> dict:
    """A device's collective traffic: total, by op, by kind, by link,
    seconds."""
    by_op, by_kind, nv, ib = {}, {}, 0.0, 0.0
    for t in transfers:
        if t.dst != dst:
            continue
        by_op[t.op] = by_op.get(t.op, 0.0) + t.traffic
        by_kind[t.kind] = by_kind.get(t.kind, 0.0) + t.traffic
        if t.intra_node:
            nv += t.traffic
        else:
            ib += t.traffic
    return {"coll": nv + ib, "coll_s": nv / NVLINK_BW + ib / IB_BW,
            "coll_nvlink": nv, "coll_ib": ib, "coll_breakdown": by_op,
            "coll_by_kind": by_kind}


# ---------------------------------------------------------------------------
# One abstract run
# ---------------------------------------------------------------------------

def _meta_params(cfg):
    return family_module(cfg).lm_init(None, cfg, torch.device("meta"))


def _abstract_put(tree, shardings):
    """A placement of ``tree``'s leaves with no data: every mesh index
    holds the same fake shard-shaped tensor (call under the fake mode)."""
    def put(x, sh):
        t = torch.empty(sh.shard_shape(tuple(x.shape)), dtype=x.dtype,
                        device=sh.mesh.devices.reshape(-1)[0])
        return shd.Sharded(x.shape, x.dtype, sh, [t] * sh.mesh.size)
    return _tree.tree_map(put, tree, shardings)


def _bytes_of(tree, shardings) -> int:
    """Bytes a mesh index holds of ``tree`` placed by ``shardings`` (every
    index holds a shard of the same shape)."""
    return sum(shd.shard_nbytes(x.shape, x.dtype, s)
               for x, s in zip(_tree.leaves(tree), _tree.leaves(shardings)))


def _batch(api, shape):
    return {k: torch.empty(s, dtype=dt, device="meta")
            for k, (s, dt) in api.batch_specs(shape.global_batch,
                                              shape.seq_len).items()}


def pieces_in_window(global_batch: int, windows: int, grad_accum: int) -> int:
    """Microbatch pieces in a batch window (``dist.spmd``'s cut)."""
    per, m = global_batch // windows, global_batch // grad_accum
    return sum(1 for i in range(grad_accum)
               if max(0, i * m) < min(per, (i + 1) * m))


def _run(cfg, shape, mesh, grad_accum, *, pieces=1, bf16_params=False):
    """One abstract run of a window's share of the cell's step: its
    counts, memory and transfer record."""
    api = model_zoo.build(cfg, device="meta")
    params = _meta_params(cfg)
    transfers = []
    if shape.kind == "decode":
        window = 4096 if shape.name == "long_500k" else 0
        caches = api.init_caches(shape.global_batch, shape.seq_len,
                                 torch.bfloat16, window=window)
        dims = spmd.cache_batch_dims(lambda b: api.init_caches(
            b, shape.seq_len, torch.bfloat16, window=window))
        tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                             device="meta")
        args = (params, caches, tokens)
        arg_sh = (shd.param_shardings(params, mesh, cfg),
                  shd.cache_shardings(caches, mesh, cfg),
                  shd.batch_shardings(tokens, mesh))
    else:
        batch = _batch(api, shape)
        if shape.kind == "train":
            state = init_state(params, 0, bf16_params=bf16_params)
            args = (state, batch)
            arg_sh = (spmd.train_state_shardings(state, mesh, cfg),
                      shd.batch_shardings(batch, mesh))
        else:
            args = (params, batch)
            arg_sh = (shd.param_shardings(params, mesh, cfg),
                      shd.batch_shardings(batch, mesh))
    arg = _bytes_of(args, arg_sh)

    # allow_non_fake_inputs: tensors made from Python numbers inside the
    # step (AdamW's bias-correction bases) come out real on "meta"
    with FakeTensorMode(allow_non_fake_inputs=True):
        placed = _abstract_put(args, arg_sh)
        traffic = _Traffic()
        with FlopCounterMode(display=False) as flops, traffic:
            if shape.kind == "decode":
                p_, c_, t_ = placed
                out = spmd.sharded_decode_step(
                    api.decode_fn, mesh, p_, t_, c_, shape.seq_len - 1,
                    batch_dims=dims, only=0, transfers=transfers)
                new_out = _nbytes(out[0])
            elif shape.kind == "train":
                step = spmd.make_sharded_train_step(
                    api.loss_fn, TrainOptions(grad_accum=grad_accum,
                                              schedule=cfg.lr_schedule),
                    mesh, arg_sh[0], arg_sh[1], transfers=transfers)
                out = step(*placed, only=0, max_pieces=pieces)
                new_out = 0
            else:
                out = spmd.sharded_forward(api.loss_fn, mesh, *placed,
                                           only=0, transfers=transfers)
                new_out = _nbytes(out[0])
            live_new = traffic.live
        del out
    compute = _compute_index(arg_sh, shape, mesh)
    if shape.kind == "train":          # the state, updated in place
        aliased = _bytes_of(args[0], arg_sh[0])
    elif shape.kind == "decode":       # the caches, written in place
        aliased = _bytes_of(args[1], arg_sh[1])
    else:
        aliased = 0
    return {
        "flops": float(flops.get_total_flops()),
        "bytes": float(traffic.bytes),
        **_coll(transfers, int(mesh.ids.reshape(-1)[compute])),
        "argument_bytes": arg,
        "mesh_argument_bytes": arg * mesh.size,
        "output_bytes": aliased + new_out,
        "alias_bytes": aliased,
        "temp_bytes": max(traffic.peak - min(live_new, new_out), 0),
    }


def _compute_index(arg_sh, shape, mesh) -> int:
    """The mesh index ``only=0`` runs: the first holding the first batch
    (or token) block — rank 0 of window 0's model row."""
    sh = arg_sh[2] if shape.kind == "decode" else _tree.leaves(arg_sh[1])[0]
    return min(p for p in range(mesh.size)
               if sh.block(p, len(sh.spec))[0] == 0)


# ---------------------------------------------------------------------------
# The reference's depth arithmetic
# ---------------------------------------------------------------------------

def _cost_depths(cfg) -> tuple[int, int, float]:
    """(d1, d2, full_units) for the shallow cost runs."""
    if cfg.family == "hybrid":
        period = cfg.shared_attn_period or cfg.num_layers
        groups = cfg.num_layers // period
        return period, 2 * period, float(groups * period)
    return 1, 2, float(cfg.num_layers)


def _shallow_cfg(cfg, depth):
    kw = {"num_layers": depth, "scan_unroll": True}
    if cfg.family == "encdec":
        kw["encoder_layers"] = depth
    return dataclasses.replace(cfg, **kw)


def _extrapolate(c1, c2, d1, d2, full):
    out = {}
    for k in ("flops", "bytes", "coll") + tuple(
            k for k in ("coll_s", "coll_nvlink", "coll_ib") if k in c1):
        slope = (c2[k] - c1[k]) / (d2 - d1)
        out[k] = max(c1[k] + slope * (full - d1), 0.0)
    bk = {}
    for op in set(c1["coll_breakdown"]) | set(c2["coll_breakdown"]):
        a = c1["coll_breakdown"].get(op, 0.0)
        b = c2["coll_breakdown"].get(op, 0.0)
        bk[op] = max(a + (b - a) / (d2 - d1) * (full - d1), 0.0)
    out["coll_breakdown"] = bk
    return out


def _extrapolated(c1, c2, d1, d2, full):
    """``_extrapolate`` (the reference's), and the traffic by kind."""
    out = _extrapolate(c1, c2, d1, d2, full)
    out["coll_by_kind"] = _extrapolate(
        {"flops": 0, "bytes": 0, "coll": 0,
         "coll_breakdown": c1["coll_by_kind"]},
        {"flops": 0, "bytes": 0, "coll": 0,
         "coll_breakdown": c2["coll_by_kind"]}, d1, d2, full)[
             "coll_breakdown"]
    return out


def _windows_of(shape, mesh) -> int:
    """Batch windows: the blocks ``batch_shardings`` cuts the batch in."""
    return shd.NamedSharding(mesh, shd._batch_spec(
        mesh, (shape.global_batch,))).counts(1)[0]


def _cost_run(cfg, shape, mesh, grad_accum, *, seq_override=None,
              bf16_params=False):
    """A shallow config's counts for a window, its microbatch pieces
    extrapolated affinely from one and two."""
    if seq_override is not None:
        shape = dataclasses.replace(shape, seq_len=seq_override)
    n = (pieces_in_window(shape.global_batch, _windows_of(shape, mesh),
                          grad_accum) if shape.kind == "train" else 1)
    c1 = _run(cfg, shape, mesh, grad_accum, pieces=1,
              bf16_params=bf16_params)
    if n == 1:
        return c1
    c2 = _run(cfg, shape, mesh, grad_accum, pieces=2,
              bf16_params=bf16_params)
    return _extrapolated(c1, c2, 1, 2, n)


def _cost_rwkv_bilinear(cfg, shape, mesh, grad_accum):
    """RWKV cost: bilinear extrapolation over (layers, seq).

    RWKV is attention-free: every op's cost is exactly linear in S (and
    the optimizer part is S-independent), so
        cost(L, S) = alpha + beta*L + gamma*S + delta*L*S
    and four shallow, short runs determine it.  The runs take
    grad_accum=1, as the reference's cost compiles do.
    """
    del grad_accum
    d1, d2, full_l = _cost_depths(cfg)
    s1, s2 = 64, 128
    grid = {}
    for d in (d1, d2):
        for s in (s1, s2):
            grid[(d, s)] = _cost_run(_shallow_cfg(cfg, d), shape, mesh, 1,
                                     seq_override=s)
    full_s = shape.seq_len
    out = {}
    for k in ("flops", "bytes", "coll", "coll_s", "coll_nvlink", "coll_ib"):
        c11, c12 = grid[(d1, s1)][k], grid[(d1, s2)][k]
        c21, c22 = grid[(d2, s1)][k], grid[(d2, s2)][k]
        delta = ((c22 - c21) - (c12 - c11)) / ((d2 - d1) * (s2 - s1))
        beta = ((c21 - c11) / (d2 - d1)) - delta * s1
        gamma = ((c12 - c11) / (s2 - s1)) - delta * d1
        alpha = c11 - beta * d1 - gamma * s1 - delta * d1 * s1
        out[k] = max(alpha + beta * full_l + gamma * full_s
                     + delta * full_l * full_s, 0.0)
    tot1 = grid[(d1, s1)]["coll"]
    scale = out["coll"] / tot1 if tot1 else 0.0
    for key in ("coll_breakdown", "coll_by_kind"):
        out[key] = {op: v * scale for op, v in grid[(d1, s1)][key].items()}
    return out


def model_flops(cfg, shape) -> float:
    """The model's FLOPs for the step: 6 (train) or 2 a token and active
    parameter; encdec's two streams see half the positions each."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        flops_per_tok = 6
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        flops_per_tok = 2
    else:
        tokens = shape.global_batch
        flops_per_tok = 2
    if cfg.family == "encdec" and shape.kind != "decode":
        tokens //= 2
    return float(flops_per_tok * cfg.active_param_count() * tokens)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def _mesh_tag(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape.values())


def analyse(cfg, shape, mesh, *, grad_accum=0, skip_cost=False,
            bf16_params=False, arch=None, verbose=False):
    """The dry run of ``cfg`` x ``shape`` on ``mesh`` (placeholder
    devices): the result dict ``run_cell`` writes."""
    windows = _windows_of(shape, mesh)
    if grad_accum == 0:
        # auto: one sequence a microbatch piece, the reference's one
        # sequence a device a microbatch (it bounds the remat stash):
        # the executor's microbatch i is global rows [i B/n, (i+1) B/n),
        # so n = B puts one sequence in each piece of every window
        grad_accum = shape.global_batch if shape.kind == "train" else 1
    n = (pieces_in_window(shape.global_batch, windows, grad_accum)
         if shape.kind == "train" else 1)

    t0 = time.time()
    mem = _run(cfg, shape, mesh, grad_accum, pieces=1,
               bf16_params=bf16_params)
    t_run = time.time() - t0
    t0 = time.time()
    one = ("one microbatch piece run" + (f" of {n} (LOWER BOUND)" if n > 1
                                         else ""))
    how = ("abstract execution (FakeTensorMode on 'meta' placeholders, "
           "one batch window's share; kernels at their plain versions' "
           "operations); FLOPs: FlopCounterMode (products and "
           "convolutions only); bytes: every dispatched op's inputs and "
           "outputs, eager; collectives: the executor's transfer record, "
           "ring model; ")
    if skip_cost:
        ext = mem
        cost_method = how + f"full-depth run, {one}"
    elif cfg.family == "rwkv" and shape.kind != "decode":
        ext = _cost_rwkv_bilinear(cfg, shape, mesh, grad_accum)
        cost_method = how + ("bilinear (layers x seq) extrapolation from 4 "
                             "short shallow runs at grad_accum=1 "
                             "(attention-free: exact for flops)")
    else:
        d1, d2, full = _cost_depths(cfg)
        cost_accum = grad_accum if cfg.family != "hybrid" else 1
        c1 = _cost_run(_shallow_cfg(cfg, d1), shape, mesh, cost_accum,
                       bf16_params=bf16_params)
        c2 = _cost_run(_shallow_cfg(cfg, d2), shape, mesh, cost_accum,
                       bf16_params=bf16_params)
        ext = _extrapolated(c1, c2, d1, d2, full)
        cost_method = how + (
            f"depth-{d1}/{d2} runs, linear extrapolation to {int(full)} "
            "layers" + (f"; microbatch pieces extrapolated from 1 and 2 to "
                        f"{pieces_in_window(shape.global_batch, windows, cost_accum)}"
                        if shape.kind == "train" and pieces_in_window(
                            shape.global_batch, windows, cost_accum) > 1
                        else ""))
    t_cost = time.time() - t0

    flops_dev, bytes_dev = ext["flops"], ext["bytes"]
    t_comp = flops_dev / PEAK_FLOPS
    t_mem = bytes_dev / HBM_BW
    t_coll = ext["coll_s"]
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    mflops = model_flops(cfg, shape)
    api = model_zoo.build(cfg, device="meta")
    fn = api.decode_fn if shape.kind == "decode" else api.loss_fn
    computing = windows * (mesh.shape.get("model", 1)
                           if spmd.splits_over_model(fn, mesh) else 1)
    peak = (mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
            - mem["alias_bytes"])
    result = {
        "arch": arch or cfg.name, "shape": shape.name,
        "mesh": _mesh_tag(mesh),
        "status": "ok",
        "chips": int(mesh.size),
        "grad_accum": grad_accum,
        "cost_method": cost_method,
        "hardware": {"name": HARDWARE, "peak_bf16_flops": PEAK_FLOPS,
                     "hbm_bytes_per_s": HBM_BW, "hbm_bytes": HBM_BYTES,
                     "nvlink_bytes_per_s": NVLINK_BW,
                     "ib_bytes_per_s": IB_BW},
        "run_s": round(t_run, 1),
        "cost_s": round(t_cost, 1),
        "per_device": {
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "temp_bytes": mem["temp_bytes"],
            "alias_bytes": mem["alias_bytes"],
            "peak_hbm_gib": round(peak / 2**30, 3),
            "fits_hbm": peak <= HBM_BYTES,
            "mesh_argument_bytes": mem["mesh_argument_bytes"],
            "flops": flops_dev,
            "hlo_bytes": bytes_dev,
            "collective_bytes": ext["coll"],
            "collective_nvlink_bytes": ext["coll_nvlink"],
            "collective_ib_bytes": ext["coll_ib"],
        },
        "collectives": ext["coll_breakdown"],
        "collectives_by_kind": ext["coll_by_kind"],
        "roofline": {
            **{k: float(f"{v:.6g}") for k, v in terms.items()},
            "dominant": dominant,
            "model_flops": mflops,
            # each index of a window's model row computes its share
            # (dense and MoE), or its first index the window; the others
            # hold and update their shards
            "hlo_flops_global": flops_dev * computing,
            "usefulness": (mflops / (flops_dev * computing)
                           if flops_dev else 0.0),
            "step_time_bound_s": max(terms.values()),
        },
    }
    if verbose:
        print(json.dumps(result, indent=1))
    return result


def run_cell(arch: str, shape_name: str, *, multi_pod=False, grad_accum=0,
             verbose=True, skip_cost=False, bf16_params=False):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    tag = "2x16x16" if multi_pod else "16x16"
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": tag,
                "status": "skipped", "reason": why}
    mshape, _ = production_shape(multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=["meta"] * math.prod(mshape))
    return analyse(cfg, shape, mesh, grad_accum=grad_accum,
                   skip_cost=skip_cost, bf16_params=bf16_params, arch=arch,
                   verbose=verbose)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=0,
                    help="0 = auto (one sequence per device per microbatch)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-cost", action="store_true",
                    help="skip the shallow cost runs (memory proof only)")
    ap.add_argument("--bf16-params", action="store_true",
                    help="bf16 live params + f32 master")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in list_archs() for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]

    results = []
    failed = 0
    for arch, shape in cells:
        try:
            results.append(run_cell(arch, shape, multi_pod=args.multi_pod,
                                    grad_accum=args.grad_accum,
                                    skip_cost=args.skip_cost,
                                    bf16_params=args.bf16_params))
        except Exception as e:  # a failing cell is a bug in the system
            failed += 1
            results.append({"arch": arch, "shape": shape,
                             "mesh": "2x16x16" if args.multi_pod else "16x16",
                             "status": "FAILED", "error": repr(e)[:2000]})
            print(f"FAILED {arch} x {shape}: {e!r}", file=sys.stderr)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
