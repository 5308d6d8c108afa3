"""Mesh-sharded execution of plans and plan programs.

Port of ``repro.dist.mesh_exec`` for one controller over a
``dist.mesh.Mesh``.  A plan's occupancy map, compiled with shard-sized
blocks, is the (S, S) shard connectivity graph: entry (d, s) says shard
d's output window reads shard s's input window.  Three regimes, cheapest
first:

* **lane-parallel** (``run_program_sharded``): every plan-program step
  routes along the control axis and is elementwise across payload
  columns, so each shard runs the whole program on its own columns —
  one megakernel launch a shard on the card, no copy between shards.
* **block-local plans** (``is_lane_parallel``): a plan whose
  shard-blocked occupancy is diagonal runs as S local crossbars.
* **cross-shard plans**: the off-diagonal entries become a *collective
  schedule* — a greedy edge-colouring groups the (src -> dst) block
  transfers into rounds of partial permutations.  Each round is one set
  of block copies to the destination shards' devices (the reference's
  one ``ppermute``), after which each destination runs its restricted
  (source, destination) block on its own device; the naive baseline
  (``apply_plan_sharded_naive``) all-gathers S - 1 blocks into every
  shard instead.

Every block runs through ``crossbar.apply_plan`` with the caller's
backend (on the card: the dense or the tile-skipping crossbar kernel),
and a shard that receives nothing in a round launches nothing (the
reference computes the block and masks it, with the same values).  The
host side — connectivity, schedule, the restricted per-block plans — is
derived once when an executor is built (``sharded_apply_fn``), never per
apply.

Executors take a payload as one tensor (split into per-shard windows,
a view where the window already lies on its shard's device) or as the
list of per-shard windows, and return the list of per-shard outputs;
the one-shot wrappers (``apply_plan_sharded``, ``run_program_sharded``)
join a tensor's result back onto its device.  Copies between shards go
through ``Tensor.copy_``, which PyTorch orders after the pending work
of both devices' current streams, on one card or between two.

Spans and counters keep the reference's names
(``sharded_schedule_derive``, ``collective_apply``,
``collective_program``; ``mesh_apply_calls``,
``mesh_apply_collective_free``, ``mesh_program_launches``), and
``mesh_block_copies`` counts the cross-shard block copies made — the
port's stand-in for the reference's "no collective in the compiled HLO"
check.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.core import crossbar as xb
from repro_torch.core import plan_algebra as pa
from repro_torch.core import plan_program as pp
from repro_torch.core import telemetry
from repro_torch.core.semiring import GF2, REAL
from repro_torch.dist import sharding as shd
from repro_torch.dist.mesh import join, split


# ---------------------------------------------------------------------------
# Shard connectivity: the occupancy map at mesh granularity
# ---------------------------------------------------------------------------

def shard_connectivity(plan: xb.PermutePlan, n_shards: int) -> np.ndarray:
    """(S, S) bool: does shard d's output window read shard s's inputs?

    The plan's ``CompiledPlan`` occupancy under a shard-sized blocking —
    the structure the tile-skipping kernel skips with, read as the
    traffic matrix between shards.  Needs shard-divisible geometry.
    """
    g = pa.to_gather(plan)
    if n_shards <= 0:
        raise ValueError(f"shard_connectivity: n_shards={n_shards} must be "
                         "positive")
    if g.n_out % n_shards or g.n_in % n_shards:
        raise ValueError(
            f"shard_connectivity: geometry ({g.n_out} out, {g.n_in} in) "
            f"does not divide into {n_shards} shards")
    compiled = xb.compile_plan(g, block_o=g.n_out // n_shards,
                               block_n=g.n_in // n_shards)
    return compiled.occupancy.cpu().numpy()


def is_lane_parallel(plan: xb.PermutePlan, n_shards: int) -> bool:
    """True when the shard-blocked occupancy is (a subset of) diagonal:
    every shard's outputs read only its own inputs."""
    conn = shard_connectivity(plan, n_shards)
    off = conn & ~np.eye(n_shards, dtype=bool)
    return not off.any()


def collective_schedule(conn: np.ndarray) -> list:
    """Greedy edge-colouring of the off-diagonal traffic graph.

    Input: (S, S) bool connectivity, conn[dst, src].  Output: rounds of
    (src, dst) transfers where each round is a partial permutation
    (every shard sends to at most one peer and receives from at most
    one).  Diagonal entries are local and never scheduled.  Each round
    is a maximal matching over the edges in (dst, src) order — the
    reference's order, so the rounds are the reference's.
    """
    conn = np.asarray(conn, dtype=bool)
    s = conn.shape[0]
    if conn.shape != (s, s):
        raise ValueError(f"collective_schedule: connectivity must be "
                         f"square, got {conn.shape}")
    remaining = [(src, dst) for dst in range(s) for src in range(s)
                 if conn[dst, src] and src != dst]
    rounds: list = []
    while remaining:
        used_src: set = set()
        used_dst: set = set()
        this_round: list = []
        rest: list = []
        for src, dst in remaining:
            if src not in used_src and dst not in used_dst:
                this_round.append((src, dst))
                used_src.add(src)
                used_dst.add(dst)
            else:
                rest.append((src, dst))
        rounds.append(this_round)
        remaining = rest
    return rounds


def schedule_stats(conn: np.ndarray) -> dict:
    """Traffic accounting for a connectivity matrix: scheduled rounds and
    moved blocks vs the naive all-gather baseline."""
    conn = np.asarray(conn, dtype=bool)
    s = conn.shape[0]
    sched = collective_schedule(conn)
    off_edges = int(conn.sum()) - int(np.diag(conn).sum())
    return {
        "n_shards": s,
        "off_diag_edges": off_edges,
        "schedule_rounds": len(sched),
        "scheduled_block_transfers": sum(len(r) for r in sched),
        "naive_rounds": s - 1,
        "naive_block_transfers": s * (s - 1),
    }


# ---------------------------------------------------------------------------
# Restricted controls
# ---------------------------------------------------------------------------

def _stack_restricted(plan: xb.PermutePlan, n_shards: int):
    """Every (source, destination) block's restricted control, stacked.

    Returns (idx, weights, k, semiring): idx is (S_src, S_dst,
    n_out_local, k) int32, block [s, d] routing shard s's input window
    into shard d's output window in local coordinates, each block padded
    to the widest block's k with DROP; weights the same shape (ones for
    an unweighted block, zeros on padding) or None.  On the plan's
    device; the reference's values.
    """
    g = pa.to_gather(plan)
    n_o_loc = g.n_out // n_shards
    n_i_loc = g.n_in // n_shards
    restricted = [[pa.shard_restrict(g, (d * n_o_loc, n_o_loc),
                                     (s * n_i_loc, n_i_loc))
                   for d in range(n_shards)] for s in range(n_shards)]
    kmax = max(r.k for row in restricted for r in row)
    pad = torch.nn.functional.pad

    def pad_idx(r):
        return pad(r.idx, (0, kmax - r.k), value=pa.DROP)

    idx = torch.stack([torch.stack([pad_idx(r) for r in row])
                       for row in restricted])
    weights = None
    if any(r.weights is not None for row in restricted for r in row):
        def pad_w(r):
            if r.weights is None:
                w = torch.ones(r.idx.shape, dtype=g.semiring.weight_dtype,
                               device=g.device)
            else:
                w = r.weights.expand(r.idx.shape)
            return pad(w, (0, kmax - w.shape[1]))
        weights = torch.stack([torch.stack([pad_w(r) for r in row])
                               for row in restricted])
    return idx, weights, kmax, g.semiring


def shard_bounds(n: int, n_shards: int) -> list:
    """Per-shard ``(lo, hi)`` row boundaries of an evenly sharded axis.

    The slicing contract the serving layer's partial-batch recovery is
    built on: shard ``s`` of a mesh-sharded batch owns rows ``[lo, hi)``
    of the padded batch axis, so a completed shard's rows can be
    salvaged — and a lost shard's rows replayed — by plain slicing.
    """
    if n_shards < 1:
        raise ValueError(f"shard_bounds: n_shards={n_shards} must be >= 1")
    if n % n_shards:
        raise ValueError(f"shard_bounds: axis size {n} not divisible by "
                         f"{n_shards} shards")
    per = n // n_shards
    return [(s * per, (s + 1) * per) for s in range(n_shards)]


def _collective_round(round_index: int, pairs: tuple) -> None:
    """Per-round hook on the host-side collective schedule derivation.

    A no-op in production; ``core.faults.inject_faults`` patches this
    module attribute to raise ``InjectedCollectiveFailure`` at
    seed-chosen rounds, so collective-bearing mesh plans have a chaos
    interception point like apply/compile/megakernel do.
    """


def _copy_block(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One cross-shard block transfer into the destination's memory."""
    telemetry.incr("mesh_block_copies")
    return torch.empty_like(x, device=device).copy_(x)


def _shards_of(x, devices: Sequence[torch.device], rows: int,
               what: str) -> list:
    """A payload as its per-shard row windows on the shards' devices."""
    if isinstance(x, torch.Tensor):
        if x.shape[0] != rows * len(devices):
            raise ValueError(f"{what}: payload leading dim {x.shape[0]} != "
                             f"plan n_in {rows * len(devices)}")
        return split(x, devices, what=f"{what} payload")
    xs = list(x)
    if len(xs) != len(devices):
        raise ValueError(f"{what}: {len(xs)} payload shards for "
                         f"{len(devices)} mesh shards")
    for s, (xl, dev) in enumerate(zip(xs, devices)):
        if xl.shape[0] != rows or xl.device != dev:
            raise ValueError(
                f"{what}: shard {s} holds {tuple(xl.shape)} on {xl.device}, "
                f"expected {rows} rows on {dev}")
    return xs


def _check_axis(mesh, axis: str, who: str) -> None:
    if axis not in mesh.axis_names:
        raise ValueError(f"{who}: axis {axis!r} not on mesh "
                         f"{tuple(mesh.axis_names)}")


# ---------------------------------------------------------------------------
# Sharded apply_plan
# ---------------------------------------------------------------------------

class ShardedApply:
    """A built mesh executor for one plan: ``fn(x) -> [out_0, ...]``.

    ``conn`` / ``schedule`` are the derivation's connectivity and
    rounds, ``blocks`` maps each (src, dst) pair that runs to its
    restricted plan on the destination's device (diagonal blocks only
    where the diagonal carries traffic), ``devices`` lists the shards'
    devices along the axis.
    """

    def __init__(self, plan, devices, conn, schedule, blocks, backend):
        self.plan = plan
        self.devices = devices
        self.conn = conn
        self.schedule = schedule
        self.blocks = blocks
        self.backend = backend

    @property
    def rounds(self) -> int:
        return sum(1 for r in self.schedule if len(r))

    def __call__(self, x) -> list:
        g, s = self.plan, len(self.devices)
        n_i_loc, n_o_loc = g.n_in // s, g.n_out // s
        xs = _shards_of(x, self.devices, n_i_loc, "sharded apply")
        fold = g.semiring is GF2
        acc = [None] * s
        for d in range(s):
            block = self.blocks.get((d, d))
            if block is not None:
                acc[d] = xb.apply_plan(block, xs[d], backend=self.backend)
        for rnd in self.schedule:
            recv = [(src, dst, _copy_block(xs[src], self.devices[dst]))
                    for src, dst in rnd]
            for src, dst, xr in recv:
                part = xb.apply_plan(self.blocks[(src, dst)], xr,
                                     backend=self.backend)
                acc[dst] = part if acc[dst] is None else acc[dst] + part
        out = []
        for d in range(s):
            a = acc[d]
            if a is None:
                a = torch.zeros((n_o_loc,) + tuple(xs[d].shape[1:]),
                                dtype=xs[d].dtype, device=self.devices[d])
            # the deferred GF(2) fold: the blocks summed as integers
            out.append(a & 1 if fold and not a.dtype.is_floating_point
                       else a)
        return out


def _block_plan(idx, weights, src: int, dst: int, n_i_loc: int, semiring,
                device) -> xb.PermutePlan:
    """Block [src, dst] of the stacked control as a plan on ``device``.
    A GF(2) block runs in REAL over the integer payload: the blocks'
    sums accumulate as integers and the caller folds mod 2 once."""
    w = None if weights is None else weights[src, dst].to(device)
    sr = REAL if semiring is GF2 else semiring
    return xb.gather_plan(idx[src, dst].to(device), n_i_loc, weights=w,
                          semiring=sr)


def sharded_apply_fn(plan: xb.PermutePlan, mesh, *, axis: str = "data",
                     backend: str = "einsum") -> ShardedApply:
    """Build the mesh executor for a plan.

    The host-side derivation — occupancy at shard granularity, the
    copy schedule, the restricted per-block plans on their destination
    devices — happens here, once; calling the result only moves blocks
    and launches crossbars.
    """
    g = pa.to_gather(plan)
    if g.semiring.name == "gf2_8":
        raise NotImplementedError(
            "sharded_apply_fn: lift GF2_8 plans to GF(2) bits first "
            "(crossbar.lift_gf2_8)")
    _check_axis(mesh, axis, "sharded_apply_fn")
    s = shd.mesh_axis_size(mesh, axis)
    shd.require_divisible(g.n_out, mesh, axis, what="plan output axis")
    shd.require_divisible(g.n_in, mesh, axis, what="plan input axis")
    devices = mesh.axis_devices(axis)
    n_i_loc = g.n_in // s
    with _obs.span("sharded_schedule_derive", shards=s, axis=axis,
                   n_out=g.n_out, n_in=g.n_in) as sp:
        conn = shard_connectivity(g, s)
        schedule = collective_schedule(conn)
        for r_i, rnd in enumerate(schedule):
            if len(rnd):
                _collective_round(r_i, tuple(rnd))
        sp.set(rounds=sum(1 for r in schedule if len(r)))
        idx, weights, _, semiring = _stack_restricted(g, s)
        pairs = [(d, d) for d in range(s) if conn[d, d]]
        pairs += [pair for rnd in schedule for pair in rnd]
        blocks = {(src, dst): _block_plan(idx, weights, src, dst, n_i_loc,
                                          semiring, devices[dst])
                  for src, dst in pairs}
    return ShardedApply(g, devices, conn, schedule, blocks, backend)


def apply_plan_sharded(plan: xb.PermutePlan, x, mesh, *,
                       axis: str = "data", backend: str = "einsum"):
    """Run ``apply_plan`` with payload rows sharded over a mesh axis.

    The plan's rows split evenly over ``axis``; trailing payload columns
    stay whole in every shard.  Diagonal occupancy runs as local
    crossbars with no copy; off-diagonal blocks move by the schedule of
    ``collective_schedule`` and accumulate in the semiring.  Bit-exact
    against single-device ``apply_plan`` for REAL routing and GF(2)
    plans.  A tensor payload gives a tensor on its device; a list of
    per-shard windows gives the list of per-shard outputs.  Repeated
    execution should build ``sharded_apply_fn`` once.
    """
    g = pa.to_gather(plan)
    if isinstance(x, torch.Tensor) and x.shape[0] != g.n_in:
        raise ValueError(
            f"apply_plan_sharded: payload leading dim {x.shape[0]} != "
            f"plan n_in {g.n_in}")
    fn = sharded_apply_fn(g, mesh, axis=axis, backend=backend)
    s = len(fn.devices)
    with _obs.span("collective_apply", shards=s, rounds=fn.rounds,
                   axis=axis, backend=backend, n_out=g.n_out,
                   n_in=g.n_in):
        out = fn(x)
    telemetry.incr("mesh_apply_calls")
    if s > 1 and fn.rounds == 0:
        telemetry.incr("mesh_apply_collective_free")
    return join(out, x.device) if isinstance(x, torch.Tensor) else out


class NaiveShardedApply:
    """The all-gather baseline executor: every shard receives the S - 1
    other input windows, then runs its output rows over the whole input
    — S(S - 1) block copies a call, whatever the plan's structure."""

    def __init__(self, plan, devices, rows, backend):
        self.plan = plan
        self.devices = devices
        self.rows = rows
        self.backend = backend

    def __call__(self, x) -> list:
        g, s = self.plan, len(self.devices)
        n_i_loc = g.n_in // s
        xs = _shards_of(x, self.devices, n_i_loc, "sharded apply (naive)")
        out = []
        for d, dev in enumerate(self.devices):
            full = torch.empty((g.n_in,) + tuple(xs[d].shape[1:]),
                               dtype=xs[d].dtype, device=dev)
            for src in range(s):
                win = full[src * n_i_loc:(src + 1) * n_i_loc]
                if src == d:
                    win.copy_(xs[d])
                else:
                    telemetry.incr("mesh_block_copies")
                    win.copy_(xs[src])
            out.append(xb.apply_plan(self.rows[d], full,
                                     backend=self.backend))
        return out


def sharded_apply_naive_fn(plan: xb.PermutePlan, mesh, *,
                           axis: str = "data",
                           backend: str = "einsum") -> NaiveShardedApply:
    """Build the all-gather baseline executor (each shard's row-restricted
    plan over the full input window, built once)."""
    g = pa.to_gather(plan)
    _check_axis(mesh, axis, "sharded_apply_naive_fn")
    s = shd.mesh_axis_size(mesh, axis)
    shd.require_divisible(g.n_out, mesh, axis, what="plan output axis")
    shd.require_divisible(g.n_in, mesh, axis, what="plan input axis")
    devices = mesh.axis_devices(axis)
    n_o_loc = g.n_out // s
    rows = []
    for d, dev in enumerate(devices):
        r = pa.shard_restrict(g, (d * n_o_loc, n_o_loc), (0, g.n_in))
        rows.append(xb.gather_plan(
            r.idx.to(dev), g.n_in, semiring=g.semiring,
            weights=None if r.weights is None else r.weights.to(dev)))
    return NaiveShardedApply(g, devices, rows, backend)


def apply_plan_sharded_naive(plan: xb.PermutePlan, x, mesh, *,
                             axis: str = "data", backend: str = "einsum"):
    """One-shot wrapper around ``sharded_apply_naive_fn`` (a tensor
    payload gives a tensor on its device)."""
    out = sharded_apply_naive_fn(plan, mesh, axis=axis, backend=backend)(x)
    return join(out, x.device) if isinstance(x, torch.Tensor) else out


# ---------------------------------------------------------------------------
# Sharded plan programs (lane-parallel over payload columns)
# ---------------------------------------------------------------------------

def sharded_program_fn(program, mesh, *, axis: str = "data",
                       backend: str = "megakernel",
                       pass_backend: str = "einsum"):
    """The column-sharded program executor: ``fn(x) -> [out_0, ...]``,
    ``x`` an (n, D) tensor (split into column windows on the shards'
    devices) or the list of per-shard (n, D/S) windows.  Each shard runs
    ``plan_program.run_program`` on its own columns — one megakernel
    launch a shard on the card — and nothing moves between shards."""
    _check_axis(mesh, axis, "sharded_program_fn")
    devices = mesh.axis_devices(axis)

    def fn(x) -> list:
        if isinstance(x, torch.Tensor):
            xs = split(x, devices, dim=1,
                       what="program payload column axis")
        else:
            xs = list(x)
            if len(xs) != len(devices):
                raise ValueError(f"sharded program: {len(xs)} payload "
                                 f"shards for {len(devices)} mesh shards")
        return [pp.run_program(program, xl, backend=backend,
                               pass_backend=pass_backend) for xl in xs]

    return fn


def run_program_sharded(program, x, mesh, *, axis: str = "data",
                        backend: str = "megakernel",
                        pass_backend: str = "einsum"):
    """Run a PlanProgram with payload COLUMNS sharded over a mesh axis.

    Every program step (PERMUTE, XOR, ANDN, ADD, ROTLV, XOR_CONST)
    routes along the control axis and is elementwise across payload
    columns, so column sharding needs no copy between shards: each
    shard runs the complete program on its own column slice.  A tensor
    payload (n, D) gives a tensor on its device; a list of per-shard
    windows gives the list of per-shard outputs.
    """
    _check_axis(mesh, axis, "run_program_sharded")
    if isinstance(x, torch.Tensor):
        if x.dim() != 2:
            raise ValueError(
                f"run_program_sharded: payload must be (n, D) to shard "
                f"columns, got shape {tuple(x.shape)}")
        shd.require_divisible(x.shape[1], mesh, axis,
                              what="program payload column axis")
        columns = x.shape[1]
    else:
        columns = sum(xl.shape[1] for xl in x)
    fn = sharded_program_fn(program, mesh, axis=axis, backend=backend,
                            pass_backend=pass_backend)
    telemetry.incr("mesh_program_launches")
    with _obs.span("collective_program", program=program.name,
                   shards=shd.mesh_axis_size(mesh, axis), axis=axis,
                   backend=backend, columns=columns):
        out = fn(x)
    return join(out, x.device, dim=1) if isinstance(x, torch.Tensor) \
        else out
