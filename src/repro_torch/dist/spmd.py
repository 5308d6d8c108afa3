"""Sharded step execution: a model's state over a mesh.

The port's counterpart of GSPMD running ``jax.jit(step,
in_shardings=(state_sh, batch_sh), out_shardings=(state_sh, None))``,
and of the reference dry run's two other lowered functions (a forward
for prefill cells, a decode step against sharded caches).  One
controller over a ``dist.mesh.Mesh``, as ``dist.mesh_exec`` is: it runs
each shard's work on its shard's device and moves the blocks itself.
Trees hold ``dist.sharding.Sharded`` leaves (``sharding.device_put``).
Each function's result equals its single-device function's, up to the
order of the gradient sums.

**Batch windows.**  The blocks of the batch leaves' leading dimension
(``batch_shardings``: one a batch shard) are the windows; each window
runs on its compute index, the first mesh index that holds it.  Batch
leaves lead with the batch dimension.

**The train step** (``make_sharded_train_step``).  For each window in
turn:

1. the parameters are gathered onto the compute index's device (fresh
   leaves: a gradient never reaches a shard's storage);
2. ``loss_fn`` runs forward and backward on the window's rows,
   microbatch piece by piece;
3. the gradients are summed in float32 into one accumulator a parameter
   block, on the block's first holder: the reduce-scatter over the batch
   axes.

Then the clip's global norm sums every block once, and the port's AdamW
updates every mesh index's shards in place, replicas included, with
that norm (``adamw_update(grad_norm=...)``).  The moments and master
take the parameters' shardings; the step counter and the generator
state are replicated (``train_state_shardings``, the reference dry
run's ``_state_shardings``).

**Loss weights.**  ``loss_fn`` returns a mean, and a mean of per-window
means is not the global mean when the windows' denominators differ.
The cross-entropy term (``metrics["ce"]`` where the loss carries other
terms, else the loss itself) is a mean over ``batch["loss_mask"]``
where there is one, else over tokens: a window's term is weighted by
max(its count, 1) / max(its microbatch's count, 1), exact however the
counts split.  The rest of the loss (the MoE family's load-balance and
z losses: means over sequences and over tokens) is weighted by the
window's share of its microbatch's rows.  With ``grad_accum`` n,
microbatch i is rows [i B/n, (i+1) B/n) of the global batch, as in the
single-device trainer, and every piece is weighted 1/n more.

**The decode step** (``sharded_decode_step``) runs each window of the
tokens' sharding on its compute index: the parameters gathered, the
window's cache rows gathered from the shards that hold them (over
"model"), ``decode_fn`` stepped, the new rows written back to every
shard that holds them.  ``sharded_forward`` is the train step's forward
without gradients (prefill cells).

**One window** (``only=j``): the work of window j's compute index alone
— its gathers, its forward (and backward, and the reduction into the
blocks it holds, and its shards' update), its cache write-back.  Every
window does the same work, so this is a device's share of the step: the
dry run (``launch/dryrun.py``) measures it.

**Transfers.**  Given a ``transfers`` list, each function appends one
``Transfer`` a collective it performs for a receiving mesh index: the
op, R (the bytes of the result on the receiving index), k (the group
size), the receiving index and the group.  ``ring_bytes(op, R, k)`` is
the reference dry run's ring model (``_collective_bytes``).  On a mesh
that repeats a device the copies stay on the device; the record is what
a mesh of distinct cards would move.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch import _tree
from repro_torch.core import abstract as _abstract
from repro_torch.dist import sharding as shd
from repro_torch.optim import AdamWState, adamw_update, make_schedule

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute", "copy")
NODE = 8            # mesh indices a node: a group within one is on NVLink


def ring_bytes(op: str, r: float, k: int) -> float:
    """A device's link traffic for one collective (ring model).

    R = result bytes a device, k = participants a group:
      all-gather          R * (k-1)/k      (device receives the other shards)
      all-reduce          2R * (k-1)/k     (reduce-scatter + all-gather)
      reduce-scatter      R * (k-1)        (input = R*k, sends (k-1)/k of it)
      all-to-all          R * (k-1)/k
      collective-permute  R                (single hop; a copy likewise)
    """
    if op not in COLLECTIVE_OPS:
        raise ValueError(f"unknown collective {op!r}")
    if k <= 1:
        return 0.0
    frac = (k - 1) / k
    if op == "all-gather":
        return r * frac
    if op == "all-reduce":
        return 2 * r * frac
    if op == "reduce-scatter":
        return r * (k - 1)
    if op == "all-to-all":
        return r * frac
    return float(r)


@dataclasses.dataclass(frozen=True)
class Transfer:
    op: str
    nbytes: float       # R: the result's bytes on the receiving index
    k: int              # group size
    dst: int            # the receiving mesh index
    group: tuple        # the group's mesh indices

    @property
    def traffic(self) -> float:
        return ring_bytes(self.op, self.nbytes, self.k)

    @property
    def intra_node(self) -> bool:
        """Whether every member lies in one node of ``NODE`` indices."""
        return len({g // NODE for g in self.group}) == 1


def train_state_shardings(state, mesh, cfg=None):
    """``TrainState``'s shardings: parameters, moments and master by
    ``param_shardings``; the optimizer's and the trainer's step counters
    and the generator state replicated."""
    from repro_torch.train.trainer import TrainState
    params_sh = shd.param_shardings(state.params, mesh, cfg)
    repl = shd.NamedSharding(mesh, shd.P())
    return TrainState(
        params=params_sh,
        opt=AdamWState(step=repl, mu=params_sh, nu=params_sh,
                       master=(params_sh if state.opt.master is not None
                               else None)),
        step=repl, rng=repl)


def cache_batch_dims(init_caches: Callable) -> object:
    """The batch dimension of every leaf of a cache tree, found by
    making the tree at batch 1 and 2 (``init_caches(batch)``: meta
    tensors cost nothing) and comparing shapes."""
    one, two = init_caches(1), init_caches(2)

    def dim(a, b):
        diff = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
        if len(diff) != 1:
            raise ValueError(f"cache leaf {tuple(a.shape)}: no single batch "
                             "dimension")
        return diff[0]

    return _tree.tree_map(dim, one, two)


# ---------------------------------------------------------------------------
# Moving blocks
# ---------------------------------------------------------------------------

def _mesh_id(mesh, p: int) -> int:
    return int(mesh.ids.reshape(-1)[p])


def _device(mesh, p: int):
    return mesh.devices.reshape(-1)[p]


def _record(transfers, mesh, op, nbytes, k, dst, members):
    if transfers is not None and k > 1:
        transfers.append(Transfer(op, float(nbytes), int(k),
                                  _mesh_id(mesh, dst),
                                  tuple(sorted(_mesh_id(mesh, m)
                                               for m in set(members)))))


def _rows(leaf: shd.Sharded, dim: int, r0: int, r1: int, c: int,
          transfers=None) -> torch.Tensor:
    """A fresh tensor on mesh index c's device holding rows [r0, r1) of
    ``leaf`` along ``dim`` (every other dimension whole), gathered from
    the blocks that hold them (c's own where c holds one)."""
    sh = leaf.sharding
    counts = list(sh.counts(leaf.ndim))
    if leaf.ndim:
        step = leaf.shape[dim] // counts[dim]
        lo, hi = r0 // step, -(-r1 // step)
        counts[dim] = hi - lo
    src = {}
    for blk, holders in sh.blocks(leaf.shape).items():
        if leaf.ndim:
            if not lo <= blk[dim] < hi:
                continue
            blk = blk[:dim] + (blk[dim] - lo,) + blk[dim + 1:]
        src[blk] = c if c in holders else holders[0]
    out = shd.assemble({k: leaf.shards[p] for k, p in src.items()}, counts,
                       _device(sh.mesh, c))
    if any(p != c for p in src.values()):
        _record(transfers, sh.mesh, "all-gather",
                out.numel() * out.element_size(), len(src), c,
                list(src.values()) + [c])
    if leaf.ndim and (r0, r1) != (lo * step, hi * step):
        out = out.narrow(dim, r0 - lo * step, r1 - r0).clone()
    return out


def _write_rows(leaf: shd.Sharded, dim: int, r0: int, rows: torch.Tensor,
                c: int, positions, transfers=None) -> None:
    """Write ``rows`` (rows [r0, r0 + len) of ``leaf`` along ``dim``,
    every other dimension whole, on index c's device) into each shard of
    ``positions`` that holds any of them."""
    sh = leaf.sharding
    r1 = r0 + rows.shape[dim]
    for p in positions:
        win = sh.index(p, leaf.shape)
        a, b = win[dim].start, win[dim].stop
        lo, hi = max(a, r0), min(b, r1)
        if lo >= hi:
            continue
        src = list(win)
        src[dim] = slice(lo - r0, hi - r0)
        dst = [slice(None)] * leaf.ndim
        dst[dim] = slice(lo - a, hi - a)
        part = rows[tuple(src)]
        leaf.shards[p][tuple(dst)].copy_(part)
        if p != c:
            _record(transfers, sh.mesh, "copy",
                    part.numel() * part.element_size(), 2, p, (c, p))


def _gather_params(leaves, c, transfers):
    """Every parameter leaf whole on c's device, each a fresh leaf."""
    return [_rows(leaf, 0, 0, leaf.shape[0] if leaf.ndim else 1, c,
                  transfers) for leaf in leaves]


def _windows(batch_leaves) -> list:
    """[(r0, r1, compute index)] of the batch leaves' leading-dimension
    blocks."""
    first = batch_leaves[0]
    b = first.shape[0]
    for leaf in batch_leaves:
        if (not leaf.ndim or leaf.shape[0] != b
                or leaf.sharding.spec[:1] != first.sharding.spec[:1]):
            raise ValueError("batch leaves must share their leading (batch) "
                             f"dimension and its sharding: {leaf} against "
                             f"{first}")
    n = first.sharding.counts(first.ndim)[0]
    per = b // n
    holders = {}
    for blk, ps in first.sharding.blocks(first.shape).items():
        holders.setdefault(blk[0], []).extend(ps)
    return [(j * per, (j + 1) * per, min(holders[j])) for j in range(n)]


def _host_int(t) -> int:
    """A replicated counter's value; an abstract run (the dry run) has
    none and reads 0 (the value changes no cost)."""
    return 0 if _abstract.is_fake(t) else int(t)


# ---------------------------------------------------------------------------
# Forward and backward over the windows
# ---------------------------------------------------------------------------

def _pieces(windows, b: int, n: int) -> list:
    """[(window, microbatch, r0, r1)]: each window's rows cut at the
    microbatch boundaries (microbatch i is rows [i b/n, (i+1) b/n))."""
    if b % n:
        raise ValueError(f"global batch {b} not divisible by accum {n}")
    m = b // n
    out = []
    for j, (w0, w1, _) in enumerate(windows):
        for i in range(n):
            lo, hi = max(w0, i * m), min(w1, (i + 1) * m)
            if lo < hi:
                out.append((j, i, lo, hi))
    return out


def _weights(batch: dict, windows, pieces, n: int, transfers, mesh):
    """[(ce weight, rest weight)] a piece (see the module docstring)."""
    b = next(iter(batch.values())).shape[0]
    m = b // n
    mask = batch.get("loss_mask")
    counts, totals = [], {}
    if mask is not None:
        for j, i, lo, hi in pieces:
            w0, _, c = windows[j]
            rows = mask.shards[c].narrow(0, lo - w0, hi - lo)
            counts.append(torch.sum(rows.to(torch.float32)))
        home = _device(mesh, windows[0][2])
        for (j, i, _, _), cnt in zip(pieces, counts):
            totals[i] = totals.get(i, 0) + cnt.to(home)
        for _, _, c in windows:
            _record(transfers, mesh, "all-reduce", 4, len(windows), c,
                    [w[2] for w in windows])
    out = []
    for idx, (j, i, lo, hi) in enumerate(pieces):
        rest = (hi - lo) / m / n
        if mask is None:
            ce = rest
        else:
            cnt = counts[idx]
            ce = (torch.clamp(cnt, min=1.0)
                  / torch.clamp(totals[i].to(cnt.device), min=1.0) / n)
        out.append((ce, rest))
    return out


def _run_piece(loss_fn, params, leaves, batch_rows, weights, grad: bool):
    """One piece's (weighted metrics, gradients of ``leaves`` or None)."""
    w_ce, w_rest = weights
    loss, metrics = loss_fn(params, batch_rows)
    ce = metrics.get("ce")
    objective = w_ce * loss if ce is None else w_ce * ce + w_rest * (loss - ce)
    grads = None
    if grad:
        grads = torch.autograd.grad(objective, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
    weighted = {}
    for k, v in metrics.items():
        v = v.detach()
        if k == "loss":
            weighted[k] = objective.detach()
        elif k == "ce":
            weighted[k] = w_ce * v
        else:
            weighted[k] = w_rest * v
    return weighted, grads


def _add_metrics(total: dict, part: dict, device) -> None:
    for k, v in part.items():
        v = v.to(device)
        total[k] = v if k not in total else total[k] + v


def _forward_windows(loss_fn, mesh, params, batch, *, n, grad, only,
                     max_pieces, transfers, on_grads=None):
    """Run every piece (of window ``only``, when given) on its compute
    index; returns the summed weighted metrics on index 0's device (or
    the window's)."""
    param_leaves = _tree.leaves(params)
    batch_leaves = _tree.leaves(batch)
    windows = _windows(batch_leaves)
    b = batch_leaves[0].shape[0]
    pieces = _pieces(windows, b, n)
    weights = _weights(batch, windows, pieces, n, transfers, mesh)
    out_dev = _device(mesh, 0 if only is None else windows[only][2])
    metrics = {}
    for j, (w0, w1, c) in enumerate(windows):
        if only is not None and j != only:
            continue
        mine = [(p, w) for p, w in zip(pieces, weights) if p[0] == j]
        if max_pieces is not None:
            mine = mine[:max_pieces]
        full = _gather_params(param_leaves, c, transfers)
        if grad:
            for t in full:
                t.requires_grad_(True)
        full_tree = _tree.unflatten(params, full)
        rows = {k: _rows(v, 0, w0, w1, c, transfers)
                for k, v in batch.items()}
        for (_, _, lo, hi), w in mine:
            piece = {k: v.narrow(0, lo - w0, hi - lo) for k, v in rows.items()}
            with torch.set_grad_enabled(grad):
                part, grads = _run_piece(loss_fn, full_tree, full, piece, w,
                                         grad)
            _add_metrics(metrics, part, out_dev)
            if grads is not None:
                on_grads(c, grads)
            del grads
        del full, full_tree, rows
    if len(windows) > 1 and only is None:
        for _, _, c in windows:
            _record(transfers, mesh, "all-reduce", 4 * len(metrics),
                    len(windows), c, [w[2] for w in windows])
    return metrics, windows


# ---------------------------------------------------------------------------
# The three functions
# ---------------------------------------------------------------------------

class ShardedTrainStep:
    """``make_sharded_train_step``'s step: ``step(state, batch) ->
    (state, metrics)``, the state updated in place and kept on
    ``state_shardings``; ``step(state, batch, only=j)`` runs window j's
    compute index's share (module docstring), its first ``max_pieces``
    microbatch pieces when given."""

    def __init__(self, loss_fn, options, mesh, state_shardings,
                 batch_shardings, *, transfers=None):
        self.loss_fn = loss_fn
        self.options = options
        self.mesh = mesh
        self.state_shardings = state_shardings
        self.batch_shardings = batch_shardings
        self.transfers = transfers
        self.schedule = make_schedule(options.schedule,
                                      peak_lr=options.peak_lr,
                                      warmup_steps=options.warmup_steps,
                                      total_steps=options.total_steps)

    def __call__(self, state, batch, *, only: Optional[int] = None,
                 max_pieces: Optional[int] = None):
        from repro_torch.train.trainer import TrainState, _advance_rng
        mesh, tr = self.mesh, self.transfers
        state = shd.device_put(state, self.state_shardings)
        batch = shd.device_put(batch, self.batch_shardings)
        params = _tree.leaves(state.params)
        windows = _windows(_tree.leaves(batch))
        computes = [w[2] for w in windows]
        positions = (range(mesh.size) if only is None
                     else [windows[only][2]])
        # one float32 accumulator a parameter block, on its first holder
        # (one window: the blocks its compute index holds), made before
        # the first piece so that every piece's peak is the same
        acc = []
        for leaf in params:
            sh = leaf.sharding
            groups = sh.blocks(leaf.shape)
            mine = {sh.block(p, leaf.ndim) for p in positions}
            acc.append({
                blk: torch.zeros(sh.shard_shape(leaf.shape),
                                 dtype=torch.float32,
                                 device=_device(mesh, ps[0] if only is None
                                                else positions[0]))
                for blk, ps in groups.items() if blk in mine})

        def reduce(c, grads):
            for leaf, g, blocks in zip(params, grads, acc):
                for blk, a in blocks.items():
                    win = tuple(slice(i * n, (i + 1) * n) for i, n in
                                zip(blk, a.shape))
                    a.add_(g[win].to(a.device, torch.float32))

        metrics, _ = _forward_windows(
            self.loss_fn, mesh, state.params, batch,
            n=self.options.grad_accum, grad=True, only=only,
            max_pieces=max_pieces, transfers=tr, on_grads=reduce)
        for leaf in params:
            _reduce_records(tr, mesh, leaf, positions, computes)

        # the clip's norm: every block once
        home = _device(mesh, positions[0])
        sq = [torch.sum(torch.square(a)).to(home)
              for blocks in acc for a in blocks.values()]
        gnorm = torch.sqrt(torch.sum(torch.stack(sq)))
        for p in positions:
            _record(tr, mesh, "all-reduce", 4, mesh.size, p,
                    range(mesh.size))

        opt = state.opt
        lr = self.schedule(_host_int(state.step.shards[positions[0]]))
        mu, nu = _tree.leaves(opt.mu), _tree.leaves(opt.nu)
        master = (_tree.leaves(opt.master) if opt.master is not None
                  else None)
        for p in positions:
            dev = _device(mesh, p)
            grads_p = [blocks[leaf.sharding.block(p, leaf.ndim)].to(dev)
                       for leaf, blocks in zip(params, acc)]
            st = AdamWState(
                step=opt.step.shards[p],
                mu=[t.shards[p] for t in mu], nu=[t.shards[p] for t in nu],
                master=(None if master is None
                        else [t.shards[p] for t in master]))
            _, new, _ = adamw_update(
                [t.shards[p] for t in params], grads_p, st, lr,
                b1=self.options.b1, b2=self.options.b2,
                weight_decay=self.options.weight_decay,
                max_grad_norm=self.options.max_grad_norm,
                grad_norm=gnorm.to(dev))
            opt.step.shards[p] = new.step
            state.step.shards[p] = state.step.shards[p] + 1
            del grads_p
        del acc
        rng0 = state.rng.shards[positions[0]]
        if not _abstract.is_fake(rng0):
            nxt = _advance_rng(rng0.cpu())
            for p in positions:
                state.rng.shards[p] = nxt.to(_device(mesh, p))
        new_state = TrainState(params=state.params, opt=opt, step=state.step,
                               rng=state.rng)
        return new_state, {**metrics, "grad_norm": gnorm.to(
            _device(mesh, 0 if only is None else positions[0])), "lr": lr}


def _reduce_records(tr, mesh, leaf, positions, computes) -> None:
    """The gradient reduction of ``leaf`` over the batch windows, as the
    collective each receiving index takes part in: a reduce-scatter over
    the batch axes the leaf splits over, an all-reduce over those it is
    replicated along."""
    k = len(computes)
    if tr is None or k <= 1:
        return
    batch = set(shd.batch_axes(mesh))
    kb = math.prod(mesh.shape[a] for e in leaf.sharding.spec
                   for a in shd._entry_axes(e) if a in batch)
    r = math.prod(leaf.sharding.shard_shape(leaf.shape)) * 4
    for p in positions:
        members = list(computes) + [p]
        if kb > 1:
            _record(tr, mesh, "reduce-scatter", r, kb, p, members)
        if k // kb > 1:
            _record(tr, mesh, "all-reduce", r, k // kb, p, members)


def make_sharded_train_step(loss_fn: Callable, options, mesh,
                            state_shardings, batch_shardings, *,
                            transfers: Optional[list] = None):
    """The counterpart of ``jit(make_train_step(loss_fn, options),
    in_shardings=(state_shardings, batch_shardings),
    out_shardings=(state_shardings, None))``: a step that takes a
    ``TrainState`` and a batch (placed trees, or plain tensors it places)
    and returns the state, updated in place on its shardings, and the
    metrics on mesh index 0's device."""
    return ShardedTrainStep(loss_fn, options, mesh, state_shardings,
                            batch_shardings, transfers=transfers)


@torch.no_grad()
def sharded_forward(loss_fn: Callable, mesh, params, batch, *,
                    only: Optional[int] = None,
                    transfers: Optional[list] = None):
    """``loss_fn(params, batch)`` over placed trees: (loss, metrics) on
    mesh index 0's device, each window run on its compute index."""
    metrics, _ = _forward_windows(loss_fn, mesh, params, batch, n=1,
                                  grad=False, only=only, max_pieces=None,
                                  transfers=transfers)
    return metrics["loss"], metrics


@torch.no_grad()
def sharded_decode_step(decode_fn: Callable, mesh, params, tokens, caches,
                        pos, *, batch_dims, only: Optional[int] = None,
                        transfers: Optional[list] = None):
    """``decode_fn(params, tokens, caches, pos)`` over placed trees:
    (logits on mesh index 0's device, the caches updated in place on
    their shardings).  ``tokens`` (B, 1) is placed by ``batch_shardings``
    (batch over the data axes when B divides them, else replicated: the
    reference dry run's decode tokens); ``batch_dims`` gives each
    cache leaf's batch dimension (``cache_batch_dims``)."""
    tokens = shd.device_put(tokens, shd.batch_shardings(tokens, mesh))
    cache_leaves = _tree.leaves(caches)
    dims = _tree.leaves(batch_dims)
    if len(dims) != len(cache_leaves):
        raise ValueError(f"{len(dims)} batch dims for {len(cache_leaves)} "
                         "cache leaves")
    windows = _windows([tokens])
    param_leaves = _tree.leaves(params)
    out = []
    for j, (w0, w1, c) in enumerate(windows):
        if only is not None and j != only:
            continue
        full = _tree.unflatten(params, _gather_params(param_leaves, c,
                                                      transfers))
        tok = _rows(tokens, 0, w0, w1, c, transfers)
        rows = [_rows(leaf, d, w0, w1, c, transfers)
                for leaf, d in zip(cache_leaves, dims)]
        logits, new = decode_fn(full, tok, _tree.unflatten(caches, rows),
                                pos)
        positions = range(mesh.size) if only is None else [c]
        for leaf, d, r in zip(cache_leaves, dims, _tree.leaves(new)):
            _write_rows(leaf, d, w0, r, c, positions, transfers)
        out.append((c, logits))
        del full, rows, new
    dev = _device(mesh, 0 if only is None else windows[only][2])
    logits = torch.cat([lg.to(dev) for _, lg in out], dim=0)
    if only is None:
        _record(transfers, mesh, "all-gather",
                logits.numel() * logits.element_size(), len(windows), 0,
                [0] + [c for c, _ in out])
    return logits, caches
