"""Sharded step execution: a model's state over a mesh.

The port's counterpart of GSPMD running ``jax.jit(step,
in_shardings=(state_sh, batch_sh), out_shardings=(state_sh, None))``,
and of the reference dry run's two other lowered functions (a forward
for prefill cells, a decode step against sharded caches).  One
controller over a ``dist.mesh.Mesh``, as ``dist.mesh_exec`` is: it runs
each shard's work on its shard's device and moves the blocks itself.
Trees hold ``dist.sharding.Sharded`` leaves (``sharding.device_put``).
Each function's result equals its single-device function's, up to the
order of the sums.

**Batch windows and model rows.**  The blocks of the batch leaves'
leading dimension (``batch_shardings``: one a batch shard) are the
windows.  Batch leaves lead with the batch dimension.  A window runs on
its **model row**: the mesh indices that hold it and differ from the
first of them along "model" only, in model-axis order (rank r of the
row).  Every family's functions (marked by ``model_zoo.build``:
``fn.model_split``) run a window on every index of its row, split over
"model" as the reference's annotations split each product: the model
code gets ``annotate.Parts`` of the row's ``annotate.ModelGroup`` and
each rank computes its share (``annotate``'s module docstring; the
splits are the model code's, the blocks ``sharding.compute_block``; the
hybrid's Mamba2 layers by SSM heads, its shared block by heads; the
rwkv time mix and its WKV state by heads, its channel mix by d_ff).  A
function not so marked runs each window on the row's first index
alone, each layer's matrices whole there.

**What an index holds.**  Its shards, and what one layer gathers: as
the reference's partitioned step holds them, not the whole model.  The
model functions get a parameter tree whose layer stacks (its top-level
lists: ``blocks``, ``enc_blocks`` / ``dec_blocks``, the hybrid's
``mamba`` and ``lora``) are per-layer views: item i is layer i's
leaves, gathered onto the index's device each time the model asks for
it (``layers.scan`` asks inside its checkpointed body, the decode loops
as they walk the stack), and freed when the model is done with it.  The
other leaves (embeddings, head, final norms, the hybrid's shared block)
are gathered once a window.  Split over "model", a rank gathers its
compute block of each leaf only (``sharding.compute_block``: the column
block of wq / wk / wv / wi / wg (and of RWKV6's wr / wk / wv / wg, its
channel mix's wk / wr), which its own shard's column holds, so that it
gathers over "data" alone; the row block of each wo (and of the channel
mix's wv), its heads' or its d_ff rows, which the model axis's column
shards hold between them (a decode step's: its column block); its
experts, or each expert's d_ff; its SSM heads' spans of Mamba2's
``in_proj`` and conv, which cross the column shards of "model", gathered
as one union (``_window``); its vocabulary rows of the tables; the
router, the LoRAs and the vectors whole), as a ``Parts`` leaf.  A
rank's blocks are 1/k of each split matrix, so no index holds or
gathers a whole layer's matrices (RWKV6's time mix, where its heads do
not divide the axis, whole).  Whole-layer compute gathers each leaf
whole.

**The train step** (``make_sharded_train_step``).  For each window in
turn, ``loss_fn`` runs forward and backward on the window's rows,
microbatch piece by piece.  A layer's gathered leaves reach the loss
through an autograd function (``_GatherLayer``) whose backward adds the
layer's gradients, in float32, into one accumulator a parameter block
on the block's first holder (the reduce-scatter over the batch axes; a
rank's block gradient lands in the blocks it overlaps) and drops the
gathered gradient; the other leaves' gradients go into their
accumulators after each piece's backward.  Under ``cfg.remat ==
"full"`` the layer is gathered inside the checkpointed body, so the
recompute gathers it again (as FSDP does, and XLA under
``jax.checkpoint``), and the recompute's moves over "model" run again;
with ``remat == "none"`` autograd keeps each gathered layer's saved
operands until the backward reaches it.

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
tokens' sharding on its row.  The caches are per-layer views too: the
model's ``c[i]`` (the hybrid's ``c[g, i]``) gathers layer i's cache
rows of the window when layer i runs — split over "model", each rank
its own block of them (the kv heads or the head_dim block the cache's
sharding gives its index), so the K/V rows never cross "model";
whole-layer, the rows of every block, gathered over "model".  The
hybrid's Mamba2 caches are read the same way, each rank its block, but
the cache's sharding (``_cache_spec``, the reference's rule) puts their
P (the state) and their channels (the conv edge) on "model", not the
heads the layer splits by: the model code moves the state to the heads'
placement and back (an all-to-all over "model") and gathers the edge,
recorded as activations; rwkv's WKV state, which it places by key rows
(the first N), the same way.  With two layer axes, ``_cache_spec`` puts
the data axes on the period, not on the batch (reference quirk R8), so a
window's Mamba2 rows cross "data"; rwkv's 4-d token-shift inputs (L, B,
1, D) it takes for unstacked caches, the data axes on the layers and
"model" on d_model (R9): a window's rows cross "data" where the layers
divide it, and the model code gathers d_model.
``decode_fn`` updates them in place, and they are written back to
every shard that holds them before the next layer's rows or parameters
are gathered, and after the step.  A cache leaf without a layer axis is
gathered whole for the window.  ``sharded_forward`` is the train step's
forward without gradients (prefill cells).

**One mesh index** (``only=j``): the work of window j's first index
alone — its gathers, its share of the forward (and backward, and the
reduction into the blocks it holds, and its shards' update), its cache
write-back; split over "model", the other ranks' contributions to its
collectives are zeros (``annotate``).  Every index does the same work,
so this is a device's share of the step: the dry run
(``launch/dryrun.py``) measures it.

**Transfers.**  Given a ``transfers`` list, each function appends one
``Transfer`` a collective it performs for a receiving mesh index: the
op, R (the bytes of the result on the receiving index), k (the group
size), the receiving index, the group, and what moved (``kind``:
"weight" gathers, "grad" reductions, "activation" moves over "model",
"cache" rows, "batch" rows and counts).  Every gather is recorded, the
recompute's included, and every reduction of a piece's gradients.
``ring_bytes(op, R, k)`` is the reference dry run's ring model
(``_collective_bytes``).  On a mesh that repeats a device the copies
stay on the device; the record is what a mesh of distinct cards would
move.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Sequence
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.core import abstract as _abstract
from repro_torch.dist import annotate as ann
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
    kind: str = "weight"    # weight | grad | activation | cache | batch

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


def _record(transfers, mesh, op, nbytes, k, dst, members, kind):
    if transfers is not None and k > 1:
        transfers.append(Transfer(op, float(nbytes), int(k),
                                  _mesh_id(mesh, dst),
                                  tuple(sorted(_mesh_id(mesh, m)
                                               for m in set(members))),
                                  kind))


def _window(leaf: shd.Sharded, ranges: dict, c: int,
            transfers=None, kind="weight") -> torch.Tensor:
    """A fresh tensor on mesh index c's device holding ``leaf`` over
    ``ranges`` ({dim: (lo, hi)}, or a list of spans: their union in
    order; every other dimension whole), gathered from the blocks that
    hold it (c's own where c holds one), each block's part cut before it
    moves: one gather, recorded with the union's bytes."""
    out, src = _cut(leaf, ranges, c)
    if any(p != c for p in src.values()):
        _record(transfers, leaf.sharding.mesh, "all-gather",
                out.numel() * out.element_size(), len(src), c,
                list(src.values()) + [c], kind)
    return out


def _cut(leaf: shd.Sharded, ranges: dict, c: int):
    """``_window``'s tensor and {block coordinates: the mesh index it
    was cut from}."""
    for d, rng in ranges.items():
        if isinstance(rng, list):          # several spans: each, joined
            cuts = [_cut(leaf, {**ranges, d: span}, c) for span in rng]
            return (torch.cat([t for t, _ in cuts], dim=d),
                    {b: p for _, src in cuts for b, p in src.items()})
    sh = leaf.sharding
    counts = list(sh.counts(leaf.ndim))
    size = sh.shard_shape(leaf.shape)
    first = [0] * leaf.ndim
    for d, (r0, r1) in ranges.items():
        first[d] = r0 // size[d]
        counts[d] = -(-r1 // size[d]) - first[d]
    src, parts = {}, {}
    for blk, holders in sh.blocks(leaf.shape).items():
        rel = tuple(b - f for b, f in zip(blk, first))
        if any(not 0 <= rel[d] < counts[d] for d in ranges):
            continue
        p = c if c in holders else holders[0]
        part = leaf.shards[p]
        for d, (r0, r1) in ranges.items():
            a = blk[d] * size[d]
            lo, hi = max(r0, a), min(r1, a + size[d])
            if (lo, hi) != (a, a + size[d]):
                part = part.narrow(d, lo - a, hi - lo)
        src[blk], parts[rel] = p, part
    return shd.assemble(parts, counts, _device(sh.mesh, c)), src


def _write_window(leaf: shd.Sharded, starts: dict, block: torch.Tensor,
                  c: int, positions, transfers=None) -> None:
    """Write ``block`` (``leaf`` from ``starts`` ({dim: first index})
    along those dimensions, every other dimension whole, on index c's
    device) into each shard of ``positions`` that holds any of it."""
    sh = leaf.sharding
    for p in positions:
        win = sh.index(p, leaf.shape)
        src = list(win)
        dst = [slice(None)] * leaf.ndim
        for d, r0 in starts.items():
            a, b = win[d].start, win[d].stop
            lo, hi = max(a, r0), min(b, r0 + block.shape[d])
            if lo >= hi:
                break
            src[d] = slice(lo - r0, hi - r0)
            dst[d] = slice(lo - a, hi - a)
        else:
            part = block[tuple(src)]
            leaf.shards[p][tuple(dst)].copy_(part)
            if p != c:
                _record(transfers, sh.mesh, "copy",
                        part.numel() * part.element_size(), 2, p, (c, p),
                        "cache")


# ---------------------------------------------------------------------------
# A compute index's view of the trees: a layer at a time
# ---------------------------------------------------------------------------

def _release(tree) -> None:
    """Empty a gathered subtree's dicts and lists in place, so that its
    tensors are freed once nothing else holds them."""
    if isinstance(tree, dict):
        for v in tree.values():
            _release(v)
        tree.clear()
    elif isinstance(tree, list):
        for v in tree:
            _release(v)
        tree.clear()


class _Layers(Sequence):
    """A layer stack as the model code walks it: item i is layer i's
    subtree, made by ``fetch(i)`` each time it is asked for.  Iterating
    releases each item before it makes the next, and the last when the
    walk ends, so that a walk holds one layer at a time."""

    def __init__(self, n: int, fetch: Callable):
        self._n = n
        self._fetch = fetch

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if not isinstance(i, int):
            raise TypeError(f"a layer stack is indexed by layer, not {i!r}")
        if not -self._n <= i < self._n:
            raise IndexError(i)
        return self._fetch(i % self._n)

    def __iter__(self):
        item = None
        try:
            for i in range(self._n):
                _release(item)
                item = self._fetch(i)
                yield item
        finally:
            _release(item)


class _GatherLayer(torch.autograd.Function):
    """Forward: ``gather()``'s fresh copies of a layer's leaves.
    Backward: their gradients handed to ``reduce`` (the reduction into
    the blocks' accumulators), nothing returned: no gradient reaches a
    shard.  ``anchor`` is a scalar that requires grad, so that autograd
    runs the backward."""

    @staticmethod
    def forward(ctx, anchor, gather, reduce):
        ctx.reduce = reduce
        ctx.set_materialize_grads(False)
        return tuple(gather())

    @staticmethod
    def backward(ctx, *grads):
        ctx.reduce(grads)
        return None, None, None


def _placed_params(params, row, transfers, *, group=None, anchor=None,
                   reduce=None, before=None, one_token=False):
    """The parameter dict a window's row runs the model on, and its
    once-a-window leaves [((flat index, ranges), tensor)].

    ``row`` is the window's mesh indices along "model"; ``group`` its
    ``annotate.ModelGroup`` (None for a row of one index).  With one
    index in the row each leaf is a tensor, gathered whole; split over
    "model", a ``Parts`` of the running ranks' compute blocks
    (``sharding.compute_block``; a decode step's with ``one_token``).
    The layer stacks, the
    dict's lists, are ``_Layers``: item i gathers layer i (through
    ``_GatherLayer`` when grad is enabled and ``anchor`` is given,
    ``reduce([(flat index, ranges)], grads)`` taking its gradients),
    after ``before()``.  Every other leaf is gathered now (requiring
    grad when ``anchor`` is given)."""
    with_path = _tree.leaves_with_path(params)
    leaves = [leaf for _, leaf in with_path]
    index = _tree.unflatten(params, range(len(leaves)))
    stacks = {name for name, sub in index.items() if isinstance(sub, list)}
    in_stacks = {k for name in stacks for k in _tree.leaves(index[name])}
    split = group is not None
    ranks = group.run if split else (0,)
    ssm = shd.ssm_geometry(params) if split else None

    def blocks(k):
        """[(rank, ranges)]: the gathers of leaf k."""
        if not split:
            return [(0, {})]
        path, leaf = with_path[k]
        return [(r, shd.compute_block(path, leaf.shape, len(row), r,
                                      one_token, ssm))
                for r in ranks]

    def metas(ks):
        return [(k, rng) for k in ks for _, rng in blocks(k)]

    def gather(ks):
        return [_window(leaves[k], rng, row[r], transfers)
                for k in ks for r, rng in blocks(k)]

    def leaf_values(ks, tensors):
        """One value a leaf: its tensor, or a ``Parts`` of its blocks."""
        it = iter(tensors)
        if not split:
            return [next(it) for _ in ks]
        out = []
        for k in ks:
            bl = blocks(k)
            out.append(group.parts({r: next(it) for r, _ in bl},
                                   next(iter(bl[0][1]), None)))
        return out

    whole_ks = [k for k in range(len(leaves)) if k not in in_stacks]
    whole_ts = gather(whole_ks)
    if anchor is not None:
        for t in whole_ts:
            t.requires_grad_(True)
    whole = dict(zip(whole_ks, leaf_values(whole_ks, whole_ts)))

    def fetch(item):
        if before is not None:
            before()
        ks = _tree.leaves(item)
        if anchor is not None and torch.is_grad_enabled():
            out = _GatherLayer.apply(anchor, lambda: gather(ks),
                                     lambda grads: reduce(metas(ks), grads))
        else:
            out = gather(ks)
        return _tree.unflatten(item, leaf_values(ks, out))

    def view(name, sub):
        if name in stacks:
            return _Layers(len(sub), lambda i: fetch(sub[i]))
        return _tree.map_with_path(lambda _, k: whole[k], sub)

    tree = {name: view(name, sub) for name, sub in index.items()}
    return tree, list(zip(metas(whole_ks), whole_ts))


class _CacheRows:
    """A stacked cache leaf's view for one window: ``view[i]`` (``[g,
    i]`` for two layer axes: the dimensions before the batch dimension)
    gathers that layer's rows of the window onto c's device and returns
    them (within ``block``, {dim: (lo, hi)}, along other dimensions: a
    rank's block over "model"); the rows held are written back to
    ``positions``' shards (``flush``) before other rows are gathered."""

    def __init__(self, leaf, dim, w0, w1, c, positions, transfers,
                 block=None):
        self.leaf, self.dim, self.w0, self.w1 = leaf, dim, w0, w1
        self.c, self.positions, self.transfers = c, positions, transfers
        self.block = block or {}
        self._held = None           # (layer index, rows with its axes)

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        if len(idx) != self.dim or not all(isinstance(i, int)
                                           for i in idx):
            raise TypeError(f"cache rows are indexed by {self.dim} layer "
                            f"indices, not {idx!r}")
        if self._held is None or self._held[0] != idx:
            self.flush()
            ranges = {d: (i, i + 1) for d, i in enumerate(idx)}
            ranges[self.dim] = (self.w0, self.w1)
            ranges.update(self.block)
            self._held = (idx, _window(self.leaf, ranges, self.c,
                                       self.transfers, "cache"))
        return self._held[1][(0,) * self.dim]

    def flush(self) -> None:
        if self._held is not None:
            idx, rows = self._held
            starts = {d: i for d, i in enumerate(idx)}
            starts[self.dim] = self.w0
            starts.update({d: lo for d, (lo, _) in self.block.items()})
            _write_window(self.leaf, starts, rows, self.c, self.positions,
                          self.transfers)
            self._held = None


def _windows(batch_leaves, split: bool) -> list:
    """[(r0, r1, row)] of the batch leaves' leading-dimension blocks:
    row is the window's model row (its first holder alone when not
    ``split``)."""
    first = batch_leaves[0]
    b = first.shape[0]
    for leaf in batch_leaves:
        if (not leaf.ndim or leaf.shape[0] != b
                or leaf.sharding.spec[:1] != first.sharding.spec[:1]):
            raise ValueError("batch leaves must share their leading (batch) "
                             f"dimension and its sharding: {leaf} against "
                             f"{first}")
    sh = first.sharding
    mesh = sh.mesh
    n = sh.counts(first.ndim)[0]
    per = b // n
    holders = {}
    for blk, ps in sh.blocks(first.shape).items():
        holders.setdefault(blk[0], []).extend(ps)
    out = []
    for j in range(n):
        c = min(holders[j])
        row = (c,)
        if split:
            row = tuple(p for p in sorted(holders[j])
                        if _off_model(mesh, p) == _off_model(mesh, c))
        out.append((j * per, (j + 1) * per, row))
    return out


def _coords(mesh, p) -> dict:
    return dict(zip(mesh.axis_names,
                    np.unravel_index(p, mesh.devices.shape)))


def _off_model(mesh, p) -> tuple:
    """Mesh index p's coordinates along every axis but "model"."""
    return tuple(int(v) for a, v in _coords(mesh, p).items() if a != "model")


def splits_over_model(fn, mesh) -> bool:
    """Whether ``fn``'s windows run split over "model": a family's
    function (``model_zoo.build`` marks them ``model_split``) on a mesh
    whose "model" axis has more than one index."""
    return (getattr(fn, "model_split", False)
            and mesh.shape.get("model", 1) > 1)


def _group(mesh, row, ranks, transfers):
    """The ``annotate.ModelGroup`` of a row, recording its moves (None
    for a row of one index)."""
    if len(row) == 1:
        return None

    def record(op, nbytes, r):
        _record(transfers, mesh, op, nbytes, len(row), row[r], row,
                "activation")
    return ann.ModelGroup(mesh, [_device(mesh, p) for p in row], ranks,
                          record)


def _rows(v: shd.Sharded, w0, w1, row, group, transfers):
    """A batch leaf's rows of a window on its row: a tensor (one index)
    or a replicated ``Parts`` (each rank's own shard's rows)."""
    if group is None:
        return _window(v, {0: (w0, w1)}, row[0], transfers, "batch")
    return group.parts({r: _window(v, {0: (w0, w1)}, row[r], transfers,
                                   "batch") for r in group.run}, None)


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
    firsts = [w[2][0] for w in windows]
    if mask is not None:
        for j, i, lo, hi in pieces:
            w0, _, row = windows[j]
            rows = mask.shards[row[0]].narrow(0, lo - w0, hi - lo)
            counts.append(torch.sum(rows.to(torch.float32)))
        home = _device(mesh, firsts[0])
        for (j, i, _, _), cnt in zip(pieces, counts):
            totals[i] = totals.get(i, 0) + cnt.to(home)
        for c in firsts:
            _record(transfers, mesh, "all-reduce", 4, len(windows), c,
                    firsts, "batch")
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
    """One piece's (weighted metrics, gradients of ``leaves`` or None; a
    leaf the loss does not reach gets None)."""
    w_ce, w_rest = weights
    loss, metrics = loss_fn(params, batch_rows)
    ce = metrics.get("ce")
    objective = w_ce * loss if ce is None else w_ce * ce + w_rest * (loss - ce)
    grads = None
    if grad:
        grads = torch.autograd.grad(objective, leaves, allow_unused=True)
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


def _narrow(v, lo, n):
    if isinstance(v, ann.Parts):
        return v.g.parts({r: t.narrow(0, lo, n) for r, t in v.t.items()},
                         v.dim)
    return v.narrow(0, lo, n)


def _forward_windows(loss_fn, mesh, params, batch, *, n, grad, only,
                     max_pieces, transfers, on_grads=None):
    """Run every piece (of window ``only``, when given) on its row;
    returns the summed weighted metrics on index 0's device (or the
    window's first index's), and the windows.  With ``grad``,
    ``on_grads(c, [(flat index, ranges)], grads)`` takes each piece's
    gradients: a layer's from its backward, the once-a-window leaves'
    after it."""
    batch_leaves = _tree.leaves(batch)
    windows = _windows(batch_leaves, splits_over_model(loss_fn, mesh))
    b = batch_leaves[0].shape[0]
    pieces = _pieces(windows, b, n)
    weights = _weights(batch, windows, pieces, n, transfers, mesh)
    out_dev = _device(mesh, 0 if only is None else windows[only][2][0])
    metrics = {}
    for j, (w0, w1, row) in enumerate(windows):
        if only is not None and j != only:
            continue
        c = row[0]
        ranks = range(len(row)) if only is None else (0,)
        mine = [(p, w) for p, w in zip(pieces, weights) if p[0] == j]
        if max_pieces is not None:
            mine = mine[:max_pieces]
        anchor = None
        if grad:
            anchor = torch.zeros((), device=_device(mesh, c),
                                 requires_grad=True)
        group = _group(mesh, row, ranks, transfers)
        tree, whole = _placed_params(
            params, row, transfers, group=group, anchor=anchor,
            reduce=lambda ms, grads, c=c: on_grads(c, ms, grads))
        rows = {k: _rows(v, w0, w1, row, group, transfers)
                for k, v in batch.items()}
        for (_, _, lo, hi), w in mine:
            piece = {k: _narrow(v, lo - w0, hi - lo)
                     for k, v in rows.items()}
            with torch.set_grad_enabled(grad):
                part, grads = _run_piece(
                    loss_fn, tree, [t for _, t in whole] + [anchor],
                    piece, w, grad)
            _add_metrics(metrics, part, out_dev)
            if grads is not None:
                on_grads(c, [m for m, _ in whole], grads[:-1])
            del grads
        del tree, whole, rows
    if len(windows) > 1 and only is None:
        firsts = [w[2][0] for w in windows]
        for c in firsts:
            _record(transfers, mesh, "all-reduce", 4 * len(metrics),
                    len(windows), c, firsts, "batch")
    return metrics, windows


def _add_block(acc: dict, ranges: dict, g: torch.Tensor) -> None:
    """Add gradient ``g`` of a leaf's region ``ranges`` ({dim: (lo,
    hi)} or a list of spans; the whole leaf along other dimensions) into
    every block accumulator ({block coordinates: float32 tensor}) it
    overlaps."""
    for d, rng in ranges.items():
        if isinstance(rng, list):          # several spans: each in turn
            off = 0
            for lo, hi in rng:
                _add_block(acc, {**ranges, d: (lo, hi)},
                           g.narrow(d, off, hi - lo))
                off += hi - lo
            return
    for blk, a in acc.items():
        src, dst = [], []
        for d, (b, n) in enumerate(zip(blk, a.shape)):
            lo, hi = ranges.get(d, (0, g.shape[d]))
            a0, a1 = max(b * n, lo), min((b + 1) * n, hi)
            if a0 >= a1:
                break
            src.append(slice(a0 - lo, a1 - lo))
            dst.append(slice(a0 - b * n, a1 - b * n))
        else:
            a[tuple(dst)].add_(g[tuple(src)].to(a.device, torch.float32))


# ---------------------------------------------------------------------------
# The three functions
# ---------------------------------------------------------------------------

class ShardedTrainStep:
    """``make_sharded_train_step``'s step: ``step(state, batch) ->
    (state, metrics)``, the state updated in place and kept on
    ``state_shardings``; ``step(state, batch, only=j)`` runs window j's
    first index's share (module docstring), its first ``max_pieces``
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
        paths = [p for p, _ in _tree.leaves_with_path(state.params)]
        windows = _windows(_tree.leaves(batch),
                           splits_over_model(self.loss_fn, mesh))
        positions = (range(mesh.size) if only is None
                     else [windows[only][2][0]])
        # one float32 accumulator a parameter block, on its first holder
        # (one index: the blocks it holds), made before the first piece
        # so that every piece's peak is the same
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
        # every rank's block of each leaf, for the reductions' records
        ssm = shd.ssm_geometry(state.params)
        computes = [[(p, shd.compute_block(path, leaf.shape, len(row), r,
                                           ssm=ssm)
                      if len(row) > 1 else {})
                     for _, _, row in windows for r, p in enumerate(row)]
                    for path, leaf in zip(paths, params)]

        # each piece's reduction is recorded once: by window `only`, or
        # by window 0 for the windows that run beside it
        recorder = windows[0 if only is None else only][2][0]

        def reduce(c, metas, grads):
            for (k, ranges), g in zip(metas, grads):
                if g is not None:
                    _add_block(acc[k], ranges, g)
            if c == recorder:
                for k in dict.fromkeys(k for k, _ in metas):
                    _reduce_records(tr, mesh, params[k], positions,
                                    computes[k])

        metrics, _ = _forward_windows(
            self.loss_fn, mesh, state.params, batch,
            n=self.options.grad_accum, grad=True, only=only,
            max_pieces=max_pieces, transfers=tr, on_grads=reduce)

        # the clip's norm: every block once
        home = _device(mesh, positions[0])
        sq = [torch.sum(torch.square(a)).to(home)
              for blocks in acc for a in blocks.values()]
        gnorm = torch.sqrt(torch.sum(torch.stack(sq)))
        for p in positions:
            _record(tr, mesh, "all-reduce", 4, mesh.size, p,
                    range(mesh.size), "grad")

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


def _overlaps(sh, p, shape, ranges) -> bool:
    """Whether mesh index p's shard of a ``shape`` leaf overlaps
    ``ranges`` ({dim: (lo, hi)})."""
    win = sh.index(p, shape)
    return all(any(win[d].start < hi and lo < win[d].stop
                   for lo, hi in shd.spans(rng))
               for d, rng in ranges.items())


def _reduce_records(tr, mesh, leaf, positions, computes) -> None:
    """The gradient reduction of ``leaf`` into each receiving index's
    shard, as the collective it takes part in, over the computing
    indices whose block overlaps the shard (``computes``: [(mesh index,
    ranges)]): a reduce-scatter over the batch axes the leaf splits
    over, an all-reduce over the rest."""
    if tr is None:
        return
    batch = set(shd.batch_axes(mesh))
    kb = math.prod(mesh.shape[a] for e in leaf.sharding.spec
                   for a in shd._entry_axes(e) if a in batch)
    r = math.prod(leaf.sharding.shard_shape(leaf.shape)) * 4
    for p in positions:
        members = [c for c, rng in computes
                   if _overlaps(leaf.sharding, p, leaf.shape, rng)]
        k = len(members)
        if k <= 1:
            continue
        kb_p = min(kb, k)
        if kb_p > 1:
            _record(tr, mesh, "reduce-scatter", r, kb_p, p, members + [p],
                    "grad")
        if k // kb_p > 1:
            _record(tr, mesh, "all-reduce", r, k // kb_p, p, members + [p],
                    "grad")


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
    mesh index 0's device, each window run on its row."""
    metrics, _ = _forward_windows(loss_fn, mesh, params, batch, n=1,
                                  grad=False, only=only, max_pieces=None,
                                  transfers=transfers)
    return metrics["loss"], metrics


def _model_block(leaf: shd.Sharded, k: int, r: int) -> dict:
    """The block along its "model" dimensions of a cache leaf that rank r
    of a row of k holds ({} when "model" splits none)."""
    out = {}
    for d, e in enumerate(leaf.sharding.spec):
        if "model" in shd._entry_axes(e):
            n = leaf.shape[d] // k
            out[d] = (r * n, (r + 1) * n)
    return out


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
    windows = _windows([tokens], splits_over_model(decode_fn, mesh))
    out = []
    for j, (w0, w1, row) in enumerate(windows):
        if only is not None and j != only:
            continue
        c = row[0]
        ranks = range(len(row)) if only is None else (0,)
        everywhere = range(mesh.size) if only is None else [c]
        views = {}
        for r in ranks:
            # rank r writes back to the shards of its "model" coordinate
            mine = [p for p in everywhere if len(row) == 1
                    or _coords(mesh, p).get("model")
                    == _coords(mesh, row[r]).get("model")]
            views[r] = [_CacheRows(leaf, d, w0, w1, row[r], mine, transfers,
                                   _model_block(leaf, len(row), r)
                                   if len(row) > 1 else None)
                        for leaf, d in zip(cache_leaves, dims)]

        def flush():
            for vs in views.values():
                for v in vs:
                    if v.dim:
                        v.flush()
        group = _group(mesh, row, ranks, transfers)
        held = [views[0][i] if group is None
                else _RowCache([views[r][i] for r in ranks], group)
                for i in range(len(cache_leaves))]
        held = [v if v.dim else v[()] for v in held]
        tree, _ = _placed_params(params, row, transfers, group=group,
                                 before=flush, one_token=True)
        tok = _rows(tokens, w0, w1, row, group, transfers)
        logits, _ = decode_fn(tree, tok, _tree.unflatten(caches, held), pos)
        for vs in views.values():
            for v in vs:
                v.flush()
        out.append((c, logits))
        del tree, views, held
    dev = _device(mesh, 0 if only is None else windows[only][2][0])
    logits = torch.cat([lg.to(dev) for _, lg in out], dim=0)
    if only is None:
        _record(transfers, mesh, "all-gather",
                logits.numel() * logits.element_size(), len(windows), 0,
                [0] + [c for c, _ in out], "batch")
    return logits, caches


class _RowCache:
    """A cache leaf's per-layer view on a row split over "model": item
    ``[i]`` is a ``Parts`` of each running rank's block of layer i's rows
    (``_CacheRows``)."""

    def __init__(self, views, group):
        self.group = group
        self.views = dict(zip(group.run, views))
        self.dim = views[0].dim
        model = list(views[0].block)
        # the split dimension of a layer's rows (the layer axes dropped)
        self.split = model[0] - self.dim if model else None

    def __getitem__(self, idx):
        return self.group.parts({r: v[idx] for r, v in self.views.items()},
                                self.split)
