"""Logical-axis sharding annotations, and the model-axis group.

Port of ``repro.dist.annotate``.  Models annotate activations with
*logical* axis names ("batch", "tp", "fsdp"); the mapping to physical
mesh axes lives here (batch -> ("pod", "data"), fsdp -> "data", tp ->
"model").  In the reference an annotation inside a
``logical_axes(mesh)`` context becomes a ``with_sharding_constraint``,
and GSPMD partitions every product around it.  ``spec`` keeps the
reference's name resolution, with its divisibility fallback: a
dimension that does not divide its axes stays replicated.

The port has no compiler to hand a constraint to.  Off the sharded
executor an annotation returns its input unchanged: a constraint never
changes values.  The executor runs a batch window on its **model-axis
group** (``ModelGroup``: the mesh indices along "model" that hold the
window, ``dist.spmd``); every family's model code then gets its
parameters and inputs as ``Parts`` —
one tensor a rank of the group, with where the global value lies (split
on a dimension, replicated, or a partial sum) — and ``annotate`` moves
such a value to
the placement its names resolve to (``spec`` on the global shape, "model" entries only: the
batch axes are the executor's windows), through the collectives below,
each recorded with its bytes:

    partial    -> split d      reduce-scatter
    partial    -> replicated   all-reduce
    split d    -> replicated   all-gather
    split d    -> split d'     all-to-all
    replicated -> split d      each rank keeps its block (no move)

Each collective's backward is its dual (all-gather <-> reduce-scatter,
all-reduce <-> all-reduce, all-to-all reversed), recorded too.  The
hybrid's moves are these: its carry, the shared block's concat and each
Mamba2 layer's input gathered over the sequence, the partial sums of
wo and ``out_proj`` reduce-scattered into the carry, the gated norm's
sums of squares all-reduced, and in decode each Mamba2 state moved from
the cache's P block to the heads' and back (an all-to-all).  The rwkv
family's: each time and channel mix's input gathered over the
sequence, the partial sums of the time mix's wo and the channel mix's
wv reduce-scattered into the carry, the receptance gate moved from its
column block to the carry's rows (an all-to-all), and in decode each
WKV state moved from the cache's key-row block to the heads' and back.  A parameter
block of several spans (Mamba2's ``in_proj`` and conv,
``sharding.compute_block``) is a ``Parts`` whose ``dim`` names the
dimension of its spans; the model code reads it rank by rank.  A group
that runs one rank alone (``only``: the dry run's one mesh index) takes
zeros for the other ranks' contributions: the moves and the memory are
a rank's, the values are not the step's.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

_state = threading.local()

# Logical name -> candidate physical axes, in mapping priority order.
# "batch" spans every pure-data axis; "tp" is the tensor-model axis.
_LOGICAL = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "tp": ("model",),
}

SUM = "sum"         # a Parts layout: the value is the ranks' sum


def _stack():
    if not hasattr(_state, "meshes"):
        _state.meshes = []
    return _state.meshes


def active_mesh():
    """The mesh of the innermost ``logical_axes`` context, or None."""
    stack = _stack()
    return stack[-1] if stack else None


@contextmanager
def logical_axes(mesh):
    """Activate logical-axis annotation against ``mesh`` (this thread)."""
    stack = _stack()
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def _physical(mesh, name):
    """Resolve a logical name to mesh axes present on this mesh."""
    if name is None:
        return None
    cands = _LOGICAL.get(name, (name,))
    present = tuple(a for a in cands if a in mesh.axis_names)
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def _axis_size(mesh, phys):
    if phys is None:
        return 1
    if isinstance(phys, tuple):
        size = 1
        for a in phys:
            size *= mesh.shape[a]
        return size
    return mesh.shape[phys]


def spec(mesh, shape, *names) -> tuple:
    """The placement ``annotate`` names for a tensor of ``shape``: one
    entry a dimension, the physical axis (or tuple of axes) it shards
    over or None (replicated) — the reference's ``PartitionSpec``
    entries.  Missing trailing names mean replicated."""
    names = tuple(names) + (None,) * (len(shape) - len(names))
    entries = []
    for dim, name in zip(shape, names):
        phys = _physical(mesh, name)
        if phys is None or dim % _axis_size(mesh, phys) != 0:
            entries.append(None)
        else:
            entries.append(phys)
    return tuple(entries)


# ---------------------------------------------------------------------------
# The model-axis group
# ---------------------------------------------------------------------------

class ModelGroup:
    """The mesh indices along "model" that run one batch window: rank r
    is ``devices[r]``'s mesh index, in model-axis order.  ``run`` is the
    ranks that run (all of them, or one: ``only``); ``record(op, nbytes,
    rank)`` takes each move a rank receives."""

    def __init__(self, mesh, devices, run, record=None):
        self.mesh = mesh
        self.devices = list(devices)
        self.k = len(self.devices)
        self.run = tuple(run)
        self._record = record

    def record(self, op, nbytes, rank) -> None:
        if self._record is not None:
            self._record(op, nbytes, rank)

    def block(self, size: int, r: int) -> tuple:
        """(lo, hi) of rank r's block of a dimension of ``size``."""
        n = size // self.k
        return r * n, (r + 1) * n

    def parts(self, t: dict, dim=None) -> "Parts":
        return Parts(t, dim, self)

    def map(self, fn, *args, dim=None, rank=False):
        """``fn`` on every running rank's tensors: each ``Parts`` argument
        (or dict of them) replaced by that rank's entry, ``fn(r, ...)``
        with ``rank``.  Returns ``Parts`` of ``dim`` (a tuple of them
        when ``fn`` returns a tuple; ``dim`` a tuple then too)."""
        outs = {}
        for r in self.run:
            a = [_at(x, r) for x in args]
            outs[r] = fn(r, *a) if rank else fn(*a)
        first = next(iter(outs.values()))
        if isinstance(first, tuple):
            dims = dim if isinstance(dim, tuple) else (dim,) * len(first)
            return tuple(self.parts({r: o[i] for r, o in outs.items()}, d)
                         for i, d in enumerate(dims))
        return self.parts(outs, dim)

    def one(self, x: "Parts") -> torch.Tensor:
        """A replicated value's tensor on the first running rank."""
        if x.dim is not None:
            raise ValueError(f"{x} is not replicated")
        return x.t[self.run[0]]


class Parts:
    """One activation (or one parameter's blocks) of a ``ModelGroup``
    ``g``: ``t[r]`` is rank r's tensor, on its device, for every rank
    that runs.  ``dim`` says where the global value lies: an int (split
    on that dimension, rank r holding block r), None (replicated: every
    rank holds all of it) or ``SUM`` (the ranks' partial sums).  The
    group travels with the value (not in a context): autograd may run
    a recompute on another thread."""

    __slots__ = ("t", "dim", "g")

    def __init__(self, t: dict, dim, g: ModelGroup):
        self.t = dict(t)
        self.dim = dim
        self.g = g

    def first(self) -> torch.Tensor:
        """The first running rank's tensor."""
        return next(iter(self.t.values()))

    @property
    def dtype(self) -> torch.dtype:
        return self.first().dtype

    @property
    def shape(self) -> tuple:
        """The global shape (a split dimension times the group's size)."""
        shape = list(self.first().shape)
        if isinstance(self.dim, int):
            shape[self.dim] *= self.g.k
        return tuple(shape)

    def __repr__(self) -> str:
        return f"Parts({self.dim!r}, {[tuple(t.shape) for t in self.t.values()]})"

    def __add__(self, other: "Parts") -> "Parts":
        """Rank by rank; both must lie the same way."""
        if not isinstance(other, Parts) or other.dim != self.dim:
            raise ValueError(f"adding {other} to {self}: place them alike")
        return self.g.parts({r: t + other.t[r] for r, t in self.t.items()},
                            self.dim)

    def __getitem__(self, idx) -> "Parts":
        """Slices rank by rank along dimensions that are not split."""
        idx = idx if isinstance(idx, tuple) else (idx,)
        if not all(isinstance(i, slice) for i in idx) or (
                isinstance(self.dim, int) and self.dim < len(idx)
                and idx[self.dim] != slice(None)):
            raise IndexError(f"{self} sliced by {idx}")
        return self.g.parts({r: t[idx] for r, t in self.t.items()},
                            self.dim)


def _at(x, r):
    if isinstance(x, Parts):
        return x.t[r]
    if isinstance(x, dict):
        return {k: _at(v, r) for k, v in x.items()}
    return x


# -- the collectives ------------------------------------------------------------

def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _gather(g, ts, dim):
    out = {}
    for q in g.run:
        mine = ts[q]
        parts = [ts[r].to(g.devices[q]) if r in ts
                 else torch.zeros_like(mine) for r in range(g.k)]
        out[q] = torch.cat(parts, dim=dim)
        g.record("all-gather", _nbytes(out[q]), q)
    return out


def _scatter(g, ts, dim):
    out = {}
    for q in g.run:
        lo, hi = g.block(ts[q].shape[dim], q)
        parts = [ts[r].narrow(dim, lo, hi - lo).to(g.devices[q])
                 for r in range(g.k) if r in ts]
        out[q] = _sum(parts)
        g.record("reduce-scatter", _nbytes(out[q]), q)
    return out


def _sum(parts, op="sum"):
    """The parts' sum (or maximum) in rank order, a fresh tensor."""
    acc = parts[0].clone()
    for p in parts[1:]:
        if op == "sum":
            acc.add_(p)
        else:
            torch.maximum(acc, p, out=acc)
    return acc


def _reduce(g, ts, op="sum"):
    out = {}
    for q in g.run:
        out[q] = _sum([ts[r].to(g.devices[q]) for r in range(g.k)
                       if r in ts], op)
        g.record("all-reduce", _nbytes(out[q]), q)
    return out


def _all_to_all(g, ts, src, dst):
    """Split on ``src`` -> split on ``dst``: rank q takes block q of
    every rank's ``dst`` dimension, joined along ``src``."""
    out = {}
    for q in g.run:
        lo, hi = g.block(ts[q].shape[dst], q)
        parts = [ts[r].narrow(dst, lo, hi - lo).to(g.devices[q]) if r in ts
                 else torch.zeros_like(ts[q].narrow(dst, lo, hi - lo))
                 for r in range(g.k)]
        out[q] = torch.cat(parts, dim=src)
        g.record("all-to-all", _nbytes(out[q]), q)
    return out


def _move(g, ts, src, dst):
    """Rank tensors placed by ``src`` moved to ``dst`` (two different
    placements)."""
    if src == SUM:
        return _reduce(g, ts) if dst is None else _scatter(g, ts, dst)
    if src is None:
        out = {}
        for r, t in ts.items():
            lo, hi = g.block(t.shape[dst], r)
            out[r] = t.narrow(dst, lo, hi - lo)
        return out
    return _gather(g, ts, src) if dst is None else _all_to_all(g, ts, src,
                                                               dst)


def _dual(layout):
    """The layout of a layout's gradient: a replicated value's gradient
    is a partial sum a rank, a partial sum's is replicated."""
    if layout is None:
        return SUM
    if layout == SUM:
        return None
    return layout


class _Collective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, src, dst, *ts):
        ctx.g, ctx.src, ctx.dst = g, src, dst
        out = _move(g, dict(zip(g.run, ts)), src, dst)
        return tuple(out[r] for r in g.run)

    @staticmethod
    def backward(ctx, *grads):
        g = ctx.g
        out = _move(g, dict(zip(g.run, grads)), _dual(ctx.dst),
                    _dual(ctx.src))
        return (None, None, None) + tuple(out[r] for r in g.run)


def reshard(x: Parts, dim) -> Parts:
    """``x`` placed by ``dim`` (an int: split there; None: replicated)."""
    g = x.g
    if x.dim == dim:
        return x
    if x.dim is None:                      # a slice: no move, no record
        return g.parts(_move(g, x.t, None, dim), dim)
    out = _Collective.apply(g, x.dim, dim, *(x.t[r] for r in g.run))
    return g.parts(dict(zip(g.run, out)), dim)


def all_reduce_max(x: Parts) -> Parts:
    """The ranks' elementwise maximum of their values, on every rank (a
    replicated value is its own; no gradient: it only shifts a
    softmax)."""
    if x.dim is None:
        return x
    return x.g.parts(_reduce(x.g, {r: t.detach() for r, t in x.t.items()},
                             op="max"), None)


def annotate(x, *names):
    """Mark ``x``'s dimensions with logical names
    (``annotate(h, "batch", None, "tp")``).  A tensor is returned
    unchanged; ``Parts`` move to the dimension that ``spec`` puts on
    "model" (replicated when none is)."""
    if not isinstance(x, Parts):
        return x
    entries = spec(x.g.mesh, x.shape, *names)
    dims = [d for d, e in enumerate(entries)
            if e == "model" or (isinstance(e, tuple) and "model" in e)]
    return reshard(x, dims[0] if dims else None)


def annotate_heads(x, *, heads: int = 2, seq: int = 1):
    """Annotate an attention tensor: batch on dim 0, heads over 'model'
    when the head count divides it (the sequence dim stays
    replicated)."""
    mesh = active_mesh()
    if mesh is None:
        return x
    names = [None] * x.ndim
    names[0] = "batch"
    if x.shape[heads] % mesh.shape.get("model", 1) == 0:
        names[heads] = "tp"
    del seq  # sequence dim stays replicated by construction
    return annotate(x, *names)
