"""Sharding rules: parameter / cache / batch shardings, and placement.

Port of ``repro.dist.sharding`` (same functions, same rules, same error
messages), duck-typed on ``mesh.axis_names`` and ``mesh.shape`` as the
reference is.  The rules are structural (by rank), with a per-dimension
divisibility fallback to replicated, so any tree from any model family
gets a valid sharding on any mesh.  Physical convention as in the
reference: batch data-parallel over ("pod", "data"), tensor-parallel
over "model".

``PartitionSpec`` and ``NamedSharding`` are the port's counterparts of
``jax.sharding``'s: a spec names, for each leading dimension, the mesh
axis or axes it splits over (None: replicated along it); the sharding
says which window of a global array each mesh index holds.  Along a
mesh axis the spec does not name, the shards are replicas.

``device_put(tree, shardings)`` places a tree on its mesh: every leaf
becomes a ``Sharded`` leaf holding one tensor a mesh index, on that
index's device, replicas included (on a mesh that repeats a device,
every replica is a real copy).  ``gather(leaf, device)`` is the
all-gather back to one tensor.  A shard's identity is its mesh index
(the row-major position in ``mesh.devices``), never its
``torch.device``: a mesh may repeat a device (``dist/mesh.py``).
``dist.spmd`` runs a model's steps on such trees.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import _tree


def batch_axes(mesh) -> tuple:
    """Mesh axes that carry pure data parallelism, slowest first."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def mesh_axis_size(mesh, axes) -> int:
    """Product of the named axes' sizes (1 for the empty tuple)."""
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(
                f"mesh_axis_size: axis {a!r} is not on the mesh; "
                f"available axes: {tuple(mesh.axis_names)}")
        size *= mesh.shape[a]
    return size


def require_divisible(dim: int, mesh, axes, *, what: str = "dimension") -> int:
    """Validate that ``dim`` splits evenly over the named mesh axes.

    Returns the per-shard size.  Raises a ValueError naming the operand
    before any shard runs.
    """
    size = mesh_axis_size(mesh, axes)
    if dim % size != 0:
        raise ValueError(
            f"{what} of size {dim} does not divide evenly over mesh "
            f"axes {axes!r} (total {size} shards); pad the {what} to a "
            f"multiple of {size} or use a smaller mesh")
    return dim // size


# ---------------------------------------------------------------------------
# Specs and shardings
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry a leading dimension: None (replicated), a mesh axis
    name, or a tuple of axis names (the dimension splits over their
    product, the first axis slowest).  Trailing dimensions the spec does
    not reach are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A ``PartitionSpec`` over a mesh: which window of a global array
    each mesh index holds.

    Mesh indices are flat row-major positions in ``mesh.devices``.
    ``index(position, shape)`` is the window (a tuple of slices);
    ``blocks(shape)`` groups the positions by the window they hold (a
    group of more than one position is a set of replicas).
    """

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec):
        spec = spec if isinstance(spec, PartitionSpec) else P(*spec)
        seen = []
        for entry in spec:
            for a in _entry_axes(entry):
                if a not in mesh.axis_names:
                    raise ValueError(f"NamedSharding: axis {a!r} of {spec} "
                                     f"is not on the mesh {mesh.axis_names}")
                if a in seen:
                    raise ValueError(f"NamedSharding: axis {a!r} used twice "
                                     f"in {spec}")
                seen.append(a)
        self.mesh = mesh
        self.spec = spec

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec})"

    def _dims(self, ndim: int) -> list:
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has {len(self.spec)} entries for "
                             f"a {ndim}-d array")
        return [_entry_axes(e) for e in self.spec] + [()] * (
            ndim - len(self.spec))

    def counts(self, ndim: int) -> tuple:
        """How many blocks each dimension splits into."""
        return tuple(math.prod(self.mesh.shape[a] for a in axes)
                     for axes in self._dims(ndim))

    def shard_shape(self, shape) -> tuple:
        """The shape every mesh index holds; raises when a named
        dimension does not divide over its axes."""
        out = []
        for i, (dim, k) in enumerate(zip(shape, self.counts(len(shape)))):
            if dim % k:
                raise ValueError(
                    f"dimension {i} of size {dim} does not divide evenly "
                    f"over {self.spec[i]!r} ({k} shards)")
            out.append(dim // k)
        return tuple(out)

    def block(self, position: int, ndim: int) -> tuple:
        """The block coordinates (one a dimension) that mesh index
        ``position`` holds."""
        coords = dict(zip(self.mesh.axis_names, np.unravel_index(
            position, self.mesh.devices.shape)))
        out = []
        for axes in self._dims(ndim):
            b = 0
            for a in axes:
                b = b * self.mesh.shape[a] + int(coords[a])
            out.append(b)
        return tuple(out)

    def index(self, position: int, shape) -> tuple:
        """The window of a ``shape`` array that ``position`` holds."""
        sub = self.shard_shape(shape)
        return tuple(slice(b * n, (b + 1) * n)
                     for b, n in zip(self.block(position, len(shape)), sub))

    def blocks(self, shape) -> dict:
        """{block coordinates: [positions holding it, row-major]}."""
        out = {}
        for p in range(self.mesh.size):
            out.setdefault(self.block(p, len(shape)), []).append(p)
        return out


# ---------------------------------------------------------------------------
# The reference's rules
# ---------------------------------------------------------------------------

def _entry(mesh, dim, axes):
    """One PartitionSpec entry with the divisibility fallback."""
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in axes if a in mesh.axis_names)
    if not axes or dim % mesh_axis_size(mesh, axes) != 0:
        return None
    return axes if len(axes) > 1 else axes[0]


def _param_spec(mesh, shape) -> PartitionSpec:
    """Matrices shard (row -> 'data' [fsdp-style], col -> 'model');
    leading (stack/expert) dims and vectors replicate."""
    if len(shape) < 2:
        return P()
    entries = [None] * (len(shape) - 2)
    entries.append(_entry(mesh, shape[-2], ("data",)))
    entries.append(_entry(mesh, shape[-1], ("model",)))
    return P(*entries)


def param_shardings(params, mesh, cfg=None):
    """NamedSharding tree for a parameter tree.  ``cfg`` is accepted for
    rule specialisation hooks; the structural rules cover every family."""
    del cfg
    return _tree.tree_map(
        lambda p: NamedSharding(mesh, _param_spec(mesh, p.shape)), params)


def _cache_spec(mesh, shape) -> PartitionSpec:
    """KV caches (..., B, S, KV, hd): batch -> data axes; kv-heads ->
    'model' when divisible, else head_dim -> 'model' (mirrors
    models/attention.annotate_grouped_q)."""
    if len(shape) < 4:
        return P()
    entries = [None] * len(shape)
    # batch dim: first dim of a 4-d cache, second of a stacked (L, B, ...)
    bdim = 0 if len(shape) == 4 else 1
    entries[bdim] = _entry(mesh, shape[bdim], batch_axes(mesh))
    kv_entry = _entry(mesh, shape[-2], ("model",))
    if kv_entry is not None:
        entries[-2] = kv_entry
    else:
        entries[-1] = _entry(mesh, shape[-1], ("model",))
    return P(*entries)


def cache_shardings(caches, mesh, cfg=None):
    """NamedSharding tree for decode caches."""
    del cfg
    return _tree.tree_map(
        lambda c: NamedSharding(mesh, _cache_spec(mesh, c.shape)), caches)


def _batch_spec(mesh, shape) -> PartitionSpec:
    """A batch leaf's leading dim over the data axes; the rest
    replicated."""
    entries = [_entry(mesh, shape[0], batch_axes(mesh))] if shape else []
    return P(*(entries + [None] * (len(shape) - 1)))


def batch_shardings(batch, mesh):
    """Shard every batch leaf's leading dim over the data axes."""
    return _tree.tree_map(
        lambda leaf: NamedSharding(mesh, _batch_spec(mesh, tuple(leaf.shape))),
        batch)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

class Sharded:
    """A global array held as one tensor a mesh index (``jax.Array``'s
    counterpart): ``shards[p]`` is mesh index p's window, on
    ``mesh.devices.flat[p]``."""

    __slots__ = ("shape", "dtype", "sharding", "shards")

    def __init__(self, shape, dtype, sharding: NamedSharding, shards):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.sharding = sharding
        self.shards = list(shards)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self) -> str:
        return (f"Sharded({self.shape}, {self.dtype}, {self.sharding.spec}, "
                f"{len(self.shards)} shards)")


def shard_nbytes(shape, dtype, sharding: NamedSharding) -> int:
    """Bytes one mesh index holds of a ``shape`` array."""
    return math.prod(sharding.shard_shape(tuple(shape))) * dtype.itemsize


def _put(x, sharding: NamedSharding) -> Sharded:
    if isinstance(x, Sharded):
        if x.sharding == sharding:
            return x
        x = gather(x)
    shape = tuple(x.shape)
    sub = sharding.shard_shape(shape)
    shards = []
    for p, dev in enumerate(sharding.mesh.devices.reshape(-1)):
        out = torch.empty(sub, dtype=x.dtype, device=dev)
        out.copy_(x[sharding.index(p, shape)])
        shards.append(out)
    return Sharded(shape, x.dtype, sharding, shards)


def device_put(tree, shardings):
    """``tree`` with every tensor leaf placed by the sharding at the same
    place of ``shardings``: a ``Sharded`` leaf with one fresh tensor a
    mesh index (a leaf already placed that way is kept; one placed
    otherwise is gathered and placed again)."""
    return _tree.tree_map(_put, tree, shardings)


def assemble(blocks: dict, counts, device) -> torch.Tensor:
    """One tensor on ``device`` from ``{block coordinates: tensor}``
    (``counts`` blocks along each dimension): nested concatenation,
    innermost dimension first.  Always a fresh tensor."""
    def build(prefix):
        d = len(prefix)
        if d == len(counts):
            t = blocks[prefix]
            return t if t.device == device else t.to(device)
        parts = [build(prefix + (i,)) for i in range(counts[d])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)

    out = build(())
    if len(blocks) == 1:
        out = out.clone()
    return out


def gather(leaf: Sharded, device=None) -> torch.Tensor:
    """The all-gather: the global array as one tensor on ``device`` (the
    first mesh index's device by default), from the first replica of
    each block."""
    device = leaf.shards[0].device if device is None else device
    groups = leaf.sharding.blocks(leaf.shape)
    return assemble({b: leaf.shards[ps[0]] for b, ps in groups.items()},
                    leaf.sharding.counts(leaf.ndim), device)
