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


def _split_block(shape, dim, k, r) -> dict:
    """Rank r's block of ``dim`` split in k ({dim: (lo, hi)}), or the
    whole leaf ({}) when the dimension does not divide (the reference's
    fallback: replicated)."""
    n = shape[dim]
    if n % k:
        return {}
    return {dim: (r * n // k, (r + 1) * n // k)}


def column_block(shape, k, r) -> dict:
    """A matrix's column block: the dimension ``_param_spec`` puts on
    'model' (the last)."""
    return _split_block(shape, len(shape) - 1, k, r)


def row_block(shape, k, r) -> dict:
    """A matrix's row block: its contraction dimension (the first)."""
    return _split_block(shape, 0, k, r)


def expert_block(shape, k, r, leaf="wi", one_token=False) -> dict:
    """An expert weight's block, (E, D, F) for wi / wg and (E, F, D) for
    wo: rank r's E/k experts when E divides the axis (expert parallel,
    the reference's ``moe._expert_axis``), else its d_ff block of every
    expert (the columns of wi / wg, the rows of wo; wo's d_model columns
    for a decode step, as ``compute_block`` says)."""
    if shape[0] % k == 0:
        return _split_block(shape, 0, k, r)
    if leaf == "wo" and not one_token:
        return _split_block(shape, 1, k, r)
    return _split_block(shape, 2, k, r)


# the subtrees of an attention layer: the decoder-only families' "attn"
# (the encoder's too), the encoder-decoder's "self_attn" and "cross_attn",
# the hybrid's shared block
_ATTENTION = ("attn", "self_attn", "cross_attn", "shared")


def spans(rng) -> list:
    """The (lo, hi) spans of one dimension's range in a block: a block
    names a pair, or a list of pairs where it takes several spans of the
    dimension (Mamba2's ``in_proj`` and conv, ``compute_block``)."""
    return list(rng) if isinstance(rng, list) else [rng]


def _joined(pairs) -> object:
    """Sorted spans with adjacent ones merged: one pair, or a list."""
    out = []
    for lo, hi in sorted(pairs):
        if out and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out[0] if len(out) == 1 else out


def ssm_geometry(params):
    """(d_inner, heads, state size N) of a hybrid tree's Mamba2 layers,
    read off its leaves' shapes (``A_log`` (H,), ``conv_w`` (W, d_inner +
    2N), ``in_proj`` (D, 2 d_inner + 2N + H)); None for a tree without
    them."""
    shapes = {}
    for path, leaf in _tree.leaves_with_path(params):
        names = [p for p in path if isinstance(p, str)]
        if "mamba" in names[:-1]:
            shapes.setdefault(names[-1] if names[-1] != "w" else names[-2],
                              tuple(leaf.shape))
    if "A_log" not in shapes:
        return None
    h = shapes["A_log"][0]
    conv = shapes["conv_w"][-1]
    d_inner = shapes["in_proj"][-1] - conv - h
    return d_inner, h, (conv - d_inner) // 2


def _ssm_block(leaf, owner, shape, k, r, one_token, ssm) -> dict:
    """A Mamba2 leaf's block: the rank's SSM heads.  ``in_proj``'s
    columns [z | x | B | C | dt] give its heads' columns of z, x and dt
    and B and C whole (several spans); the conv's channels [x | B | C]
    its heads' x channels and B and C whole; ``out_proj`` its heads'
    rows (d_inner is head-major), a decode step's its column block; the
    vectors whole.  Where the heads do not divide the axis, every leaf
    whole (the reference's ``annotate_heads`` then leaves the heads
    replicated)."""
    if ssm is None:
        raise ValueError("a Mamba2 leaf's block needs the tree's SSM "
                         "geometry (ssm_geometry)")
    d_inner, h, n = ssm
    if h % k:
        return {}
    lo, hi = r * d_inner // k, (r + 1) * d_inner // k
    if owner == "in_proj":
        dt = 2 * d_inner + 2 * n
        return {1: _joined([(lo, hi), (d_inner + lo, d_inner + hi),
                            (2 * d_inner, dt),
                            (dt + r * h // k, dt + (r + 1) * h // k)])}
    if leaf in ("conv_w", "conv_b"):
        return {len(shape) - 1: _joined([(lo, hi),
                                         (d_inner, d_inner + 2 * n)])}
    if owner == "out_proj":
        return column_block(shape, k, r) if one_token else {0: (lo, hi)}
    return {}


def rwkv_heads(d_model: int) -> tuple:
    """(H, N) of an RWKV6 time mix of width ``d_model``: the head size is
    64, or in a reduced width the largest of 64, 32, ... that divides it
    (the reference's ``rwkv._head_geometry``)."""
    n = min(64, d_model)
    while d_model % n:
        n //= 2
    return d_model // n, n


def _rwkv_block(leaf, owner, mix, shape, k, r, one_token) -> dict:
    """An RWKV6 leaf's block.  The time mix's wr / wk / wv / wg take the
    column block (the rank's heads, N channels a head) and wo the row
    block (a decode step's: the column block), each whole where the
    heads do not divide the axis; the channel mix's wk (d_ff) and wr
    the column block, its wv the row block (a decode step's: the column
    block).  The LoRAs and the vectors whole."""
    if leaf != "w":
        return {}
    if mix == "tmix" and rwkv_heads(shape[0])[0] % k:
        return {}
    if owner == ("wo" if mix == "tmix" else "wv"):
        return (column_block if one_token else row_block)(shape, k, r)
    if owner in (("wr", "wk", "wv", "wg") if mix == "tmix"
                 else ("wk", "wr")):
        return column_block(shape, k, r)
    return {}


def compute_block(path, shape, k, r, one_token=False, ssm=None) -> dict:
    """{dim: (lo, hi)}: the block of a model's parameter leaf (at
    ``path`` in its tree: ``blocks``, ``enc_blocks`` or ``dec_blocks``,
    the hybrid's ``mamba`` and ``shared``, RWKV6's ``tmix`` and ``cmix``,
    or a table) that rank r of a model axis of k computes with; {} is
    the whole leaf.  A dimension the block takes in several spans names
    a list of pairs (``spans``).

    * wq / wk / wv (and their biases), wi and wg: the column block, the
      block ``_param_spec`` puts on 'model' (heads or kv heads, d_ff),
      in self, cross and the hybrid's shared attention alike;
    * the wo of attention and of the MLP: the row block (the rank's
      heads, its d_ff), whose products are partial sums over 'model';
      for a decode step (``one_token``), the column block, on the input
      gathered: a decode step's products then equal one device's
      (``layers.split_dense``), which partial sums cannot;
    * expert weights: ``expert_block``;
    * Mamba2's leaves: the rank's SSM heads (``_ssm_block``; ``ssm`` is
      the tree's ``ssm_geometry``);
    * RWKV6's time mix by heads, its channel mix by d_ff (``_rwkv_block``:
      wr / wk / wv / wg and the channel mix's wk / wr by columns, the
      time mix's wo and the channel mix's wv by rows, a decode step's by
      columns);
    * the embedding table and the head: the vocabulary row block;
    * the router, the norms, the LoRAs and every other vector: whole
      (every rank routes its window's groups and normalises its rows).

    A dimension that does not divide the axis stays whole (the
    reference's fallback)."""
    names = [p for p in path if isinstance(p, str)]
    leaf, owner = names[-1], names[-2] if len(names) > 1 else None
    attn = any(n in names for n in _ATTENTION)
    if leaf == "table":
        return _split_block(shape, 0, k, r)
    if "mamba" in names[:-1] and "ln" not in names:
        return _ssm_block(leaf, owner, shape, k, r, one_token, ssm)
    mix = next((n for n in ("tmix", "cmix") if n in names[:-1]), None)
    if mix is not None:
        return _rwkv_block(leaf, owner, mix, shape, k, r, one_token)
    if "moe" in names and owner == "moe" and leaf in ("wi", "wg", "wo"):
        return expert_block(shape, k, r, leaf, one_token)
    if owner == "wo" and (attn or "mlp" in names):
        if leaf != "w":
            return {}
        return (column_block if one_token else row_block)(shape, k, r)
    if ((attn and owner in ("wq", "wk", "wv"))
            or ("mlp" in names and owner in ("wi", "wg"))):
        return column_block(shape, k, r)
    return {}


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
