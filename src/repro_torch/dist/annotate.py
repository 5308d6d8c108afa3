"""Logical-axis sharding annotations.

Port of ``repro.dist.annotate``.  Models annotate activations with
*logical* axis names ("batch", "tp", "fsdp"); the mapping to physical
mesh axes lives here (batch -> ("pod", "data"), fsdp -> "data", tp ->
"model").  In the reference an annotation inside a
``logical_axes(mesh)`` context becomes a ``with_sharding_constraint``.
The port has no compiler to hand a constraint to: a constraint never
changes values, and the executors of ``dist.mesh_exec`` place the
shards themselves, so ``annotate`` returns its input unchanged.  It
keeps the reference's name resolution (``spec``), with its
divisibility fallback: a dimension that does not divide its axes stays
replicated.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

_state = threading.local()

# Logical name -> candidate physical axes, in mapping priority order.
# "batch" spans every pure-data axis; "tp" is the tensor-model axis.
_LOGICAL = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "tp": ("model",),
}


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


def annotate(x, *names):
    """Mark ``x``'s dimensions with logical names
    (``annotate(h, "batch", None, "tp")``).  Returns ``x`` unchanged:
    the placement it names is ``spec(active_mesh(), x.shape, *names)``."""
    return x


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
