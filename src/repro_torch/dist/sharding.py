"""Sharding rules: mesh-axis sizes and divisibility.

Port of the mesh-geometry half of ``repro.dist.sharding`` (same
functions, same error messages), duck-typed on ``mesh.axis_names`` and
``mesh.shape`` as the reference is.  Physical convention as in the
reference: batch data-parallel over ("pod", "data"), tensor-parallel
over "model".  ``param_shardings`` / ``cache_shardings`` /
``batch_shardings`` place a model's state and are ported with the
launchers' mesh and dry runs (ROADMAP Queue 1, slice 13).
"""

from __future__ import annotations


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
