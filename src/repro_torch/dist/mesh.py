"""Device meshes: one controller over a grid of shards.

The port's counterpart of ``jax.sharding.Mesh`` and ``jax.make_mesh``
(and of ``launch/mesh.py::make_host_mesh``).  The reference runs one
process over a mesh and lets ``shard_map`` place each shard; the port
does the same from one Python process: a ``Mesh`` is an array of
``torch.device`` s with named axes, and the executors of
``dist.mesh_exec`` run each shard's work on its shard's device and copy
blocks between shards themselves.

A device may repeat: ``[cuda:0] * 8`` is eight shards on one card (and
``["cpu"] * 8`` eight on the CPU, as the tests use).  A mesh over
several cards is the same code, with peer copies in place of copies on
one card.  So a shard's identity is its **mesh index** (``Mesh.ids``),
never its ``torch.device``: with repeated devices, device equality
would make every shard on a card one shard.

``split`` and ``join`` are the placement helpers of the executors: a
payload's windows along one dimension, each on its shard's device, and
back.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve


def _device_array(devices: Sequence[torch.device], shape) -> np.ndarray:
    # np.asarray would try to iterate the devices; fill an object array.
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return arr.reshape(shape)


class Mesh:
    """An n-d array of ``torch.device`` s with one name an axis.

    ``devices``: the object array; ``axis_names``: the axis names;
    ``shape``: an ordered dict of axis sizes.  ``ids`` holds each shard's
    index on the mesh it was cut from (a survivor mesh keeps its shards'
    indices on the full mesh; a fresh mesh numbers its shards 0..size-1
    in row-major order) — the identity that health tracking uses.
    """

    def __init__(self, devices, axis_names: Sequence[str], *,
                 ids: Optional[np.ndarray] = None):
        if isinstance(devices, np.ndarray):
            devs = devices
        else:
            devs = list(devices)
            devs = _device_array(devs, (len(devs),))
        axis_names = tuple(axis_names)
        if devs.ndim != len(axis_names):
            raise ValueError(f"Mesh: {devs.ndim}-d device array but "
                             f"{len(axis_names)} axis names {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"Mesh: repeated axis name in {axis_names}")
        if devs.size == 0:
            raise ValueError("Mesh: no devices")
        self.devices = devs
        self.axis_names = axis_names
        self.shape = OrderedDict(zip(axis_names, devs.shape))
        if ids is None:
            ids = np.arange(devs.size).reshape(devs.shape)
        ids = np.asarray(ids, dtype=np.int64).reshape(devs.shape)
        if len(set(ids.reshape(-1).tolist())) != ids.size:
            raise ValueError(f"Mesh: shard ids {ids.tolist()} repeat")
        self.ids = ids

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_devices(self, axis: str) -> list:
        """The devices of the shards along ``axis``, every other axis at
        its first index: where a payload sharded over ``axis`` lives (the
        other axes would hold replicas)."""
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} not on mesh {self.axis_names}")
        at = tuple(slice(None) if a == axis else 0 for a in self.axis_names)
        return list(self.devices[at])

    def __repr__(self) -> str:
        devs = [str(d) for d in self.devices.reshape(-1)]
        return (f"Mesh({dict(self.shape)}, devices={devs}, "
                f"ids={self.ids.reshape(-1).tolist()})")


def make_mesh(shape, axes: Sequence[str],
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``.

    ``devices=None`` means the card: the visible CUDA devices in order,
    repeated round-robin when the mesh has more shards than cards (so
    ``make_mesh((8,), ("data",))`` is eight shards on a one-card
    machine); it raises ``DeviceUnavailable`` without CUDA.  Otherwise
    ``devices`` lists one device a shard, in row-major order, and may
    repeat a device (``["cpu"] * 8``).
    """
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if len(shape) != len(tuple(axes)):
        raise ValueError(f"make_mesh: shape {shape} but axes {tuple(axes)}")
    if devices is None:
        first = resolve(None)
        count = torch.cuda.device_count()
        devs = [torch.device("cuda", (first.index + i) % count)
                for i in range(n)]
    else:
        devs = [resolve(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"make_mesh: {len(devs)} devices for a mesh "
                             f"of {n} shards {shape}")
    return Mesh(_device_array(devs, shape), axes)


def split(x: torch.Tensor, devices: Sequence[torch.device], *,
          dim: int = 0, what: str = "payload") -> list:
    """``x``'s equal windows along ``dim``, window s on ``devices[s]``
    (a view where ``x`` already lies there and the window is
    contiguous)."""
    s = len(devices)
    if x.shape[dim] % s:
        raise ValueError(f"{what} of size {x.shape[dim]} does not divide "
                         f"evenly over {s} shards")
    out = []
    for win, dev in zip(torch.chunk(x, s, dim=dim), devices):
        out.append(win.to(dev).contiguous())
    return out


def join(shards: Sequence[torch.Tensor], device, *,
         dim: int = 0) -> torch.Tensor:
    """The per-shard windows back as one tensor on ``device``."""
    return torch.cat([t.to(device) for t in shards], dim=dim)
