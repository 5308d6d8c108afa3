"""Production meshes.

Port of ``repro.launch.mesh`` over the port's ``dist.mesh.Mesh``, with
the reference's shapes and axis names:

    single-pod:  (16, 16)      -> ("data", "model")          = 256 cards
    multi-pod:   (2, 16, 16)   -> ("pod", "data", "model")   = 512 cards
    host:        (data, model) -> ("data", "model") over the visible cards

Logical mapping: batch -> ("pod", "data"); fsdp -> "data"; tp -> "model".

``make_production_mesh`` with ``devices=None`` needs one card a shard
and refuses a machine with fewer, as ``jax.make_mesh`` refuses: the
port's round-robin repetition (``dist.mesh.make_mesh``) would otherwise
put 256 shards on one card without a word.  The dry run passes
placeholder devices (``["meta"] * 256``).  ``make_host_mesh`` is the
card or cards, repeated as ``make_mesh`` repeats them.
"""

from __future__ import annotations

import math

import torch

from repro_torch._device import resolve
from repro_torch.dist.mesh import make_mesh


def production_shape(multi_pod: bool = False) -> tuple:
    """(mesh shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, devices=None):
    shape, axes = production_shape(multi_pod)
    if devices is None:
        resolve(None)                  # the card, or DeviceUnavailable
        have, need = torch.cuda.device_count(), math.prod(shape)
        if have < need:
            raise ValueError(
                f"make_production_mesh: the {shape} mesh needs {need} "
                f"devices, this machine has {have}; pass placeholder "
                "devices (devices=['meta'] * n) for a dry run")
    return make_mesh(shape, axes, devices=devices)


def make_host_mesh(*, data: int | None = None, model: int = 1,
                   devices=None):
    """Small mesh over the visible cards (tests / examples): ``data``
    defaults to the cards a model group.  With ``devices=None`` a mesh
    larger than the machine repeats its cards (``make_mesh``)."""
    if devices is None:
        resolve(None)                  # the card, or DeviceUnavailable
        n = torch.cuda.device_count()
    else:
        n = len(devices)
    data = data if data is not None else max(n // model, 1)
    if devices is not None and len(devices) != data * model:
        raise ValueError(f"make_host_mesh: {len(devices)} devices for a "
                         f"({data}, {model}) mesh")
    return make_mesh((data, model), ("data", "model"), devices=devices)
