"""Fault tolerance policies: survivor meshes, stragglers, heartbeats.

Port of ``repro.dist.fault``: the host-side policies (plain Python and
numpy) and ``rescale_gradients``, the alive-set mean of per-worker
gradients.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import _tree


def _prod(d: dict) -> int:
    return math.prod(d.values())


def survivor_mesh_shape(shape: dict, lost_devices: int) -> dict:
    """Largest mesh shape that fits the surviving devices.

    Drops whole pods first, then halves the data axis; the model axis
    never shrinks (model-parallel shards are not replicas).  Raises
    ``RuntimeError`` when only the model axis remains to give up.
    """
    total = _prod(shape)
    if lost_devices < 0:
        raise ValueError(f"lost_devices must be >= 0, got {lost_devices}")
    if lost_devices >= total:
        raise ValueError(
            f"lost_devices={lost_devices} >= total devices {total} in mesh "
            f"{shape}: no survivors — there is no mesh to shrink to; "
            "restore onto a fresh fleet instead")
    alive = total - lost_devices
    new = dict(shape)
    while _prod(new) > alive:
        if new.get("pod", 1) > 1:
            new["pod"] -= 1
        elif new.get("data", 1) > 1:
            new["data"] //= 2
        else:
            raise RuntimeError(
                f"cannot fit mesh {shape} into {alive} devices without "
                "shrinking the model axis")
    return new


@dataclasses.dataclass
class StragglerPolicy:
    """EWMA-deadline straggler detection with a drop/block decision.

    Workers slower than ``deadline_factor`` x the EWMA step time are
    dropped, unless that would drop more than ``1 - min_alive_fraction``
    of the fleet, in which case the step blocks for everyone.
    """

    deadline_factor: float = 2.0
    ewma_alpha: float = 0.1
    min_alive_fraction: float = 0.5
    _ewma: float | None = None

    def observe(self, step_time_s: float) -> None:
        if self._ewma is None:
            self._ewma = float(step_time_s)
        else:
            a = self.ewma_alpha
            self._ewma = a * float(step_time_s) + (1.0 - a) * self._ewma

    @property
    def deadline(self) -> float:
        if self._ewma is None:
            return float("inf")
        return self.deadline_factor * self._ewma

    def decide(self, worker_times) -> tuple[np.ndarray, bool]:
        """(alive mask, block): who to keep, or block for everyone."""
        times = np.asarray(worker_times, dtype=np.float64)
        alive = times <= self.deadline
        if alive.mean() < self.min_alive_fraction:
            return np.ones_like(alive, dtype=bool), True
        return alive, False


def rescale_gradients(grads, alive):
    """Mean of per-worker gradients over the alive set (unbiased: the
    denominator is the alive count, not the fleet size).

    grads: tree of (workers, ...) stacked per-worker grads.
    alive: (workers,) bool.
    """
    leaves = _tree.leaves(grads)
    dev = leaves[0].device if leaves else None
    alive = torch.as_tensor(alive, device=dev)
    denom = torch.clamp(torch.sum(alive.to(torch.float32)), min=1.0)

    def reduce(g):
        mask = alive.to(g.dtype).reshape((-1,) + (1,) * (g.dim() - 1))
        return torch.sum(g * mask, dim=0) / denom.to(g.dtype)

    return _tree.tree_map(reduce, grads)


class HeartbeatTracker:
    """Counts consecutive missed heartbeats per host.

    ``beat(host)`` between ticks marks the host alive; ``tick()``
    advances the epoch and returns the hosts at or over the threshold.
    """

    def __init__(self, hosts: int, miss_threshold: int = 3):
        if hosts < 1:
            raise ValueError(f"need at least one host, got {hosts}")
        if miss_threshold < 1:
            raise ValueError(
                f"miss_threshold must be >= 1, got {miss_threshold}")
        self.hosts = hosts
        self.miss_threshold = miss_threshold
        self._misses = [0] * hosts
        self._beaten = [False] * hosts

    def beat(self, host: int) -> None:
        # A negative index would wrap to another host's slot and mask a
        # real liveness bug.
        if not 0 <= host < self.hosts:
            raise ValueError(
                f"host index {host} out of range [0, {self.hosts})")
        self._beaten[host] = True

    def tick(self) -> list:
        for h in range(self.hosts):
            if self._beaten[h]:
                self._misses[h] = 0
            else:
                self._misses[h] += 1
            self._beaten[h] = False
        return [h for h in range(self.hosts)
                if self._misses[h] >= self.miss_threshold]
