"""LR schedules: linear-warmup cosine and WSD (Warmup-Stable-Decay).

Port of ``repro.optim.schedules``, as functions of an integer step that
return a float.  WSD is the MiniCPM schedule (arXiv:2404.06395): warmup
-> long constant plateau -> short (10%) exponential decay tail.
"""

from __future__ import annotations

import math


def _clip01(v: float) -> float:
    return min(max(v, 0.0), 1.0)


def cosine_schedule(step, *, peak_lr, warmup_steps, total_steps,
                    min_ratio=0.1):
    s = float(step)
    if s < warmup_steps:
        return peak_lr * s / max(warmup_steps, 1)
    prog = _clip01((s - warmup_steps) / max(total_steps - warmup_steps, 1))
    return peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                      (1 + math.cos(math.pi * prog)))


def wsd_schedule(step, *, peak_lr, warmup_steps, total_steps,
                 decay_fraction=0.1, min_ratio=0.01):
    """MiniCPM Warmup-Stable-Decay: plateau at peak, 10% tail decay."""
    s = float(step)
    decay_steps = max(int(total_steps * decay_fraction), 1)
    decay_start = total_steps - decay_steps
    if s < warmup_steps:
        return peak_lr * s / max(warmup_steps, 1)
    if s < decay_start:
        return peak_lr
    # exponential decay tail: lr = peak * min_ratio ** (progress_in_tail)
    return peak_lr * min_ratio ** _clip01((s - decay_start) / decay_steps)


def make_schedule(kind: str, *, peak_lr=3e-4, warmup_steps=100,
                  total_steps=10_000):
    if kind == "wsd":
        return lambda step: wsd_schedule(step, peak_lr=peak_lr,
                                         warmup_steps=warmup_steps,
                                         total_steps=total_steps)
    return lambda step: cosine_schedule(step, peak_lr=peak_lr,
                                        warmup_steps=warmup_steps,
                                        total_steps=total_steps)
