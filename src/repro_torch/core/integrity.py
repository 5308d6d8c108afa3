"""Corruption-aware cache integrity (port of ``repro.core.integrity``).

Guarded caches of control information — pinned and LRU tile schedules,
megakernel control tables, registry program constants, GF(2) bit lifts
of GF(2^k) plans — are sealed
with a content digest at insert and re-verified on sampled hits: the
first hit of an entry and every ``sample_every``-th after it (16 by
default), and after ``force_verify`` (an engine fault) the next hit of
every entry.  A mismatch evicts the entry, counts an
``integrity_faults`` tick, emits an ``integrity_fault`` obs event and
raises ``IntegrityError``.  ``integrity_info`` aggregates the guards'
stats; three lazy gauges export the sampling knob, the verified-hit
rate and the sealed entries.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.core import abstract as _abstract


class IntegrityError(RuntimeError):
    """A guarded cache entry failed its content-digest verification."""

    def __init__(self, guard: str, key) -> None:
        super().__init__(
            f"integrity: cached {guard} entry failed digest verification "
            f"(key={key!r}); entry evicted — retry recompiles")
        self.guard = guard
        self.key = key


def _chunk(dtype_name: str, shape: tuple, raw: bytes) -> bytes:
    return (dtype_name.encode() + b"|" + repr(tuple(shape)).encode()
            + b"|" + raw)


def content_digest(parts: Iterable) -> str:
    """One hex digest over heterogeneous content parts.

    Tensors (on any device) and numpy arrays contribute dtype, shape and
    raw bytes; ``bytes`` themselves; ``None`` and scalars their repr.
    Parts are length-prefixed so adjacent parts cannot alias.
    """
    h = hashlib.sha256()
    for part in parts:
        if part is None:
            chunk = b"\x00none"
        elif isinstance(part, (bytes, bytearray)):
            chunk = bytes(part)
        elif isinstance(part, (str, int, float, bool)):
            chunk = repr(part).encode()
        elif isinstance(part, torch.Tensor):
            # Static control is read for real under the audit's fake
            # mode; a fake (payload-derived) part still raises.
            with _abstract.concrete(part):
                t = part.detach().contiguous().cpu()
                # Bit-level bytes of any dtype (bf16 has no numpy twin).
                raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
            chunk = _chunk(str(t.dtype), t.shape, raw)
        else:
            arr = np.ascontiguousarray(np.asarray(part))
            chunk = _chunk(str(arr.dtype), arr.shape, arr.tobytes())
        h.update(len(chunk).to_bytes(8, "big"))
        h.update(chunk)
    return h.hexdigest()


_LOCK = threading.RLock()
_SAMPLE_EVERY = 16        # verify hit 1, N+1, 2N+1, ... of each entry
_FORCE_EPOCH = 0          # bumped on every engine fault


def set_sample_every(n: int) -> int:
    """Set the verify-sampling knob; returns the previous value."""
    global _SAMPLE_EVERY
    if n < 1:
        raise ValueError(f"sample_every must be >= 1, got {n}")
    with _LOCK:
        prev, _SAMPLE_EVERY = _SAMPLE_EVERY, int(n)
    return prev


def sample_every() -> int:
    with _LOCK:
        return _SAMPLE_EVERY


@contextlib.contextmanager
def always_verify():
    """Scope with sampling forced to every hit (test helper)."""
    prev = set_sample_every(1)
    try:
        yield
    finally:
        set_sample_every(prev)


def force_verify() -> int:
    """Arm verify-on-next-hit for every guarded entry (after any engine
    fault, the next touch of each cached schedule, lift or program
    re-digests regardless of the sampling phase).  Returns the new
    fault epoch."""
    global _FORCE_EPOCH
    with _LOCK:
        _FORCE_EPOCH += 1
        return _FORCE_EPOCH


class _Entry:
    __slots__ = ("digest", "hits", "epoch")

    def __init__(self, digest: str, epoch: int) -> None:
        self.digest = digest
        self.hits = 0
        self.epoch = epoch


class CacheGuard:
    """Digest ledger for one cache family: the digest sealed at insert,
    the hit count and fault epoch of every key, and the family's
    sealed / hits / checks / faults counts.  ``sample_every`` fixes the
    guard's own sampling period; None follows the module's knob."""

    def __init__(self, name: str,
                 sample_every: Optional[int] = None) -> None:
        self.name = name
        self._sample_every = sample_every
        self._entries: dict = {}
        self._stats = {"sealed": 0, "hits": 0, "checks": 0, "faults": 0}

    def _effective_sample(self) -> int:
        return (self._sample_every if self._sample_every is not None
                else _SAMPLE_EVERY)

    def seal(self, key, parts: Optional[Iterable] = None, *,
             digest: Optional[str] = None) -> str:
        """Record the content digest for ``key`` (overwrite-on-insert)."""
        if digest is None:
            digest = content_digest(parts if parts is not None else ())
        with _LOCK:
            self._entries[key] = _Entry(digest, _FORCE_EPOCH)
            self._stats["sealed"] += 1
        return digest

    def verify(self, key, parts_fn: Optional[Callable[[], Iterable]] = None,
               *, digest_fn: Optional[Callable[[], str]] = None,
               evict: Optional[Callable[[], None]] = None) -> bool:
        """Check one cache hit against its seal (sampled, or forced by a
        fault epoch newer than the entry's last check).

        True when a comparison ran and matched; False when the hit was
        unsampled or never sealed.  On mismatch: drop the seal, run
        ``evict``, count, emit an ``integrity_fault`` event and raise
        ``IntegrityError``.
        """
        with _LOCK:
            entry = self._entries.get(key)
            if entry is None:
                return False
            hit_index = entry.hits
            entry.hits += 1
            self._stats["hits"] += 1
            if not (entry.epoch < _FORCE_EPOCH
                    or hit_index % self._effective_sample() == 0):
                return False
            entry.epoch = _FORCE_EPOCH
            self._stats["checks"] += 1
            want = entry.digest
        _telemetry_incr("integrity_checks")
        got = digest_fn() if digest_fn is not None else content_digest(
            parts_fn() if parts_fn is not None else ())
        if got == want:
            return True
        with _LOCK:
            self._entries.pop(key, None)
            self._stats["faults"] += 1
        if evict is not None:
            evict()
        _telemetry_incr("integrity_faults")
        _obs.event("integrity_fault", guard=self.name, key=str(key))
        raise IntegrityError(self.name, key)

    def drop(self, key) -> None:
        with _LOCK:
            self._entries.pop(key, None)

    def clear(self) -> None:
        with _LOCK:
            self._entries.clear()

    def depth(self) -> int:
        with _LOCK:
            return len(self._entries)

    def info(self) -> dict:
        with _LOCK:
            return dict(self._stats, size=len(self._entries),
                        sample_every=self._effective_sample())


def _telemetry_incr(name: str) -> None:
    from repro_torch.core import telemetry  # telemetry imports crossbar
    telemetry.incr(name)


SCHEDULE_GUARD = CacheGuard("schedule")    # pinned + LRU tile schedules
PROGRAM_GUARD = CacheGuard("program")      # megakernel control tables
CONST_GUARD = CacheGuard("const")          # registry program const blocks
LIFT_GUARD = CacheGuard("lift")            # GF(2^k) -> GF(2) lifted plans

GUARDS = (SCHEDULE_GUARD, PROGRAM_GUARD, CONST_GUARD, LIFT_GUARD)


def integrity_info() -> dict:
    """Aggregated guard stats (tests, dashboards)."""
    out = {g.name: g.info() for g in GUARDS}
    hits = sum(v["hits"] for v in out.values())
    checks = sum(v["checks"] for v in out.values())
    out["verify_rate"] = (checks / hits) if hits else 0.0
    return out


def reset() -> None:
    """Drop every seal and rewind the sampling state (test isolation)."""
    global _FORCE_EPOCH
    with _LOCK:
        for g in GUARDS:
            g._entries.clear()
            g._stats.update(sealed=0, hits=0, checks=0, faults=0)
        _FORCE_EPOCH = 0


# Export-time gauges: the sampling knob, the verified-hit fraction
# (checks / hits over every guard) and the sealed entries.
_obs.metrics.gauge_fn("integrity_sample_every", sample_every)
_obs.metrics.gauge_ratio(
    "integrity_verify_rate",
    lambda: sum(g.info()["checks"] for g in GUARDS),
    lambda: sum(g.info()["hits"] for g in GUARDS))
_obs.metrics.gauge_fn(
    "integrity_sealed_entries",
    lambda: sum(g.depth() for g in GUARDS))
