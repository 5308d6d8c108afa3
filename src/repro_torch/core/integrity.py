"""Corruption-aware cache integrity (port of ``repro.core.integrity``).

Guarded caches of control information — pinned and LRU tile schedules,
megakernel control tables, registry program constants, GF(2) bit lifts
of GF(2^k) plans — are sealed
with a content digest at insert and re-verified on sampled hits: the
first hit of an entry and every ``sample_every``-th after it (16 by
default).  A mismatch evicts the entry, counts an ``integrity_faults``
tick and raises ``IntegrityError``.  (The reference's fault-armed
``force_verify`` epoch comes with the resilience layer.)
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Callable, Iterable, Optional

import numpy as np
import torch


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
_SAMPLE_EVERY = 16


def set_sample_every(n: int) -> int:
    """Set the verify-sampling knob; returns the previous value."""
    global _SAMPLE_EVERY
    if n < 1:
        raise ValueError(f"sample_every must be >= 1, got {n}")
    with _LOCK:
        prev, _SAMPLE_EVERY = _SAMPLE_EVERY, int(n)
    return prev


@contextlib.contextmanager
def always_verify():
    """Scope with sampling forced to every hit (test helper)."""
    prev = set_sample_every(1)
    try:
        yield
    finally:
        set_sample_every(prev)


class CacheGuard:
    """Digest ledger for one cache family: the digest sealed at insert
    and the hit count of every key."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._entries: dict = {}      # key -> [digest, hits]

    def seal(self, key, parts: Optional[Iterable] = None, *,
             digest: Optional[str] = None) -> str:
        """Record the content digest for ``key`` (overwrite-on-insert)."""
        if digest is None:
            digest = content_digest(parts if parts is not None else ())
        with _LOCK:
            self._entries[key] = [digest, 0]
        return digest

    def verify(self, key, parts_fn: Optional[Callable[[], Iterable]] = None,
               *, digest_fn: Optional[Callable[[], str]] = None,
               evict: Optional[Callable[[], None]] = None) -> bool:
        """Check one cache hit against its seal (sampled).

        True when a comparison ran and matched; False when the hit was
        unsampled or never sealed.  On mismatch: drop the seal, run
        ``evict``, count, raise ``IntegrityError``.
        """
        with _LOCK:
            entry = self._entries.get(key)
            if entry is None:
                return False
            want, hit_index = entry
            entry[1] += 1
            if hit_index % _SAMPLE_EVERY:
                return False
        _telemetry_incr("integrity_checks")
        got = digest_fn() if digest_fn is not None else content_digest(
            parts_fn() if parts_fn is not None else ())
        if got == want:
            return True
        self.drop(key)
        if evict is not None:
            evict()
        _telemetry_incr("integrity_faults")
        raise IntegrityError(self.name, key)

    def drop(self, key) -> None:
        with _LOCK:
            self._entries.pop(key, None)


def _telemetry_incr(name: str) -> None:
    from repro_torch.core import telemetry  # telemetry imports crossbar
    telemetry.incr(name)


SCHEDULE_GUARD = CacheGuard("schedule")    # pinned + LRU tile schedules
PROGRAM_GUARD = CacheGuard("program")      # megakernel control tables
CONST_GUARD = CacheGuard("const")          # registry program const blocks
LIFT_GUARD = CacheGuard("lift")            # GF(2^k) -> GF(2) lifted plans

GUARDS = (SCHEDULE_GUARD, PROGRAM_GUARD, CONST_GUARD, LIFT_GUARD)


def reset() -> None:
    """Drop every seal (test isolation)."""
    with _LOCK:
        for g in GUARDS:
            g._entries.clear()
