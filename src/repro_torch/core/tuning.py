"""Measured backend tuning table: persist what ``backend="auto"`` learned.

Port of ``repro.core.tuning`` (host-only Python, no tensor in it).  The
auto heuristic in ``crossbar._choose_backend`` is a *prior*; this table
is the *posterior*: every timed execution records (op, geometry, mesh)
-> backend -> EWMA seconds, the table ranks backends by measured wall
time, and ``crossbar.set_tuning_table`` makes ``backend="auto"``
consult the measurements before the heuristic.  The serving engine
records its bucket executions automatically and ranks a bucket's chain
by them once every rung has a measurement (a table loaded from a
profiling run has them), and the table serialises to JSON so the next
process starts warm.

Keys are canonical strings (``op|geometry|mesh``), values per-backend
EWMA seconds; serialisation sorts everything, so ``from_json(to_json())``
is byte-stable and byte-identical to the reference's text for the same
records.  The mesh part takes a ``dist.mesh.Mesh``, a dict of axis
sizes, their items, or ``None``.
"""

from __future__ import annotations

import json
import threading
from typing import Optional, Sequence


def _canon_geometry(geometry) -> str:
    """Geometry tuples/ints/strings -> one canonical token."""
    if isinstance(geometry, (tuple, list)):
        return "x".join(_canon_geometry(g) for g in geometry)
    return str(geometry)


def _canon_mesh(mesh_shape) -> str:
    """Mesh shape (dict, Mesh, items, or None) -> one canonical token."""
    if mesh_shape is None:
        return "-"
    if hasattr(mesh_shape, "axis_names"):  # a dist.mesh.Mesh
        mesh_shape = dict(mesh_shape.shape)
    if isinstance(mesh_shape, dict):
        items = sorted(mesh_shape.items())
    else:
        items = sorted(tuple(mesh_shape))
    return ",".join(f"{a}:{s}" for a, s in items)


def make_key(op: str, geometry, mesh_shape=None) -> str:
    return f"{op}|{_canon_geometry(geometry)}|{_canon_mesh(mesh_shape)}"


class TuningTable:
    """Thread-safe EWMA wall-time table keyed by (op, geometry, mesh)."""

    def __init__(self, *, alpha: float = 0.3):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"TuningTable: alpha={alpha} must be in (0, 1]")
        self.alpha = alpha
        self._lock = threading.Lock()
        self._entries: dict[str, dict[str, dict]] = {}

    # -- recording ----------------------------------------------------------

    def record(self, op: str, geometry, backend: str, seconds: float, *,
               mesh_shape=None) -> None:
        """Fold one measured execution into the EWMA for its key."""
        if seconds < 0:
            raise ValueError(f"TuningTable.record: negative wall time "
                             f"{seconds}")
        key = make_key(op, geometry, mesh_shape)
        with self._lock:
            per_backend = self._entries.setdefault(key, {})
            ent = per_backend.get(backend)
            if ent is None:
                per_backend[backend] = {"ewma_s": float(seconds), "n": 1}
            else:
                a = self.alpha
                ent["ewma_s"] = a * float(seconds) + (1 - a) * ent["ewma_s"]
                ent["n"] += 1

    def record_span(self, sp, op: str, geometry, backend: str, *,
                    mesh_shape=None) -> None:
        """Fold a finished ``repro_torch.obs`` span's duration into the
        EWMA: the span is the stopwatch (a disabled span still times
        itself), so tracing, metrics and tuning read one clock."""
        self.record(op, geometry, backend, max(sp.duration_s, 0.0),
                    mesh_shape=mesh_shape)

    # -- queries ------------------------------------------------------------

    def best(self, op: str, geometry, *, mesh_shape=None,
             min_samples: int = 1) -> Optional[str]:
        """Fastest measured backend for the key, or None if unmeasured."""
        key = make_key(op, geometry, mesh_shape)
        with self._lock:
            per_backend = self._entries.get(key)
            if not per_backend:
                return None
            cands = [(e["ewma_s"], b) for b, e in per_backend.items()
                     if e["n"] >= min_samples]
        if not cands:
            return None
        return min(cands)[1]

    def rank_chain(self, op: str, geometry, chain: Sequence[str], *,
                   mesh_shape=None) -> tuple:
        """Reorder a fallback chain measured-fastest-first: measured
        backends lead (ascending EWMA), unmeasured ones keep their
        relative order after them, so the chain stays complete."""
        key = make_key(op, geometry, mesh_shape)
        with self._lock:
            per_backend = dict(self._entries.get(key) or {})
        measured = [b for b in chain if b in per_backend]
        measured.sort(key=lambda b: per_backend[b]["ewma_s"])
        unmeasured = [b for b in chain if b not in per_backend]
        return tuple(measured + unmeasured)

    def lookup(self, op: str, geometry, *, mesh_shape=None) -> dict:
        """Raw per-backend stats for a key (copy), {} if absent."""
        key = make_key(op, geometry, mesh_shape)
        with self._lock:
            return {b: dict(e)
                    for b, e in (self._entries.get(key) or {}).items()}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- serialisation ------------------------------------------------------

    def to_json(self) -> str:
        """Deterministic JSON: sorted keys at every level, exact floats,
        so ``from_json(t.to_json()).to_json() == t.to_json()``."""
        with self._lock:
            payload = {
                "version": 1,
                "alpha": self.alpha,
                "entries": {
                    k: {b: {"ewma_s": e["ewma_s"], "n": e["n"]}
                        for b, e in sorted(v.items())}
                    for k, v in sorted(self._entries.items())
                },
            }
        return json.dumps(payload, sort_keys=True, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "TuningTable":
        payload = json.loads(text)
        if payload.get("version") != 1:
            raise ValueError(
                f"TuningTable.from_json: unknown version "
                f"{payload.get('version')!r}")
        t = cls(alpha=payload.get("alpha", 0.3))
        for key, per_backend in payload.get("entries", {}).items():
            t._entries[key] = {
                b: {"ewma_s": float(e["ewma_s"]), "n": int(e["n"])}
                for b, e in per_backend.items()}
        return t

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        with open(path) as f:
            return cls.from_json(f.read())
