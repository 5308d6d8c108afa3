"""Fixed-latency drift monitor: the paper's contract as a watched SLO
(port of ``repro.obs.drift``).

``core.static_registry`` enforces the fixed-latency contract
*structurally*: a registered op must always execute the same pass
count and schedule fingerprints, or ``FixedLatencyError`` fires and
the op is quarantined.  That is a tripwire — binary, after the fact.
This module adds the *streaming* view: per registered op it keeps

* the frozen structural signature (pass count, schedule fingerprint)
  from the first observation, and counts every structural mismatch it
  sees (even the ones the registry is about to raise on);
* a frozen **timing baseline** — the median launch wall over the first
  ``baseline_n`` observations — and a sliding recent window, surfacing
  a warning-level drift signal when the recent median exceeds the
  baseline by ``ratio_threshold``× (above an absolute noise floor,
  since µs-scale CPU jitter is not drift).

A drifting op still *passes* the structural check — same passes, same
schedule, just slower (cache pressure, a degraded device, thermal
throttling).  The monitor turns that into a signal an operator sees
*before* anything trips quarantine: a one-shot ``warnings.warn`` per
op, a ``drift_warnings`` telemetry counter, and a ``report()`` dict.
"""

from __future__ import annotations

import statistics
import threading
import warnings
from typing import Dict, Optional

# Defaults chosen for host-side CPU timing: a 1.75x sustained median
# shift is far outside scheduler jitter once the absolute floor
# (100 µs) filters out the sub-bucket noise of trivially fast ops.
BASELINE_N = 8
RECENT_N = 8
RATIO_THRESHOLD = 1.75
MIN_DELTA_S = 100e-6


class _OpState:
    __slots__ = ("signature", "structural_mismatches", "baseline",
                 "baseline_median", "recent", "n_obs", "warned")

    def __init__(self):
        self.signature = None          # frozen (passes, fingerprint)
        self.structural_mismatches = 0
        self.baseline: "list[float]" = []
        self.baseline_median: Optional[float] = None
        self.recent: "list[float]" = []
        self.n_obs = 0
        self.warned = False


class DriftMonitor:
    """Streaming per-op latency-drift detector (thread-safe)."""

    def __init__(self, *, baseline_n: int = BASELINE_N,
                 recent_n: int = RECENT_N,
                 ratio_threshold: float = RATIO_THRESHOLD,
                 min_delta_s: float = MIN_DELTA_S):
        self._lock = threading.Lock()
        self._ops: Dict[str, _OpState] = {}
        self.baseline_n = baseline_n
        self.recent_n = recent_n
        self.ratio_threshold = ratio_threshold
        self.min_delta_s = min_delta_s

    def observe(self, op: str, *, passes: int, fingerprint,
                wall_s: float) -> Optional[dict]:
        """Feed one observation; returns a drift record when this
        observation first pushes the op over the threshold, else None.

        Called from ``StaticPlanRegistry.observe`` *before* the
        structural signature comparison, so drift is visible even for
        the observation that is about to raise ``FixedLatencyError``.
        """
        sig = (passes, fingerprint)
        drift = None
        with self._lock:
            st = self._ops.get(op)
            if st is None:
                st = self._ops[op] = _OpState()
            st.n_obs += 1
            if st.signature is None:
                st.signature = sig
            elif sig != st.signature:
                st.structural_mismatches += 1
            if st.baseline_median is None:
                st.baseline.append(wall_s)
                if len(st.baseline) >= self.baseline_n:
                    st.baseline_median = statistics.median(st.baseline)
            else:
                st.recent.append(wall_s)
                if len(st.recent) > self.recent_n:
                    st.recent.pop(0)
                if len(st.recent) == self.recent_n and not st.warned:
                    recent_med = statistics.median(st.recent)
                    base = st.baseline_median
                    if (recent_med > base * self.ratio_threshold
                            and recent_med - base > self.min_delta_s):
                        st.warned = True
                        drift = {
                            "op": op,
                            "baseline_median_s": base,
                            "recent_median_s": recent_med,
                            "ratio": recent_med / base if base > 0
                            else float("inf"),
                            "n_obs": st.n_obs,
                        }
        if drift is not None:
            self._emit(drift)
        return drift

    def _emit(self, drift: dict) -> None:
        try:
            from repro_torch.core import telemetry  # lazy: import-cycle safe
            telemetry.incr("drift_warnings")
        except Exception:  # noqa: BLE001
            pass
        warnings.warn(
            f"fixed-latency drift on op '{drift['op']}': recent median "
            f"{drift['recent_median_s'] * 1e3:.3f} ms is "
            f"{drift['ratio']:.2f}x the frozen baseline "
            f"{drift['baseline_median_s'] * 1e3:.3f} ms "
            f"(structural contract still intact — investigate before "
            f"quarantine trips)",
            RuntimeWarning,
            stacklevel=3,
        )

    def report(self) -> dict:
        """Per-op drift status, JSON-able."""
        with self._lock:
            out = {}
            for op, st in sorted(self._ops.items()):
                recent_med = (statistics.median(st.recent)
                              if st.recent else None)
                base = st.baseline_median
                out[op] = {
                    "n_obs": st.n_obs,
                    "passes": st.signature[0] if st.signature else None,
                    "structural_mismatches": st.structural_mismatches,
                    "baseline_median_s": base,
                    "recent_median_s": recent_med,
                    "ratio": (recent_med / base
                              if base and recent_med is not None
                              else None),
                    "drifting": st.warned,
                }
            return out

    def clear(self) -> None:
        with self._lock:
            self._ops.clear()


# Process-wide monitor fed by the static registry's observe path.
MONITOR = DriftMonitor()


def reset() -> None:
    """Forget all baselines and warnings (test isolation)."""
    MONITOR.clear()
