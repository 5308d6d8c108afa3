"""Metrics registry: log-bucketed histograms + gauges, two exports
(port of ``repro.obs.metrics``).

The span layer (``repro_torch.obs.tracing``) records *individual* timed
regions; this module keeps the *aggregates* an operator would alert
on — latency distributions per span name (p50/p90/p99/max from
log-bucketed histograms) and point-in-time gauges (queue depth, open
breakers, survivor-mesh size, cache sizes).  Two export formats:

* ``snapshot()`` — one JSON-able dict: every histogram's buckets +
  quantiles, every gauge, and the full ``core.telemetry`` counter
  snapshot (the engine's pass/launch/cache/serving counters become
  exported metrics for free).
* ``prometheus_text()`` — Prometheus exposition format (text v0.0.4):
  ``repro_span_seconds`` histograms labelled by span name with
  cumulative ``le`` buckets, ``repro_<gauge>`` gauges, and
  ``repro_<counter>_total`` counters.  Scrapable as-is; also validated
  structurally by ``repro_torch.obs.validate``.

Histograms are log-bucketed (powers of 2 from 1 µs), so the memory per
histogram is a fixed ~30 ints regardless of sample count and quantile
error is bounded by the bucket ratio (×2 worst case — the right trade
for latency SLOs, where orders of magnitude matter and the exact max is
tracked separately).

Gauges come in two kinds: value gauges (``gauge(name).set(x)``) and
*lazy* gauges (``gauge_fn(name, fn)``) whose callable is evaluated only
at export time — zero hot-path cost, which is how the serving engine
exposes queue depth and breaker state without touching the admission
path.

Everything is thread-safe; ``repro_torch`` imports stay lazy (telemetry is
imported inside the exporters) so this module can sit below
``core.crossbar`` in the import graph.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, Optional

# Bucket upper bounds in seconds: 1 µs .. ~67 s, powers of two, then
# +Inf.  27 buckets cover every engine latency from a disabled-span
# call to a 10^6-request drain.
BUCKET_BOUNDS = tuple(1e-6 * (2.0 ** i) for i in range(27))


class Histogram:
    """Fixed-bucket log histogram with exact count/sum/min/max."""

    __slots__ = ("_lock", "counts", "n", "total", "vmin", "vmax")

    def __init__(self):
        self._lock = threading.Lock()
        self.counts = [0] * (len(BUCKET_BOUNDS) + 1)  # +1: overflow
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = 0.0

    def observe(self, value: float) -> None:
        if value < 0:
            value = 0.0
        # log2 bucket index without a scan: value = 1e-6 * 2**i.
        if value <= BUCKET_BOUNDS[0]:
            i = 0
        else:
            i = min(int(math.log2(value / 1e-6)) + 1, len(BUCKET_BOUNDS))
            # Guard the float edge: log2 can land one bucket high/low.
            while i > 0 and value <= BUCKET_BOUNDS[i - 1]:
                i -= 1
            while i < len(BUCKET_BOUNDS) and value > BUCKET_BOUNDS[i]:
                i += 1
        with self._lock:
            self.counts[i] += 1
            self.n += 1
            self.total += value
            if value < self.vmin:
                self.vmin = value
            if value > self.vmax:
                self.vmax = value

    def quantile(self, q: float) -> float:
        """Upper bucket bound at quantile ``q`` (0..1); exact max for
        the tail bucket."""
        with self._lock:
            n = self.n
            if n == 0:
                return 0.0
            target = q * n
            acc = 0
            for i, c in enumerate(self.counts):
                acc += c
                if acc >= target and c > 0:
                    if i >= len(BUCKET_BOUNDS):
                        return self.vmax
                    return min(BUCKET_BOUNDS[i], self.vmax)
            return self.vmax

    def stats(self) -> dict:
        with self._lock:
            n, total = self.n, self.total
            vmin, vmax = self.vmin, self.vmax
        return {
            "count": n,
            "sum_s": total,
            "mean_s": (total / n) if n else 0.0,
            "min_s": 0.0 if n == 0 else vmin,
            "max_s": vmax,
            "p50_s": self.quantile(0.50),
            "p90_s": self.quantile(0.90),
            "p99_s": self.quantile(0.99),
        }

    def cumulative_buckets(self) -> list:
        """[(le_bound, cumulative_count)] + (+Inf, n) — Prometheus
        histogram convention."""
        return self.exposition()[0]

    def exposition(self) -> tuple:
        """(cumulative buckets, count, sum), read under one lock: an
        export stays consistent (+Inf bucket == count) while other
        threads keep observing."""
        with self._lock:
            out, acc = [], 0
            for bound, c in zip(BUCKET_BOUNDS, self.counts):
                acc += c
                out.append((bound, acc))
            out.append((math.inf, self.n))
            return out, self.n, self.total


class Gauge:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def add(self, delta: float) -> None:
        with self._lock:
            self.value += float(delta)

    def get(self) -> float:
        with self._lock:
            return self.value


class MetricsRegistry:
    """Named histograms + gauges with JSON and Prometheus export."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: Dict[str, Histogram] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._gauge_fns: Dict[str, Callable[[], float]] = {}

    # -- access -------------------------------------------------------------

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            return h

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def gauge_fn(self, name: str, fn: Callable[[], float]) -> None:
        """Register a lazy gauge evaluated only at export time (zero
        hot-path cost; re-registering replaces the callable)."""
        with self._lock:
            self._gauge_fns[name] = fn

    def gauge_ratio(self, name: str, num_fn: Callable[[], float],
                    den_fn: Callable[[], float]) -> None:
        """Register a lazy ratio gauge: ``num_fn() / den_fn()`` at
        export time, 0.0 when the denominator is zero.  The standard
        shape for sampled-fraction observables (e.g. integrity verify
        rate = digest checks / cache hits, journal occupancy = depth /
        capacity) — the division lives here so every caller reports
        the empty case the same way."""

        def ratio() -> float:
            den = den_fn()
            return (num_fn() / den) if den else 0.0

        self.gauge_fn(name, ratio)

    def unregister_gauge_fn(self, name: str) -> None:
        with self._lock:
            self._gauge_fns.pop(name, None)

    def clear(self) -> None:
        """Drop recorded data (histograms, value gauges).  Lazy gauge
        *registrations* survive: they are wiring installed at import or
        engine construction, not data — a test-isolation reset must not
        silently disconnect the cache/queue gauges."""
        with self._lock:
            self._hists.clear()
            self._gauges.clear()

    # -- export -------------------------------------------------------------

    def _gauge_values(self) -> dict:
        with self._lock:
            vals = {name: g.get() for name, g in self._gauges.items()}
            fns = dict(self._gauge_fns)
        for name, fn in fns.items():
            try:
                vals[name] = float(fn())
            except Exception:  # noqa: BLE001 — a dead lazy gauge
                vals[name] = math.nan  # must not break the export
        return vals

    def snapshot(self, *, include_telemetry: bool = True) -> dict:
        """One JSON-able dict of everything the registry knows."""
        with self._lock:
            hists = dict(self._hists)
        out = {
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "histograms": {name: h.stats() for name, h in hists.items()},
            "gauges": self._gauge_values(),
        }
        if include_telemetry:
            from repro_torch.core import telemetry  # lazy: avoids import cycle
            out["counters"] = telemetry.snapshot()
        return out

    def prometheus_text(self, *, include_telemetry: bool = True) -> str:
        """Prometheus exposition format (text v0.0.4).

        Histograms export as ONE metric family ``repro_span_seconds``
        labelled by span name (cumulative buckets, _sum, _count);
        gauges as ``repro_<name>``; telemetry counters as
        ``repro_<name>_total``.
        """
        lines = []
        with self._lock:
            hists = sorted(self._hists.items())
        if hists:
            lines.append("# HELP repro_span_seconds Latency of engine "
                         "spans by name.")
            lines.append("# TYPE repro_span_seconds histogram")
            for name, h in hists:
                label = _label_value(name)
                buckets, count, total = h.exposition()
                for bound, acc in buckets:
                    le = "+Inf" if math.isinf(bound) else _fmt_float(bound)
                    lines.append(
                        f'repro_span_seconds_bucket{{span="{label}",'
                        f'le="{le}"}} {acc}')
                lines.append(f'repro_span_seconds_sum{{span="{label}"}} '
                             f'{_fmt_float(total)}')
                lines.append(f'repro_span_seconds_count{{span="{label}"}} '
                             f'{count}')
        for name, val in sorted(self._gauge_values().items()):
            metric = f"repro_{_sanitize(name)}"
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {_fmt_float(val)}")
        if include_telemetry:
            from repro_torch.core import telemetry  # lazy
            for name, val in sorted(telemetry.snapshot().items()):
                metric = f"repro_{_sanitize(name)}_total"
                lines.append(f"# TYPE {metric} counter")
                lines.append(f"{metric} {val}")
        return "\n".join(lines) + "\n"


def _sanitize(name: str) -> str:
    """Metric-name charset: [a-zA-Z0-9_:], must not start with a digit."""
    out = "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)
    if out and out[0].isdigit():
        out = "_" + out
    return out or "_"


def _label_value(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_float(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


# The process-wide registry plus the span sink that feeds it: every
# recorded span's duration lands in the histogram named after the span.
METRICS = MetricsRegistry()


def _span_sink(sp) -> None:
    METRICS.histogram(sp.name).observe(sp.duration_s)


from repro_torch.obs import tracing as _tracing  # noqa: E402 (sink wiring)

_tracing.add_sink(_span_sink)


def reset() -> None:
    """Drop every metric (test isolation)."""
    METRICS.clear()
