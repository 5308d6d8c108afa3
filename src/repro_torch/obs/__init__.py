"""``repro_torch.obs`` — tracing, metrics, timeline export, drift monitoring.

Port of ``repro.obs`` (pure Python, no JAX or PyTorch at module level):

* :mod:`repro_torch.obs.tracing` — thread-safe spans with request-scoped
  trace IDs; **no-op when disabled** (the default; enable with
  ``REPRO_TORCH_OBS=1`` or :func:`enable`).
* :mod:`repro_torch.obs.metrics` — log-bucketed latency histograms fed
  from spans, plus gauges; JSON snapshot + Prometheus text export.
* :mod:`repro_torch.obs.timeline` — Chrome/Perfetto trace-event JSON
  dump of any traced window.
* :mod:`repro_torch.obs.drift` — streaming fixed-latency drift monitor.
* :mod:`repro_torch.obs.validate` — structural checks of both exports.

Every span, event, gauge, histogram and Prometheus metric name is the
reference's (``repro_span_seconds``, ``repro_<gauge>``,
``repro_<counter>_total``), so the two packages' exports compare line
for line.  The switch is ``REPRO_TORCH_OBS``, not the reference's
``REPRO_OBS``: the two packages keep separate state, and a process that
holds both can trace one without the other.

Import-graph note: this package sits *below* ``repro_torch.core`` —
the crossbar, integrity and registry modules import it — so nothing
here imports ``repro_torch.core`` at module level; the telemetry
counters in the exporters are read lazily.

Typical use::

    from repro_torch import obs

    obs.enable()
    with obs.span("apply_plan", op="sha3", backend="auto") as sp:
        out = apply_plan(plan, x)
        sp.set(backend=resolved)
    print(obs.prometheus_text())
    obs.export_chrome_trace("trace.json")
"""

from repro_torch.obs import metrics as _metrics  # registers the span sink
from repro_torch.obs import tracing as _tracing
from repro_torch.obs.drift import MONITOR as drift_monitor
from repro_torch.obs.drift import DriftMonitor
from repro_torch.obs.metrics import METRICS as metrics
from repro_torch.obs.metrics import Gauge, Histogram, MetricsRegistry
from repro_torch.obs.timeline import chrome_trace, export_chrome_trace
from repro_torch.obs.tracing import (
    Span,
    add_sink,
    current_trace_id,
    disable,
    disabled_call_count,
    dropped_count,
    enable,
    enabled,
    event,
    finished_spans,
    new_trace_id,
    set_buffer_capacity,
    span,
    span_at,
)
from repro_torch.obs.validate import validate_chrome_trace, validate_prometheus_text


def snapshot(**kw) -> dict:
    """JSON-able metrics snapshot (histograms + gauges + counters)."""
    return _metrics.METRICS.snapshot(**kw)


def prometheus_text(**kw) -> str:
    """Prometheus exposition-format dump of the metrics registry."""
    return _metrics.METRICS.prometheus_text(**kw)


def drift_report() -> dict:
    """Per-op fixed-latency drift status from the global monitor."""
    return drift_monitor.report()


def reset() -> None:
    """Clear spans, metrics, and drift baselines (test isolation;
    leaves the enabled flag and registered sinks alone)."""
    from repro_torch.obs import drift as _drift
    _tracing.clear()
    _metrics.reset()
    _drift.reset()


__all__ = [
    "Span",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DriftMonitor",
    "span",
    "span_at",
    "event",
    "enable",
    "disable",
    "enabled",
    "new_trace_id",
    "current_trace_id",
    "add_sink",
    "finished_spans",
    "dropped_count",
    "disabled_call_count",
    "set_buffer_capacity",
    "metrics",
    "snapshot",
    "prometheus_text",
    "chrome_trace",
    "export_chrome_trace",
    "drift_monitor",
    "drift_report",
    "validate_chrome_trace",
    "validate_prometheus_text",
    "reset",
]
