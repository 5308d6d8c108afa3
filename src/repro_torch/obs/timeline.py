"""Chrome/Perfetto trace-event export of the recorded span buffer
(port of ``repro.obs.timeline``).

Converts the ring buffer in ``repro_torch.obs.tracing`` into the Chrome
trace-event JSON format (the ``{"traceEvents": [...]}`` object form),
loadable in ``chrome://tracing`` and https://ui.perfetto.dev:

* each finished span becomes one complete event (``"ph": "X"``) with
  microsecond ``ts``/``dur`` relative to the trace epoch, ``pid`` =
  this process, ``tid`` = the recording thread, and the span's attrs +
  trace/span/parent ids under ``args``;
* span-internal marks (retries, breaker trips, fallbacks) become
  instant events (``"ph": "i"``, thread scope);
* thread names are emitted as ``"M"`` metadata events so the serving
  engine's admission / host-prep / device-feed lanes are labelled rows
  in the UI.

The export is a pure read of the buffer — it can be taken mid-run.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from repro_torch.obs import tracing


def _us(t: float) -> float:
    """perf_counter reading -> microseconds since the trace epoch."""
    return (t - tracing._EPOCH) * 1e6


def chrome_trace(spans=None) -> dict:
    """Build the trace-event object for ``spans`` (default: the full
    recorded buffer)."""
    if spans is None:
        spans = tracing.finished_spans()
    pid = os.getpid()
    events = []
    seen_threads = {}
    for sp in spans:
        tid = sp.thread_id
        if tid not in seen_threads:
            seen_threads[tid] = sp.thread_name
        args = {"trace_id": sp.trace_id, "span_id": sp.span_id}
        if sp.parent_id is not None:
            args["parent_id"] = sp.parent_id
        for k, v in sp.attrs.items():
            args[k] = v if isinstance(v, (int, float, str, bool,
                                          type(None))) else repr(v)
        events.append({
            "name": sp.name,
            "ph": "X",
            "ts": _us(sp.t0),
            "dur": max((sp.t1 - sp.t0) * 1e6, 0.0),
            "pid": pid,
            "tid": tid,
            "cat": "repro",
            "args": args,
        })
        for ename, et, eattrs in sp.events:
            events.append({
                "name": f"{sp.name}:{ename}",
                "ph": "i",
                "s": "t",  # thread-scoped instant
                "ts": _us(et),
                "pid": pid,
                "tid": tid,
                "cat": "repro",
                "args": dict(eattrs, span_id=sp.span_id,
                             trace_id=sp.trace_id),
            })
    for tid, tname in seen_threads.items():
        events.append({
            "name": "thread_name",
            "ph": "M",
            "pid": pid,
            "tid": tid,
            "args": {"name": tname},
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "repro_torch.obs",
            "dropped_spans": tracing.dropped_count(),
        },
    }


def export_chrome_trace(path: str, spans=None) -> dict:
    """Write the trace-event JSON to ``path``; returns the object."""
    obj = chrome_trace(spans)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj
