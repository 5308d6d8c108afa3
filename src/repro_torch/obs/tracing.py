"""Thread-safe spans for the permutation engine (port of
``repro.obs.tracing``).

``core.telemetry`` counts *how many* passes and launches happened; this
module records *when* and *how long*.  A span is one timed host-side
unit of work — a crossbar pass, a megakernel launch, a registry
observation — with a name, attributes, a thread, and a trace ID that
groups every span of one logical request across threads.

* **No-op when disabled.**  Off by default (enable with
  ``REPRO_TORCH_OBS=1`` or ``obs.enable()``); a disabled ``span()``
  returns ``_NullSpan``, a two-slot timer that touches no locks, ids or
  shared state.
* **Host values only.**  Attributes are Python values the caller already
  holds (shapes, names, counts).  No attribute may be computed from a
  CUDA tensor's contents (``.item()``, ``int()``, ``bool()``): that
  would add a host synchronisation to every traced call.  A span's
  duration is host time; on the card it brackets the enqueue unless the
  caller synchronises inside it.
* **Thread-safe when enabled.**  Finished spans land in a bounded ring
  buffer under one lock; span and trace ids come from one counter.
* **Stdlib only**: metrics feed through a registered sink
  (``repro_torch.obs.metrics`` installs itself on import).
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import Callable, Optional

# The trace epoch: every span timestamp is perf_counter() relative to
# this, so exported timelines start near zero and remain monotonic
# across threads (perf_counter is a global clock on CPython >= 3.3).
_EPOCH = time.perf_counter()

_IDS = itertools.count(1)  # span + trace ids (atomic under the GIL)

# Ring buffer of finished _Span objects.  Bounded: a 10^6-request mesh
# run must not hold 10^6 span dicts alive — the default keeps the most
# recent window, and exporters say how much was dropped.
DEFAULT_BUFFER_CAP = 200_000

_LOCK = threading.Lock()
_SPANS: "collections.deque" = collections.deque(maxlen=DEFAULT_BUFFER_CAP)
_DROPPED = 0          # spans evicted from the ring since last clear()
_DISABLED_CALLS = 0   # span() calls taken on the disabled fast path

# Sinks: callables fired on every finished recorded span (the metrics
# module registers its histogram feed here; tests can register probes).
_SINKS: "list[Callable]" = []

# Per-thread span stack: parent ids + trace-id inheritance.
_TLS = threading.local()


def _truthy_env(name: str, default: str = "0") -> bool:
    return os.environ.get(name, default).strip().lower() not in (
        "", "0", "false", "no", "off")


_ENABLED = _truthy_env("REPRO_TORCH_OBS")


def enabled() -> bool:
    """Is span recording on?  (Module-global; default off.)"""
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def new_trace_id() -> int:
    """A fresh trace ID (request-scoped grouping key for spans)."""
    return next(_IDS)


def current_trace_id() -> Optional[int]:
    """The trace ID of the innermost open span on this thread, if any."""
    stack = getattr(_TLS, "stack", None)
    if stack:
        return stack[-1].trace_id
    return getattr(_TLS, "trace_id", None)


class _NullSpan:
    """The disabled fast path: a timer and nothing else.

    Still context-managed and still measures its own wall time (the
    tuning-table feed reads ``duration_s`` regardless of recording),
    but records nothing, allocates no ids, and takes no locks.
    """

    __slots__ = ("t0", "t1")
    recording = False
    trace_id = None
    span_id = None

    def __enter__(self) -> "_NullSpan":
        global _DISABLED_CALLS
        _DISABLED_CALLS += 1
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def set(self, **attrs) -> "_NullSpan":
        return self

    def event(self, name: str, **attrs) -> None:
        pass


class Span:
    """One recorded timed region.

    ``trace_id`` groups spans across threads: pass it explicitly to
    adopt a request's trace (the serving engine stamps each request at
    admission and hands the id to the prep and device-feed threads), or
    leave it None to inherit from the enclosing span on this thread
    (falling back to a fresh id for a root span).
    """

    __slots__ = ("name", "attrs", "trace_id", "span_id", "parent_id",
                 "thread_id", "thread_name", "t0", "t1", "events")

    recording = True

    def __init__(self, name: str, attrs: dict,
                 trace_id: Optional[int] = None):
        self.name = name
        self.attrs = attrs
        self.trace_id = trace_id
        self.span_id = next(_IDS)
        self.parent_id: Optional[int] = None
        t = threading.current_thread()
        self.thread_id = t.ident or 0
        self.thread_name = t.name
        self.t0 = 0.0
        self.t1 = 0.0
        self.events: "list[tuple]" = []

    def __enter__(self) -> "Span":
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        if stack:
            self.parent_id = stack[-1].span_id
            if self.trace_id is None:
                self.trace_id = stack[-1].trace_id
        if self.trace_id is None:
            self.trace_id = getattr(_TLS, "trace_id", None) or next(_IDS)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.t1 = time.perf_counter()
        stack = getattr(_TLS, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        elif stack and self in stack:   # mis-nested exit: still unwind
            stack.remove(self)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        _record(self)

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def set(self, **attrs) -> "Span":
        """Attach attributes discovered mid-span (resolved backend,
        batch size after padding, ...)."""
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs) -> None:
        """A zero-duration mark inside this span (retry, fallback,
        breaker trip) — exported as an instant event on the timeline."""
        self.events.append((name, time.perf_counter(), attrs))


def span(name: str, *, trace_id: Optional[int] = None, **attrs):
    """Open a span.  The ONE instrumentation entry point.

    Usage::

        with obs.span("apply_plan", backend="einsum") as sp:
            ...
            sp.set(n_out=plan.n_out)

    Disabled (the default): returns a ``_NullSpan`` — a bare timer, no
    recording, no locks.  Enabled: returns a ``Span`` that lands in the
    ring buffer on exit and feeds every registered sink.
    """
    if not _ENABLED:
        return _NullSpan()
    return Span(name, attrs, trace_id)


def span_at(name: str, t0: float, t1: float, *,
            trace_id: Optional[int] = None, thread_name: Optional[str] = None,
            **attrs) -> None:
    """Record a span retroactively from two ``perf_counter`` readings.

    For phases whose boundaries are only known after the fact — a
    serving request's queue wait is (submit time, batch-take time),
    measured on two different threads.  No-op when disabled.
    """
    if not _ENABLED:
        return
    sp = Span(name, attrs, trace_id)
    if sp.trace_id is None:
        sp.trace_id = next(_IDS)
    sp.t0, sp.t1 = t0, t1
    if thread_name is not None:
        sp.thread_name = thread_name
    _record(sp)


def event(name: str, *, trace_id: Optional[int] = None, **attrs) -> None:
    """A free-standing instant event (zero-duration span)."""
    if not _ENABLED:
        return
    t = time.perf_counter()
    span_at(name, t, t, trace_id=trace_id, **attrs)


def _record(sp: Span) -> None:
    global _DROPPED
    with _LOCK:
        if len(_SPANS) == _SPANS.maxlen:
            _DROPPED += 1
        _SPANS.append(sp)
        sinks = tuple(_SINKS)
    for sink in sinks:
        try:
            sink(sp)
        except Exception:  # noqa: BLE001 — a broken sink must not
            pass           # take down the instrumented hot path


def add_sink(fn: Callable) -> None:
    """Register a callable fired with every finished recorded span."""
    with _LOCK:
        if fn not in _SINKS:
            _SINKS.append(fn)


def finished_spans() -> list:
    """A consistent copy of the ring buffer (oldest first)."""
    with _LOCK:
        return list(_SPANS)


def dropped_count() -> int:
    with _LOCK:
        return _DROPPED


def disabled_call_count() -> int:
    """How many ``span()`` calls took the disabled fast path — the
    numerator of the instrumentation-overhead bound checked in CI."""
    return _DISABLED_CALLS


def clear() -> None:
    """Drop recorded spans and reset drop/disabled counters (test
    isolation; sinks and the enabled flag are preserved)."""
    global _DROPPED, _DISABLED_CALLS
    with _LOCK:
        _SPANS.clear()
        _DROPPED = 0
    _DISABLED_CALLS = 0


def set_buffer_capacity(cap: int) -> None:
    """Resize the ring buffer (keeps the newest spans)."""
    global _SPANS
    if cap < 1:
        raise ValueError(f"span buffer capacity must be >= 1, got {cap}")
    with _LOCK:
        _SPANS = collections.deque(_SPANS, maxlen=cap)
