"""Structural validators for the two export formats (port of
``repro.obs.validate``).

Used by the tests and ``chip_smoke.py`` to assert that
what we emit actually parses as what we claim it is — without pulling
in a Prometheus client or Perfetto itself (neither is in the image).

* ``validate_prometheus_text``: line-grammar check of the exposition
  format (text v0.0.4): every non-comment line is
  ``name[{labels}] value``, every ``# TYPE`` names a valid type, every
  histogram family has monotone cumulative buckets ending in
  ``le="+Inf"`` whose count equals ``_count``.
* ``validate_chrome_trace``: trace-event JSON object-form check:
  ``traceEvents`` list where every event has ``name``/``ph``/``pid``,
  ``"X"`` events have numeric ``ts`` and ``dur >= 0``, phases are from
  the known set.

Both raise ``ValueError`` with a line/event index on the first
violation and return a small summary dict on success.
"""

from __future__ import annotations

import math
import re
from typing import Dict

_METRIC_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?'
    r'\s+(?P<value>[^\s]+)(?:\s+\d+)?$')
_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_TYPES = {"counter", "gauge", "histogram", "summary", "untyped"}
_PHASES = {"X", "B", "E", "i", "I", "M", "C", "b", "e", "n", "s", "t",
           "f", "P", "O", "N", "D"}


def _parse_value(raw: str, lineno: int) -> float:
    if raw == "+Inf":
        return math.inf
    if raw == "-Inf":
        return -math.inf
    if raw == "NaN":
        return math.nan
    try:
        return float(raw)
    except ValueError:
        raise ValueError(
            f"prometheus line {lineno}: unparseable value {raw!r}")


def validate_prometheus_text(text: str) -> dict:
    """Raise ValueError on the first malformed line; return a summary
    ({'samples': n, 'families': n, 'histograms': n}) on success."""
    samples = 0
    typed: Dict[str, str] = {}
    # histogram family -> {labels-sans-le: [(le, cum)]}, and _count.
    buckets: Dict[str, Dict[str, list]] = {}
    counts: Dict[str, Dict[str, float]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 2 and parts[1] == "TYPE":
                if len(parts) < 4 or parts[3] not in _TYPES:
                    raise ValueError(
                        f"prometheus line {lineno}: bad TYPE line "
                        f"{line!r}")
                typed[parts[2]] = parts[3]
            continue
        m = _METRIC_RE.match(line)
        if m is None:
            raise ValueError(
                f"prometheus line {lineno}: malformed sample {line!r}")
        value = _parse_value(m.group("value"), lineno)
        samples += 1
        labels = dict(_LABEL_RE.findall(m.group("labels") or ""))
        name = m.group("name")
        if name.endswith("_bucket") and "le" in labels:
            fam = name[: -len("_bucket")]
            le = labels.pop("le")
            key = repr(sorted(labels.items()))
            buckets.setdefault(fam, {}).setdefault(key, []).append(
                (math.inf if le == "+Inf" else float(le), value, lineno))
        elif name.endswith("_count"):
            fam = name[: -len("_count")]
            key = repr(sorted(labels.items()))
            counts.setdefault(fam, {})[key] = value
    n_hist = 0
    for fam, series in buckets.items():
        for key, rows in series.items():
            n_hist += 1
            prev = -math.inf
            for le, cum, lineno in rows:
                if le <= prev:
                    raise ValueError(
                        f"prometheus line {lineno}: histogram {fam} "
                        f"buckets not ordered by le")
                prev = le
            les = [r[0] for r in rows]
            if not math.isinf(les[-1]):
                raise ValueError(
                    f"prometheus: histogram {fam}{key} missing "
                    f'le="+Inf" bucket')
            cums = [r[1] for r in rows]
            for earlier, later in zip(cums, cums[1:]):
                if later < earlier:
                    raise ValueError(
                        f"prometheus: histogram {fam}{key} cumulative "
                        f"bucket counts decrease")
            want = counts.get(fam, {}).get(key)
            if want is not None and cums[-1] != want:
                raise ValueError(
                    f"prometheus: histogram {fam}{key} +Inf bucket "
                    f"({cums[-1]}) != _count ({want})")
    return {"samples": samples, "families": len(typed),
            "histograms": n_hist}


def validate_chrome_trace(obj) -> dict:
    """Raise ValueError on the first malformed event; return a summary
    ({'events': n, 'complete': n, 'threads': n}) on success."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError(
            "chrome trace: expected object form with 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("chrome trace: traceEvents is not a list")
    n_complete = 0
    threads = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"chrome trace event {i}: not an object")
        for field in ("name", "ph", "pid"):
            if field not in ev:
                raise ValueError(
                    f"chrome trace event {i}: missing {field!r}")
        ph = ev["ph"]
        if ph not in _PHASES:
            raise ValueError(
                f"chrome trace event {i}: unknown phase {ph!r}")
        if "tid" in ev:
            threads.add(ev["tid"])
        if ph == "X":
            n_complete += 1
            ts, dur = ev.get("ts"), ev.get("dur")
            if not isinstance(ts, (int, float)):
                raise ValueError(
                    f"chrome trace event {i}: 'X' without numeric ts")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"chrome trace event {i}: 'X' with bad dur {dur!r}")
        elif ph != "M" and not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(
                f"chrome trace event {i}: missing numeric ts")
    return {"events": len(events), "complete": n_complete,
            "threads": len(threads)}
