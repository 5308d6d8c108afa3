"""Traced serving walkthrough: spans, metrics, timeline, drift.

Port of ``examples/observe_serving.py`` on ``repro_torch``; runs on the
CUDA card by default (each bucket's absorbs are one plan-program
megakernel launch), ``--device cpu`` elsewhere (the einsum-first chain).
Enables ``repro_torch.obs``, serves a burst of SHA3-256 requests through
the continuous-batching engine, then exports everything an operator
would look at:

* ``observe_trace.json``   — Chrome/Perfetto timeline (open it at
  https://ui.perfetto.dev or chrome://tracing) showing each request's
  lifecycle — queue wait, bucket pack, device absorb — stitched across
  the engine's threads by request-scoped trace ids;
* ``observe_metrics.json`` — the JSON metrics snapshot: per-span latency
  histograms (p50/p90/p99/max), live gauges (queue depth, breaker
  state, cache sizes), and every engine telemetry counter;
* Prometheus exposition text + the fixed-latency drift report, printed.

Both exports are validated structurally before being written.  They go
next to this script unless ``main(out_dir=...)`` names another
directory.

Run:  PYTHONPATH=src python examples_torch/observe_serving.py [--device cpu]
"""

import argparse
import hashlib
import json
import os

from repro_torch import obs
from repro_torch._device import resolve
from repro_torch.serve.batching import BatchingEngine, BatchingOptions

OUT_DIR = os.path.dirname(os.path.abspath(__file__))
PAYLOADS = [bytes([i % 256]) * (7 + 23 * i % 400) for i in range(48)]


def main(argv=None, *, device=None, log_fn=print, out_dir=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve(device if device is not None else args.device)
    out_dir = out_dir or OUT_DIR

    # equivalent to running with REPRO_TORCH_OBS=1, in a window of its own
    was_enabled = obs.enabled()
    obs.enable()
    obs.reset()
    try:
        return _walkthrough(dev, out_dir, log_fn)
    finally:
        if not was_enabled:
            obs.disable()


def _walkthrough(dev, out_dir, log_fn):
    # -- serve a burst of variable-length payloads --------------------------
    payloads = PAYLOADS
    engine = BatchingEngine(BatchingOptions(max_batch=8), device=dev,
                            start=False)
    requests = [engine.submit(p) for p in payloads]
    while engine.run_once():
        pass
    digests = [r.result(timeout=120) for r in requests]
    assert all(d == hashlib.sha3_256(p).digest()
               for p, d in zip(payloads, digests)), "digest mismatch"
    log_fn(f"served {len(payloads)} requests bit-exactly "
           f"({len(obs.finished_spans())} spans recorded)")

    # -- per-request timeline -----------------------------------------------
    sample = requests[0]
    stages = [(s.name, s.duration_s * 1e3) for s in obs.finished_spans()
              if s.trace_id == sample.trace_id]
    log_fn(f"\nrequest trace_id={sample.trace_id} lifecycle:")
    for name, ms in stages:
        log_fn(f"  {name:<16} {ms:8.3f} ms")

    # -- exports (validated, then written) ----------------------------------
    trace_path = os.path.join(out_dir, "observe_trace.json")
    trace_obj = obs.export_chrome_trace(trace_path)
    summary = obs.validate_chrome_trace(trace_obj)
    log_fn(f"\nwrote {trace_path}: {summary['events']} events across "
           f"{summary['threads']} threads (valid trace-event JSON)")

    snap = obs.snapshot()
    metrics_path = os.path.join(out_dir, "observe_metrics.json")
    with open(metrics_path, "w") as f:
        json.dump(snap, f, indent=2, default=repr)
        f.write("\n")
    log_fn(f"wrote {metrics_path}: {len(snap['histograms'])} histograms, "
           f"{len(snap['gauges'])} gauges, {len(snap['counters'])} counters")

    prom = obs.prometheus_text()
    obs.validate_prometheus_text(prom)
    log_fn("\nPrometheus exposition (histogram families + gauges):")
    for line in prom.splitlines():
        if "_count{" in line or line.startswith("# TYPE repro_serve"):
            log_fn(f"  {line}")

    log_fn("\nper-span latency quantiles:")
    for name, st in sorted(snap["histograms"].items()):
        log_fn(f"  {name:<18} n={st['count']:<4} "
               f"p50={st['p50_s']*1e3:8.3f} ms  "
               f"p99={st['p99_s']*1e3:8.3f} ms  max={st['max_s']*1e3:8.3f} ms")

    # -- fixed-latency drift ------------------------------------------------
    # The drift monitor watched every observed fixed-latency region above;
    # a stable engine reports drifting=False everywhere, with frozen
    # structural signatures (pass counts) per op.
    log_fn("\nfixed-latency drift report:")
    report = obs.drift_report()
    for op, rec in report.items():
        log_fn(f"  {op}: n_obs={rec['n_obs']} passes={rec['passes']} "
               f"drifting={rec['drifting']} "
               f"mismatches={rec['structural_mismatches']}")
    assert report and not any(r["drifting"] for r in report.values())
    return digests


if __name__ == "__main__":
    main()
