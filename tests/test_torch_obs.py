"""The port's observability layer (``repro_torch.obs``).

The reference's ``tests/test_obs.py`` cases mirrored onto the port:
spans are no-ops when disabled (and still time), nest and carry trace
ids across threads; the metrics registry exports valid Prometheus text
and Chrome trace JSON; the drift monitor warns on timing drift before
the structural contract trips; the telemetry delta keeps mid-window
counters; an 8-thread hammer keeps exact counts.  The reference's
serving and tuning cases have no port module yet (ROADMAP item 13);
their place is taken by the port's instrumented paths: the
``compile_plan`` / ``apply_plan`` / ``registry_observe`` spans, the
cache and integrity gauges and the ``integrity_fault`` event.  The two
packages' validators give the same verdict on the same text, and the
same observations export the same Prometheus text from both packages.
"""

import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import crossbar as xb
from repro_torch.core import integrity, telemetry
from repro_torch.core.semiring import GF2
from repro_torch.core.static_registry import StaticPlanRegistry
from repro_torch.obs import drift as drift_mod
from repro_torch.obs import tracing
from test_torch_support import reset_torch_state  # noqa: F401


@pytest.fixture(autouse=True)
def _obs_flag_guard():
    """Restore the enabled flag after each test (the telemetry reset
    clears obs data but leaves the flag)."""
    was = obs.enabled()
    yield
    (obs.enable if was else obs.disable)()
    obs.reset()


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

class TestSpans:
    def test_disabled_records_nothing_but_still_times(self):
        obs.disable()
        n0 = obs.disabled_call_count()
        with obs.span("x", op="probe") as sp:
            time.sleep(0.001)
        assert sp.recording is False
        assert sp.duration_s >= 0.001
        assert obs.finished_spans() == []
        assert obs.disabled_call_count() == n0 + 1

    def test_enabled_records_with_attrs(self):
        obs.enable()
        with obs.span("work", op="sha3", k=3) as sp:
            sp.set(backend="einsum")
        spans = obs.finished_spans()
        assert [s.name for s in spans] == ["work"]
        assert spans[0].attrs == {"op": "sha3", "k": 3, "backend": "einsum"}
        assert spans[0].duration_s >= 0
        assert spans[0].trace_id is not None

    def test_nesting_inherits_parent_and_trace(self):
        obs.enable()
        with obs.span("outer") as outer:
            with obs.span("inner") as inner:
                pass
        assert inner.parent_id == outer.span_id
        assert inner.trace_id == outer.trace_id

    def test_explicit_trace_id_crosses_threads(self):
        obs.enable()
        tid = obs.new_trace_id()

        def work():
            with obs.span("stage_b", trace_id=tid):
                pass

        with obs.span("stage_a", trace_id=tid):
            assert obs.current_trace_id() == tid
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        assert {s.trace_id for s in obs.finished_spans()} == {tid}

    def test_span_at_retroactive_and_event(self):
        obs.enable()
        t0 = time.perf_counter()
        obs.span_at("queue_wait", t0, t0 + 0.25, thread_name="elsewhere")
        obs.event("mark", detail=1)
        sp, ev = obs.finished_spans()
        assert sp.duration_s == pytest.approx(0.25)
        assert sp.thread_name == "elsewhere"
        assert ev.name == "mark" and ev.duration_s == 0.0

    def test_exception_tagged_and_propagated(self):
        obs.enable()
        with pytest.raises(ValueError):
            with obs.span("boom"):
                raise ValueError("x")
        (sp,) = obs.finished_spans()
        assert sp.attrs["error"] == "ValueError"

    def test_ring_buffer_bounds_and_counts_drops(self):
        obs.enable()
        obs.set_buffer_capacity(8)
        try:
            for _ in range(20):
                with obs.span("s"):
                    pass
            assert len(obs.finished_spans()) == 8
            assert obs.dropped_count() == 12
        finally:
            obs.set_buffer_capacity(tracing.DEFAULT_BUFFER_CAP)

    def test_switch_is_the_ports_own(self, monkeypatch):
        """The port reads REPRO_TORCH_OBS; the reference's REPRO_OBS and
        its enable() leave the port's tracing off, and the other way
        round."""
        import importlib
        monkeypatch.setenv("REPRO_OBS", "1")
        monkeypatch.delenv("REPRO_TORCH_OBS", raising=False)
        assert tracing._truthy_env("REPRO_TORCH_OBS") is False
        monkeypatch.setenv("REPRO_TORCH_OBS", "yes")
        assert tracing._truthy_env("REPRO_TORCH_OBS") is True
        ref_obs = importlib.import_module("repro.obs")
        was = ref_obs.enabled()
        try:
            obs.disable()
            ref_obs.enable()
            assert obs.enabled() is False
            obs.enable()
            ref_obs.disable()
            assert obs.enabled() is True and ref_obs.enabled() is False
        finally:
            (ref_obs.enable if was else ref_obs.disable)()


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

class TestMetrics:
    def test_histogram_quantiles_bound_samples(self):
        h = obs.Histogram()
        for v in [0.001] * 90 + [0.1] * 10:
            h.observe(v)
        st = h.stats()
        assert st["count"] == 100
        assert st["max_s"] == pytest.approx(0.1)
        assert 0.001 <= st["p50_s"] <= 0.002048
        assert st["p99_s"] >= 0.1 or st["p99_s"] == pytest.approx(0.1)

    def test_span_sink_feeds_histograms(self):
        obs.enable()
        with obs.span("fed"):
            pass
        assert obs.metrics.histogram("fed").n == 1

    def test_gauge_fn_lazy_and_survives_reset(self):
        calls = []

        def g():
            calls.append(1)
            return 7.0

        obs.metrics.gauge_fn("test_lazy", g)
        try:
            assert calls == []
            snap = obs.snapshot(include_telemetry=False)
            assert snap["gauges"]["test_lazy"] == 7.0
            assert calls == [1]
            obs.reset()
            snap = obs.snapshot(include_telemetry=False)
            assert snap["gauges"]["test_lazy"] == 7.0
        finally:
            obs.metrics.unregister_gauge_fn("test_lazy")

    def test_broken_gauge_fn_does_not_break_export(self):
        obs.metrics.gauge_fn("test_dead", lambda: 1 / 0)
        try:
            snap = obs.snapshot(include_telemetry=False)
            assert np.isnan(snap["gauges"]["test_dead"])
            obs.validate_prometheus_text(obs.prometheus_text())
        finally:
            obs.metrics.unregister_gauge_fn("test_dead")

    def test_prometheus_text_validates_and_has_counters(self):
        obs.enable()
        telemetry.incr("test_obs_counter", 3)
        with obs.span("apply_plan"):
            pass
        txt = obs.prometheus_text()
        summary = obs.validate_prometheus_text(txt)
        assert summary["samples"] > 0 and summary["histograms"] >= 1
        assert "repro_test_obs_counter_total 3" in txt
        assert 'repro_span_seconds_count{span="apply_plan"} 1' in txt
        assert "repro_kernel_launches_plan_program_total 0" in txt

    def test_validator_rejects_malformed(self):
        with pytest.raises(ValueError, match="malformed"):
            obs.validate_prometheus_text("this is not{ a metric line\n")
        bad_hist = (
            '# TYPE repro_span_seconds histogram\n'
            'repro_span_seconds_bucket{span="x",le="0.1"} 5\n'
            'repro_span_seconds_bucket{span="x",le="+Inf"} 3\n')
        with pytest.raises(ValueError, match="decrease"):
            obs.validate_prometheus_text(bad_hist)

    def test_same_observations_export_the_same_text(self):
        """Metric names and format are the reference's: the same
        histograms and gauges give byte-identical Prometheus text."""
        from repro.obs.metrics import MetricsRegistry
        regs = (obs.MetricsRegistry(), MetricsRegistry())
        for reg in regs:
            for v in (3e-6, 0.002, 0.5, 70.0):
                reg.histogram("gcm_seal").observe(v)
            reg.histogram("apply_plan").observe(1e-4)
            reg.gauge("compile_cache_size").set(3)
            reg.gauge_ratio("integrity_verify_rate", lambda: 1, lambda: 4)
        got, want = (r.prometheus_text(include_telemetry=False)
                     for r in regs)
        assert got == want
        assert 'repro_span_seconds_count{span="gcm_seal"} 4' in got


# ---------------------------------------------------------------------------
# Timeline and the two packages' validators
# ---------------------------------------------------------------------------

_GOOD_TEXT = ('# TYPE repro_x gauge\nrepro_x 1.0\n'
              '# TYPE repro_span_seconds histogram\n'
              'repro_span_seconds_bucket{span="a",le="0.1"} 1\n'
              'repro_span_seconds_bucket{span="a",le="+Inf"} 2\n'
              'repro_span_seconds_count{span="a"} 2\n')
PROM_CASES = {
    "good": _GOOD_TEXT,
    "malformed": "this is not{ a metric line\n",
    "bad_type": "# TYPE repro_x sometimes\nrepro_x 1\n",
    "bad_value": "repro_x one\n",
    "no_inf": ('repro_span_seconds_bucket{span="a",le="0.1"} 1\n'),
    "unordered": ('repro_span_seconds_bucket{span="a",le="0.2"} 1\n'
                  'repro_span_seconds_bucket{span="a",le="0.1"} 1\n'
                  'repro_span_seconds_bucket{span="a",le="+Inf"} 1\n'),
    "count_mismatch": _GOOD_TEXT.replace('{span="a"} 2', '{span="a"} 3'),
}
TRACE_CASES = {
    "good": {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 2,
                              "ts": 0.0, "dur": 1.0},
                             {"name": "thread_name", "ph": "M", "pid": 1,
                              "tid": 2, "args": {"name": "t"}}]},
    "no_events": {"foo": []},
    "not_list": {"traceEvents": {}},
    "missing_pid": {"traceEvents": [{"name": "x", "ph": "i", "ts": 0}]},
    "bad_phase": {"traceEvents": [{"name": "x", "ph": "Q", "pid": 1}]},
    "bad_dur": {"traceEvents": [{"name": "x", "ph": "X", "pid": 1,
                                 "ts": 0.0, "dur": -1}]},
    "no_ts": {"traceEvents": [{"name": "x", "ph": "i", "pid": 1}]},
}


def _verdict(fn, arg):
    try:
        return ("ok", fn(arg))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("case", sorted(PROM_CASES))
def test_prometheus_validators_agree(case):
    from repro.obs import validate as ref_validate
    text = PROM_CASES[case]
    got = _verdict(obs.validate_prometheus_text, text)
    assert got == _verdict(ref_validate.validate_prometheus_text, text)
    assert got[0] == ("ok" if case == "good" else "error")


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_chrome_trace_validators_agree(case):
    from repro.obs import validate as ref_validate
    trace = TRACE_CASES[case]
    got = _verdict(obs.validate_chrome_trace, trace)
    assert got == _verdict(ref_validate.validate_chrome_trace, trace)
    assert got[0] == ("ok" if case == "good" else "error")


class TestTimeline:
    def test_chrome_trace_valid_and_complete(self, tmp_path):
        obs.enable()
        with obs.span("outer", op="sha3") as sp:
            sp.event("mark", detail=1)
        path = tmp_path / "trace.json"
        got = obs.export_chrome_trace(str(path))
        summary = obs.validate_chrome_trace(got)
        assert summary["complete"] == 1
        phases = sorted(e["ph"] for e in got["traceEvents"])
        assert phases == ["M", "X", "i"]
        on_disk = json.loads(path.read_text())
        assert obs.validate_chrome_trace(on_disk)["events"] == 3
        assert on_disk["otherData"]["source"] == "repro_torch.obs"

    def test_validator_rejects_bad_events(self):
        with pytest.raises(ValueError, match="traceEvents"):
            obs.validate_chrome_trace({"foo": []})
        with pytest.raises(ValueError, match="bad dur"):
            obs.validate_chrome_trace({"traceEvents": [
                {"name": "x", "ph": "X", "pid": 1, "ts": 0.0, "dur": -1}]})


# ---------------------------------------------------------------------------
# Drift monitor
# ---------------------------------------------------------------------------

class TestDriftMonitor:
    def _mon(self):
        return drift_mod.DriftMonitor(baseline_n=4, recent_n=4)

    def test_stable_op_never_warns(self):
        m = self._mon()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for _ in range(20):
                m.observe("op", passes=3, fingerprint="f", wall_s=0.001)
        assert w == []
        rep = m.report()["op"]
        assert rep["drifting"] is False
        assert rep["structural_mismatches"] == 0

    def test_timing_drift_warns_once(self):
        m = self._mon()
        for _ in range(4):
            m.observe("op", passes=3, fingerprint="f", wall_s=0.001)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for _ in range(10):
                m.observe("op", passes=3, fingerprint="f", wall_s=0.01)
        msgs = [x for x in w if "fixed-latency drift" in str(x.message)]
        assert len(msgs) == 1
        rep = m.report()["op"]
        assert rep["drifting"] is True
        assert rep["ratio"] == pytest.approx(10.0)
        assert telemetry.counter("drift_warnings") == 1

    def test_sub_floor_jitter_ignored(self):
        m = self._mon()
        for _ in range(4):
            m.observe("op", passes=3, fingerprint="f", wall_s=1e-6)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for _ in range(10):
                m.observe("op", passes=3, fingerprint="f", wall_s=1e-5)
        assert w == []

    def test_structural_mismatch_counted(self):
        m = self._mon()
        m.observe("op", passes=3, fingerprint="f", wall_s=0.001)
        m.observe("op", passes=4, fingerprint="f", wall_s=0.001)
        assert m.report()["op"]["structural_mismatches"] == 1

    def test_registry_observe_feeds_monitor_and_span(self):
        obs.enable()
        reg = StaticPlanRegistry("t")
        idx = torch.arange(8, dtype=torch.int32)[:, None]
        reg.register("p", xb.gather_plan(idx, 8, semiring=GF2))
        x = torch.arange(8, dtype=torch.int32) % 2
        for _ in range(3):
            with reg.observe("probe", shapes=(8,), plan_keys=["p"]):
                xb.apply_plan(reg["p"], x)
        rep = obs.drift_report()
        assert rep["t:probe"]["n_obs"] == 3
        assert rep["t:probe"]["passes"] == 1
        spans = [s for s in obs.finished_spans()
                 if s.name == "registry_observe"]
        assert len(spans) == 3
        assert spans[0].attrs == {"op": "probe", "registry": "t",
                                  "backend": ""}
        inner = [s for s in obs.finished_spans() if s.name == "apply_plan"]
        assert {s.parent_id for s in inner} == {s.span_id for s in spans}


# ---------------------------------------------------------------------------
# The port's instrumented paths
# ---------------------------------------------------------------------------

def test_crossbar_spans_carry_host_values_only():
    """compile_plan and apply_plan record their reference attributes,
    all plain Python values (nothing read off a tensor)."""
    obs.enable()
    idx = torch.as_tensor(np.random.default_rng(0).integers(
        0, 300, (300, 2)).astype(np.int32))
    plan = xb.gather_plan(idx, 300)
    x = torch.ones((300, 4))
    xb.apply_plan(plan, x, backend="auto")
    xb.apply_plan(plan, x, backend="sparse")
    spans = {s.name: s for s in obs.finished_spans()}
    assert spans["apply_plan"].attrs == {
        "backend": "sparse", "requested": "sparse", "mode": "gather",
        "n_out": 300, "n_in": 300, "semiring": "real"}
    assert spans["compile_plan"].attrs == {
        "mode": "gather", "n_out": 300, "n_in": 300, "block_o": 128,
        "block_n": 128, "pin": False}
    first = next(s for s in obs.finished_spans() if s.name == "apply_plan")
    assert (first.attrs["requested"], first.attrs["backend"]) == ("auto",
                                                                  "einsum")
    for s in obs.finished_spans():
        for v in s.attrs.values():
            assert isinstance(v, (bool, int, float, str))
    gauges = obs.snapshot(include_telemetry=False)["gauges"]
    assert gauges["compile_cache_size"] == xb.compile_cache_info()["size"] == 1
    assert gauges["compile_cache_pinned"] == 0


def test_integrity_gauges_info_and_fault_event():
    obs.enable()
    plan = xb.gather_plan(torch.tensor([1, 0, 2], dtype=torch.int32), 3)
    xb.compile_plan(plan)
    with integrity.always_verify():
        xb.compile_plan(plan)
        info = integrity.integrity_info()
        assert info["schedule"]["hits"] == info["schedule"]["checks"] == 1
        assert info["verify_rate"] == 1.0
        gauges = obs.snapshot(include_telemetry=False)["gauges"]
        assert gauges["integrity_sample_every"] == 1.0
        assert gauges["integrity_verify_rate"] == 1.0
        assert gauges["integrity_sealed_entries"] == 1.0
        compiled = xb.compile_plan(plan)
        compiled.pair_o.add_(1)                  # flip the cached schedule
        with pytest.raises(integrity.IntegrityError):
            xb.compile_plan(plan)
    faults = [s for s in obs.finished_spans() if s.name == "integrity_fault"]
    assert len(faults) == 1 and faults[0].attrs["guard"] == "schedule"
    assert integrity.integrity_info()["schedule"]["faults"] == 1
    assert telemetry.counter("integrity_faults") == 1


def test_force_verify_checks_the_next_hit_of_every_entry():
    plan = xb.gather_plan(torch.tensor([2, 0, 1], dtype=torch.int32), 3)
    xb.compile_plan(plan)
    xb.compile_plan(plan)                        # hit 0: always checked
    xb.compile_plan(plan)                        # hit 1: unsampled
    checks = integrity.integrity_info()["schedule"]["checks"]
    assert integrity.sample_every() == 16 and checks == 1
    epoch = integrity.force_verify()
    xb.compile_plan(plan)                        # forced by the epoch
    xb.compile_plan(plan)                        # back to sampling
    assert integrity.force_verify() == epoch + 1
    assert integrity.integrity_info()["schedule"]["checks"] == checks + 1


def test_telemetry_reset_resets_obs():
    obs.enable()
    with obs.span("kept_until_reset"):
        pass
    drift_mod.MONITOR.observe("op", passes=1, fingerprint=(), wall_s=0.1)
    telemetry.reset()
    assert obs.finished_spans() == []
    assert obs.drift_report() == {}
    assert obs.snapshot(include_telemetry=False)["histograms"] == {}
    assert obs.enabled()


# ---------------------------------------------------------------------------
# telemetry.delta: counters created or cleared mid-window
# ---------------------------------------------------------------------------

class TestDeltaMidWindowCounters:
    def test_counter_created_inside_window_needs_no_guard(self):
        with telemetry.delta() as d:
            telemetry.incr("test_obs_brand_new", 5)
        assert d()["test_obs_brand_new"] == 5

    def test_key_only_in_baseline_still_present(self):
        telemetry.incr("test_obs_doomed", 2)
        with telemetry.delta() as d:
            telemetry.reset()
        assert d()["test_obs_doomed"] == -2

    def test_sizes_report_end_state(self):
        with telemetry.delta() as d:
            telemetry.incr("whatever_size", 3)
        assert d()["whatever_size"] == 3


# ---------------------------------------------------------------------------
# Thread safety under load
# ---------------------------------------------------------------------------

def test_hammer_keeps_exact_counts():
    """8 threads bump counters, record spans and export concurrently,
    while a ninth runs crossbar passes: no lost increment, no torn
    export."""
    obs.enable()
    n_threads, n_iter = 8, 300
    errors = []
    plan = xb.gather_plan(torch.tensor([3, 2, 1, 0], dtype=torch.int32), 4)
    x = torch.arange(4, dtype=torch.int32)

    def hammer(tid):
        try:
            for i in range(n_iter):
                telemetry.incr("chaos_hammer")
                telemetry.incr(f"chaos_hammer_{tid}")
                with obs.span("chaos_span", tid=tid):
                    pass
                if i % 100 == 0:
                    assert telemetry.snapshot()["chaos_hammer"] >= 1
                    with telemetry.delta() as d:
                        telemetry.incr("chaos_probe")
                    assert d()["chaos_probe"] >= 1
                    obs.validate_prometheus_text(obs.prometheus_text())
                    obs.snapshot()
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    def passes():
        try:
            for _ in range(100):
                assert torch.equal(xb.apply_plan(plan, x), x.flip(0))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(t,))
               for t in range(n_threads)] + [threading.Thread(target=passes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert telemetry.counter("chaos_hammer") == n_threads * n_iter
    for tid in range(n_threads):
        assert telemetry.counter(f"chaos_hammer_{tid}") == n_iter
    assert obs.metrics.histogram("chaos_span").n == n_threads * n_iter
    assert obs.metrics.histogram("apply_plan").n == 100
