"""The port's continuous-batching serving engine on the CPU.

Mirrors the reference's ``tests/test_batching.py`` on ``device="cpu"``
(buckets, admission, degradation, AEAD records, the worker thread; the
chaos sweep is in ``test_torch_batching_chaos.py``), driven
synchronously (``start=False`` + ``run_once``) where batch composition must be deterministic.  Digest ground truth is
hashlib, seal ground truth the port's einsum path and the pure-Python
GCM of ``test_torch_gcm``.  On top: the same submissions through the
reference's engine and the port's give equal batch logs, results and
``serve_*`` / ``resilience_*`` counter deltas.
"""

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import faults, telemetry
from repro_torch.core.faults import InjectedLaunchFailure
from repro_torch.core.resilience import (CircuitBreaker, LaunchFault,
                                         ResilientExecutor, RetryPolicy,
                                         TimeoutFault)
from repro_torch.crypto import gcm
from repro_torch.crypto import keccak
from repro_torch.crypto.registry import registry
from repro_torch.serve import (BatchingEngine, BatchingOptions, Cancelled,
                               Overloaded)
from repro_torch.serve.batching import (_bucket_digests, _dummy_payload,
                                        _n_blocks, _pack_blocks,
                                        encode_aead_record)
from test_torch_support import jax_ref, reset_torch_state  # noqa: F401

pytestmark = pytest.mark.chaos

ROOT = Path(__file__).resolve().parents[1]
REG = registry("cpu")


def _engine(**opts):
    opts.setdefault("chain", ("einsum", "reference"))
    return BatchingEngine(BatchingOptions(**opts), device="cpu", start=False)


def _drain(eng):
    while eng.run_once():
        pass


class TestBuckets:
    def test_n_blocks_matches_pad101(self):
        for n in (0, 1, 135, 136, 137, 271, 272, 500):
            got = _n_blocks(n)
            assert got == keccak._pad101(b"\x00" * n, 136, 0x06).shape[0]

    def test_dummy_payload_lands_in_its_bucket(self):
        for nb in (1, 2, 5):
            assert _n_blocks(len(_dummy_payload(nb))) == nb

    def test_mixed_lengths_bit_exact(self):
        eng = _engine(max_batch=4)
        msgs = [b"", b"a", b"x" * 135, b"y" * 136, b"z" * 300, b"ab" * 80]
        reqs = [eng.submit(m) for m in msgs]
        _drain(eng)
        for m, r in zip(msgs, reqs):
            assert r.result(timeout=1) == hashlib.sha3_256(m).digest()
            assert r.backend == "einsum" and r.latency_s > 0

    def test_batches_are_bucket_aligned_and_pow2_padded(self):
        eng = _engine(max_batch=4)
        for m in (b"a", b"b", b"c", b"x" * 140):
            eng.submit(m)
        _drain(eng)
        shapes = sorted(shape for _, shape, _, _ in eng.batch_log)
        assert shapes == [(1, 2), (4, 1)]
        assert telemetry.counter("serve_padded_lanes") == 1  # 3 -> 4 lanes
        assert telemetry.counter("serve_completed") == 4

    def test_fifo_within_bucket(self):
        eng = _engine(max_batch=2)
        reqs = [eng.submit(bytes([i])) for i in range(5)]
        assert eng.run_once() == 2               # oldest two first
        assert reqs[0].done() and reqs[1].done() and not reqs[2].done()
        _drain(eng)
        assert all(r.done() for r in reqs)

    @pytest.mark.parametrize("backend", ["megakernel", "sparse", "kernel",
                                         "reference"])
    def test_every_rung_answers_bit_exactly(self, backend):
        eng = _engine(max_batch=8, chain=(backend,))
        msgs = [bytes([i]) * (17 * i) for i in range(6)]
        reqs = [eng.submit(m) for m in msgs]
        _drain(eng)
        assert [r.result(1) for r in reqs] == [
            hashlib.sha3_256(m).digest() for m in msgs]
        assert {r.backend for r in reqs} == {backend}


class TestAdmission:
    def test_overload_sheds_with_typed_rejection(self):
        eng = _engine(max_queue=2)
        eng.submit(b"a")
        eng.submit(b"b")
        with pytest.raises(Overloaded, match="queue full"):
            eng.submit(b"c")
        assert telemetry.counter("serve_shed") == 1
        assert eng.queue_depth() == 2            # shed request never queued
        _drain(eng)

    def test_unsupported_op_rejected_at_submit(self):
        eng = _engine()
        with pytest.raises(ValueError, match="unsupported op"):
            eng.submit(b"x", op="md5")

    def test_expired_deadline_completes_with_timeout_fault(self):
        eng = _engine()
        req = eng.submit(b"late", timeout_s=0.0)
        time.sleep(0.01)
        eng.run_once()
        with pytest.raises(TimeoutFault, match="deadline expired"):
            req.result(timeout=1)
        assert telemetry.counter("serve_timeouts") == 1

    def test_cancel_before_dispatch(self):
        eng = _engine()
        a = eng.submit(b"keep")
        b = eng.submit(b"drop")
        assert b.cancel()
        _drain(eng)
        assert a.result(1) == hashlib.sha3_256(b"keep").digest()
        with pytest.raises(Cancelled):
            b.result(timeout=1)
        assert not b.cancel()                    # already completed
        assert telemetry.counter("serve_cancelled") == 1

    def test_result_timeout_while_queued(self):
        eng = _engine()
        req = eng.submit(b"never run")
        with pytest.raises(TimeoutFault, match="not ready"):
            req.result(timeout=0.01)
        assert not req.done()                    # still queued, not failed

    def test_engine_runs_on_the_card_unless_asked(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            BatchingEngine(start=False)
        eng = BatchingEngine(device="cpu", start=False)
        assert eng.device == torch.device("cpu")
        assert eng.chain == ("einsum", "sparse", "kernel", "reference")

    def test_mesh_option_shards_buckets_over_the_mesh(self):
        from repro_torch.dist import make_mesh
        mesh = make_mesh((2,), ("data",), devices=["cpu", "cpu"])
        eng = _engine(mesh=mesh, max_batch=4)
        reqs = [eng.submit(bytes([i]) * 5) for i in range(3)]
        _drain(eng)
        assert [r.result(1) for r in reqs] == [
            hashlib.sha3_256(bytes([i]) * 5).digest() for i in range(3)]
        assert eng.batch_log[0][1] == (4, 1)        # pow2 over the mesh
        assert telemetry.counter("serve_shard_launches") == 2
        with pytest.raises(ValueError, match="mesh_axis"):
            BatchingOptions(mesh=mesh, mesh_axis="model")


class TestDegradation:
    def _chaos_engine(self):
        ex = ResilientExecutor(
            chain=("einsum", "reference"),
            retry=RetryPolicy(max_attempts=2, backoff_base_s=0.0),
            breaker=CircuitBreaker(threshold=10, clock=lambda: 0.0),
            sleep=lambda s: None, registry=REG)
        return BatchingEngine(
            BatchingOptions(max_batch=4, chain=("einsum", "reference")),
            executor=ex, device="cpu", start=False)

    def test_injected_faults_fall_back_bit_exactly(self):
        eng = self._chaos_engine()
        msgs = [b"alpha", b"beta", b"gamma"]
        with faults.inject_faults(seed=0, launch_rate=1.0,
                                  max_faults=2) as inj:
            reqs = [eng.submit(m) for m in msgs]
            _drain(eng)
        assert inj.count == 2                    # einsum's two attempts
        for m, r in zip(msgs, reqs):
            assert r.result(1) == hashlib.sha3_256(m).digest()
            assert r.backend == "reference"      # degraded, not wrong
        snap = telemetry.snapshot()
        assert snap["resilience_fallbacks"] == 1
        assert snap["resilience_retries"] == 1
        assert snap["serve_completed"] == 3
        assert [b for _, _, b, _ in eng.batch_log] == ["reference"]

    def test_exhausted_chain_rejects_all_requests_typed(self):
        eng = self._chaos_engine()
        with faults.inject_faults(seed=0, launch_rate=1.0):
            reqs = [eng.submit(m) for m in (b"a", b"b")]
            _drain(eng)
        for r in reqs:
            with pytest.raises(LaunchFault) as ei:
                r.result(timeout=1)
            assert isinstance(ei.value.__cause__, InjectedLaunchFailure)
        assert telemetry.counter("serve_failed") == 2
        assert telemetry.counter("resilience_exhausted") == 1

    def test_drift_quarantine_inside_serving_path(self):
        eng = self._chaos_engine()
        eng.submit(b"warm the geometry")
        _drain(eng)
        assert faults.poison_observations(REG) > 0
        req = eng.submit(b"post-drift request")
        _drain(eng)
        assert req.result(1) == hashlib.sha3_256(
            b"post-drift request").digest()
        assert req.backend == "einsum"           # recovered, not degraded
        assert REG.quarantine_count("keccak/rho_pi") == 1
        assert telemetry.counter("resilience_quarantines") == 1

    def test_stats_exposes_counters_and_breakers(self):
        eng = self._chaos_engine()
        eng.submit(b"x")
        _drain(eng)
        stats = eng.stats()
        assert stats["queue_depth"] == 0
        assert stats["serve_completed"] == 1
        assert stats["breaker_open"] == []
        assert stats["resilience_backend_einsum"] == 1
        assert stats["tuning_entries"] == 1
        assert stats["journal_depth"] == 0       # no mesh: nothing journaled
        assert "mesh_active" not in stats

    def test_program_fault_falls_to_the_next_rung(self):
        ex = ResilientExecutor(chain=("megakernel", "sparse"),
                               retry=RetryPolicy(max_attempts=1),
                               registry=REG)
        eng = BatchingEngine(BatchingOptions(max_batch=4,
                                             chain=("megakernel", "sparse")),
                             executor=ex, device="cpu", start=False)
        reqs = [eng.submit(bytes([i]) * 9) for i in range(3)]
        with faults.inject_faults(seed=3, program_rate=1.0,
                                  sites=("program",), max_faults=1) as inj:
            _drain(eng)
        assert inj.injected == [("program", 0)]
        assert [r.result(1) for r in reqs] == [
            hashlib.sha3_256(bytes([i]) * 9).digest() for i in range(3)]
        assert {r.backend for r in reqs} == {"sparse"}
        assert telemetry.counter("resilience_fallbacks") == 1

    def test_build_failure_escapes_and_fails_the_batch(self, monkeypatch):
        from repro_torch.core import plan_program as pp
        from repro_torch.kernels._build import KernelBuildError

        def no_nvcc(program, x2):
            raise KernelBuildError("nvcc not found")
        eng = _engine(max_batch=4, chain=("megakernel", "einsum"))
        reqs = [eng.submit(bytes([i])) for i in range(3)]
        monkeypatch.setattr(pp, "_run_megakernel", no_nvcc)
        _drain(eng)
        for r in reqs:
            with pytest.raises(KernelBuildError):
                r.result(1)
        assert telemetry.counter("serve_failed") == 3
        assert telemetry.counter("resilience_fallbacks") == 0
        assert telemetry.counter("resilience_backend_einsum") == 0
        assert not eng.batch_log

    def test_tuning_table_ranks_the_chain(self):
        from repro_torch.core import crossbar as xb
        from repro_torch.core.tuning import TuningTable
        table = TuningTable()
        table.record("sha3_256", (1, 1), "einsum", 1.0)
        table.record("sha3_256", (1, 1), "reference", 1e-6)
        eng = _engine(max_batch=4, chain=("einsum", "reference"),
                      tuning=table)
        assert xb.get_tuning_table() is None    # the engine's own table
        req = eng.submit(b"ranked")
        _drain(eng)
        assert req.backend == "reference"
        assert table.lookup("sha3_256", (1, 1))["reference"]["n"] == 2

    def test_partly_measured_chain_keeps_its_head(self):
        from repro_torch.core.tuning import TuningTable
        table = TuningTable()
        table.record("sha3_256", (1, 1), "reference", 1e-6)
        eng = _engine(max_batch=4, chain=("einsum", "reference"),
                      tuning=table)
        req = eng.submit(b"head first")
        _drain(eng)
        assert req.backend == "einsum"
        assert set(table.lookup("sha3_256", (1, 1))) == {"einsum",
                                                          "reference"}

    def test_one_head_fault_does_not_move_the_bucket_off_the_head(self):
        ex = ResilientExecutor(chain=("megakernel", "sparse"),
                               retry=RetryPolicy(max_attempts=1),
                               registry=REG)
        eng = BatchingEngine(BatchingOptions(max_batch=4,
                                             chain=("megakernel", "sparse")),
                             executor=ex, device="cpu", start=False)
        first = [eng.submit(bytes([i]) * 9) for i in range(3)]
        with faults.inject_faults(seed=3, program_rate=1.0,
                                  sites=("program",), max_faults=1):
            _drain(eng)
        later = [eng.submit(bytes([i]) * 7) for i in range(3)]
        _drain(eng)
        assert {r.backend for r in first} == {"sparse"}
        assert {r.backend for r in later} == {"megakernel"}
        assert [r.result(1) for r in later] == [
            hashlib.sha3_256(bytes([i]) * 7).digest() for i in range(3)]
        assert [b for _, _, b, _ in eng.batch_log] == ["sparse",
                                                       "megakernel"]


class TestAEADRecords:
    KEY = bytes(range(16))

    def test_mixed_geometries_bucket_and_seal_bit_exactly(self):
        eng = _engine(aead_key=self.KEY, max_batch=8)
        recs = [(bytes([i]) * 12, bytes([0x40 + i]) * pt, b"ad" * i)
                for i, pt in enumerate((20, 20, 33, 33, 5))]
        reqs = [eng.submit(encode_aead_record(n, p, a), op="gcm_seal")
                for n, p, a in recs]
        _drain(eng)
        for req, (n, p, a) in zip(reqs, recs):
            want = gcm.aes128_gcm_seal(self.KEY, n, p, a, backend="einsum",
                                       device="cpu")
            assert req.result(timeout=5) == want

    def test_bucket_key_is_op_and_geometry(self):
        eng = _engine(aead_key=self.KEY, max_batch=2)
        same = [encode_aead_record(bytes([i]) * 12, b"x" * 24, b"aa")
                for i in range(2)]
        other = encode_aead_record(b"\x07" * 12, b"x" * 24)  # no AAD
        reqs = [eng.submit(r, op="gcm_seal") for r in same + [other]]
        eng.run_once()                           # full (24, 2) bucket
        assert reqs[0].done() and reqs[1].done() and not reqs[2].done()
        _drain(eng)
        assert reqs[2].done()

    def test_filler_records_never_leak_into_results(self):
        eng = _engine(aead_key=self.KEY, max_batch=8)
        recs = [(bytes([9 - i]) * 12, bytes(range(16)), b"")
                for i in range(3)]
        reqs = [eng.submit(encode_aead_record(n, p, a), op="gcm_seal")
                for n, p, a in recs]
        _drain(eng)
        for req, (n, p, a) in zip(reqs, recs):
            got = req.result(timeout=5)
            assert got[-16:] == gcm.aes128_gcm_seal(
                self.KEY, n, p, a, backend="einsum", device="cpu")[-16:]
            assert gcm.aes128_gcm_open(self.KEY, n, got, device="cpu") == p

    def test_sha3_and_gcm_interleave_in_one_engine(self):
        eng = _engine(aead_key=self.KEY, max_batch=8)
        msg = b"hash me"
        rec = encode_aead_record(b"\x01" * 12, b"seal me")
        h = eng.submit(msg)
        s = eng.submit(rec, op="gcm_seal")
        _drain(eng)
        assert h.result(timeout=5) == hashlib.sha3_256(msg).digest()
        assert s.result(timeout=5) == gcm.aes128_gcm_seal(
            self.KEY, b"\x01" * 12, b"seal me", backend="einsum",
            device="cpu")

    def test_megakernel_rung_seals_a_bucket_in_one_launch(self):
        eng = _engine(aead_key=self.KEY, max_batch=8,
                      chain=("megakernel", "einsum"))
        recs = [(bytes([i]) * 12, bytes([i]) * 40, b"hdr") for i in range(5)]
        reqs = [eng.submit(encode_aead_record(*r), op="gcm_seal")
                for r in recs]
        with telemetry.delta() as d:
            _drain(eng)
        assert d()["program_launches"] == 1
        assert eng.batch_log[-1] == ("gcm_seal", (8, 40, 3), "megakernel", 5)
        for req, r in zip(reqs, recs):
            assert req.result(1) == gcm.aes128_gcm_seal(
                self.KEY, *r, backend="einsum", device="cpu")


class TestWorkerThread:
    def test_threaded_end_to_end(self):
        eng = BatchingEngine(
            BatchingOptions(max_batch=4, chain=("einsum", "reference")),
            device="cpu")
        try:
            msgs = [bytes([i]) * (i + 1) for i in range(6)]
            digests = eng.map(msgs)
            assert digests == [hashlib.sha3_256(m).digest() for m in msgs]
        finally:
            eng.close(timeout=60)
        assert eng._worker is None and eng._prep is None
        assert eng.check_workers() == []         # worker was beating

    def test_single_buffered_worker(self):
        eng = BatchingEngine(
            BatchingOptions(max_batch=2, chain=("einsum",),
                            double_buffer=False), device="cpu")
        try:
            msgs = [b"one", b"two", b"three" * 40]
            assert eng.map(msgs) == [hashlib.sha3_256(m).digest()
                                     for m in msgs]
        finally:
            eng.close(timeout=60)

    def test_staging_drops_requeue_without_losing_requests(self):
        eng = BatchingEngine(
            BatchingOptions(max_batch=2, chain=("einsum",)), device="cpu",
            start=False)
        msgs = [bytes([i]) * 3 for i in range(5)]
        with faults.inject_faults(seed=1, staging_rate=0.5,
                                  max_faults=3) as inj:
            reqs = [eng.submit(m) for m in msgs]
            eng.start()
            got = [r.result(timeout=60) for r in reqs]
            eng.close(timeout=60)
        assert got == [hashlib.sha3_256(m).digest() for m in msgs]
        assert telemetry.counter("serve_staging_drops") == inj.count > 0

    def test_close_without_drain_cancels_pending(self):
        eng = _engine()                          # start=False: never runs
        req = eng.submit(b"doomed")
        eng.close(drain=False)
        with pytest.raises(Cancelled):
            req.result(timeout=1)

    def test_watchdog_reports_wedged_worker(self):
        eng = _engine(watchdog_miss_threshold=2)  # start=False: no beats
        assert eng.check_workers() == []
        assert eng.check_workers() == [0]
        assert telemetry.counter("serve_watchdog_misses") == 1
        eng.heartbeats.beat(0)                   # a beat recovers it
        assert eng.check_workers() == []


# ---------------------------------------------------------------------------
# Differential: the port's engine against the reference's
# ---------------------------------------------------------------------------

KEY = bytes(range(16))


def _submissions():
    rng = np.random.default_rng(3)
    subs = []
    for i in range(14):
        subs.append(("sha3_256", rng.bytes(int(rng.integers(0, 300)))))
        if i % 4 == 1:
            subs.append(("gcm_seal", encode_aead_record(
                rng.bytes(12), rng.bytes(24), rng.bytes(8))))
    return subs


def _serve(engine_cls, options_cls, telemetry_mod, subs, *, chaos=None,
           **kw):
    """Submit, cancel one, drain with run_once; returns the outcome of
    every request, the batch log and the serve_/resilience_ deltas."""
    eng = engine_cls(options_cls(max_batch=4, aead_key=KEY,
                                 chain=("einsum", "reference")),
                     start=False, **kw)
    before = telemetry_mod.snapshot()
    reqs = [eng.submit(p, op=op) for op, p in subs]
    reqs[3].cancel()
    if chaos is None:
        _drain(eng)
    else:
        with chaos() as inj:
            _drain(eng)
        chaos = inj.injected
    after = telemetry_mod.snapshot()
    outcomes = []
    for r in reqs:
        try:
            outcomes.append((r.result(0), r.backend))
        except Exception as e:  # noqa: BLE001 — compared by type
            outcomes.append((type(e).__name__, r.backend))
    deltas = {k: after.get(k, 0) - before.get(k, 0) for k in after
              if k.startswith(("serve_", "resilience_"))}
    return (outcomes, list(eng.batch_log),
            {k: v for k, v in deltas.items() if v}, chaos)


def test_same_submissions_same_batches_results_and_counters(jax_ref):
    from repro.core import telemetry as jtel
    from repro.serve import batching as jsb
    subs = _submissions()
    mine = _serve(BatchingEngine, BatchingOptions, telemetry, subs,
                  device="cpu")
    ref = _serve(jsb.BatchingEngine, jsb.BatchingOptions, jtel, subs)
    assert mine == ref
    outcomes, log, deltas, _ = mine
    assert {op for op, _, _, _ in log} == {"sha3_256", "gcm_seal"}
    assert outcomes[3] == ("Cancelled", None)
    assert deltas["serve_completed"] == len(subs) - 1


def test_same_fault_seed_same_degradation_as_the_reference(jax_ref):
    from repro.core import faults as jfaults
    from repro.core import telemetry as jtel
    from repro.serve import batching as jsb
    subs = [s for s in _submissions() if s[0] == "sha3_256"]
    for backend in ("einsum", "reference"):      # register on both sides
        keccak.sha3_256(b"warm", backend=backend, fixed_latency=True,
                        device="cpu")
    from repro.crypto import keccak as jk
    for backend in ("einsum", "reference"):
        jk.sha3_256(b"warm", backend=backend, fixed_latency=True)

    mine = _serve(BatchingEngine, BatchingOptions, telemetry, subs,
                  device="cpu", chaos=lambda: faults.inject_faults(
                      seed=5, launch_rate=0.02))
    ref = _serve(jsb.BatchingEngine, jsb.BatchingOptions, jtel, subs,
                 chaos=lambda: jfaults.inject_faults(seed=5,
                                                     launch_rate=0.02))
    assert mine == ref
    assert mine[3], "the seed fired no fault"
    assert mine[2].get("resilience_faults", 0) == len(mine[3])


def test_pack_blocks_matches_the_reference(jax_ref):
    from repro.serve import batching as jsb
    payloads = [b"", b"a" * 135, b"b" * 136, b"c" * 200]
    for group in ([payloads[0], payloads[1]], [payloads[2], payloads[3]]):
        got, want = _pack_blocks(group), jsb._pack_blocks(group)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert _bucket_digests(group, "einsum", fixed_latency=True,
                               device="cpu") == [
            hashlib.sha3_256(m).digest() for m in group]


def test_serving_modules_import_neither_jax_nor_reference():
    mods = ["repro_torch.serve", "repro_torch.serve.batching",
            "repro_torch.core.resilience", "repro_torch.core.faults",
            "repro_torch.core.tuning", "repro_torch.dist",
            "repro_torch.dist.fault"]
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or\n"
        "    m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
        "    m.startswith('repro.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
