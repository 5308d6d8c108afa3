"""Mesh serving on the CPU: ``BatchingEngine(mesh=...)`` over a mesh of 8
repeated ``"cpu"`` shards.

Mirrors the reference's survivor-mesh and partial-replay suites
(``tests/test_mesh_exec.py``, there over 8 fake host devices in a
subprocess), in-process: digests equal the unsharded engine's and
hashlib; a shard killed mid-batch loses one lane window, which replays
on a survivor while the other shards' lanes are kept (the launch
ledger: 8 + 1, never 16); later batches run on the survivor mesh of 4;
health is tracked by mesh index, so with every shard on one device a
tripped shard stays out while its device's other shards serve.
"""

import hashlib
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import crossbar as txb
from repro_torch.core import faults, telemetry
from repro_torch.core.resilience import (CircuitBreaker, LaunchFault,
                                         ResilientExecutor, RetryPolicy)
from repro_torch.crypto.registry import registry
from repro_torch.dist import make_mesh
from repro_torch.dist import mesh_exec as mx
from repro_torch.serve import BatchingEngine, BatchingOptions, Overloaded
from repro_torch.serve.batching import (ResultJournal, _absorb_digests,
                                        _pack_blocks, encode_aead_record)
from test_torch_support import reset_torch_state  # noqa: F401

pytestmark = pytest.mark.chaos

CHAIN = ("einsum", "reference")


def _mesh(s=8):
    return make_mesh((s,), ("data",), devices=["cpu"] * s)


def _engine(mesh=None, **opts):
    opts.setdefault("chain", CHAIN)
    opts.setdefault("max_batch", 64)
    return BatchingEngine(BatchingOptions(mesh=mesh, double_buffer=False,
                                          **opts),
                          device="cpu", start=False)


def _payloads(n=64, hi=100, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(l)) for l in rng.integers(1, hi, n)]


def _drain(eng, payloads):
    reqs = [eng.submit(p) for p in payloads]
    while eng.run_once():
        pass
    return reqs


def _exact(reqs, payloads):
    return all(r.result(1) == hashlib.sha3_256(p).digest()
               for p, r in zip(payloads, reqs))


def _delta(base):
    snap = telemetry.snapshot()
    return lambda k: snap.get(k, 0) - base.get(k, 0)


@pytest.mark.parametrize("partial", [True, False])
def test_mesh_digests_equal_unsharded_engine_and_hashlib(partial):
    payloads = _payloads(hi=300)                   # one- and two-block
    plain = _drain(_engine(), payloads)
    eng = _engine(_mesh(), partial_results=partial)
    reqs = _drain(eng, payloads)
    assert _exact(reqs, payloads) and _exact(plain, payloads)
    assert [r.result(1) for r in reqs] == [r.result(1) for r in plain]
    # the full mesh sets the lane floor: every bucket pads to >= 8
    assert all(shape[0] >= 8 and shape[0] % 8 == 0
               for _, shape, _, _ in eng.batch_log)
    assert telemetry.counter("serve_mesh_batches") == len(eng.batch_log)
    stats = eng.stats()
    assert stats["mesh_devices"] == stats["mesh_active"] == 8
    assert stats["mesh_lost"] == []
    if partial:
        assert telemetry.counter("serve_partial_batches") == len(
            eng.batch_log)
        assert stats["journal_depth"] == len(payloads)
    else:
        assert telemetry.counter("serve_shard_launches") == 0


def test_sharded_absorb_splits_lanes_over_the_mesh():
    payloads = _payloads(16, hi=130)
    blocks = _pack_blocks(payloads)
    txb.reset_apply_call_count()
    got = _absorb_digests(blocks, "kernel", fixed_latency=False,
                          device=torch.device("cpu"), mesh=_mesh(4))
    assert got == [hashlib.sha3_256(p).digest() for p in payloads]
    # per block and shard one 24-pass permutation: 4 shards x 24
    assert txb.apply_calls_by_backend()["kernel"] == 4 * 24
    txb.reset_apply_call_count()
    _absorb_digests(blocks, "megakernel", fixed_latency=False,
                    device=torch.device("cpu"),
                    mesh=_mesh(4))                # keeps the unsharded path
    assert txb.apply_call_count() == 0


def test_device_fault_replays_only_the_lost_window():
    eng = _engine(_mesh())
    payloads = _payloads()
    assert _exact(_drain(eng, payloads), payloads)
    assert telemetry.counter("serve_shard_launches") == 8
    assert telemetry.counter("serve_partial_batches") == 1

    base = telemetry.snapshot()
    with faults.inject_device_fault(3, max_fires=64) as state:
        reqs = _drain(eng, payloads)
    d = _delta(base)
    assert _exact(reqs, payloads)
    assert d("serve_shard_launches") == 9          # 8 + the one replay
    assert d("serve_shards_salvaged") == 7
    assert d("lanes_replayed") == 8
    assert d("serve_completed") == 64
    assert d("serve_mesh_device_drops") == 1
    # every rung of the chain failed, each twice, before the trip
    assert state["fired"] == 2 * len(CHAIN)
    assert eng.stats()["mesh_lost"] == [3]
    assert {r.backend for r in reqs} == {"einsum"}

    base = telemetry.snapshot()
    assert _exact(_drain(eng, payloads), payloads)
    d = _delta(base)
    survivor = eng._active_mesh()
    assert survivor.size == eng.stats()["mesh_active"] == 4
    assert survivor.ids.tolist() == [0, 1, 2, 4]
    assert d("serve_shard_launches") == 4 and d("lanes_replayed") == 0
    assert telemetry.counter("serve_mesh_rebuilds") == 1
    assert eng._active_mesh() is survivor            # cached


def test_health_is_tracked_by_mesh_index_with_repeated_devices():
    eng = _engine(_mesh())
    payloads = _payloads(32)
    for _ in range(3):
        eng.report_device_fault(2)
    assert eng.stats()["mesh_lost"] == [2]
    assert telemetry.counter("serve_mesh_device_drops") == 1
    reqs = _drain(eng, payloads)
    assert _exact(reqs, payloads)
    # a successful batch on shards that share shard 2's device does not
    # bring shard 2 back
    assert eng.device_health.lost() == [2]
    assert 2 not in eng._active_mesh().ids.tolist()
    assert all(eng.device_health.is_healthy(d) for d in (0, 1, 3, 4))


def test_tripped_shard_rejoins_after_its_cooldown():
    now = [0.0]
    eng = _engine(_mesh())
    eng.device_health.breaker = CircuitBreaker(threshold=1, cooldown_s=5.0,
                                               clock=lambda: now[0])
    eng.report_device_fault(6)
    assert eng.stats()["mesh_active"] == 4
    now[0] = 6.0                                     # half-open: probe
    payloads = _payloads(16)
    assert _exact(_drain(eng, payloads), payloads)
    assert eng.stats()["mesh_lost"] == []
    assert eng.stats()["mesh_active"] == 8


def test_collapse_below_the_survivor_floor_serves_on_one_device():
    eng = _engine(_mesh(2))
    for d in (0, 1):
        for _ in range(3):
            eng.report_device_fault(d)
    assert eng._active_mesh() is None
    assert telemetry.counter("serve_mesh_collapsed") == 1
    assert eng.stats()["mesh_active"] == 0
    payloads = _payloads(8)
    reqs = _drain(eng, payloads)
    assert _exact(reqs, payloads)
    assert telemetry.counter("serve_partial_batches") == 0


def test_a_replay_that_fails_everywhere_fails_its_lanes_typed():
    eng = _engine(_mesh(2))
    payloads = _payloads(8)
    probes = []

    def probe(shard_index, dev_index):
        probes.append(dev_index)
        raise faults.InjectedDeviceFailure(dev_index)

    from repro_torch.serve import batching as sb
    saved = sb._shard_probe
    sb._shard_probe = probe
    try:
        reqs = _drain(eng, payloads)
    finally:
        sb._shard_probe = saved
    for r in reqs:
        with pytest.raises(LaunchFault):
            r.result(1)
    assert telemetry.counter("serve_mesh_collapsed") == 1   # the replay's
    assert eng.stats()["mesh_lost"] == [0, 1]
    assert telemetry.counter("serve_failed") == len(payloads)


def test_replay_serves_journaled_lanes_and_sheds_late_ones():
    eng = _engine(_mesh(2), default_timeout_s=None)
    payloads = _payloads(4)
    reqs = [eng.submit(p) for p in payloads]
    with eng._lock:
        batch, _ = eng._take_batch_locked()
    op, geom, b_pad, data = eng._prepare(batch)
    by_lane = list(batch) + [None] * (b_pad - len(batch))
    half = b_pad // 2
    # journal every lane as if an earlier replay got them
    for req in batch:
        eng.journal.record(req.rid, b"journaled")
    eng.device_health.record_failure(1)
    with obs.span("partial_batch") as sp:
        eng._replay_lost(op, geom, data, by_lane,
                         [(0, 0, half), (1, half, b_pad)], None, sp)
    assert [r.result(1) for r in reqs] == [b"journaled"] * 4
    assert {r.backend for r in reqs} == {"journal"}

    late = eng.submit(b"late")
    late.deadline = time.monotonic() - 1.0
    with obs.span("partial_batch") as sp:
        eng._replay_lost(op, geom, data, [late] + [None] * (b_pad - 1),
                         [(0, 0, half)], None, sp)
    with pytest.raises(Overloaded, match="deadline"):
        late.result(1)


def test_journal_ages_out_oldest_entries():
    j = ResultJournal(cap=2)
    for rid in (1, 2, 3):
        j.record(rid, bytes([rid]))
    assert j.depth() == 2 and j.get(1) is None and j.get(3) == b"\x03"
    j.record(2, b"again")                            # refresh moves to end
    j.record(4, b"\x04")
    assert j.get(3) is None and j.get(2) == b"again"
    j.forget(2)
    assert j.depth() == 1
    with pytest.raises(ValueError, match="cap"):
        ResultJournal(cap=0)
    eng = _engine(_mesh(), journal_cap=16)
    payloads = _payloads(64)
    assert _exact(_drain(eng, payloads), payloads)
    assert eng.stats()["journal_depth"] == 16


def test_collective_site_surfaces_as_a_launch_fault():
    rng = np.random.default_rng(0)
    plan = txb.gather_plan(torch.as_tensor(rng.permutation(64).astype(
        np.int32)), 64)
    ex = ResilientExecutor(chain=("einsum",),
                           retry=RetryPolicy(max_attempts=2,
                                             backoff_base_s=0.0),
                           sleep=lambda s: None, registry=registry("cpu"))

    def run(backend):
        return mx.apply_plan_sharded(plan, torch.ones(64, 2), _mesh(),
                                     backend=backend)

    with faults.inject_faults(seed=1, collective_rate=1.0,
                              sites=("collective",)) as inj:
        with pytest.raises(LaunchFault, match="collective"):
            ex.execute("mesh_apply", (64,), run)
    assert [s for s, _ in inj.injected] == ["collective"] * 2
    assert telemetry.counter("resilience_faults") == 2


def test_gcm_seal_never_shards_and_gauges_export():
    eng = _engine(_mesh())
    rec = encode_aead_record(b"\x01" * 12, b"secret record", b"aad")
    req = eng.submit(rec, op="gcm_seal")
    _drain(eng, [])
    assert len(req.result(1)) == len(b"secret record") + 16
    assert telemetry.counter("serve_shard_launches") == 0
    assert telemetry.counter("serve_mesh_batches") == 1
    gauges = obs.metrics.snapshot()["gauges"]
    assert gauges["serve_mesh_active"] == 8
    assert gauges["serve_mesh_lost"] == 0
    assert gauges["serve_journal_depth"] == 0        # the seal journals none


def test_engine_without_mesh_refuses_device_reports():
    eng = _engine()
    with pytest.raises(ValueError, match="no mesh"):
        eng.report_device_fault(0)
    with pytest.raises(ValueError, match="mesh_axis"):
        BatchingOptions(mesh=_mesh(), mesh_axis="model")


def test_threaded_mesh_engine_end_to_end():
    eng = BatchingEngine(BatchingOptions(max_batch=16, chain=CHAIN,
                                         mesh=_mesh(4)), device="cpu")
    try:
        payloads = _payloads(40)
        assert eng.map(payloads) == [hashlib.sha3_256(p).digest()
                                     for p in payloads]
    finally:
        eng.close(timeout=30)
    assert eng._worker is None
    assert telemetry.counter("serve_partial_batches") >= 3
