"""Chaos suite of the port: typed faults, fallback chain, breaker,
quarantine, the injection harness and the host-side dist policies.

The first half mirrors the reference's ``tests/test_resilience.py`` on
``repro_torch`` (CPU, deterministic: faults from the seed-driven harness
or scripted run callables, clocks and sleeps injected).  The second half
holds the port to the reference itself: the same fault schedule through
both executors gives equal ledgers and counter deltas, the same
injection seed the same fault ledger on a SHA-3 call, and the dist
policies the same decisions.  A kernel build failure and a missing card
must escape the chain unclassified.
"""

import hashlib
import threading

import pytest
import torch

from repro_torch._device import DeviceUnavailable
from repro_torch.core import crossbar as xb
from repro_torch.core import faults, integrity, telemetry
from repro_torch.core import resilience as tres
from repro_torch.core.resilience import (CARD_CHAIN, FULL_CHAIN,
                                         CircuitBreaker,
                                         CompileFault, DriftFault, Fault,
                                         IntegrityFault, LaunchFault,
                                         ResilientExecutor, RetryPolicy,
                                         TimeoutFault, classify,
                                         default_chain, is_build_failure)
from repro_torch.core.static_registry import FixedLatencyError
from repro_torch.crypto import keccak
from repro_torch.crypto.registry import registry
from repro_torch.dist import fault as tfault
from repro_torch.kernels import ops
from repro_torch.kernels._build import KernelBuildError, KernelLaunchError
from test_torch_support import jax_ref, reset_torch_state  # noqa: F401

pytestmark = pytest.mark.chaos

REG = registry("cpu")


# ---------------------------------------------------------------------------
# Taxonomy
# ---------------------------------------------------------------------------

class TestClassify:
    @pytest.mark.parametrize("exc,expected", [
        (FixedLatencyError("drift"), DriftFault),
        (integrity.IntegrityError("schedule", "k"), IntegrityFault),
        (TimeoutError("late"), TimeoutFault),
        (faults.InjectedCompileFailure("boom"), CompileFault),
        (faults.InjectedLaunchFailure("boom"), LaunchFault),
        (faults.InjectedProgramFailure("boom"), LaunchFault),
        (ValueError("anything else"), LaunchFault),
    ])
    def test_mapping(self, exc, expected):
        assert classify(exc) is expected

    def test_typed_faults_pass_through(self):
        for cls in (CompileFault, LaunchFault, DriftFault, TimeoutFault):
            assert classify(cls("x")) is cls

    def test_kernel_launch_error_is_launch_fault(self):
        assert classify(ops.KernelLaunchError("cuda launch died")) \
            is LaunchFault

    def test_default_chain_ends_at_reference(self):
        chain = default_chain("cpu")
        assert chain[-1] == "reference"
        assert len(set(chain)) == len(chain)

    def test_default_chain_by_device(self, monkeypatch):
        assert default_chain("cpu") == ("einsum", "sparse", "kernel",
                                        "reference")
        assert default_chain(torch.device("cuda", 0)) == CARD_CHAIN
        assert CARD_CHAIN == ("megakernel", "sparse", "kernel")
        assert CARD_CHAIN == FULL_CHAIN[:3]
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(DeviceUnavailable):
            default_chain()                       # None means the card


# ---------------------------------------------------------------------------
# Circuit breaker (deterministic fake clock)
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class TestCircuitBreaker:
    def test_trips_after_threshold(self):
        clk = FakeClock()
        br = CircuitBreaker(threshold=3, cooldown_s=10.0, clock=clk)
        key = ("op", (8,), "einsum")
        assert not br.record_failure(key)
        assert not br.record_failure(key)
        assert br.allow(key)                    # still closed at 2 faults
        assert br.record_failure(key)           # third trips
        assert br.state(key) == "open"
        assert not br.allow(key)
        assert br.open_keys() == [key]

    def test_success_resets_consecutive_count(self):
        br = CircuitBreaker(threshold=2, clock=FakeClock())
        key = "k"
        br.record_failure(key)
        br.record_success(key)
        assert not br.record_failure(key)       # count restarted
        assert br.state(key) == "closed"

    def test_halfopen_probe_success_closes(self):
        clk = FakeClock()
        br = CircuitBreaker(threshold=1, cooldown_s=5.0, clock=clk)
        br.record_failure("k")
        assert br.state("k") == "open"
        clk.t = 5.0
        assert br.state("k") == "half_open"
        assert br.allow("k")                    # the probe
        br.record_success("k")
        assert br.state("k") == "closed"
        assert br.allow("k")

    def test_halfopen_probe_failure_reopens(self):
        clk = FakeClock()
        br = CircuitBreaker(threshold=1, cooldown_s=5.0, clock=clk)
        br.record_failure("k")
        clk.t = 5.0
        assert br.allow("k")
        assert br.record_failure("k")           # failed probe re-trips
        assert br.state("k") == "open"
        assert not br.allow("k")
        clk.t = 9.0                             # cooldown restarted at t=5
        assert br.state("k") == "open"
        clk.t = 10.0
        assert br.state("k") == "half_open"

    def test_threshold_validation(self):
        with pytest.raises(ValueError):
            CircuitBreaker(threshold=0)


# ---------------------------------------------------------------------------
# Executor: retry, fallback, breaker wiring (scripted runs — no engine)
# ---------------------------------------------------------------------------

def _executor(chain, **kw):
    kw.setdefault("sleep", lambda s: None)
    kw.setdefault("breaker", CircuitBreaker(threshold=3, clock=FakeClock()))
    return ResilientExecutor(chain=chain, **kw)


class TestResilientExecutor:
    def test_transient_fault_retries_same_backend(self):
        calls = []

        def run(backend):
            calls.append(backend)
            if len(calls) == 1:
                raise faults.InjectedLaunchFailure("transient")
            return "ok"

        res = _executor(("einsum", "reference")).execute("op", (8,), run)
        assert res.value == "ok"
        assert calls == ["einsum", "einsum"]
        assert (res.backend, res.chain_index, res.attempts) == ("einsum", 0, 2)
        assert not res.degraded
        snap = telemetry.snapshot()
        assert snap["resilience_retries"] == 1
        assert snap["resilience_backend_einsum"] == 1
        assert "resilience_fallbacks" not in snap

    def test_persistent_fault_falls_back(self):
        def run(backend):
            if backend == "einsum":
                raise faults.InjectedLaunchFailure("dead backend")
            return f"answered by {backend}"

        res = _executor(("einsum", "reference")).execute("op", (8,), run)
        assert res.value == "answered by reference"
        assert res.degraded and res.chain_index == 1
        assert [b for b, _, _ in res.faults] == ["einsum", "einsum"]
        snap = telemetry.snapshot()
        assert snap["resilience_fallbacks"] == 1
        assert snap["resilience_backend_reference"] == 1

    def test_chain_exhaustion_raises_last_typed_fault(self):
        def run(backend):
            raise faults.InjectedCompileFailure(f"{backend} broken")

        with pytest.raises(CompileFault, match="reference"):
            _executor(("einsum", "reference")).execute("op", (8,), run)
        assert telemetry.counter("resilience_exhausted") == 1

    def test_timeout_fault_never_retries(self):
        calls = []

        def run(backend):
            calls.append(backend)
            raise TimeoutError("deadline blown inside the attempt")

        with pytest.raises(TimeoutFault):
            _executor(("einsum", "reference")).execute("op", (8,), run)
        assert calls == ["einsum"]              # no retry, no fallback

    def test_deadline_checked_between_attempts(self):
        clk = FakeClock()
        ex = _executor(("einsum",), clock=clk,
                       breaker=CircuitBreaker(clock=clk))
        clk.t = 100.0
        with pytest.raises(TimeoutFault, match="deadline expired"):
            ex.execute("op", (8,), lambda b: "never runs", deadline=50.0)

    def test_backoff_is_exponential(self):
        sleeps = []
        ex = ResilientExecutor(
            chain=("einsum",),
            retry=RetryPolicy(max_attempts=3, backoff_base_s=0.01,
                              backoff_factor=2.0),
            breaker=CircuitBreaker(threshold=99, clock=FakeClock()),
            sleep=sleeps.append)

        def run(backend):
            raise faults.InjectedLaunchFailure("always")

        with pytest.raises(LaunchFault):
            ex.execute("op", (8,), run)
        assert sleeps == [0.01, 0.02]

    def test_breaker_trips_then_reprobes(self):
        clk = FakeClock()
        ex = ResilientExecutor(
            chain=("einsum", "reference"),
            retry=RetryPolicy(max_attempts=1),
            breaker=CircuitBreaker(threshold=2, cooldown_s=30.0, clock=clk),
            sleep=lambda s: None)
        healed = False

        def run(backend):
            if backend == "einsum" and not healed:
                raise faults.InjectedLaunchFailure("einsum down")
            return backend

        assert ex.execute("op", (8,), run).backend == "reference"
        assert ex.execute("op", (8,), run).backend == "reference"  # trips
        assert telemetry.counter("resilience_breaker_trips") == 1
        res = ex.execute("op", (8,), run)
        assert res.backend == "reference"
        assert res.faults[0][1] == "BreakerOpen"
        assert telemetry.counter("resilience_breaker_skips") == 1
        clk.t = 30.0
        healed = True
        res = ex.execute("op", (8,), run)
        assert res.backend == "einsum" and not res.degraded
        assert telemetry.counter("resilience_breaker_probes") == 1
        assert ex.breaker.state(("op", (8,), "einsum")) == "closed"

    def test_all_breakers_open_is_typed(self):
        clk = FakeClock()
        ex = ResilientExecutor(
            chain=("einsum",), retry=RetryPolicy(max_attempts=1),
            breaker=CircuitBreaker(threshold=1, cooldown_s=30.0, clock=clk),
            sleep=lambda s: None)
        with pytest.raises(LaunchFault):
            ex.execute("op", (8,), lambda b: 1 / 0)
        with pytest.raises(Fault, match="circuit-open"):
            ex.execute("op", (8,), lambda b: "unreachable")

    def test_exhausted_card_chain_raises_and_no_plain_rung_answers(self):
        calls = []

        def run(backend):
            calls.append(backend)
            raise KernelLaunchError(f"{backend} died")

        with pytest.raises(LaunchFault, match="'kernel' failed"):
            _executor(CARD_CHAIN).execute("op", (8,), run)
        assert calls == ["megakernel"] * 2 + ["sparse"] * 2 + ["kernel"] * 2
        assert telemetry.counter("resilience_exhausted") == 1
        assert telemetry.counter("resilience_backend_einsum") == 0

    @pytest.mark.parametrize("chain", [("einsum", "reference"), CARD_CHAIN])
    def test_shadow_mismatch_is_never_served(self, chain):
        """A result the shadow audit disagrees with never leaves the
        executor: the shadow's value answers where the chain holds the
        shadow backend (the reference's behaviour), else a typed
        IntegrityFault is raised."""
        def run(backend):
            return b"shadow" if backend == "reference" else b"suspect"

        ex = _executor(chain, shadow_rate=1.0)
        if "reference" in chain:
            res = ex.execute("op", (8,), run)
            assert (res.value, res.backend) == (b"shadow", "reference")
        else:
            with pytest.raises(IntegrityFault, match="does not serve"):
                ex.execute("op", (8,), run)
        assert telemetry.counter("shadow_mismatches") == 1
        assert telemetry.counter("resilience_backend_reference") == (
            1 if "reference" in chain else 0)

    def test_shadow_audit_agreeing_keeps_the_kernel_answer(self):
        ex = _executor(CARD_CHAIN, shadow_rate=1.0)
        res = ex.execute("op", (8,), lambda b: b"same")
        assert (res.value, res.backend) == (b"same", "megakernel")
        assert telemetry.counter("shadow_audits") == 1
        assert telemetry.counter("shadow_mismatches") == 0

    def test_chain_default_follows_the_device(self):
        assert ResilientExecutor(device="cpu").chain == default_chain("cpu")
        with pytest.raises(ValueError, match="at least one"):
            ResilientExecutor(chain=())


# ---------------------------------------------------------------------------
# Build failures and a missing card never degrade
# ---------------------------------------------------------------------------

class TestBuildFailuresEscape:
    @pytest.mark.parametrize("make", [
        lambda: KernelBuildError("nvcc not found"),
        lambda: DeviceUnavailable("no CUDA device"),
    ])
    def test_escapes_execute_unclassified(self, make):
        calls = []

        def run(backend):
            calls.append(backend)
            raise make()

        ex = _executor(FULL_CHAIN)
        with pytest.raises((KernelBuildError, DeviceUnavailable)) as ei:
            ex.execute("op", (8,), run)
        assert not isinstance(ei.value, Fault)
        assert calls == ["megakernel"]          # no retry, no fallback
        snap = telemetry.snapshot()
        for key in ("resilience_faults", "resilience_fallbacks",
                    "resilience_retries", "resilience_exhausted"):
            assert key not in snap

    def test_escapes_from_the_cause_chain(self):
        def run(backend):
            try:
                raise KernelBuildError("nvcc failed on plan_program.cu")
            except KernelBuildError as e:
                raise RuntimeError("while launching the megakernel") from e

        with pytest.raises(RuntimeError, match="while launching"):
            _executor(FULL_CHAIN).execute("op", (8,), run)
        assert telemetry.counter("resilience_fallbacks") == 0

    def test_launch_errors_still_degrade(self):
        def run(backend):
            if backend == "megakernel":
                raise KernelLaunchError("cudaError 700")
            return backend

        res = _executor(FULL_CHAIN).execute("op", (8,), run)
        assert res.backend == "sparse"
        assert [f[1] for f in res.faults] == ["LaunchFault", "LaunchFault"]

    def test_is_build_failure(self):
        assert is_build_failure(KernelBuildError("x"))
        assert is_build_failure(DeviceUnavailable("x"))
        assert not is_build_failure(KernelLaunchError("x"))
        assert not is_build_failure(None)

    def test_kernel_wrappers_keep_build_failures_typed(self):
        plan = xb.gather_plan(torch.tensor([1, 0]), 2)
        with pytest.raises(KernelBuildError, match=r"dense crossbar kernel "
                           r"failed for plan \(mode=gather, 2->2"):
            with ops._surface_kernel_errors("dense crossbar kernel", plan):
                raise KernelBuildError("nvcc not found")
        with pytest.raises(KernelLaunchError) as ei:
            with ops._surface_kernel_errors("sparse crossbar kernel", plan):
                raise KernelLaunchError("cudaError 700")
        assert type(ei.value) is KernelLaunchError
        assert "sparse crossbar kernel failed" in str(ei.value)
        with pytest.raises(ValueError):          # validation passes through
            with ops._surface_kernel_errors("dense crossbar kernel", plan):
                raise ValueError("bad shape")


# ---------------------------------------------------------------------------
# Injection harness: determinism + restoration
# ---------------------------------------------------------------------------

class TestFaultInjector:
    def _drive(self, seed):
        """Fixed call sequence against the patched sites; returns ledger."""
        plan = xb.gather_plan(torch.tensor([1, 0, 2]), 3)
        x = torch.arange(3.0)
        with faults.inject_faults(seed=seed, launch_rate=0.4,
                                  compile_rate=0.4) as inj:
            for _ in range(8):
                try:
                    xb.apply_plan(plan, x)
                except faults.InjectedFault:
                    pass
                try:
                    xb.compile_plan(plan)
                except faults.InjectedFault:
                    pass
        return inj.injected

    def test_same_seed_same_schedule(self):
        assert self._drive(7) == self._drive(7)
        assert len(self._drive(7)) > 0

    def test_different_seed_different_schedule(self):
        assert self._drive(7) != self._drive(1234)

    def test_patches_are_restored(self):
        from repro_torch.core import plan_program as pp
        orig = (xb.apply_plan, xb.compile_plan, pp._run_megakernel)
        with faults.inject_faults(seed=0, launch_rate=1.0):
            assert xb.apply_plan is not orig[0]
            assert pp._run_megakernel is not orig[2]
        assert (xb.apply_plan, xb.compile_plan, pp._run_megakernel) == orig

    def test_restored_even_on_escape(self):
        orig = xb.apply_plan
        with pytest.raises(RuntimeError, match="escaping"):
            with faults.inject_faults(seed=0):
                raise RuntimeError("escaping the context")
        assert xb.apply_plan is orig

    def test_max_faults_bounds_the_burst(self):
        plan = xb.gather_plan(torch.tensor([1, 0]), 2)
        x = torch.arange(2.0)
        with faults.inject_faults(seed=0, launch_rate=1.0,
                                  max_faults=2) as inj:
            hits = 0
            for _ in range(6):
                try:
                    xb.apply_plan(plan, x)
                except faults.InjectedLaunchFailure:
                    hits += 1
        assert hits == 2 and inj.count == 2

    def test_program_site_fires_before_the_megakernel(self):
        state = torch.zeros(1600, 2, dtype=torch.int32)
        with faults.inject_faults(seed=3, program_rate=1.0,
                                  sites=("program",), max_faults=1) as inj:
            with pytest.raises(faults.InjectedProgramFailure):
                keccak.keccak_f1600(state.T, backend="megakernel")
            keccak.keccak_f1600(state.T, backend="megakernel")
        assert inj.injected == [("program", 0)]

    def test_mesh_sites_arm_their_hooks(self):
        from repro_torch.dist import mesh_exec as mx
        from repro_torch.serve import batching as sb
        round_hook, probe = mx._collective_round, sb._shard_probe
        with faults.inject_faults(seed=0, collective_rate=1.0,
                                  sites=("collective",)) as inj:
            with pytest.raises(faults.InjectedCollectiveFailure):
                mx._collective_round(0, ((1, 0),))
        assert inj.injected == [("collective", 0)]
        assert mx._collective_round is round_hook
        with faults.inject_device_fault(2, max_fires=1) as state:
            sb._shard_probe(0, 1)                # another shard: no fault
            with pytest.raises(faults.InjectedDeviceFailure) as e:
                sb._shard_probe(5, 2)
            sb._shard_probe(6, 2)                # max_fires spent
        assert e.value.device == 2 and state["fired"] == 1
        assert sb._shard_probe is probe
        assert isinstance(e.value, faults.InjectedLaunchFailure)
        with pytest.raises(ValueError, match="unknown fault sites"):
            with faults.inject_faults(sites=("nowhere",)):
                pass


# ---------------------------------------------------------------------------
# Cache corruption: detected, never served
# ---------------------------------------------------------------------------

class TestCorruptCache:
    def test_empty_caches_corrupt_nothing(self):
        assert faults.corrupt_cache(target="const") is None

    def test_const_flip_reaches_the_control_and_is_refused(self):
        import numpy as np
        from repro_torch.core import plan_program as pp
        msg = b"corrupt me, then serve me exactly"
        want = hashlib.sha3_256(msg).digest()
        run = _sha3_run(msg, backend="megakernel")
        ex = _executor(("megakernel", "einsum"), registry=REG)
        assert ex.execute("sha3", (1,), run,
                          registry_keys=_keccak_keys).value == want
        program = keccak.megakernel_program("cpu")
        ctl = pp.control_for(program, torch.device("cpu"))
        consts_before = ctl["consts"].clone()
        hit = faults.corrupt_cache(np.random.default_rng(2), target="const")
        assert hit is not None and hit[0] == "const"
        assert not torch.equal(torch.as_tensor(program.consts),
                               consts_before)
        assert torch.equal(ctl["consts"], torch.as_tensor(program.consts))
        with integrity.always_verify():
            res = ex.execute("sha3", (1,), run, registry_keys=_keccak_keys)
        assert res.value == want
        assert telemetry.counter("integrity_faults") >= 1
        assert telemetry.counter("resilience_quarantines") >= 1

    def test_schedule_and_lift_flips_are_detected(self):
        import numpy as np
        from repro_torch.core import semiring as sr
        plan = xb.gather_plan(torch.tensor([[1, 2], [0, 2], [1, 0]]), 3,
                              weights=torch.tensor([[3, 7], [1, 2], [5, 9]]),
                              semiring=sr.GF2_8)
        xb.compile_plan(plan, pin=True)
        x = torch.tensor([[17], [200], [3]], dtype=torch.int32)
        want = xb.apply_plan(plan, x, backend="reference")
        assert torch.equal(xb.apply_plan(plan, x, backend="sparse"), want)
        rng = np.random.default_rng(0)
        kinds = set()
        for target in ("schedule", "lift"):
            hit = faults.corrupt_cache(rng, target=target)
            assert hit is not None and hit[0] == target
            kinds.add(hit[0])
        with integrity.always_verify():
            for _ in range(3):
                try:
                    got = xb.apply_plan(plan, x, backend="sparse")
                except integrity.IntegrityError:
                    continue
                assert torch.equal(got, want)
                break
        assert kinds == {"schedule", "lift"}
        assert telemetry.counter("integrity_faults") >= 1


# ---------------------------------------------------------------------------
# End-to-end chaos: SHA-3 answers bit-exactly through degradation
# ---------------------------------------------------------------------------

def _sha3_run(msg, backend=None):
    """An executor-shaped run callable: full SHA3-256 on the backend."""
    def run(b):
        return keccak.sha3_256(msg, backend=backend or b, fixed_latency=True,
                               device="cpu")
    return run


def _keccak_keys(backend):
    if backend == "megakernel":
        return (keccak.MEGAKERNEL_PROGRAM_KEY,)
    return ("keccak/rho_pi",)


class TestChaosEndToEnd:
    MSG = b"chaos, bit-exact or rejected"

    @pytest.mark.parametrize("site,rates", [
        ("apply", dict(launch_rate=1.0)),
        ("compile", dict(compile_rate=1.0)),
    ])
    def test_injected_faults_degrade_bit_exactly(self, site, rates):
        ex = _executor(("einsum", "reference"),
                       retry=RetryPolicy(max_attempts=2, backoff_base_s=0.0))
        with faults.inject_faults(seed=0, max_faults=2, **rates) as inj:
            res = ex.execute("sha3_256", (1, len(self.MSG)),
                             _sha3_run(self.MSG))
        assert res.value == hashlib.sha3_256(self.MSG).digest()
        assert res.backend == "reference" and res.degraded
        assert inj.count == 2
        snap = telemetry.snapshot()
        assert snap["resilience_backend_reference"] == 1
        assert snap["resilience_fallbacks"] == 1
        assert snap["resilience_faults"] == 2

    def test_clean_path_stays_on_primary(self):
        ex = _executor(("einsum", "reference"))
        res = ex.execute("sha3_256", (1, len(self.MSG)),
                         _sha3_run(self.MSG))
        assert res.value == hashlib.sha3_256(self.MSG).digest()
        assert res.backend == "einsum" and not res.degraded

    def test_drift_quarantines_and_recovers(self):
        ex = _executor(("einsum", "reference"), registry=REG)
        run = _sha3_run(self.MSG)
        assert ex.execute("sha3", (1,), run,
                          registry_keys=_keccak_keys).value == \
            hashlib.sha3_256(self.MSG).digest()          # warm + observe
        assert faults.poison_observations(REG) > 0
        res = ex.execute("sha3", (1,), run, registry_keys=_keccak_keys)
        assert res.value == hashlib.sha3_256(self.MSG).digest()
        assert res.backend == "einsum"                   # same backend
        assert REG.quarantine_count("keccak/rho_pi") == 1
        assert telemetry.counter("resilience_quarantines") == 1
        assert "keccak/rho_pi" in REG                    # re-registered

    def test_repeat_drift_escalates_to_next_backend(self):
        ex = _executor(("einsum", "reference"), registry=REG)
        run = _sha3_run(self.MSG)
        ex.execute("sha3", (1,), run, registry_keys=_keccak_keys)  # warm
        REG.quarantine("keccak/rho_pi")
        keccak.rho_pi_plan("cpu")                        # rebuild the plan
        faults.poison_observations(REG)
        ex.execute("sha3", (1,), run, registry_keys=_keccak_keys)
        faults.poison_observations(REG)
        res = ex.execute("sha3", (1,), run, registry_keys=_keccak_keys)
        assert res.value == hashlib.sha3_256(self.MSG).digest()
        assert res.backend == "reference" and res.degraded
        assert telemetry.counter("resilience_drift_escalations") == 1
        assert REG.quarantine_count("keccak/rho_pi") >= 2

    def test_poison_filters_by_site(self):
        ex = _executor(("megakernel", "einsum"), registry=REG)
        ex.execute("sha3", (1,), _sha3_run(self.MSG),
                   registry_keys=_keccak_keys)
        assert faults.poison_observations(REG, site="gcm") == 0
        assert faults.poison_observations(REG, site="keccak") > 0
        res = ex.execute("sha3", (1,), _sha3_run(self.MSG),
                         registry_keys=_keccak_keys)
        assert res.backend == "megakernel"
        assert REG.quarantine_count(keccak.MEGAKERNEL_PROGRAM_KEY) == 1


# ---------------------------------------------------------------------------
# Telemetry thread safety
# ---------------------------------------------------------------------------

class TestTelemetryThreadSafety:
    def test_two_threads_no_lost_increments(self):
        n, per = 4, 5000

        def worker():
            for _ in range(per):
                telemetry.incr("race_test")

        threads = [threading.Thread(target=worker) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert telemetry.counter("race_test") == n * per
        assert telemetry.snapshot()["race_test"] == n * per

    def test_crossbar_counters_locked(self):
        plan = xb.gather_plan(torch.tensor([1, 0]), 2)
        x = torch.arange(2.0)
        xb.reset_apply_call_count()
        per = 50

        def worker():
            for _ in range(per):
                xb.apply_plan(plan, x)

        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert xb.apply_call_count() == 2 * per


# ---------------------------------------------------------------------------
# Differential: the port against the reference
# ---------------------------------------------------------------------------

class _FakeRegistry:
    """The executor's view of a registry: quarantine counts per key."""

    def __init__(self):
        self.counts = {}

    def quarantine(self, key):
        self.counts[key] = self.counts.get(key, 0) + 1
        return self.counts[key]


# (op, {backend: [exception kind of attempt 0, 1, ...]}); None succeeds.
SCHEDULE = [
    ("a", {"einsum": ["launch", None]}),
    ("a", {"einsum": ["launch", "launch"], "sparse": ["compile", None]}),
    ("b", {"einsum": ["drift", None]}),
    ("b", {"einsum": ["drift", "drift"], "sparse": [None]}),
    ("c", {"einsum": ["integrity", "launch"], "sparse": ["launch"] * 2,
           "reference": [None]}),
    ("a", {"einsum": ["launch"] * 2, "sparse": ["launch"] * 2,
           "reference": [None]}),
    ("a", {"einsum": ["launch"] * 2, "sparse": ["launch"] * 2,
           "reference": ["compile", "launch"]}),
    ("a", {}),
    ("d", {"einsum": ["timeout"]}),
    ("c", {"einsum": ["integrity", "integrity"], "sparse": [None]}),
]


def _play(pkg_faults, pkg_res, fle, telemetry_mod):
    """Run SCHEDULE through one package's executor; returns each call's
    ledger (or raised fault) and the resilience_* counter deltas."""
    clock = FakeClock()
    make = {"launch": lambda m: pkg_faults.InjectedLaunchFailure(m),
            "compile": lambda m: pkg_faults.InjectedCompileFailure(m),
            "drift": lambda m: fle(m),
            "timeout": lambda m: TimeoutError(m),
            "integrity": lambda m: pkg_res.IntegrityError("program", m)}
    ex = pkg_res.ResilientExecutor(
        chain=("einsum", "sparse", "reference"),
        retry=pkg_res.RetryPolicy(max_attempts=2, backoff_base_s=0.0),
        breaker=pkg_res.CircuitBreaker(threshold=3, cooldown_s=5.0,
                                       clock=clock),
        sleep=lambda s: None, clock=clock, registry=_FakeRegistry(),
        shadow_rate=0.5, shadow_seed=4)
    before = telemetry_mod.snapshot()
    out = []
    for step, (op, plan) in enumerate(SCHEDULE):
        seen = {}

        def run(backend, plan=plan, seen=seen, op=op):
            i = seen.get(backend, 0)
            seen[backend] = i + 1
            kinds = plan.get(backend, [])
            kind = kinds[i] if i < len(kinds) else None
            if kind is not None:
                raise make[kind](f"{op}:{backend}:{i}:{kind}")
            return f"{op} by {backend}"

        clock.t = float(step)
        try:
            r = ex.execute(op, (8, step % 2), run,
                           registry_keys=lambda b: (f"k/{b}",))
            out.append((r.value, r.backend, r.chain_index, r.attempts,
                        r.faults))
        except Exception as e:  # noqa: BLE001 — compared as a ledger
            out.append((type(e).__name__, str(e)))
    after = telemetry_mod.snapshot()
    deltas = {k: after.get(k, 0) - before.get(k, 0) for k in after
              if k.startswith(("resilience_", "shadow_"))}
    return out, {k: v for k, v in deltas.items() if v}, ex.registry.counts


def test_same_fault_schedule_same_ledgers_and_counters(jax_ref):
    from repro.core import faults as jfaults
    from repro.core import resilience as jres
    from repro.core import telemetry as jtel
    from repro.core.static_registry import FixedLatencyError as JFLE
    mine = _play(faults, tres, FixedLatencyError, telemetry)
    ref = _play(jfaults, jres, JFLE, jtel)
    assert mine == ref
    assert mine[1]["resilience_fallbacks"] > 0
    assert mine[1]["resilience_quarantines"] > 0


@pytest.mark.parametrize("seed,fixed_latency", [(0, False), (7, False),
                                                (1, True), (7, True)])
def test_same_injection_seed_same_ledger_on_sha3(jax_ref, seed,
                                                 fixed_latency):
    from repro.core import faults as jfaults
    from repro.core import resilience as jres
    from repro.crypto import keccak as jk
    msg = b"the same seed, the same faults" * 6

    def drive(pkg_faults, pkg_res, sha3):
        # registration compiles schedules: register first, on both sides
        for backend in ("einsum", "reference"):
            sha3(msg, backend=backend, fixed_latency=fixed_latency)
        ex = pkg_res.ResilientExecutor(
            chain=("einsum", "reference"),
            retry=pkg_res.RetryPolicy(max_attempts=3, backoff_base_s=0.0),
            breaker=pkg_res.CircuitBreaker(threshold=99, clock=lambda: 0.0),
            sleep=lambda s: None)
        with pkg_faults.inject_faults(seed=seed, launch_rate=0.02,
                                      compile_rate=0.3) as inj:
            try:
                r = ex.execute("sha3", (1,), lambda b: sha3(
                    msg, backend=b, fixed_latency=fixed_latency))
                res = (r.value, r.backend, r.attempts,
                       [f[:2] for f in r.faults])
            except pkg_res.Fault as e:
                res = type(e).__name__
        return inj.injected, inj.calls, res

    mine = drive(faults, tres, lambda m, **kw: keccak.sha3_256(
        m, device="cpu", **kw))
    ref = drive(jfaults, jres, jk.sha3_256)
    assert mine == ref
    assert mine[1]["apply"] > 0


def test_device_health_matches_the_reference(jax_ref):
    from repro.core import resilience as jres
    from repro.core import telemetry as jtel
    ops_ = [("f", 1), ("f", 1), ("f", 1), ("s", 2), ("f", 2), ("t", 10.0),
            ("f", 1), ("t", 31.0), ("s", 1), ("f", 0), ("f", 0), ("f", 0)]

    def play(res_mod, tel):
        clk = FakeClock()
        dh = res_mod.DeviceHealth(4, threshold=3, cooldown_s=30.0, clock=clk)
        before = tel.counter("device_trips")
        out = []
        for what, arg in ops_:
            if what == "t":
                clk.t = arg
            elif what == "f":
                out.append(dh.record_failure(arg))
            else:
                dh.record_success(arg)
            out.append((dh.healthy(), dh.lost(),
                        [dh.is_healthy(d) for d in range(4)]))
        with pytest.raises(ValueError):
            dh.record_failure(4)
        return out, tel.counter("device_trips") - before

    assert play(tres, telemetry) == play(jres, jtel)


def test_dist_policies_match_the_reference(jax_ref):
    import numpy as np
    from repro.dist import fault as jfault
    for shape, lost in (({"data": 8}, 1), ({"data": 8}, 3),
                        ({"pod": 3, "data": 4, "model": 2}, 5),
                        ({"data": 16, "model": 4}, 40)):
        assert tfault.survivor_mesh_shape(shape, lost) == \
            jfault.survivor_mesh_shape(shape, lost)
    for bad in (({"data": 4}, 4), ({"data": 4}, -1)):
        with pytest.raises(ValueError):
            tfault.survivor_mesh_shape(*bad)
        with pytest.raises(ValueError):
            jfault.survivor_mesh_shape(*bad)
    with pytest.raises(RuntimeError, match="model axis"):
        tfault.survivor_mesh_shape({"model": 4}, 1)

    rng = np.random.default_rng(0)
    mine, ref = tfault.StragglerPolicy(), jfault.StragglerPolicy()
    for step in range(30):
        t = float(rng.exponential(0.01))
        mine.observe(t)
        ref.observe(t)
        assert mine.deadline == ref.deadline
        times = rng.exponential(0.01, 8)
        a, b = mine.decide(times), ref.decide(times)
        assert np.array_equal(a[0], b[0]) and a[1] == b[1]
    assert tfault.StragglerPolicy().deadline == float("inf")

    hb_m, hb_r = tfault.HeartbeatTracker(3, 2), jfault.HeartbeatTracker(3, 2)
    for beats in ([0, 1, 2], [0], [], [1, 2], [], []):
        for h in beats:
            hb_m.beat(h)
            hb_r.beat(h)
        assert hb_m.tick() == hb_r.tick()
    for bad in (-1, 3):
        with pytest.raises(ValueError):
            hb_m.beat(bad)
    with pytest.raises(ValueError):
        tfault.HeartbeatTracker(0)
