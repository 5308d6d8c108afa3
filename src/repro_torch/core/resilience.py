"""Graceful backend degradation for the permutation engine.

Port of ``repro.core.resilience``: the same taxonomy, chain, breaker,
quarantine and shadow audits, under the same telemetry counter and
span names.  When a call fails, a serving path degrades to a
slower-but-exact backend, never to a wrong answer or a hung queue.

* **Error taxonomy** — every engine failure is classified into one of
  five typed ``Fault``s (``classify``): ``CompileFault`` (schedule or
  program compilation, injected compile failures), ``LaunchFault`` (an
  execution failed: a kernel launch, ``kernels.ops.KernelLaunchError``),
  ``DriftFault`` (``static_registry.FixedLatencyError``),
  ``IntegrityFault`` (``integrity.IntegrityError``) and
  ``TimeoutFault``.

* **Fallback chain** — ``ResilientExecutor.execute`` runs an operation
  through an ordered backend chain: ``CARD_CHAIN`` (megakernel →
  sparse → kernel, the kernel rungs of ``FULL_CHAIN``) on a CUDA
  device, and the reference's off-TPU chain (einsum first) on the CPU,
  where the kernels run their plain versions.  On the card no plain
  PyTorch rung serves: a batch that every kernel rung failed raises.
  Each backend gets bounded retries with exponential backoff;
  exhausting one falls to the next; exhausting the chain raises the
  last typed fault.  Every decision is counted in
  ``core.telemetry`` (``resilience_retries`` / ``_fallbacks`` /
  ``_breaker_trips`` / ``_quarantines`` / ``_backend_<name>``).

* **What never degrades** — a kernel build failure
  (``KernelBuildError``: nvcc missing or failing) and a missing card
  (``DeviceUnavailable``) anywhere in an exception's cause chain escape
  ``execute`` unclassified: they are faults of the installation, not of
  one execution, and a lower rung must not hide them.

* **Circuit breaker + quarantine** — a per-(op, geometry, backend)
  breaker trips after N consecutive faults and re-probes half-open
  after its cooldown.  A ``DriftFault`` or ``IntegrityFault`` on an
  operation with declared registry keys quarantines those entries
  (``StaticPlanRegistry.quarantine``) and retries once; a repeat drift
  on the same entry escalates to the next backend.

Every path here is chaos-testable through ``core.faults``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch._device import DeviceUnavailable, resolve
from repro_torch.core import integrity as _integrity
from repro_torch.core import telemetry
from repro_torch.core.integrity import IntegrityError
from repro_torch.core.static_registry import (FixedLatencyError,
                                              StaticPlanRegistry)
from repro_torch.kernels._build import KernelBuildError


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------

class Fault(RuntimeError):
    """Base of the serving-layer error taxonomy (all faults are typed)."""


class CompileFault(Fault):
    """Schedule or executable compilation failed."""


class LaunchFault(Fault):
    """A kernel/contraction execution failed at launch or run time."""


class DriftFault(Fault):
    """The fixed-latency contract was violated (wraps FixedLatencyError)."""


class IntegrityFault(Fault):
    """A cached schedule/lift/program failed its content-digest check
    (wraps ``integrity.IntegrityError``).  Retryable: the poisoned
    entry is already evicted when this is raised, so a retry
    recompiles; with declared registry keys the backing entries are
    quarantined first so the rebuild starts from clean sources."""


class TimeoutFault(Fault):
    """A deadline expired before the operation completed."""


def classify(exc: BaseException) -> type:
    """Map an arbitrary engine exception to its ``Fault`` class.

    Typed faults pass through; ``FixedLatencyError`` is drift; injected
    compile failures (``core.faults``) and anything whose type names
    compilation are compile faults; ``TimeoutError`` maps to timeout;
    everything else — CUDA runtime errors, kernel wrapper errors
    (``kernels.ops.KernelLaunchError``), shape errors surfaced at
    launch — is a launch fault.
    """
    if isinstance(exc, Fault):
        return type(exc)
    if isinstance(exc, FixedLatencyError):
        return DriftFault
    if isinstance(exc, IntegrityError):
        return IntegrityFault
    if isinstance(exc, TimeoutError):
        return TimeoutFault
    from repro_torch.core import faults as _faults
    if isinstance(exc, _faults.InjectedCompileFailure):
        return CompileFault
    if "compil" in type(exc).__name__.lower():
        return CompileFault
    return LaunchFault


# ---------------------------------------------------------------------------
# Backend chains
# ---------------------------------------------------------------------------

# The full degradation order: fastest/most-fused first, the take-oracle
# reference contraction last (always available, always exact).
FULL_CHAIN = ("megakernel", "sparse", "kernel", "einsum", "reference")
# The card's chain: the kernel rungs only.  einsum and reference are
# plain PyTorch, which never answers a request on the card.
CARD_CHAIN = FULL_CHAIN[:3]


def default_chain(device=None) -> tuple:
    """The fallback chain for a device (``None``: the card).

    On a CUDA device the fused paths lead, as the reference's chain does
    on a TPU, and the chain ends at the last kernel rung, so a batch
    that every kernel failed raises its typed fault.  On the CPU every
    kernel runs its plain version, far slower than the einsum
    contraction, so the chain starts at einsum and keeps the kernels'
    plain versions as intermediate fallbacks — the reference's off-TPU
    chain, so the two packages agree.
    """
    if resolve(device).type == "cuda":
        return CARD_CHAIN
    return ("einsum", "sparse", "kernel", "reference")


def is_build_failure(exc: Optional[BaseException]) -> bool:
    """A kernel build failure or a missing card anywhere in the cause
    (or context) chain."""
    seen = 0
    while exc is not None and seen < 16:
        if isinstance(exc, (KernelBuildError, DeviceUnavailable)):
            return True
        exc = exc.__cause__ or exc.__context__
        seen += 1
    return False


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _BreakerEntry:
    failures: int = 0
    opened_at: Optional[float] = None
    probing: bool = False


class CircuitBreaker:
    """Per-key consecutive-failure breaker with cooldown re-probes.

    ``threshold`` consecutive faults open the circuit: ``allow`` returns
    False (callers skip that backend) until ``cooldown_s`` has elapsed,
    after which exactly one half-open probe is allowed — success closes
    the circuit, failure re-opens it for another cooldown.  ``clock`` is
    injectable so chaos tests advance time deterministically.
    """

    def __init__(self, *, threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if threshold < 1:
            raise ValueError(f"breaker threshold must be >= 1, got "
                             f"{threshold}")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._lock = threading.Lock()
        self._entries: dict = {}

    def _entry(self, key) -> _BreakerEntry:
        e = self._entries.get(key)
        if e is None:
            e = self._entries[key] = _BreakerEntry()
        return e

    def state(self, key) -> str:
        """'closed' | 'open' | 'half_open' (cooldown elapsed, probe due)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.opened_at is None:
                return "closed"
            if self.clock() - e.opened_at >= self.cooldown_s:
                return "half_open"
            return "open"

    def allow(self, key) -> bool:
        """May this key be attempted now?  (Half-open counts as yes.)"""
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.opened_at is None:
                return True
            if self.clock() - e.opened_at >= self.cooldown_s:
                e.probing = True
                return True
            return False

    def record_success(self, key) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def record_failure(self, key) -> bool:
        """Count a fault; returns True when this one trips (or re-trips)
        the breaker open."""
        with self._lock:
            e = self._entry(key)
            e.failures += 1
            if e.opened_at is not None:
                if e.probing:  # failed half-open probe: re-open
                    e.opened_at = self.clock()
                    e.probing = False
                    return True
                return False
            if e.failures >= self.threshold:
                e.opened_at = self.clock()
                return True
            return False

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()

    def open_keys(self) -> list:
        with self._lock:
            now = self.clock()
            return [k for k, e in self._entries.items()
                    if e.opened_at is not None
                    and now - e.opened_at < self.cooldown_s]


# ---------------------------------------------------------------------------
# The resilient executor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff, per backend.

    ``max_attempts`` counts the first try; only ``retryable`` fault
    classes re-attempt the same backend (drift has its own quarantine
    path, timeouts never retry).  ``backoff_base_s * backoff_factor**i``
    sleeps between attempt i and i+1.
    """

    max_attempts: int = 2
    backoff_base_s: float = 0.01
    backoff_factor: float = 2.0
    retryable: tuple = (LaunchFault, CompileFault, IntegrityFault)

    def backoff_s(self, attempt: int) -> float:
        return self.backoff_base_s * (self.backoff_factor ** attempt)


@dataclasses.dataclass
class ResilientResult:
    """What ``execute`` returns: the value plus the degradation ledger."""

    value: object
    backend: str
    chain_index: int          # 0 = primary backend answered
    attempts: int             # total run() invocations
    faults: list              # (backend, fault-class name, message) tuples

    @property
    def degraded(self) -> bool:
        return self.chain_index > 0


class ResilientExecutor:
    """Run operations through the fallback chain under breaker control.

    One executor instance is meant to live as long as the serving
    process: the breaker state and quarantine escalation are its memory
    of which (op, geometry, backend) combinations are currently
    unhealthy.  ``sleep``/``clock`` are injectable for deterministic
    chaos tests.  ``device`` picks ``default_chain(device)`` when no
    chain is given.
    """

    def __init__(self, *, chain: Optional[Sequence[str]] = None,
                 retry: RetryPolicy = RetryPolicy(),
                 breaker: Optional[CircuitBreaker] = None,
                 registry: Optional[StaticPlanRegistry] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 shadow_rate: float = 0.0, shadow_seed: int = 0,
                 shadow_backend: str = "reference", device=None):
        self.chain = (tuple(chain) if chain is not None
                      else default_chain(device))
        if not self.chain:
            raise ValueError("fallback chain must name at least one backend")
        if not 0.0 <= shadow_rate <= 1.0:
            raise ValueError(f"shadow_rate must be in [0, 1], got "
                             f"{shadow_rate}")
        self.retry = retry
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            clock=clock)
        self.registry = registry
        self.sleep = sleep
        self.clock = clock
        # Shadow audits: a seed-deterministic fraction of successful
        # executions is re-run on the reference backend and compared
        # bit-exactly — the end-to-end check that catches corruption a
        # cache digest cannot see (e.g. a source array poisoned before
        # its first seal).  One RNG draw per audited-eligible success
        # keeps the sampled batch indices reproducible under a seed.
        self.shadow_rate = shadow_rate
        self.shadow_seed = shadow_seed
        self.shadow_backend = shadow_backend
        self._shadow_rng = np.random.default_rng(shadow_seed)
        self._shadow_lock = threading.Lock()

    # -- core ---------------------------------------------------------------

    def execute(self, op: str, geometry: Sequence, run: Callable[[str], object],
                *, chain: Optional[Sequence[str]] = None,
                deadline: Optional[float] = None,
                registry_keys: Union[Sequence[str],
                                     Callable[[str], Sequence[str]], None]
                = None) -> ResilientResult:
        """Run ``run(backend)`` through the chain until one answers.

        Args:
          op / geometry: the breaker key prefix — one op at one padded
            bucket geometry is one health domain.
          run: executes the operation on the named backend and returns
            the result; any exception is classified and handled.
          chain: per-call chain override (defaults to the executor's).
          deadline: absolute ``clock()`` time after which attempts stop
            with ``TimeoutFault`` (checked between attempts; a running
            attempt is never interrupted mid-flight).
          registry_keys: static-registry keys involved per backend —
            either a sequence or a ``backend -> keys`` callable.  On
            drift, these entries are quarantined and the backend retried
            once; a repeat quarantine of the same entry escalates.
        Returns:
          ``ResilientResult`` (value + which backend answered + ledger).
        Raises:
          The last typed ``Fault`` when every allowed backend failed;
          a build failure or a missing card as it came (never
          classified, never a fallback).
        """
        use_chain = tuple(chain) if chain is not None else self.chain
        geometry = tuple(geometry)
        faults: list = []
        attempts = 0
        last_fault: Optional[Fault] = None

        with _obs.span("resilient_execute", op=op) as sp:
            for chain_index, backend in enumerate(use_chain):
                key = (op, geometry, backend)
                if not self.breaker.allow(key):
                    telemetry.incr("resilience_breaker_skips")
                    faults.append((backend, "BreakerOpen", "circuit open"))
                    sp.event("breaker_skip", backend=backend)
                    continue
                if self.breaker.state(key) == "half_open":
                    telemetry.incr("resilience_breaker_probes")
                    sp.event("breaker_probe", backend=backend)
                drift_quarantined = False
                attempt = 0
                while attempt < self.retry.max_attempts:
                    if deadline is not None and self.clock() >= deadline:
                        telemetry.incr("resilience_timeouts")
                        raise TimeoutFault(
                            f"{op}{geometry}: deadline expired before "
                            f"backend {backend!r} attempt {attempt}")
                    try:
                        attempts += 1
                        value = run(backend)
                    except Exception as e:  # noqa: BLE001 — classify
                        if is_build_failure(e):
                            raise
                        fault_cls = classify(e)
                        faults.append((backend, fault_cls.__name__, str(e)))
                        telemetry.incr("resilience_faults")
                        # Any fault arms always-verify-on-next-hit for
                        # every guarded cache entry: whatever just went
                        # wrong, the next touch of each cached schedule
                        # / lift / program re-checks its digest.
                        _integrity.force_verify()
                        sp.event("fault", backend=backend,
                                 fault=fault_cls.__name__)
                        if self.breaker.record_failure(key):
                            telemetry.incr("resilience_breaker_trips")
                            sp.event("breaker_trip", backend=backend)
                        last_fault = fault_cls(
                            f"{op}{geometry}: backend {backend!r} failed "
                            f"(attempt {attempt + 1}): {e}")
                        last_fault.__cause__ = e
                        if fault_cls is TimeoutFault:
                            telemetry.incr("resilience_timeouts")
                            raise last_fault
                        if fault_cls in (DriftFault, IntegrityFault):
                            if (self.registry is not None and registry_keys
                                    and not drift_quarantined):
                                keys = (registry_keys(backend)
                                        if callable(registry_keys)
                                        else registry_keys)
                                counts = [self.registry.quarantine(k)
                                          for k in keys]
                                telemetry.incr("resilience_quarantines")
                                sp.event("quarantine", backend=backend,
                                         fault=fault_cls.__name__)
                                drift_quarantined = True
                                if counts and max(counts) <= 1:
                                    # First drift/corruption of these
                                    # entries: they were evicted and
                                    # will rebuild lazily — one free
                                    # retry on the same backend.
                                    continue
                            if fault_cls is DriftFault:
                                telemetry.incr(
                                    "resilience_drift_escalations")
                                break  # repeat drift: escalate
                            # IntegrityFault without registry keys (or
                            # a repeat): the poisoned cache entry was
                            # already evicted when the error was
                            # raised, so the bounded-retry path below
                            # recompiles — fall through.
                        attempt += 1
                        if (attempt < self.retry.max_attempts
                                and issubclass(fault_cls,
                                               self.retry.retryable)):
                            telemetry.incr("resilience_retries")
                            sp.event("retry", backend=backend,
                                     attempt=attempt)
                            backoff = self.retry.backoff_s(attempt - 1)
                            if backoff > 0:
                                self.sleep(backoff)
                            continue
                        break  # non-retryable or attempts exhausted
                    else:
                        self.breaker.record_success(key)
                        if self._shadow_due(backend):
                            value, backend = self._shadow_audit(
                                op, geometry, backend, run, value,
                                registry_keys, sp,
                                serve=self.shadow_backend in use_chain)
                        telemetry.incr(f"resilience_backend_{backend}")
                        if chain_index > 0:
                            telemetry.incr("resilience_fallbacks")
                            sp.event("fallback", backend=backend,
                                     chain_index=chain_index)
                        sp.set(backend=backend, attempts=attempts,
                               chain_index=chain_index)
                        return ResilientResult(value, backend, chain_index,
                                               attempts, faults)
            telemetry.incr("resilience_exhausted")
            sp.set(attempts=attempts, exhausted=True)
            if last_fault is None:
                last_fault = LaunchFault(
                    f"{op}{geometry}: every backend in {use_chain} is "
                    "circuit-open; no attempt was possible")
            raise last_fault

    # -- shadow audits ------------------------------------------------------

    def _shadow_due(self, backend: str) -> bool:
        """Seed-deterministic per-success sampling decision.  Results
        produced *by* the shadow backend are never audited against
        themselves."""
        if self.shadow_rate <= 0.0 or backend == self.shadow_backend:
            return False
        with self._shadow_lock:
            return float(self._shadow_rng.random()) < self.shadow_rate

    def _shadow_audit(self, op: str, geometry: tuple, backend: str,
                      run: Callable[[str], object], value, registry_keys,
                      sp, *, serve: bool = True) -> tuple:
        """Re-execute on the shadow (reference) backend and compare
        bit-exactly.  On mismatch: count, trace, arm always-verify,
        quarantine the declared registry entries, and serve the
        *reference* value when the chain may serve it (``serve``), else
        raise ``IntegrityFault`` — a suspect primary result never leaves
        the executor, and a backend outside the chain (plain PyTorch on
        the card) never answers.  Returns (value, backend_name)."""
        telemetry.incr("shadow_audits")
        sp.event("shadow_audit", backend=backend)
        try:
            ref = run(self.shadow_backend)
        except Exception as e:  # noqa: BLE001 — audit must not fail serving
            telemetry.incr("shadow_audit_errors")
            sp.event("shadow_audit_error", backend=self.shadow_backend,
                     error=type(e).__name__)
            return value, backend
        if _bit_exact(value, ref):
            return value, backend
        telemetry.incr("shadow_mismatches")
        sp.event("shadow_mismatch", backend=backend)
        _obs.event("shadow_mismatch", op=op, backend=backend,
                   shadow=self.shadow_backend)
        _integrity.force_verify()
        if self.registry is not None and registry_keys:
            keys = (registry_keys(backend) if callable(registry_keys)
                    else registry_keys)
            for k in keys:
                self.registry.quarantine(k)
            if keys:
                telemetry.incr("resilience_quarantines")
        if not serve:
            raise IntegrityFault(
                f"{op}{geometry}: backend {backend!r} disagreed with the "
                f"shadow {self.shadow_backend!r}, which this chain does "
                "not serve")
        return ref, self.shadow_backend


def _bit_exact(a, b) -> bool:
    """Bit-exact structural equality for audit comparisons: bytes
    compare as bytes, arrays and tensors as (shape, dtype, raw bytes),
    containers recursively.  The engine's backends promise bit-exact
    agreement (integer/GF(2^k) datapaths), so any difference is a
    defect, not tolerance noise."""
    if a is None or b is None:
        return a is b
    if isinstance(a, (bytes, bytearray)):
        return isinstance(b, (bytes, bytearray)) and bytes(a) == bytes(b)
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_bit_exact(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_bit_exact(v, b[k]) for k, v in a.items()))
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
            return False
        return (a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(a.cpu(), b.cpu()))
    aa, bb = np.asarray(a), np.asarray(b)
    return (aa.shape == bb.shape and aa.dtype == bb.dtype
            and aa.tobytes() == bb.tobytes())


# ---------------------------------------------------------------------------
# Per-device health: mesh membership as a breaker domain
# ---------------------------------------------------------------------------

class DeviceHealth:
    """Per-DEVICE circuit breakers for mesh-sharded execution.

    The backend chain above answers "which *implementation* is healthy";
    this answers "which *devices* are" — a device being a mesh shard,
    named by its mesh index (shards may share a card).  The distinction
    matters on a mesh: one sick device must not trip the whole backend (the
    implementation is fine on the seven others) — it should drop out of
    the mesh, and the serving layer rebuilds on a survivor mesh
    (``dist.fault.survivor_mesh_shape``) of the remaining devices.

    Reuses ``CircuitBreaker`` under ``("device", index)`` keys, so sick
    devices re-probe after the cooldown and rejoin on success.  Health
    reads use ``state()`` (side-effect free); ``allow()`` is reserved
    for the actual probe attempt because it arms the half-open latch.
    """

    def __init__(self, n_devices: int, *,
                 breaker: Optional[CircuitBreaker] = None,
                 threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if n_devices < 1:
            raise ValueError(f"DeviceHealth: n_devices={n_devices} must be "
                             ">= 1")
        self.n_devices = n_devices
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            threshold=threshold, cooldown_s=cooldown_s, clock=clock)

    @staticmethod
    def key(device: int) -> tuple:
        return ("device", int(device))

    def _check(self, device: int) -> None:
        if not (0 <= device < self.n_devices):
            raise ValueError(f"DeviceHealth: device {device} out of range "
                             f"[0, {self.n_devices})")

    def record_success(self, device: int) -> None:
        self._check(device)
        self.breaker.record_success(self.key(device))

    def record_failure(self, device: int) -> bool:
        """Count a device fault; True when this one trips the device out
        of the active mesh."""
        self._check(device)
        tripped = self.breaker.record_failure(self.key(device))
        if tripped:
            telemetry.incr("device_trips")
        return tripped

    def is_healthy(self, device: int) -> bool:
        self._check(device)
        return self.breaker.state(self.key(device)) != "open"

    def healthy(self) -> list:
        """Device indices currently allowed on the mesh (half-open
        devices count: they are due a probe)."""
        return [d for d in range(self.n_devices) if self.is_healthy(d)]

    def lost(self) -> list:
        return [d for d in range(self.n_devices) if not self.is_healthy(d)]
