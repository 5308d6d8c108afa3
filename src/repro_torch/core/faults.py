"""Deterministic, seed-driven fault injection for the execution stack.

Port of ``repro.core.faults``.  Every degradation path in
``core.resilience`` is exercisable without real hardware failures: this
harness patches the execution choke points —

* ``crossbar.apply_plan``          (every per-pass backend),
* ``crossbar.compile_plan``        (schedule compilation, incl. the
  fingerprinting done by fixed-latency observation),
* ``plan_program._run_megakernel`` (the single-launch fused executor),
* ``dist.mesh_exec._collective_round`` (each non-empty round of a
  sharded plan's copy schedule, as it is derived),
* ``serve.batching._staging_put``  (the double-buffer staging queue
  between the prep thread and the device feed) —

and raises typed *injected* failures at seed-determined call indices.
Every call site reaches these functions through module-attribute lookup
(``xb.apply_plan(...)``, the module global ``_run_megakernel``), so
patching the module attributes intercepts the whole engine.  The RNG
draw happens on *every* intercepted call in program order, in the
reference's order, so a seed gives the same fault ledger as the
reference for the same call sequence.  ``inject_device_fault`` kills
one mesh shard mid-batch through ``serve.batching._shard_probe``.

A sixth site, ``corrupt``, injects *silent* damage instead of raising:
``corrupt_cache`` flips one bit in a cached tile schedule, GF(2^k) lift
or program constants block; the ``core.integrity`` guards, the
fixed-latency fingerprints and the shadow audits must refuse to serve
the result.  On a flipped constants block the program's control tables
are rebuilt from the flipped block, so the damage reaches what the next
launch reads (the card's megakernel reads its device control, not
``program.consts``); the registry's ``CONST_GUARD`` check on the
program lookup, which precedes every launch, and the program
fingerprint of a fixed-latency call are what refuse it.

Schedule *drift* is injected by ``poison_observations``: it corrupts
the recorded fixed-latency signatures of a ``StaticPlanRegistry`` so the
next observed call raises a genuine ``FixedLatencyError``.

Usage::

    with faults.inject_faults(seed=7, launch_rate=0.01) as inj:
        serve_lots_of_requests()
    assert inj.count == len(inj.injected)   # the deterministic ledger

    # Only the megakernel launches, nothing else:
    with faults.inject_faults(seed=3, program_rate=1.0,
                              sites=("program",), max_faults=1):
        seal_records()
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import crossbar as xb
from repro_torch.core import plan_program as pp

class InjectedFault(RuntimeError):
    """Base marker: a harness-injected failure, never a real engine bug."""


class InjectedCompileFailure(InjectedFault):
    """Injected at ``compile_plan`` (classified as ``CompileFault``)."""


class InjectedLaunchFailure(InjectedFault):
    """Injected at ``apply_plan`` (classified as ``LaunchFault``)."""


class InjectedProgramFailure(InjectedLaunchFailure):
    """Injected at the megakernel executor (a launch-class fault)."""


class InjectedCollectiveFailure(InjectedLaunchFailure):
    """Injected at a collective round of a sharded plan (a launch-class
    fault)."""


class InjectedStagingFailure(InjectedFault):
    """Injected at the serving staging queue: the prepared batch is
    dropped before the device feed sees it.  Handled by the prep loop
    (requeue + ``serve_staging_drops``), never by the executor."""


class InjectedDeviceFailure(InjectedLaunchFailure):
    """A specific mesh shard failed mid-batch (carries ``.device``, the
    shard's mesh index)."""

    def __init__(self, device: int, msg: Optional[str] = None):
        super().__init__(msg or f"injected failure on device {device}")
        self.device = int(device)


# The interception points, in the order their rates are declared (the
# reference's).
SITES = ("compile", "apply", "program", "slow", "collective", "staging",
         "corrupt")


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault scheduler shared by the patched sites.

    ``rates`` maps site -> probability that one call at that site
    faults; a fresh RNG draw is consumed per intercepted call whether or
    not the site is armed, so the schedule is a pure function of the
    seed and the call sequence.  ``max_faults`` bounds the total number
    of injections (the "transient burst" regime: N faults, then the
    fleet heals).  ``injected`` is the ledger of (site, call-index)
    pairs actually fired.
    """

    seed: int = 0
    rates: dict = dataclasses.field(default_factory=dict)
    max_faults: Optional[int] = None
    slow_s: float = 0.0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.calls = {s: 0 for s in SITES}
        self.injected: list = []

    @property
    def count(self) -> int:
        return len(self.injected)

    def should_fire(self, site: str) -> bool:
        index = self.calls[site]
        self.calls[site] += 1
        draw = float(self._rng.random())
        if self.max_faults is not None and self.count >= self.max_faults:
            return False
        if draw >= self.rates.get(site, 0.0):
            return False
        self.injected.append((site, index))
        return True


@contextlib.contextmanager
def inject_faults(*, seed: int = 0, compile_rate: float = 0.0,
                  launch_rate: float = 0.0, program_rate: float = 0.0,
                  slow_rate: float = 0.0, slow_s: float = 0.0,
                  collective_rate: float = 0.0, staging_rate: float = 0.0,
                  staging_mode: str = "drop",
                  corrupt_cache_rate: float = 0.0,
                  sites: Optional[Sequence[str]] = None,
                  max_faults: Optional[int] = None):
    """Patch the engine's choke points with a deterministic fault plan.

    Args:
      seed: RNG seed; same seed + same call sequence = same faults.
      compile_rate: per-call fault probability at ``compile_plan``.
      launch_rate: per-call fault probability at ``apply_plan``.
      program_rate: per-call fault probability at the megakernel
        executor (fires *before* the launch).
      slow_rate / slow_s: probability and duration of an injected stall
        at ``apply_plan`` (deadline/straggler testing).
      collective_rate: per-round fault probability at the collective
        schedule derivation (``mesh_exec._collective_round``) — one draw
        per non-empty round of a sharded plan's build.
      staging_rate: per-put fault probability at the serving staging
        queue (``serve.batching._staging_put``).
      staging_mode: what a fired staging fault does — ``"drop"`` raises
        ``InjectedStagingFailure`` (the prep loop requeues the batch),
        ``"stall"`` sleeps ``slow_s`` then delivers (double-buffer
        backpressure testing).
      corrupt_cache_rate: per-intercepted-call probability (drawn at
        apply and megakernel interceptions) of silently flipping one
        bit in a randomly chosen cached schedule / lift / constants
        block (``corrupt_cache``).  Nothing raises at the injection
        point — detection is ``core.integrity``'s job.
      sites: optional site whitelist (names from ``SITES``).  When
        given, only the listed sites are armed — e.g.
        ``sites=("program",)`` targets the megakernel launches while
        leaving routing compilation untouched.
      max_faults: total injection budget across all sites (transient
        bursts; ``None`` = unbounded).
    Yields:
      The ``FaultInjector`` (ledger + per-site call counts).
    """
    if staging_mode not in ("drop", "stall"):
        raise ValueError(f"staging_mode must be 'drop' or 'stall', got "
                         f"{staging_mode!r}")
    rates = {"compile": compile_rate, "apply": launch_rate,
             "program": program_rate, "slow": slow_rate,
             "collective": collective_rate, "staging": staging_rate,
             "corrupt": corrupt_cache_rate}
    if sites is not None:
        unknown = set(sites) - set(SITES)
        if unknown:
            raise ValueError(f"unknown fault sites {sorted(unknown)}; "
                             f"valid: {SITES}")
        rates = {s: (r if s in sites else 0.0) for s, r in rates.items()}
    inj = FaultInjector(seed=seed, rates=rates, max_faults=max_faults,
                        slow_s=slow_s)
    corrupt_rng = np.random.default_rng(seed + 0x5EED)
    orig_apply = xb.apply_plan
    orig_compile = xb.compile_plan
    orig_mega = pp._run_megakernel

    def apply_wrapper(plan, x, **kw):
        if inj.should_fire("slow"):
            time.sleep(inj.slow_s)
        if inj.should_fire("corrupt"):
            corrupt_cache(corrupt_rng)
        if inj.should_fire("apply"):
            raise InjectedLaunchFailure(
                f"injected crossbar launch failure "
                f"(apply call #{inj.calls['apply'] - 1}, seed {inj.seed})")
        return orig_apply(plan, x, **kw)

    def compile_wrapper(plan, **kw):
        if inj.should_fire("compile"):
            raise InjectedCompileFailure(
                f"injected schedule compilation failure "
                f"(compile call #{inj.calls['compile'] - 1}, "
                f"seed {inj.seed})")
        return orig_compile(plan, **kw)

    def mega_wrapper(program, x2):
        if inj.should_fire("corrupt"):
            corrupt_cache(corrupt_rng)
        if inj.should_fire("program"):
            raise InjectedProgramFailure(
                f"injected megakernel launch failure "
                f"(program call #{inj.calls['program'] - 1}, "
                f"seed {inj.seed})")
        return orig_mega(program, x2)

    xb.apply_plan = apply_wrapper
    xb.compile_plan = compile_wrapper
    pp._run_megakernel = mega_wrapper

    # The collective and staging sites live in optional layers (dist/,
    # serve/); patch them only when armed so core-only chaos tests do
    # not import either package.
    mx = sb = None
    orig_round = orig_put = None
    if rates.get("collective", 0.0) > 0.0:
        from repro_torch.dist import mesh_exec as mx
        orig_round = mx._collective_round

        def round_wrapper(round_index, pairs):
            if inj.should_fire("collective"):
                raise InjectedCollectiveFailure(
                    f"injected collective failure at round {round_index} "
                    f"(pairs {pairs}, seed {inj.seed})")
            return orig_round(round_index, pairs)

        mx._collective_round = round_wrapper
    if rates.get("staging", 0.0) > 0.0:
        from repro_torch.serve import batching as sb
        orig_put = sb._staging_put

        def put_wrapper(queue, item):
            if inj.should_fire("staging"):
                if staging_mode == "stall":
                    time.sleep(inj.slow_s)
                else:
                    raise InjectedStagingFailure(
                        f"injected staging-queue drop "
                        f"(put #{inj.calls['staging'] - 1}, "
                        f"seed {inj.seed})")
            return orig_put(queue, item)

        sb._staging_put = put_wrapper
    try:
        yield inj
    finally:
        xb.apply_plan = orig_apply
        xb.compile_plan = orig_compile
        pp._run_megakernel = orig_mega
        if orig_round is not None:
            mx._collective_round = orig_round
        if orig_put is not None:
            sb._staging_put = orig_put


def _flip_random_bit(arr: np.ndarray, rng) -> None:
    """Flip one rng-chosen bit of a contiguous numpy array, in place."""
    flat = arr.reshape(-1).view(np.uint8)
    i = int(rng.integers(flat.size))
    flat[i] ^= np.uint8(1 << int(rng.integers(8)))


def _flipped(t: torch.Tensor, rng) -> torch.Tensor:
    """A copy of ``t`` on its device with one rng-chosen bit flipped."""
    host = t.cpu().numpy().copy()
    _flip_random_bit(host, rng)
    return torch.as_tensor(host, device=t.device)


def corrupt_cache(rng=None, *, target: Optional[str] = None):
    """Flip one bit in a randomly chosen cached control structure.

    Targets (``target=None`` picks uniformly among the non-empty ones):

    * ``"schedule"`` — a compiled tile schedule's active-pair list
      (pinned or LRU).  The cache key survives, so the poisoned schedule
      keeps hitting until a digest check catches it.
    * ``"lift"`` — a cached GF(2^k) bit-lift plan's index array, which
      the crossbar kernels read.
    * ``"const"`` — a cached program's constants block, flipped in place
      (also reflected in the registry's sealed consts and the program
      fingerprint), and the program's control tables on that device
      rebuilt from it, so the next launch reads the flip.

    Returns ``(target, key)`` describing what was corrupted, or ``None``
    when no cache of the requested family holds an entry yet.  Nothing
    is raised here: detection is ``core.integrity``'s job.
    """
    rng = np.random.default_rng() if rng is None else rng
    candidates = []
    if target in (None, "schedule"):
        for key, compiled in list(xb._PINNED_COMPILE.items()) + \
                list(xb._COMPILE_CACHE.items()):
            if not isinstance(compiled.num_active, int) \
                    or compiled.num_active == 0:
                continue
            candidates.append(("schedule", key, compiled))
    if target in (None, "lift"):
        for key, entry in xb._LIFT_CACHE.items():
            candidates.append(("lift", key, entry[0]))
    if target in (None, "const"):
        for key, entry in pp._EXEC_CACHE.items():
            if entry[0].consts is not None:
                candidates.append(("const", key, entry))
    if not candidates:
        return None
    kind, key, obj = candidates[int(rng.integers(len(candidates)))]
    if kind == "schedule":
        obj.pair_o = _flipped(obj.pair_o, rng)
    elif kind == "lift":
        obj.idx = _flipped(obj.idx, rng)
    else:
        program, ctl = obj
        _flip_random_bit(program.consts, rng)
        ctl.update(pp.build_control(program, ctl["steps"].device))
    return kind, key


@contextlib.contextmanager
def inject_device_fault(device: int, *, max_fires: int = 1):
    """Kill one mesh shard mid-batch, deterministically.

    Patches the serving layer's per-shard dispatch probe
    (``serve.batching._shard_probe``) so the next ``max_fires`` shards
    dispatched to mesh index ``device`` raise ``InjectedDeviceFailure``
    — *after* earlier shards of the same batch have completed, which is
    the partial-batch regime: the engine must salvage the finished
    shards' lanes and replay only the lost ones on the survivor mesh.
    ``device`` is a mesh index, not a ``torch.device`` (shards may share
    a card).  Yields a dict whose ``"fired"`` entry counts the
    injections.
    """
    from repro_torch.serve import batching as sb
    orig = sb._shard_probe
    state = {"fired": 0}

    def probe(shard_index, dev_index):
        orig(shard_index, dev_index)
        if dev_index == device and state["fired"] < max_fires:
            state["fired"] += 1
            raise InjectedDeviceFailure(
                device, f"injected device failure (shard {shard_index} "
                        f"on device {dev_index})")

    sb._shard_probe = probe
    try:
        yield state
    finally:
        sb._shard_probe = orig


def poison_observations(registry, *, site: Optional[str] = None) -> int:
    """Corrupt recorded fixed-latency signatures in ``registry``.

    The next ``observe`` under a poisoned key then fails its signature
    comparison and raises a genuine ``FixedLatencyError`` — injected
    schedule drift that flows through the real contract checker,
    exercising quarantine/re-registration end-to-end.

    ``site`` filters by observation name substring, so drift can be
    aimed at one serving path without perturbing the rest::

        faults.poison_observations(registry(dev))              # everything
        faults.poison_observations(registry(dev), site="gcm")  # GCM only
        faults.poison_observations(registry(dev), site="keccak")

    Returns the number of signatures poisoned (0 means nothing matching
    was observed yet and no drift can fire).
    """
    poisoned = 0
    for key in list(registry._observed):
        if site is not None and site not in str(key[0]):
            continue
        registry._observed[key] = ("__injected_drift__",)
        poisoned += 1
    return poisoned
