"""Compile-once plan registries and the fixed-latency contract.

Port of ``repro.core.static_registry``.  ``StaticPlanRegistry`` holds
named static plans and whole ``PlanProgram`` schedules, pins their tile
schedules (immune to LRU churn) and seals program constants;
``observe`` records an observed block's signature — crossbar passes,
program launches, and the schedule / program fingerprints it declares —
on first execution per (op, payload shapes, backend) and raises
``FixedLatencyError`` when a later call differs.  Payload values never
enter the signature.

``execute`` runs one pass of a registered plan, observed under the
contract when asked; ``audit_host_syncs=True`` also forbids host syncs
inside the observed block (``telemetry.no_host_sync``).  Each
observation runs inside a ``registry_observe`` span and feeds the
streaming drift monitor (``obs.drift_monitor``) before its signature is
compared.  ``quarantine`` evicts a drifted entry and
``quarantine_count`` reads its history (``core.resilience`` escalates on
a repeat).

``audit_constant_time`` proves statically that a region's schedule
cannot read payload values: it runs the region under ``FakeTensorMode``
(abstract evaluation, the reference's ``jax.eval_shape``), where a read
of a payload-derived value raises.  Plans, schedules and program tables
are static control and are built and read for real under it
(``core.abstract.concrete``); no cache keeps a fake tensor.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           FakeTensorMode)

from repro_torch import obs as _obs
from repro_torch._tree import tree_map
from repro_torch.core import abstract as _abstract
from repro_torch.core import crossbar as xb
from repro_torch.core import integrity as _integrity
from repro_torch.core import plan_program as pp
from repro_torch.core import telemetry


class FixedLatencyError(AssertionError):
    """A fixed-latency operation changed schedule/pass-count across calls."""


# ``audit_constant_time``'s abstract output: a tensor's shape and dtype.
ShapeDtype = collections.namedtuple("ShapeDtype", ("shape", "dtype"))

# What torch raises for ``.numpy()`` on a fake tensor.
_FAKE_NUMPY_MESSAGE = ".numpy() is not supported for tensor subclasses"


def _built_static(registry: str, key: str, builder: Callable):
    """Run a static builder on real tensors, as the reference builds under
    ``jax.ensure_compile_time_eval``; a result derived from a payload
    (a fake tensor under the audit) is refused, never registered."""
    with _abstract.concrete():
        built = builder()
    if _abstract.holds_fake(built) or (
            isinstance(built, pp.PlanProgram)
            and _abstract.holds_fake(built.plans)):
        raise FixedLatencyError(
            f"{registry}:{key}: static control built from payload values "
            "(a value-dependent host sync waiting to happen) — a "
            "registered plan must derive from static information alone")
    return built


def schedule_fingerprint(plan: xb.PermutePlan, *, block_o: int = 128,
                         block_n: int = 128) -> tuple:
    """Value-level identity of a plan's compiled schedule (geometry,
    selects, occupied-tile count) — a pinned-cache hit when steady.  A
    GF(2^k) plan executes as its GF(2) bit lift, so the lifted plan's
    schedule is pinned and fingerprinted too."""
    compiled = xb.compile_plan(plan, block_o=block_o, block_n=block_n,
                               pin=True)
    fp = (plan.mode, plan.n_in, plan.n_out, plan.k, plan.semiring.name,
          compiled.n_o_tiles, compiled.n_n_tiles, compiled.num_active)
    if plan.semiring.is_gf2k:
        lifted = xb.lift_gf2_k(plan)
        lc = xb.compile_plan(lifted, block_o=block_o, block_n=block_n,
                             pin=True)
        fp = fp + (("lift", lifted.n_in, lifted.n_out, lifted.k,
                    lc.n_o_tiles, lc.n_n_tiles, lc.num_active),)
    return fp


def program_step_fingerprint(program: pp.PlanProgram, step) -> tuple:
    """PERMUTE steps carry their plan's schedule fingerprint; the others
    their opcode, wiring and constant slot."""
    if step.op == "permute":
        return (step.op, step.dst, step.a,
                schedule_fingerprint(program.plans[step.plan]))
    if step.const >= 0:
        return (step.op, step.dst, step.a, step.const)
    return (step.op, step.dst, step.a, step.b)


class StaticPlanRegistry:
    """Named static plans, compiled once, executed under a latency contract."""

    def __init__(self, name: str):
        self.name = name
        self._plans: Dict[str, xb.PermutePlan] = {}
        self._programs: Dict[str, pp.PlanProgram] = {}
        self._observed: Dict[tuple, tuple] = {}
        self._quarantined: Dict[str, int] = {}

    # -- registration -------------------------------------------------------

    def register(self, key: str, plan: xb.PermutePlan, *,
                 precompile: bool = True) -> xb.PermutePlan:
        """Register a static plan (double registration is an error);
        ``precompile`` pins its tile schedule at once."""
        if key in self._plans:
            raise ValueError(
                f"plan {key!r} already registered in {self.name!r}; "
                "static plans are immutable — use a new key")
        self._plans[key] = plan
        if precompile:
            xb.compile_plan(plan, pin=True)
            if plan.semiring.is_gf2k:
                # pin the executed (bit-lifted) schedule as well
                xb.compile_plan(xb.lift_gf2_k(plan), pin=True)
        return plan

    def get_or_register(self, key: str,
                        builder: Callable[[], xb.PermutePlan], *,
                        precompile: bool = True) -> xb.PermutePlan:
        """Idempotent registration: build only if ``key`` is absent."""
        plan = self._plans.get(key)
        if plan is None:
            plan = self.register(key, _built_static(self.name, key, builder),
                                 precompile=precompile)
        return plan

    def __contains__(self, key: str) -> bool:
        return key in self._plans

    def __getitem__(self, key: str) -> xb.PermutePlan:
        try:
            return self._plans[key]
        except KeyError:
            raise KeyError(
                f"no plan {key!r} in static registry {self.name!r} "
                f"(registered: {sorted(self._plans)})") from None

    def keys(self):
        return self._plans.keys()

    def batch_variant(self, key: str, b: int) -> Tuple[xb.PermutePlan, str]:
        """The width-``b`` block-diagonal variant of a registered plan,
        registered lazily under ``"<key>_x<b>"``; returns (plan, key)."""
        base = self[key]
        if b == 1:
            return base, key
        from repro_torch.core import plan_algebra as pa
        variant_key = f"{key}_x{b}"
        return self.get_or_register(
            variant_key, lambda: pa.batch(base, b)), variant_key

    def compiled(self, key: str) -> xb.CompiledPlan:
        """The pinned schedule of a registered plan (re-pins after clears)."""
        return xb.compile_plan(self[key], pin=True)

    def fingerprint(self, key: str) -> tuple:
        return schedule_fingerprint(self[key])

    # -- whole-program registration ----------------------------------------

    def register_program(self, key: str, program: pp.PlanProgram, *,
                         precompile: bool = True) -> pp.PlanProgram:
        """Register a static program: its constants are sealed and every
        plan's tile schedule pinned."""
        if key in self._programs:
            raise ValueError(
                f"program {key!r} already registered in {self.name!r}; "
                "static programs are immutable — use a new key")
        self._programs[key] = program
        _integrity.CONST_GUARD.seal((self.name, key), (program.consts,))
        if precompile:
            for plan in program.plans:
                xb.compile_plan(plan, pin=True)
        return program

    def get_or_register_program(self, key: str, builder: Callable, *,
                                precompile: bool = True) -> pp.PlanProgram:
        program = self._programs.get(key)
        if program is None:
            program = self.register_program(
                key, _built_static(self.name, key, builder),
                precompile=precompile)
        else:
            self._verify_program(key, program)
        return program

    def program(self, key: str) -> pp.PlanProgram:
        try:
            program = self._programs[key]
        except KeyError:
            raise KeyError(
                f"no program {key!r} in static registry {self.name!r} "
                f"(registered: {sorted(self._programs)})") from None
        self._verify_program(key, program)
        return program

    def _verify_program(self, key: str, program: pp.PlanProgram) -> None:
        """Sampled consts-digest check on lookup; a mismatch evicts."""
        _integrity.CONST_GUARD.verify(
            (self.name, key), lambda: (program.consts,),
            evict=lambda: self._evict_program(key))

    def _evict_program(self, key: str) -> None:
        program = self._programs.pop(key, None)
        if program is not None:
            for plan in program.plans:
                xb.unpin_plan(plan)

    def program_fingerprint(self, key: str) -> tuple:
        """Per-step fingerprints in step order, plus trip count, constant
        stride and a digest of the constants table."""
        program = self.program(key)
        consts_digest = (None if program.consts is None else
                         hashlib.sha256(
                             program.consts.tobytes()).hexdigest()[:16])
        return (program.n, program.n_regs, program.rounds,
                program.const_stride, len(program.steps), consts_digest,
                tuple(program_step_fingerprint(program, s)
                      for s in program.steps))

    def info(self) -> dict:
        return {"name": self.name, "plans": len(self._plans),
                "programs": len(self._programs),
                "observed_signatures": len(self._observed),
                "quarantines": sum(self._quarantined.values())}

    # -- quarantine ---------------------------------------------------------

    def quarantine(self, key: str) -> int:
        """Evict an entry and its batch variants, unpin their schedules
        and forget every recorded signature; returns how many times
        ``key`` has been quarantined."""
        evicted: list = []
        for k in list(self._plans):
            if k == key or k.startswith(key + "_x"):
                evicted.append(self._plans.pop(k))
        for k in list(self._programs):
            if k == key or k.startswith(key + "_x"):
                evicted.extend(self._programs.pop(k).plans)
                _integrity.CONST_GUARD.drop((self.name, k))
        for plan in evicted:
            xb.unpin_plan(plan)
        self._observed.clear()
        self._quarantined[key] = self._quarantined.get(key, 0) + 1
        return self._quarantined[key]

    def quarantine_count(self, key: str) -> int:
        """How many times ``key`` has been quarantined since the last
        ``reset_observations``."""
        return self._quarantined.get(key, 0)

    # -- fixed-latency contract --------------------------------------------

    def reset_observations(self) -> None:
        """Forget recorded signatures and quarantine history; keep plans."""
        self._observed.clear()
        self._quarantined.clear()

    @contextlib.contextmanager
    def observe(self, name: Any, *, shapes: Sequence = (),
                backend: Optional[str] = None,
                plan_keys: Sequence[str] = (),
                program_keys: Sequence[str] = (),
                expect_apply_calls: Optional[int] = None,
                expect_program_launches: Optional[int] = None,
                audit_host_syncs: bool = False):
        """Assert the wrapped block's schedule signature is call-invariant
        for this (name, shapes, backend), and optionally its exact pass
        and program-launch counts.

        ``audit_host_syncs=True`` also forbids host syncs inside the block
        (``telemetry.no_host_sync``): a scalar read of any tensor, or on a
        card any synchronizing CUDA call, raises ``FixedLatencyError``; so
        does a fake tensor's refusal of a value read
        (``DataDependentOutputException``) when the block runs under a
        fake mode.  Zero-copy reads of CPU tensors stay invisible to it:
        ``audit_constant_time`` is the device-independent static check.
        """
        audit = (telemetry.no_host_sync() if audit_host_syncs
                 else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with _obs.span("registry_observe", op=str(name),
                           registry=self.name, backend=backend or ""), \
                    telemetry.delta() as d, audit:
                yield
        except telemetry.HostSyncError as e:
            raise FixedLatencyError(
                f"{self.name}:{name}: value-dependent host sync inside "
                f"an observed fixed-latency region — {e}") from e
        except DataDependentOutputException as e:
            if not audit_host_syncs:
                raise
            raise FixedLatencyError(
                f"{self.name}:{name}: read of a fake tensor's value "
                f"inside an observed fixed-latency region — {e}") from e
        delta = d()
        calls = delta["apply_calls"]
        if expect_apply_calls is not None and calls != expect_apply_calls:
            raise FixedLatencyError(
                f"{self.name}:{name}: expected {expect_apply_calls} "
                f"crossbar passes, executed {calls}")
        launches = delta["program_launches"]
        if (expect_program_launches is not None
                and launches != expect_program_launches):
            raise FixedLatencyError(
                f"{self.name}:{name}: expected {expect_program_launches} "
                f"program launches, executed {launches}")
        sig = (calls, tuple(self.fingerprint(k) for k in plan_keys))
        if program_keys or expect_program_launches is not None:
            sig = sig + (launches,
                         tuple(self.program_fingerprint(k)
                               for k in program_keys))
        # The drift monitor sees every observation, the one about to
        # raise FixedLatencyError included.
        _obs.drift_monitor.observe(f"{self.name}:{name}", passes=calls,
                                   fingerprint=sig[1:],
                                   wall_s=time.perf_counter() - t0)
        key = (name, tuple(shapes), backend)
        prev = self._observed.get(key)
        if prev is None:
            self._observed[key] = sig
        elif prev != sig:
            raise FixedLatencyError(
                f"{self.name}:{name} violated the fixed-latency contract "
                f"for shapes={tuple(shapes)} backend={backend!r}: first "
                f"call signature {prev} != this call {sig}")

    def audit_constant_time(self, name: Any, fn: Callable, *example_args,
                            **example_kwargs):
        """Statically assert ``fn``'s schedule cannot read payload values.

        The region is abstract-evaluated: ``fn`` runs under
        ``FakeTensorMode`` with every tensor argument replaced by a fake
        tensor of the same shape, dtype and device.  Any value-dependent
        host sync in the implementation — ``int()`` / ``.item()`` /
        ``.tolist()`` / ``.numpy()`` of a payload-derived value, a
        data-dependent Python branch — raises, and becomes
        ``FixedLatencyError``.  No data moves and no FLOPs run.  Static
        control (plans, schedules, program tables) is built and read for
        real, and no cache keeps a fake tensor afterwards.

        Returns the output's ``ShapeDtype(shape, dtype)`` tree, so callers
        can pin the output geometry too.
        """
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        leaky = (f"{self.name}:{name}: implementation performs a "
                 "value-dependent host sync (int()/.item()/.numpy()/branch "
                 "on payload values) — schedule is not a function of "
                 "static control information alone. Root cause: ")
        try:
            with mode:
                args, kwargs = tree_map(
                    lambda a: (mode.from_tensor(a)
                               if isinstance(a, torch.Tensor) else a),
                    (example_args, example_kwargs))
                out = fn(*args, **kwargs)
        except DataDependentOutputException as e:
            raise FixedLatencyError(leaky + repr(e)) from e
        except RuntimeError as e:
            if _FAKE_NUMPY_MESSAGE not in str(e):
                raise
            raise FixedLatencyError(leaky + repr(e)) from e
        return tree_map(
            lambda t: (ShapeDtype(tuple(t.shape), t.dtype)
                       if isinstance(t, torch.Tensor) else t), out)

    # -- execution ----------------------------------------------------------

    def execute(self, key: str, x, *, merge=None, backend: str = "einsum",
                out_mask=None, fixed_latency: bool = False,
                audit_host_syncs: bool = False):
        """One crossbar pass of a registered plan over ``x``.

        With ``fixed_latency=True`` the pass is observed: exactly one
        ``apply_plan`` call, schedule fingerprint invariant across calls
        for this (key, payload shape/dtype, backend);
        ``audit_host_syncs=True`` also forbids host syncs during the pass
        (see ``observe``).
        """
        plan = self[key]
        if not fixed_latency:
            return xb.apply_plan(plan, x, merge=merge, backend=backend,
                                 out_mask=out_mask)
        with self.observe(("execute", key),
                          shapes=(tuple(x.shape), str(x.dtype)),
                          backend=backend, plan_keys=(key,),
                          expect_apply_calls=1,
                          audit_host_syncs=audit_host_syncs):
            out = xb.apply_plan(plan, x, merge=merge, backend=backend,
                                out_mask=out_mask)
        return out
