"""Abstract evaluation for the constant-time audit.

``StaticPlanRegistry.audit_constant_time`` runs a region under
``FakeTensorMode``: its tensors carry shape, dtype and device but no
data, and a read of a value derived from the payload raises.  The
engine's own static control (plans, schedules, program tables) is real
and has to stay real, so the places that build or read it run their
work through ``concrete(*operands)``: outside a fake mode it does
nothing; inside one it leaves the mode for the block when no operand
holds a fake tensor.  A payload-derived operand keeps the block fake, so
its reads still raise: that is the audit's finding.  ``holds_fake``
lets a cache refuse to keep what a fake block built, and
``fake_cache_entries`` lists any cache entry that holds one anyway.
"""

from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import (FakeTensor,
                                           unset_fake_temporarily)

_FAKE_KEY = torch._C._TorchDispatchModeKey.FAKE


def is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


def holds_fake(obj) -> bool:
    """True if ``obj`` — a tensor, a plan (``idx`` / ``weights``), or a
    tuple, list or dict of them — holds a fake tensor."""
    if obj is None:
        return False
    if isinstance(obj, torch.Tensor):
        return is_fake(obj)
    if isinstance(obj, (tuple, list)):
        return any(holds_fake(o) for o in obj)
    if isinstance(obj, dict):
        return any(holds_fake(o) for o in obj.values())
    idx = getattr(obj, "idx", None)
    if isinstance(idx, torch.Tensor):
        return is_fake(idx) or holds_fake(getattr(obj, "weights", None))
    return False


@contextlib.contextmanager
def concrete(*operands):
    """Run the block on real tensors when its operands are real.

    Inside a fake mode, static control work (building a plan from real
    control, compiling its schedule, digesting a cache entry, walking a
    program's step table) must run for real, or it would fail on the
    fake mode's refusal of value reads — or leave a fake tensor in a
    cache.  With a fake operand the block stays under the mode."""
    if (torch._C._get_dispatch_mode(_FAKE_KEY) is None
            or holds_fake(operands)):
        yield
        return
    with unset_fake_temporarily():
        yield


def fake_cache_entries() -> list:
    """Every entry of the engine's caches that holds a fake tensor: the
    crypto registries' plans and programs, the plan-algebra memo, the
    schedule LRU and pinned schedules, the GF(2^k) lifts and the program
    control cache.  Empty after any audit."""
    from repro_torch.core import crossbar as xb
    from repro_torch.core import plan_algebra as pa
    from repro_torch.core import plan_program as pp
    from repro_torch.crypto import registry as creg

    found = []
    for name, reg in creg._REGISTRIES.items():
        found += [("registry plan", name, k) for k, plan in
                  reg._plans.items() if holds_fake(plan)]
        found += [("registry program", name, k) for k, prog in
                  reg._programs.items() if holds_fake(prog.plans)]
    found += [("plan memo", k) for k, (plan, _) in pa._PLAN_CACHE.items()
              if holds_fake(plan)]
    for cache in (xb._COMPILE_CACHE, xb._PINNED_COMPILE):
        found += [("schedule", k) for k, c in cache.items()
                  if holds_fake((c.plan, c.occupancy, c.pair_o, c.pair_n,
                                 c.run_o, c.run_ptr, c.idle_rows))]
    found += [("lift", k) for k, (lifted, _, _) in xb._LIFT_CACHE.items()
              if holds_fake(lifted)]
    found += [("program control", k) for k, (_, ctl) in
              pp._EXEC_CACHE.items() if holds_fake(ctl)]
    return found
