"""Execution-count and cache telemetry (port of ``repro.core.telemetry``).

One aggregation point over the engine's counters: ``apply_plan`` passes
(total and by resolved backend), the schedule LRU, the plan-algebra
memo, plan-program launches and the passes they replaced, the program
control cache, and — new in the port — the launch count of every CUDA
kernel wrapper (``kernel_launches_<name>``).  ``snapshot()`` reads them
all; ``delta()`` measures a block:

    with telemetry.delta() as d:
        y = expr.apply()
    assert d()["apply_calls"] == 1

``reset()`` also resets ``repro_torch.obs`` (spans, histograms, drift
baselines) when that package is loaded.  ``no_host_sync()`` is the
host-sync audit primitive: a block inside it that reads a tensor's value
back to the host raises ``HostSyncError``.
"""

from __future__ import annotations

import contextlib
import sys
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels as _kernels
from repro_torch.core import crossbar as xb
from repro_torch.core import integrity as _integrity
from repro_torch.core import plan_algebra as pa
from repro_torch.core import plan_program as pp

_BACKENDS = ("einsum", "kernel", "sparse", "reference")



class HostSyncError(RuntimeError):
    """A device->host sync happened inside a no-host-sync region."""


LOCK = threading.RLock()
_COUNTERS: "dict[str, int]" = {}


def incr(name: str, n: int = 1) -> int:
    """Thread-safely bump a named counter; returns the new value."""
    with LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n
        return _COUNTERS[name]


def counter(name: str) -> int:
    with LOCK:
        return _COUNTERS.get(name, 0)


def snapshot() -> dict:
    """All engine counters, flattened into one dict."""
    with LOCK:
        compile_info = xb.compile_cache_info()
        plan_info = pa.plan_cache_info()
        by_backend = xb.apply_calls_by_backend()
        program_info = pp.program_cache_info()
        lift_info = xb.lift_cache_info()
        out = {
            "apply_calls": xb.apply_call_count(),
            "compile_cache_hits": compile_info["hits"],
            "compile_cache_misses": compile_info["misses"],
            "compile_cache_size": compile_info["size"],
            "plan_cache_hits": plan_info["hits"],
            "plan_cache_misses": plan_info["misses"],
            "plan_cache_size": plan_info["size"],
            "program_launches": pp.program_launch_count(),
            "program_passes_avoided": pp.passes_avoided_count(),
            "program_cache_hits": program_info["hits"],
            "program_cache_misses": program_info["misses"],
            "program_cache_size": program_info["size"],
            "lift_cache_hits": lift_info["hits"],
            "lift_cache_misses": lift_info["misses"],
            "lift_cache_size": lift_info["size"],
        }
        for b in _BACKENDS:
            out[f"apply_calls_{b}"] = by_backend.get(b, 0)
        for name, n in _kernels.launch_counts().items():
            out[f"kernel_launches_{name}"] = n
        out.update(_COUNTERS)
        return out


def reset() -> None:
    """Zero every counter and drop the caches (test isolation)."""
    with LOCK:
        xb.clear_compile_cache()
        xb.clear_lift_cache()
        xb.reset_apply_call_count()
        pa.clear_plan_cache()
        pp.reset_program_counters()
        pp.clear_program_cache()
        _integrity.reset()
        _kernels.reset_launch_counts()
        _COUNTERS.clear()
    obs = sys.modules.get("repro_torch.obs")
    if obs is not None:
        obs.reset()


@contextlib.contextmanager
def delta():
    """Yield a callable returning counter deltas since entry (sizes are
    end-state levels, everything else a difference)."""
    before = snapshot()

    def diff() -> dict:
        after = snapshot()
        out = {}
        for k in set(before) | set(after):
            if k.endswith("_size"):
                out[k] = after.get(k, 0)
            else:
                out[k] = after.get(k, 0) - before.get(k, 0)
        return out

    yield diff


class _ScalarReadGuard(TorchDispatchMode):
    """Refuses ``aten._local_scalar_dense``: the op behind ``int()``,
    ``float()``, ``bool()`` and ``.item()`` on a tensor of any device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise HostSyncError(
                "device->host sync inside a no-host-sync region: a scalar "
                f"read ({func}) of a tensor's value")
        return func(*args, **(kwargs or {}))


# The error torch raises for a synchronizing CUDA call under
# ``torch.cuda.set_sync_debug_mode("error")``.
_CUDA_SYNC_MESSAGE = "called a synchronizing cuda operation"


@contextlib.contextmanager
def no_host_sync():
    """Raise ``HostSyncError`` on a read of a tensor's value in the block.

    The constant-time audit primitive: a fixed-latency region's schedule
    must be a function of static control information only, so any
    value-dependent host sync inside it is a data-dependent-schedule bug.
    A dispatch mode refuses every scalar read (``int()`` / ``float()`` /
    ``bool()`` / ``.item()``) on any device; on a machine with a card,
    ``torch.cuda.set_sync_debug_mode("error")`` also refuses every
    synchronizing CUDA call (a device->host copy among them) for the
    block, and the previous mode is restored on exit.

    The hole that stays open: ``.numpy()`` and ``.tolist()`` of a CPU
    tensor are zero-copy reads that dispatch no op and sync nothing, so
    neither guard sees them (the reference's docstring names the same
    hole for JAX's transfer guard on CPU hosts).  Use
    ``StaticPlanRegistry.audit_constant_time`` for a device-independent
    static check.

    The dispatch mode is the calling thread's, but the CUDA sync debug
    mode is the process's: while the block runs, a synchronizing CUDA
    call on any other thread (a serving engine's prep or feed thread)
    raises too.  Run the block where no other thread drives the card.
    """
    cuda = torch.cuda.is_available()
    saved = torch.cuda.get_sync_debug_mode() if cuda else None
    try:
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        with _ScalarReadGuard():
            yield
    except RuntimeError as e:
        # Only rebrand the sync guard's own error, never an unrelated
        # RuntimeError.
        if (not isinstance(e, HostSyncError)
                and _CUDA_SYNC_MESSAGE in str(e).lower()):
            raise HostSyncError(
                f"device->host sync inside a no-host-sync region: {e}"
            ) from e
        raise
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(saved)
