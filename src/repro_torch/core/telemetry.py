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
baselines) when that package is loaded.  (``no_host_sync``, the
constant-time audit primitive, waits for a later slice.)
"""

from __future__ import annotations

import contextlib
import sys
import threading

from repro_torch import kernels as _kernels
from repro_torch.core import crossbar as xb
from repro_torch.core import integrity as _integrity
from repro_torch.core import plan_algebra as pa
from repro_torch.core import plan_program as pp

_BACKENDS = ("einsum", "kernel", "sparse", "reference")

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
