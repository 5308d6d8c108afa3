"""The port's package API against the reference's: ``repro_torch.core``
re-exports the names of ``repro.core.__all__`` from the port's own
modules, and ``repro_torch.kernels`` its kernels' wrappers, ``ops`` and
``ref``; both import first thing with no cycle and no JAX."""

import inspect
import json
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch.core as tcore
import repro_torch.kernels as tkernels

ROOT = Path(__file__).resolve().parents[1]

KERNEL_EXPORTS = {"ops", "ref", "crossbar_permute_cuda",
                  "crossbar_permute_sparse_cuda", "fused_vcompress_cuda",
                  "moe_route_cuda", "plan_program_cuda", "launch_counts",
                  "reset_launch_counts"}


def test_core_exports_the_reference_names():
    import repro.core as jcore
    assert set(tcore.__all__) == set(jcore.__all__)
    assert len(tcore.__all__) == len(set(tcore.__all__)) == 61
    for name in jcore.__all__:
        got, want = getattr(tcore, name), getattr(jcore, name)
        assert inspect.ismodule(got) == inspect.ismodule(want), name
        assert inspect.isclass(got) == inspect.isclass(want), name
        assert callable(got) == callable(want), name
        if isinstance(want, (int, str)):
            assert got == want, name            # DROP, GATHER, SCATTER
            continue
        owner = got.__name__ if inspect.ismodule(got) else getattr(
            got, "__module__", None) or type(got).__module__
        assert owner.startswith("repro_torch."), (name, owner)


def test_kernels_export_wrappers_ops_and_ref():
    assert set(tkernels.__all__) == KERNEL_EXPORTS
    for name in KERNEL_EXPORTS:
        obj = getattr(tkernels, name)
        assert inspect.ismodule(obj) or callable(obj), name
    assert tkernels.ops.__name__ == "repro_torch.kernels.ops"
    assert tkernels.ref.__name__ == "repro_torch.kernels.ref"
    assert tkernels.crossbar_permute_cuda.__module__ == (
        "repro_torch.kernels.crossbar_permute")


@pytest.mark.parametrize("first", [
    "from repro_torch.core import apply_plan, vrgather, PlanProgram, GF2",
    "import repro_torch.kernels",
    "from repro_torch.kernels import ops"])
def test_package_imports_first_thing_without_jax(first):
    """In a fresh interpreter the package imports first (no import
    cycle) and pulls in neither JAX nor the reference."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        f"{first}\n"
        "import repro_torch.core, repro_torch.kernels\n"
        "assert len(repro_torch.core.__all__) == 61\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
