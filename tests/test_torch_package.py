"""The port's package boundary: no JAX, no reference, no hidden fallback."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import kernels
from repro_torch.core import crossbar as txb
from repro_torch.kernels import _build
from repro_torch.kernels import crossbar_permute as xbk
from test_torch_support import reset_torch_state  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(_modules()) >= 15


def test_sources_do_not_name_the_reference():
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "from repro." not in text and "import repro." not in text, \
            path


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.default_device()
    from repro_torch.crypto import keccak
    with pytest.raises(RuntimeError, match="CUDA"):
        keccak.sha3_256(b"abc")                # no silent CPU fallback
    assert repro_torch.resolve("cpu") == torch.device("cpu")


def test_cpu_tensors_run_plain_versions_and_count_no_launch():
    from repro_torch.crypto import keccak
    s = torch.zeros(2, 1600, dtype=torch.int32)
    keccak.keccak_f1600(s, backend="megakernel")
    keccak.keccak_f1600(s, backend="kernel", batch_mode="payload")
    keccak.keccak_f1600(s, backend="sparse")
    from repro_torch.kernels import ops
    ops.moe_route_transform(torch.zeros(4, 2, dtype=torch.int32),
                            num_experts=2, capacity=2)
    ops.fused_vcompress(torch.ones(4, dtype=torch.bool), torch.zeros(4, 3))
    assert kernels.launch_counts() == {"crossbar_dense": 0,
                                       "crossbar_sparse": 0,
                                       "plan_program": 0,
                                       "moe_route": 0,
                                       "fused_vcompress": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    idx = torch.zeros(4, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        xbk.crossbar_permute_cuda(idx, torch.zeros(4, 2), mode="gather",
                                  n_out=4)
    from repro_torch.kernels import plan_program_kernel as ppk
    from repro_torch.core import plan_program as tpp
    ctl = tpp.build_control(tpp.ProgramBuilder("p", 4, n_regs=1).build(),
                            "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ppk.plan_program_cuda(torch.zeros(4, 2, dtype=torch.int32), ctl)
    from repro_torch.kernels import moe_route
    with pytest.raises(ValueError, match="CUDA"):
        moe_route.moe_route_cuda(idx, num_experts=2, capacity=2)
    assert set(kernels.launch_counts().values()) == {0}


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.build()
    assert issubclass(_build.KernelBuildError, _build.KernelLaunchError)


def test_kernel_errors_carry_plan_geometry():
    from repro_torch.kernels import ops
    plan = txb.gather_plan(torch.tensor([1, 0], dtype=torch.int32), 2)
    with pytest.raises(ops.KernelLaunchError, match="2->2, k=1"):
        with ops._surface_kernel_errors("dense crossbar kernel", plan):
            raise _build.KernelBuildError("nvcc not found")
    with pytest.raises(ValueError, match="bad input"):
        with ops._surface_kernel_errors("dense crossbar kernel", plan):
            raise ValueError("bad input")


def test_build_is_keyed_by_the_sources():
    h1 = _build._source_hash("/usr/local/cuda/bin/nvcc")
    assert h1 == _build._source_hash("/usr/local/cuda/bin/nvcc")
    assert h1 != _build._source_hash("/opt/other/nvcc")
    assert _build.build_root() == ROOT / "build" / "repro_torch_kernels"
    assert all((_build.CSRC / s).is_file() for s in _build.SOURCES)


def test_chip_smoke_needs_a_card_and_the_repo(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [(tmp_path, lone)]
    if not torch.cuda.is_available():
        runs.append((ROOT, ROOT / "chip_smoke.py"))
    for cwd, script in runs:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_plan_from_numpy_round_trip():
    import numpy as np
    plan = txb.plan_from_numpy("scatter", np.array([2, 0, 1]), 3, 3,
                               weights=np.ones(3, np.float32), device="cpu")
    assert plan.idx.dtype == torch.int32 and plan.idx.shape == (3, 1)
    out = txb.apply_plan(plan, torch.tensor([[1.0], [2.0], [3.0]]))
    assert out[:, 0].tolist() == [2.0, 3.0, 1.0]
