"""The port's model examples against the reference's.

The harness and the rules for the lines that differ by design are in
``test_torch_examples.py``.

``observe_serving`` runs from a copy in ``tmp_path`` on both sides, each
in a process of its own: its metrics line counts the lazy gauges the
process has registered, and an engine's registrations outlive it, so
only a fresh process prints what a user sees.  ``train_moe_e2e`` trains a
~155 M-parameter model for 300 steps: here the port runs it at
``configs.reduced`` for 3 steps through a checkpoint and a resume, and
its configuration, data and options are held to the literals of the
reference script.
"""

import ast
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch._device import DeviceUnavailable
from repro_torch.configs import reduced
from test_torch_examples import (PORT_DIR, REF_DIR, ROOT, assert_same_lines,
                                 load_port, run_port, run_reference)
from test_torch_support import jax_ref, one_thread, reset_torch_state  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def test_serving_prints_reference_lines(jax_ref):
    assert_same_lines("serving", run_reference("serving"),
                      run_port("serving"))


_RUN_REFERENCE = """
import runpy, sys
import jax
from jax._src import core
jax.core.trace_state_clean = core.trace_state_clean
runpy.run_path(sys.argv[1], run_name="__main__")
"""
_RUN_PORT = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("observe_serving", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod.main([], device="cpu")
"""


def _run_copy(code, script, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + os.environ.get("PYTHONPATH", "").split(
            os.pathsep)), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    done = subprocess.run([sys.executable, "-c", code, str(script)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    return done.stdout.splitlines()


def test_observe_serving_prints_reference_lines(tmp_path):
    out = {}
    for side, src, code in (("ref", REF_DIR, _RUN_REFERENCE),
                            ("port", PORT_DIR, _RUN_PORT)):
        d = tmp_path / side
        d.mkdir()
        script = Path(shutil.copy(src / "observe_serving.py", d))
        out[side] = _run_copy(code, script, d)
        assert {p.name for p in d.iterdir()} == {
            "observe_serving.py", "observe_trace.json",
            "observe_metrics.json"}, side
    assert_same_lines("observe_serving", out["ref"], out["port"])
    names = re.findall(r'span="(\w+)"', "\n".join(out["port"]))
    assert sorted(set(names)) == [
        "apply_plan", "bucket_pack", "compile_plan", "device_absorb",
        "queue_wait", "registry_observe", "request", "resilient_execute"]
    assert out["port"][-1].endswith("passes=24 drifting=False mismatches=0")


# -- train_moe_e2e ----------------------------------------------------------

def _literal_calls(path):
    """{callee name: {keyword: literal}} of the calls in a script."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and isinstance(
                node.func, (ast.Name, ast.Attribute)):
            kws = {}
            for kw in node.keywords:
                try:
                    kws[kw.arg] = ast.literal_eval(kw.value)
                except ValueError:
                    pass
            name = getattr(node.func, "id", getattr(node.func, "attr", ""))
            out.setdefault(name, {}).update(kws)
    return out


def _options(directory):
    """{option: default} of train_moe_e2e's command line."""
    tree = ast.parse((directory / "train_moe_e2e.py").read_text())
    out = {}
    for c in ast.walk(tree):
        if (isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
                and c.func.attr == "add_argument"):
            default = [k.value for k in c.keywords if k.arg == "default"]
            out[c.args[0].value] = (ast.literal_eval(default[0])
                                    if default and isinstance(
                                        default[0], ast.Constant) else None)
    return out


def test_train_config_data_and_options_are_the_references():
    from repro.configs.base import ModelConfig as JModelConfig
    calls = _literal_calls(REF_DIR / "train_moe_e2e.py")
    port = load_port("train_moe_e2e")
    cfg = port.CONFIG
    assert calls["ModelConfig"] == {
        k: getattr(cfg, k) for k in calls["ModelConfig"]}
    jcfg = JModelConfig(**calls["ModelConfig"])
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert calls["SyntheticLM"] == dict(seq_len=port.SEQ_LEN,
                                        global_batch=port.GLOBAL_BATCH)
    assert calls["TrainOptions"] == dict(peak_lr=1e-3, warmup_steps=30,
                                         grad_accum=port.GRAD_ACCUM)
    assert calls["Trainer"] == dict(keep=2, donate=False)
    assert calls["run"] == dict(ckpt_every=100, log_every=20)
    assert _options(REF_DIR) == {"--steps": 300,
                                 "--ckpt-dir": "/tmp/repro_moe_ckpt"}
    assert _options(PORT_DIR)["--steps"] == 300
    assert port.CKPT_EVERY == 100
    lines = []
    with pytest.raises(DeviceUnavailable):
        port.main([], log_fn=lines.append)
    assert lines == []


def test_train_moe_e2e_reduced_trains_checkpoints_and_resumes(
        tmp_path, monkeypatch):
    from repro_torch.checkpoint import CheckpointManager
    port = load_port("train_moe_e2e")
    monkeypatch.setattr(port, "CONFIG", reduced(port.CONFIG))
    monkeypatch.setattr(port, "CKPT_EVERY", 3)
    ckpt = tmp_path / "ckpt"
    argv = ["--steps", "3", "--ckpt-dir", str(ckpt)]
    lines = []
    first = port.main(argv, device="cpu", log_fn=lines.append)
    assert [h["step"] for h in first] == [0, 1, 2]
    assert all(math.isfinite(h["loss"]) for h in first)
    assert CheckpointManager(str(ckpt), keep=2).latest_step() == 3
    assert lines[0] == "params: 0M total, 0M active"
    assert lines[1].startswith("step      0 loss ")
    assert re.fullmatch(r"final loss \d+\.\d{4} \(start \d+\.\d{4}\); "
                        r"dropped-token fraction \d\.\d{3}", lines[-1])
    resumed = port.main(argv, device="cpu", log_fn=lambda s: None)
    assert [h["step"] for h in resumed] == [3, 4, 5]
    straight = port.main(["--steps", "6", "--ckpt-dir",
                          str(tmp_path / "straight")], device="cpu",
                         log_fn=lambda s: None)
    np.testing.assert_array_equal([h["loss"] for h in straight],
                                  [h["loss"] for h in first + resumed])
