"""The port's dry run (``launch/dryrun.py``), its sweep and its
meshes, on the CPU with placeholder devices.

* A reduced cell on a (2, 2) mesh of ``"meta"`` placeholders: its
  ``argument_bytes`` equal the arithmetic of the shard shapes (train,
  prefill and decode), its result carries the reference's keys, the
  H100 datasheet constants and a ``cost_method`` naming its counters.
* The depth extrapolation from depths 1 and 2 equals a direct count at
  depth 4 (FLOPs, bytes and collective bytes, exactly), and the
  microbatch extrapolation from 1 and 2 pieces a direct count of 4.
* ``_extrapolate`` / ``_cost_depths`` / ``_shallow_cfg`` equal the
  reference's on the same inputs; ``model_flops`` and the skip reasons
  equal the reference's arithmetic for every production (arch, shape).
* ``dryrun_all``'s resume and ``FAILED`` records, with
  ``subprocess.run`` replaced.
"""

import dataclasses
import json
import math
import os
import subprocess

import pytest
import torch

from repro_torch._device import DeviceUnavailable
from repro_torch.configs import SHAPES, get_config, list_archs, reduced
from repro_torch.configs.base import ShapeCell
from repro_torch.dist import make_mesh
from repro_torch.launch import dryrun as D
from repro_torch.launch import dryrun_all
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from test_torch_support import one_thread, reset_torch_state  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TRAIN = ShapeCell("train_small", 16, 8, "train")
PREFILL = ShapeCell("prefill_small", 16, 8, "prefill")
DECODE = ShapeCell("decode_small", 16, 8, "decode")


def _mesh():
    return make_mesh((2, 2), ("data", "model"), devices=["meta"] * 4)


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference dry run module, imported with the process's
    XLA_FLAGS put back at once (the module sets them to 512 host
    devices at import; no later JAX test in this worker may see it)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


def _split(dim, k):
    return dim // k if dim % k == 0 else dim


def _param_bytes(params, dtype_bytes=4):
    """A (2, 2) mesh index's bytes of a parameter tree: matrix rows over
    data and columns over model where they divide, vectors whole."""
    from repro_torch import _tree
    total = 0
    for p in _tree.leaves(params):
        s = list(p.shape)
        if len(s) >= 2:
            s[-2], s[-1] = _split(s[-2], 2), _split(s[-1], 2)
        total += math.prod(s) * dtype_bytes
    return total


def test_argument_bytes_are_the_shard_arithmetic():
    cfg = reduced(get_config("phi3.5-moe"))
    params = D._meta_params(cfg)
    p_bytes = _param_bytes(params)
    rng = torch.Generator().manual_seed(0).get_state().numel()
    tokens = (8 // 2) * 16 * 4
    train = D.analyse(cfg, TRAIN, _mesh(), grad_accum=1, skip_cost=True)
    # parameters, both moments, the trainer's int64 and the optimizer's
    # int32 step, the generator state (replicated), a window of tokens
    want = 3 * p_bytes + 8 + 4 + rng + tokens
    pd = train["per_device"]
    assert pd["argument_bytes"] == want
    assert pd["mesh_argument_bytes"] == 4 * want
    # the state is updated in place: its bytes are output and alias
    assert pd["output_bytes"] == pd["alias_bytes"] == want - tokens
    assert pd["temp_bytes"] > 4 * p_bytes       # gathered params + grads
    prefill = D.analyse(cfg, PREFILL, _mesh(), skip_cost=True)
    assert prefill["per_device"]["argument_bytes"] == p_bytes + tokens
    decode = D.analyse(cfg, DECODE, _mesh(), skip_cost=True)
    # caches (L, B, S, KV, hd) bf16: batch over data, kv heads over model
    cache = 2 * cfg.num_layers * (8 // 2) * 16 * (
        cfg.num_kv_heads // 2) * cfg.hd * 2
    assert decode["per_device"]["argument_bytes"] == (
        p_bytes + cache + (8 // 2) * 4)
    assert decode["per_device"]["alias_bytes"] == cache
    # the window's logits (4 rows, float32) are new
    assert decode["per_device"]["output_bytes"] == cache + (
        (8 // 2) * cfg.padded_vocab * 4)


def test_result_keys_constants_and_method():
    cfg = reduced(get_config("minicpm"))
    r = D.analyse(cfg, TRAIN, _mesh(), arch="minicpm-2b")
    assert r["status"] == "ok" and r["chips"] == 4 and r["mesh"] == "2x2"
    assert r["grad_accum"] == 8                  # auto: a sequence a piece
    assert set(r["per_device"]) >= {"argument_bytes", "output_bytes",
                                    "temp_bytes", "alias_bytes",
                                    "peak_hbm_gib", "flops", "hlo_bytes",
                                    "collective_bytes"}
    assert set(r["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                  "dominant", "model_flops",
                                  "hlo_flops_global", "usefulness",
                                  "step_time_bound_s"}
    hw = r["hardware"]
    assert (hw["peak_bf16_flops"], hw["hbm_bytes_per_s"],
            hw["nvlink_bytes_per_s"], hw["ib_bytes_per_s"]) == (
        989.4e12, 3.35e12, 450e9, 50e9)
    assert "datasheet" in hw["name"]
    for word in ("FakeTensorMode", "FlopCounterMode", "ring model",
                 "depth-1/2"):
        assert word in r["cost_method"]
    pd, rf = r["per_device"], r["roofline"]
    assert rf["compute_s"] == pytest.approx(pd["flops"] / 989.4e12,
                                            rel=1e-5)
    assert rf["memory_s"] == pytest.approx(pd["hlo_bytes"] / 3.35e12,
                                           rel=1e-5)
    # every group of a (2, 2) mesh lies within a node: NVLink
    assert pd["collective_ib_bytes"] == 0 < pd["collective_nvlink_bytes"]
    assert rf["collective_s"] == pytest.approx(
        pd["collective_nvlink_bytes"] / 450e9, rel=1e-5)
    assert set(r["collectives"]) == {"all-gather", "reduce-scatter",
                                     "all-reduce"}
    assert set(r["collectives_by_kind"]) == {"weight", "grad", "activation"}
    assert sum(r["collectives_by_kind"].values()) == pytest.approx(
        sum(r["collectives"].values()), rel=1e-9)
    assert rf["model_flops"] == D.model_flops(cfg, TRAIN)


@pytest.mark.parametrize("arch", ["minicpm", "phi3.5-moe"])
@pytest.mark.parametrize("shape", [TRAIN, DECODE])
def test_depth_extrapolation_equals_a_direct_count(arch, shape):
    cfg = dataclasses.replace(reduced(get_config(arch)), num_layers=4)
    d1, d2, full = D._cost_depths(cfg)
    c1 = D._cost_run(D._shallow_cfg(cfg, d1), shape, _mesh(), 8)
    c2 = D._cost_run(D._shallow_cfg(cfg, d2), shape, _mesh(), 8)
    ext = D._extrapolate(c1, c2, d1, d2, full)
    direct = D._cost_run(cfg, shape, _mesh(), 8)
    for key in ("flops", "bytes", "coll"):
        assert ext[key] == direct[key], key
    assert ext["flops"] > c2["flops"] > c1["flops"] > 0


def test_microbatch_extrapolation_equals_a_direct_count():
    cfg = reduced(get_config("minicpm"))
    # 8 rows over 2 windows, one row a microbatch: 4 pieces a window
    assert D.pieces_in_window(8, 2, 8) == 4
    ext = D._cost_run(cfg, TRAIN, _mesh(), 8)
    direct = D._run(cfg, TRAIN, _mesh(), 8, pieces=4)
    for key in ("flops", "bytes", "coll"):
        assert ext[key] == pytest.approx(direct[key], rel=1e-12), key


def test_depth_helpers_equal_reference(ref_dryrun):
    from repro.configs import get_config as jget
    c1 = {"flops": 10.0, "bytes": 7.0, "coll": 3.0,
          "coll_breakdown": {"all-gather": 2.0, "all-reduce": 1.0}}
    c2 = {"flops": 16.0, "bytes": 8.5, "coll": 2.0,
          "coll_breakdown": {"all-gather": 1.5, "reduce-scatter": 4.0}}
    for args in ((1, 2, 40.0), (6, 12, 54.0), (1, 2, 1.0)):
        assert D._extrapolate(c1, c2, *args) == ref_dryrun._extrapolate(
            c1, c2, *args)
    for arch in list_archs():
        cfg, jcfg = get_config(arch), jget(arch)
        assert D._cost_depths(cfg) == ref_dryrun._cost_depths(jcfg)
        for depth in (1, 2, 6):
            got, want = D._shallow_cfg(cfg, depth), ref_dryrun._shallow_cfg(
                jcfg, depth)
            for f in ("num_layers", "encoder_layers", "scan_unroll"):
                assert getattr(got, f) == getattr(want, f), (arch, f)


def test_model_flops_and_skip_reasons_equal_reference():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import cell_applicable as japplicable
    from repro.configs import get_config as jget
    n_skipped = 0
    for arch in list_archs():
        jcfg = jget(arch)
        for name, shape in SHAPES.items():
            jshape = JSHAPES[name]
            ok, why = japplicable(jcfg, jshape)
            if not ok:
                n_skipped += 1
                got = D.run_cell(arch, name, verbose=False)
                assert got == {"arch": arch, "shape": name, "mesh": "16x16",
                               "status": "skipped", "reason": why}
                continue
            # the reference's arithmetic, from its run_cell
            tokens = (jshape.global_batch * jshape.seq_len
                      if jshape.kind != "decode" else jshape.global_batch)
            per = 6 if jshape.kind == "train" else 2
            if jcfg.family == "encdec" and jshape.kind != "decode":
                tokens //= 2
            want = float(per * jcfg.active_param_count() * tokens)
            assert D.model_flops(get_config(arch), shape) == want, (arch,
                                                                    name)
    assert n_skipped == 7           # long_500k: the 7 quadratic archs


def test_cli_records_skipped_and_failed_cells(tmp_path, monkeypatch):
    out = tmp_path / "cell.json"
    with pytest.raises(SystemExit) as done:
        D.main(["--arch", "minicpm-2b", "--shape", "long_500k", "--out",
                str(out)])
    assert done.value.code == 0
    rec = json.loads(out.read_text())
    assert rec[0]["status"] == "skipped" and "quadratic" in rec[0]["reason"]

    def boom(*a, **k):
        raise RuntimeError("lowering went wrong")

    monkeypatch.setattr(D, "run_cell", boom)
    with pytest.raises(SystemExit) as done:
        D.main(["--arch", "minicpm-2b", "--shape", "train_4k", "--multi-pod",
                "--out", str(out)])
    assert done.value.code == 1
    rec = json.loads(out.read_text())[0]
    assert rec["status"] == "FAILED" and rec["mesh"] == "2x16x16"
    assert "lowering went wrong" in rec["error"]


def test_meshes():
    m = make_production_mesh(devices=["meta"] * 256)
    assert list(m.shape.items()) == [("data", 16), ("model", 16)]
    m = make_production_mesh(multi_pod=True, devices=["meta"] * 512)
    assert m.axis_names == ("pod", "data", "model") and m.size == 512
    h = make_host_mesh(data=2, model=2, devices=["cpu"] * 4)
    assert list(h.shape.items()) == [("data", 2), ("model", 2)]
    assert make_host_mesh(model=2, devices=["cpu"] * 8).shape["data"] == 4
    with pytest.raises(ValueError, match="3 devices"):
        make_host_mesh(data=2, model=2, devices=["cpu"] * 3)


def test_production_mesh_refuses_a_small_machine(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        make_production_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 256 devices"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True)


def test_sweep_resumes_and_records_failures(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun_all, "HERE", str(tmp_path))
    calls = []

    def fake_run(cmd, capture_output, text, timeout, env):
        assert cmd[1:3] == ["-m", "repro_torch.launch.dryrun"]
        assert env["PYTHONPATH"] == os.path.join(str(tmp_path), "src")
        arch, shape = cmd[cmd.index("--arch") + 1], cmd[cmd.index(
            "--shape") + 1]
        out = cmd[cmd.index("--out") + 1]
        calls.append((shape, "--skip-cost" in cmd))
        if shape == "decode_32k":
            raise subprocess.TimeoutExpired(cmd, timeout)
        if shape == "prefill_32k":
            return subprocess.CompletedProcess(cmd, 1, "", "x" * 900 + "boom")
        status = "skipped" if shape == "long_500k" else "ok"
        with open(out, "w") as f:
            json.dump([{"arch": arch, "shape": shape, "status": status}], f)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(dryrun_all.subprocess, "run", fake_run)
    logs = []
    got = dryrun_all.main(["--only", "minicpm-2b"], log_fn=logs.append)
    assert got == {"ok": 1, "skipped": 1, "failed": 2}
    outdir = tmp_path / "experiments" / "dryrun_torch" / "16x16"
    recs = {p.name: json.loads(p.read_text())[0] for p in outdir.iterdir()}
    assert recs["minicpm-2b__decode_32k.json"]["error"] == "TIMEOUT"
    failed = recs["minicpm-2b__prefill_32k.json"]
    assert failed["status"] == "FAILED" and failed["mesh"] == "16x16"
    assert failed["error"].endswith("boom") and len(failed["error"]) == 800
    assert sorted(c[0] for c in calls) == sorted(SHAPES)

    calls.clear()
    got = dryrun_all.main(["--only", "minicpm-2b"], log_fn=logs.append)
    assert sorted(c[0] for c in calls) == ["decode_32k", "prefill_32k"]
    assert got == {"ok": 1, "skipped": 1, "failed": 2}
    calls.clear()
    dryrun_all.main(["--only", "minicpm-2b", "--force"], log_fn=logs.append)
    assert len(calls) == 4
    calls.clear()
    dryrun_all.main(["--only", "minicpm-2b", "--multi-pod"],
                    log_fn=logs.append)
    assert len(calls) == 4 and all(skip for _, skip in calls)
    assert (tmp_path / "experiments" / "dryrun_torch" / "2x16x16").is_dir()
    assert "ok=1 skipped=1 failed=2" in logs[-1]
