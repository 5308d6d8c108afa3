"""Checkpointing in the port: the reference's seven checkpoint tests,
mirrored (atomicity, keep-k, async manager, extra payload, restore onto
another device, dtype through the template), and the on-disk layout
against the reference's own ``save``/``restore``."""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step, restore,
                                    save)
from repro_torch.train.trainer import init_state
from test_torch_support import (jax_ref, one_thread,  # noqa: F401
                                reset_torch_state)

pytestmark = pytest.mark.usefixtures("one_thread")


def tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32)}}


def test_roundtrip():
    with tempfile.TemporaryDirectory() as d:
        save(tree(), d, 7)
        got, step, _ = restore(d, tree())
        assert step == 7
        assert torch.equal(got["a"], tree()["a"])
        assert torch.equal(got["b"]["c"], tree()["b"]["c"])


def test_latest_and_keep_k():
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4):
            save(tree(), d, s, keep=2)
        assert latest_step(d) == 4
        assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]


def test_atomic_no_partial_visible():
    """A stale tmp dir never shadows a committed checkpoint."""
    with tempfile.TemporaryDirectory() as d:
        save(tree(), d, 1)
        os.makedirs(os.path.join(d, "step_00000002.tmp-999"))
        assert latest_step(d) == 1
        _, step, _ = restore(d, tree())
        assert step == 1


def test_extra_payload():
    with tempfile.TemporaryDirectory() as d:
        save(tree(), d, 3, extra={"data_cursor": 123})
        _, _, extra = restore(d, tree())
        assert extra["data_cursor"] == 123


def test_async_manager():
    with tempfile.TemporaryDirectory() as d:
        m = CheckpointManager(d, keep=2)
        for s in (1, 2, 3):
            m.save_async(tree(), s)
        m.wait()
        assert m.latest_step() == 3
        assert len(os.listdir(d)) == 2


def test_restore_with_new_shardings():
    """Restore onto another device than the template's (the port's
    reading of the reference's elastic restore with new shardings): the
    ``meta`` device, which every torch build has."""
    with tempfile.TemporaryDirectory() as d:
        save(tree(), d, 1)
        got, _, _ = restore(d, tree(), device="meta")
        assert got["a"].device.type == "meta"
        assert got["a"].shape == (2, 3) and got["b"]["c"].dtype == torch.int32
        here, _, _ = restore(d, {"a": tree()["a"].to("meta"),
                                 "b": tree()["b"]}, device="cpu")
        assert torch.equal(here["a"], tree()["a"])


def test_dtype_preserved_via_template():
    t = {"w": torch.tensor([1.5, -2.0, 3.0], dtype=torch.bfloat16)}
    with tempfile.TemporaryDirectory() as d:
        save(t, d, 1)
        with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
            leaf = json.load(f)["leaves"][0]
        assert leaf == {"name": "w", "shape": [3], "dtype": "bfloat16"}
        assert np.load(os.path.join(d, "step_00000001",
                                    "w.npy")).dtype == np.float32
        got, _, _ = restore(d, t)
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"], t["w"])


def test_async_snapshot_is_taken_before_the_state_changes():
    """The trainer updates its state in place after ``save_async``
    returns: the written checkpoint holds the values at the call."""
    t = tree()
    with tempfile.TemporaryDirectory() as d:
        m = CheckpointManager(d)
        m.save_async(t, 1)
        t["a"].add_(100.0)
        m.wait()
        got, _, _ = restore(d, tree())
        assert torch.equal(got["a"], tree()["a"])


def test_train_state_layout_matches_the_reference(jax_ref):
    """A training state's files carry the reference's leaf names (a
    dataclass field by its index), shapes and manifest keys, and each
    package restores the other's checkpoint."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import restore as j_restore
    from repro.checkpoint import save as j_save
    from repro.train.trainer import init_state as j_init
    params = {"embed": {"table": np.arange(12, dtype=np.float32).reshape(3, 4)},
              "final_norm": {"scale": np.ones(4, np.float32)}}
    jstate = j_init(jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(0))
    tstate = init_state({k: {n: torch.as_tensor(v) for n, v in d.items()}
                         for k, d in params.items()}, 0)
    with tempfile.TemporaryDirectory() as d:
        j_save(jstate, os.path.join(d, "ref"), 5)
        save(tstate, os.path.join(d, "port"), 5)
        man = {}
        for who in ("ref", "port"):
            with open(os.path.join(d, who, "step_00000005",
                                   "manifest.json")) as f:
                man[who] = json.load(f)
        assert man["ref"].keys() == man["port"].keys()
        shapes = {who: {leaf["name"]: leaf["shape"]
                        for leaf in man[who]["leaves"]} for who in man}
        # params, moments (mu, nu), the optimizer and the train step
        # counters: named alike; the RNG leaf is the one that differs
        # (a threefry key there, a torch.Generator state here)
        common = {k: v for k, v in shapes["ref"].items() if k != "3"}
        assert {k: shapes["port"][k] for k in common} == common
        assert set(shapes["port"]) - set(common) == {"3"}
        # each package restores the other's parameter and moment files
        got, step, _ = restore(os.path.join(d, "ref"), tstate)
        assert step == 5
        assert torch.equal(got.params["embed"]["table"],
                           torch.as_tensor(params["embed"]["table"]))
        jgot, step, _ = j_restore(os.path.join(d, "port"), jstate)
        assert step == 5
        np.testing.assert_array_equal(
            np.asarray(jgot.params["embed"]["table"]),
            params["embed"]["table"])
        np.testing.assert_array_equal(
            np.asarray(jgot.opt.nu["final_norm"]["scale"]),
            np.zeros(4, np.float32))
