"""The port's measured tuning table and ``backend="auto"`` against the
JAX reference's ``repro.core.tuning``.

The same seeded sequence of ``record`` calls must give byte-identical
``to_json`` text and the same ``best`` / ``rank_chain`` / ``lookup``
answers; ``plan_geometry`` must key the Keccak, AES and GCM plans as the
reference does; and ``backend="auto"`` must take the installed table's
measured winner.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import crossbar as txb
from repro_torch.core import telemetry
from repro_torch.core import tuning as ttun
from repro_torch.crypto import aes as TA
from repro_torch.crypto import gcm as TG
from repro_torch.crypto import keccak as TK
from test_torch_support import jax_ref, reset_torch_state  # noqa: F401

BACKENDS = ("megakernel", "sparse", "kernel", "einsum", "reference")
OPS = ("sha3_256", "gcm_seal", "apply_plan")


def _records(seed, n=200):
    """A seeded sequence of record() arguments: ops, geometries (tuples,
    ints, strings), backends, seconds and mesh shapes (None or dicts)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        op = OPS[int(rng.integers(len(OPS)))]
        kind = int(rng.integers(3))
        if kind == 0:
            geometry = tuple(int(g) for g in rng.integers(1, 9, 2) * 16)
        elif kind == 1:
            geometry = int(rng.integers(1, 5))
        else:
            geometry = ("gather", 1600, 1600, int(rng.integers(1, 12)),
                        "gf2")
        mesh = None if rng.random() < 0.7 else {
            "data": int(rng.integers(1, 9)), "model": 1}
        out.append((op, geometry, BACKENDS[int(rng.integers(5))],
                    float(rng.exponential(1e-3)), mesh))
    return out


def _fill(table, records):
    for op, geometry, backend, secs, mesh in records:
        table.record(op, geometry, backend, secs, mesh_shape=mesh)
    return table


@pytest.mark.parametrize("seed,alpha", [(0, 0.3), (1, 1.0), (2, 0.05)])
def test_seeded_records_give_the_reference_json_and_answers(jax_ref, seed,
                                                            alpha):
    from repro.core import tuning as jtun
    recs = _records(seed)
    mine = _fill(ttun.TuningTable(alpha=alpha), recs)
    ref = _fill(jtun.TuningTable(alpha=alpha), recs)
    assert mine.to_json() == ref.to_json()
    assert len(mine) == len(ref)
    for op, geometry, _, _, mesh in recs:
        assert mine.best(op, geometry, mesh_shape=mesh) == ref.best(
            op, geometry, mesh_shape=mesh)
        assert mine.best(op, geometry, mesh_shape=mesh, min_samples=3) == \
            ref.best(op, geometry, mesh_shape=mesh, min_samples=3)
        assert mine.rank_chain(op, geometry, BACKENDS, mesh_shape=mesh) == \
            ref.rank_chain(op, geometry, BACKENDS, mesh_shape=mesh)
        assert mine.lookup(op, geometry, mesh_shape=mesh) == ref.lookup(
            op, geometry, mesh_shape=mesh)
    assert mine.best("never", (1,)) is ref.best("never", (1,)) is None
    # each package reads the other's serialisation
    assert ttun.TuningTable.from_json(ref.to_json()).to_json() == \
        mine.to_json()
    assert jtun.TuningTable.from_json(mine.to_json()).to_json() == \
        ref.to_json()


def test_keys_are_the_references(jax_ref):
    from repro.core import tuning as jtun
    for geometry, mesh in (((8, 1), None), (3, {"data": 4}),
                           (("a", (1, 2)), [("model", 2), ("data", 4)])):
        assert ttun.make_key("op", geometry, mesh) == jtun.make_key(
            "op", geometry, mesh)


def test_json_round_trip_and_persistence(tmp_path):
    t = _fill(ttun.TuningTable(), _records(3, n=40))
    text = t.to_json()
    assert ttun.TuningTable.from_json(text).to_json() == text
    path = tmp_path / "tuning.json"
    t.save(str(path))
    assert ttun.TuningTable.load(str(path)).to_json() == text
    with pytest.raises(ValueError, match="unknown version"):
        ttun.TuningTable.from_json('{"version": 2}')


def test_validation_and_ewma():
    with pytest.raises(ValueError, match="alpha"):
        ttun.TuningTable(alpha=0.0)
    t = ttun.TuningTable(alpha=0.5)
    with pytest.raises(ValueError, match="negative"):
        t.record("op", (1,), "einsum", -1.0)
    t.record("op", (1,), "einsum", 2.0)
    t.record("op", (1,), "einsum", 4.0)
    t.record("op", (1,), "sparse", 1.0)
    assert t.lookup("op", (1,)) == {"einsum": {"ewma_s": 3.0, "n": 2},
                                    "sparse": {"ewma_s": 1.0, "n": 1}}
    assert t.best("op", (1,)) == "sparse"
    assert t.best("op", (1,), min_samples=2) == "einsum"
    assert t.rank_chain("op", (1,), ("megakernel", "einsum", "sparse")) == \
        ("sparse", "einsum", "megakernel")

    class Span:
        duration_s = 0.25
    t.record_span(Span(), "op", (2,), "kernel")
    assert t.lookup("op", (2,))["kernel"]["ewma_s"] == 0.25


def _port_plans():
    h = TG._hash_key(bytes(range(16)))
    return {
        "keccak/rho_pi": TK.rho_pi_plan("cpu"),
        "keccak/theta_rho_pi": TK.theta_rho_pi_plan("cpu"),
        "aes/sbox": TA.sbox_plan(device="cpu"),
        "aes/round_linear": TA.round_linear_plan(device="cpu"),
        "ghash/horner": TG.ghash_plan(h, mode="horner", device="cpu")[0],
        "ghash/powers": TG.ghash_plan(h, mode="powers", m=5,
                                      device="cpu")[0],
    }


def test_plan_geometry_keys_the_crypto_plans_as_the_reference(jax_ref):
    from repro.core import crossbar as jxb
    from repro.crypto import aes as JA
    from repro.crypto import gcm as JG
    from repro.crypto import keccak as JK
    h = JG._hash_key(bytes(range(16)))
    ref = {
        "keccak/rho_pi": JK.rho_pi_plan(),
        "keccak/theta_rho_pi": JK.theta_rho_pi_plan(),
        "aes/sbox": JA.sbox_plan(),
        "aes/round_linear": JA.round_linear_plan(),
        "ghash/horner": JG.ghash_plan(h, mode="horner")[0],
        "ghash/powers": JG.ghash_plan(h, mode="powers", m=5)[0],
    }
    mine = _port_plans()
    for name, plan in mine.items():
        assert txb.plan_geometry(plan) == jxb.plan_geometry(ref[name]), name


def test_auto_takes_the_tables_measured_winner():
    plan = TK.rho_pi_plan("cpu")
    x = torch.randint(0, 2, (1600, 4), dtype=torch.int32)
    want = txb.apply_plan(plan, x, backend="reference")
    table = ttun.TuningTable()
    table.record("apply_plan", txb.plan_geometry(plan), "reference", 1e-4)
    table.record("apply_plan", txb.plan_geometry(plan), "einsum", 1e-2)
    prev = txb.get_tuning_table()
    try:
        txb.set_tuning_table(table)
        assert txb.get_tuning_table() is table
        with telemetry.delta() as d:
            got = txb.apply_plan(plan, x, backend="auto")
        assert d()["apply_calls_reference"] == 1
        assert torch.equal(got, want)
        # a measured name that is not a crossbar backend is ignored
        other = txb.gather_plan(torch.tensor([1, 0, 2]), 3)
        table.record("apply_plan", txb.plan_geometry(other), "megakernel",
                     1e-6)
        with telemetry.delta() as d:
            txb.apply_plan(other, torch.arange(3), backend="auto")
        assert d()["apply_calls_einsum"] == 1
        txb.set_tuning_table(None)
        with telemetry.delta() as d:
            txb.apply_plan(plan, x, backend="auto")
        assert d()["apply_calls_einsum"] == 1      # the CPU prior
    finally:
        txb.set_tuning_table(prev)
