"""The port's mesh, sharding rules, annotations, compressed collectives
and ring halo exchange, on the CPU.

Sharding helpers and annotation resolution are held to the reference's
functions on the same mesh geometry (the reference's helpers read only
``axis_names`` and ``shape``); ``quantize_int8`` bit-exact against the
reference's; ``compressed_psum`` against a numpy composition of the
reference's ``quantize_int8`` / ``dequantize_int8`` (the reference's own
``compressed_psum`` needs ``jax.core.axis_frame``, which this jax no
longer has).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tuning as jtuning
from repro.dist import annotate as jann
from repro.dist import collectives as jcoll
from repro.dist import sharding as jshd
from repro_torch._device import DeviceUnavailable
from repro_torch.core import sequence
from repro_torch.core import tuning as ttuning
from repro_torch.dist import Mesh, annotate, collectives, make_mesh, mesh
from repro_torch.dist import sharding as shd
from repro_torch.models import attention as A
from test_torch_support import (F32_TOL, assert_bitexact, assert_close,
                                reset_torch_state)  # noqa: F401

MESHES = [((8,), ("data",)), ((2, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")), ((4, 2), ("model", "data"))]


def _mesh(shape, axes):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


# ---------------------------------------------------------------------------
# Mesh
# ---------------------------------------------------------------------------

def test_make_mesh_repeats_devices_and_numbers_shards():
    m = _mesh((2, 4), ("data", "model"))
    assert list(m.shape.items()) == [("data", 2), ("model", 4)]
    assert m.size == 8 and m.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in m.devices.reshape(-1))
    assert m.ids.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert m.axis_devices("data") == [torch.device("cpu")] * 2
    assert m.axis_devices("model") == [torch.device("cpu")] * 4
    sub = Mesh([torch.device("cpu")] * 3, ("data",), ids=np.array([0, 2, 5]))
    assert sub.ids.tolist() == [0, 2, 5] and sub.size == 3


def test_make_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable, match="CUDA"):
        make_mesh((8,), ("data",))


@pytest.mark.parametrize("bad, match", [
    (lambda: make_mesh((2, 2), ("data",), devices=["cpu"] * 4), "axes"),
    (lambda: make_mesh((4,), ("data",), devices=["cpu"] * 3), "3 devices"),
    (lambda: Mesh([torch.device("cpu")] * 2, ("a", "a")), "axis"),
    (lambda: Mesh([torch.device("cpu")] * 2, ("a",), ids=np.array([1, 1])),
     "repeat"),
    (lambda: _mesh((4,), ("data",)).axis_devices("model"), "not on mesh"),
])
def test_mesh_rejects_bad_geometry(bad, match):
    with pytest.raises(ValueError, match=match):
        bad()


def test_split_and_join_round_trip():
    x = torch.arange(48).reshape(8, 6)
    devs = [torch.device("cpu")] * 4
    rows = mesh.split(x, devs)
    assert [tuple(r.shape) for r in rows] == [(2, 6)] * 4
    assert rows[1].data_ptr() == x[2:4].data_ptr()      # a view, no copy
    assert torch.equal(mesh.join(rows, "cpu"), x)
    cols = mesh.split(x, devs[:3], dim=1)
    assert torch.equal(mesh.join(cols, "cpu", dim=1), x)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.split(x, devs[:3])


# ---------------------------------------------------------------------------
# Sharding rules: the reference's answers and messages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape, axes", MESHES)
def test_sharding_helpers_equal_reference(shape, axes):
    m = _mesh(shape, axes)
    assert shd.batch_axes(m) == jshd.batch_axes(m)
    for ax in [a for a in axes] + [("data", "model"), ()]:
        ax = tuple(a for a in (ax if isinstance(ax, tuple) else (ax,))
                   if a in axes)
        assert shd.mesh_axis_size(m, ax) == jshd.mesh_axis_size(m, ax)
        for dim in (8, 12, 6):
            try:
                want = jshd.require_divisible(dim, m, ax, what="rows")
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    shd.require_divisible(dim, m, ax, what="rows")
                assert str(got.value) == str(e)
            else:
                assert shd.require_divisible(dim, m, ax, what="rows") == want
    for fn in (shd.mesh_axis_size, jshd.mesh_axis_size):
        with pytest.raises(ValueError, match="not on the mesh"):
            fn(m, ("bogus",))


# ---------------------------------------------------------------------------
# Annotations
# ---------------------------------------------------------------------------

def _ref_spec(m, shape, *names):
    """The reference ``annotate``'s PartitionSpec entries, from its own
    name resolution."""
    names = tuple(names) + (None,) * (len(shape) - len(names))
    out = []
    for dim, name in zip(shape, names):
        phys = jann._physical(m, name)
        ok = phys is not None and dim % jann._axis_size(m, phys) == 0
        out.append(phys if ok else None)
    return tuple(out)


@pytest.mark.parametrize("shape, axes", MESHES)
def test_annotation_resolution_equals_reference(shape, axes):
    m = _mesh(shape, axes)
    assert annotate._LOGICAL == jann._LOGICAL
    for tshape, names in (((16, 8, 4), ("batch", None, "tp")),
                          ((6, 8), ("batch", "tp")),
                          ((8, 3), ("fsdp", "tp")),
                          ((4, 4, 4), ("data", "model", "pod")),
                          ((8,), ()), ((8, 8), ("nonsense",))):
        assert annotate.spec(m, tshape, *names) == _ref_spec(m, tshape,
                                                             *names)


def test_annotate_returns_its_input_on_and_off_a_mesh():
    x = torch.zeros(8, 4, 2)
    m = _mesh((2, 4), ("data", "model"))
    assert annotate.active_mesh() is None
    assert annotate.annotate(x, "batch") is x
    with annotate.logical_axes(m) as am:
        assert am is m and annotate.active_mesh() is m
        with annotate.logical_axes(_mesh((8,), ("data",))) as inner:
            assert annotate.active_mesh() is inner
        assert annotate.active_mesh() is m
        assert annotate.annotate(x, "batch", None, "tp") is x
        assert annotate.annotate_heads(x) is x
        qh = torch.zeros(2, 1, 4, 2, 8)
        assert A.annotate_grouped_q(qh) is qh
    assert annotate.active_mesh() is None


# ---------------------------------------------------------------------------
# Compressed collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["normal", "halves", "zeros", "bf16",
                                  "tiny"])
def test_quantize_int8_bitexact_with_reference(case):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((37, 5)).astype(np.float32) * 3
    if case == "halves":       # ties: round half to even in both
        x = (np.arange(-254, 255, dtype=np.float32) / 2.0)
    elif case == "zeros":      # the 1e-12 scale floor
        x = np.zeros((4, 4), np.float32)
    elif case == "tiny":
        x = x * 1e-30
    tx = torch.as_tensor(x)
    if case == "bf16":
        tx = tx.to(torch.bfloat16)
        x = tx.float().numpy()
    q, scale = collectives.quantize_int8(tx)
    jq, jscale = jcoll.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert_bitexact(q, np.asarray(jq))
    assert_bitexact(scale, np.asarray(jscale))
    assert_bitexact(collectives.dequantize_int8(q, scale),
                    np.asarray(jcoll.dequantize_int8(jq, jscale)))
    with pytest.raises(ValueError, match="empty"):
        collectives.quantize_int8(torch.zeros(0))


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_compressed_psum_equals_reference_composition(s):
    rng = np.random.default_rng(s)
    xs = [rng.standard_normal((6, 5)).astype(np.float32) * (i + 1)
          for i in range(s)]
    m = _mesh((s,), ("data",))
    means, errs = collectives.compressed_psum(
        [torch.as_tensor(x) for x in xs], m, "data")
    sent = [np.array(jcoll.dequantize_int8(*jcoll.quantize_int8(
        jnp.asarray(x)))) for x in xs]
    total = sent[0]
    for v in sent[1:]:
        total = total + v
    assert len(means) == len(errs) == s
    for x, mean, err, v in zip(xs, means, errs, sent):
        assert_close(mean, total / s, F32_TOL)
        assert_bitexact(err, x - v)


def test_compressed_psum_rejects_unbound_axis_and_wrong_count():
    m = _mesh((4,), ("data",))
    xs = [torch.ones(3)] * 4
    with pytest.raises(ValueError, match="not bound"):
        collectives.compressed_psum(xs, m, "model")
    with pytest.raises(ValueError, match="3 shards"):
        collectives.compressed_psum(xs[:3], m, "data")


# ---------------------------------------------------------------------------
# Ring halo exchange
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift", [1, 3, -1, 8])
def test_ring_halo_is_a_ring_step(shift):
    shards = [torch.full((2, 3), float(i)) for i in range(8)]
    got = sequence.ring_halo(shards, shift=shift)
    for i in range(8):
        j = (i + shift) % 8
        assert torch.equal(got[j], shards[i])
        assert got[j] is not shards[i]                    # a copy
        assert got[j].device == shards[j].device


# ---------------------------------------------------------------------------
# Tuning keys over a mesh
# ---------------------------------------------------------------------------

def test_tuning_key_takes_a_mesh():
    m = _mesh((2, 4), ("data", "model"))
    key = ttuning.make_key("apply_plan", (64, 1600), m)
    assert key == ttuning.make_key("apply_plan", (64, 1600),
                                   {"model": 4, "data": 2})
    assert key == jtuning.make_key("apply_plan", (64, 1600),
                                   {"data": 2, "model": 4})
    t = ttuning.TuningTable()
    t.record("sha3_256", (8, 1), "megakernel", 1e-3, mesh_shape=m)
    assert t.best("sha3_256", (8, 1), mesh_shape={"data": 2, "model": 4}) \
        == "megakernel"
    assert t.best("sha3_256", (8, 1)) is None
