"""Port vs reference: the last public members the port had not carried
over — ``CacheGuard``'s own sampling period and ``clear``,
``PlanProgram.total_steps`` and ``Semiring.cast_weights``.

The guard cases mirror ``tests/test_integrity.py``'s ``sample_every``
cases and run the same calls through both packages' guards."""

import numpy as np
import pytest
import torch

from repro.core import integrity as jint
from repro.core import semiring as jsr
from repro_torch.core import integrity as tint
from repro_torch.core import semiring as tsr
from repro_torch.core import telemetry
from test_torch_plan_program import _all_ops_jax_program, _port_of
from test_torch_support import (assert_bitexact, one_thread,
                                reset_torch_state, to_numpy)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _both(name, **kw):
    return jint.CacheGuard(name, **kw), tint.CacheGuard(name, **kw)


def _checks(g, content, hits):
    return [g.verify("k", lambda: (content,)) for _ in range(hits)]


@pytest.mark.parametrize("every,hits", [(1, 3), (4, 9), (1000, 3)])
def test_guard_sampling_cadence_matches_reference(every, hits):
    """Hits 0, N, 2N, ... verify; the rest are free; ``info`` reports the
    guard's own period, not the module knob's."""
    jg, tg = _both("t", sample_every=every)
    for g in (jg, tg):
        g.seal("k", (b"c",))
    got = _checks(tg, b"c", hits)
    assert got == _checks(jg, b"c", hits)
    assert got == [i % every == 0 for i in range(hits)]
    assert tg.info() == jg.info()
    assert tg.info()["sample_every"] == every != tint.sample_every()


def test_guard_without_a_period_follows_the_module_knob():
    jg, tg = _both("t")
    prev_j, prev_t = jint.set_sample_every(3), tint.set_sample_every(3)
    try:
        for g in (jg, tg):
            g.seal("k", (b"c",))
        assert _checks(tg, b"c", 7) == _checks(jg, b"c", 7) == [
            True, False, False, True, False, False, True]
        assert tg.info() == jg.info()
        assert tg.info()["sample_every"] == 3
    finally:
        jint.set_sample_every(prev_j)
        tint.set_sample_every(prev_t)
    assert tg.info()["sample_every"] == prev_t


def test_guard_period_overrides_always_verify():
    """``always_verify`` sets the module knob to 1; a guard with its own
    period keeps it, in both packages."""
    jg, tg = _both("t", sample_every=1000)
    with jint.always_verify(), tint.always_verify():
        for g in (jg, tg):
            g.seal("k", (b"c",))
        assert _checks(tg, b"c", 3) == _checks(jg, b"c", 3) == [
            True, False, False]


def test_guard_mismatch_with_a_period_of_one_raises_in_both():
    jg, tg = _both("t", sample_every=1)
    for g in (jg, tg):
        g.seal("k", (b"good",))
    with pytest.raises(jint.IntegrityError):
        jg.verify("k", lambda: (b"bad",))
    with pytest.raises(tint.IntegrityError) as ei:
        tg.verify("k", lambda: (b"bad",))
    assert (ei.value.guard, ei.value.key) == ("t", "k")
    assert tg.info() == jg.info()
    assert telemetry.snapshot().get("integrity_faults") == 1


def test_guard_clear_forgets_every_seal():
    jg, tg = _both("t", sample_every=1)
    for g in (jg, tg):
        g.seal("a", (b"1",))
        g.seal("b", (b"2",))
        assert g.depth() == 2
        g.clear()
        assert g.depth() == 0
        # a cleared key reads as never sealed
        assert g.verify("a", lambda: (b"1",)) is False
    assert tg.info() == jg.info()
    assert tg.info()["sealed"] == 2 and tg.info()["size"] == 0


def test_program_total_steps_matches_reference():
    jprog = _all_ops_jax_program()
    tprog = _port_of(jprog)
    assert tprog.total_steps == jprog.total_steps == 3 * len(tprog.steps)
    flat = tprog.unroll()
    assert flat.total_steps == tprog.total_steps
    assert flat.prefix(5).total_steps == 5


@pytest.mark.parametrize("name", ["REAL", "GF2", "GF2_8"])
def test_semiring_cast_weights_matches_reference(name):
    w = np.random.default_rng(0).uniform(-300, 300, (4, 3)).astype(
        np.float32)
    want = jsr.__dict__[name].cast_weights(w)
    got = tsr.__dict__[name].cast_weights(w)
    assert got.dtype == tsr.__dict__[name].weight_dtype
    assert_bitexact(got, want)
    t = tsr.__dict__[name].cast_weights(torch.as_tensor(w))
    assert_bitexact(t, to_numpy(got))
