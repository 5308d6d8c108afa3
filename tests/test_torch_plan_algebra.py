"""Port vs reference: the plan algebra, the lazy chain and the RVV ops."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import crossbar as jxb
from repro.core import permute as JP
from repro.core import plan_algebra as jpa
from repro.core import semiring as jsr
from repro_torch.core import crossbar as txb
from repro_torch.core import permute as TP
from repro_torch.core import plan_algebra as tpa
from repro_torch.core import semiring as tsr
from repro_torch.core import telemetry
from test_torch_support import (assert_bitexact, assert_close, jax_ref,
                                reset_torch_state)  # noqa: F401

N = 96


def _both(mode, idx, n_in, n_out, w=None, sr="real"):
    jfn = jxb.gather_plan if mode == "gather" else jxb.scatter_plan
    jplan = jfn(jnp.asarray(idx), n_in if mode == "gather" else n_out,
                weights=None if w is None else jnp.asarray(w),
                semiring=jsr.get(sr))
    tplan = txb.plan_from_numpy(mode, idx, n_in, n_out, weights=w,
                                semiring=sr, device="cpu")
    return jplan, tplan


def _same_plan(tplan, jplan):
    assert (tplan.mode, tplan.n_in, tplan.n_out, tplan.semiring.name) == (
        jplan.mode, jplan.n_in, jplan.n_out, jplan.semiring.name)
    assert_bitexact(tplan.idx, jplan.idx)
    assert (tplan.weights is None) == (jplan.weights is None)
    if tplan.weights is not None:
        assert_bitexact(tplan.weights, jplan.weights)


@pytest.mark.parametrize("seed", [0, 1])
def test_compose_to_gather_and_compact_equal_reference(jax_ref, seed):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N).astype(np.int32)
    dest = np.where(rng.random(N) < 0.2, -1, perm).astype(np.int32)
    j1, t1 = _both("scatter", dest, N, N)            # injective scatter
    src = rng.integers(-3, N + 3, (N, 2)).astype(np.int32)
    w = rng.integers(0, 2, (N, 2)).astype(np.int32)
    j2, t2 = _both("gather", src, N, N, w=w, sr="gf2")
    _same_plan(tpa.to_gather(t1), jpa.to_gather(j1))
    _same_plan(tpa.compose(t2, t1), jpa.compose(j2, j1))
    _same_plan(tpa.compose(t1, t2), jpa.compose(j1, j2))
    _same_plan(tpa.compact_selects(tpa.compose(t2, t2)),
               jpa.compact_selects(jpa.compose(j2, j2)))
    _same_plan(tpa.compose_all([t1, t2, t1]), jpa.compose_all([j1, j2, j1]))
    # The memo returns the same object for a rebuilt construction.
    assert tpa.compose(t2, t1) is tpa.compose(t2, t1)
    with pytest.raises(ValueError, match="semiring mismatch"):
        tpa.compose(t2, tpa.with_weights(t1, torch.ones(N)))


def test_compose_real_weights_and_identity(jax_ref):
    rng = np.random.default_rng(4)
    src = rng.integers(0, N, (N, 2)).astype(np.int32)
    w = rng.standard_normal((N, 2)).astype(np.float32)
    jg, tg = _both("gather", src, N, N, w=w)
    jc, tc = jpa.compose(jg, jg), tpa.compose(tg, tg)
    assert_bitexact(tc.idx, jc.idx)
    assert_close(tc.weights, jc.weights)
    ident = tpa.identity_plan(N, device="cpu")
    assert tpa.is_identity(ident)
    assert tpa.compose(tg, ident) is tg
    x = torch.as_tensor(rng.standard_normal((N, 3)).astype(np.float32))
    assert_close(txb.apply_plan(tc, x),
                 txb.apply_plan(tg, txb.apply_plan(tg, x)))


def test_batch_block_diag_and_batched_plans_equal_reference(jax_ref):
    rng = np.random.default_rng(5)
    src = rng.integers(-2, 40, (32, 2)).astype(np.int32)
    w = rng.standard_normal((32, 2)).astype(np.float32)
    jg, tg = _both("gather", src, 40, 32, w=w)
    jh, th = _both("gather", rng.integers(0, 16, 16).astype(np.int32), 16, 16)
    _same_plan(tpa.batch(tg, 3), jpa.batch(jg, 3))
    _same_plan(tpa.block_diag([tg, th]), jpa.block_diag([jg, jh]))
    bidx = rng.integers(-1, 20, (3, 20)).astype(np.int32)
    _same_plan(tpa.batched_gather_plan(torch.as_tensor(bidx), 20),
               jpa.batched_gather_plan(jnp.asarray(bidx), 20))
    _same_plan(tpa.batched_scatter_plan(torch.as_tensor(bidx), 20),
               jpa.batched_scatter_plan(jnp.asarray(bidx), 20))
    with pytest.raises(ValueError, match="empty"):
        tpa.block_diag([])
    assert tpa.with_semiring(tg, tsr.GF2).semiring is tsr.GF2


def test_lazy_chain_is_one_pass_and_matches_reference(jax_ref):
    rng = np.random.default_rng(6)
    x = rng.integers(-100, 100, (N, 4)).astype(np.int32)
    mask = rng.integers(0, 2, N).astype(bool)
    gidx = rng.integers(-4, N + 4, N).astype(np.int32)
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    tm, jm = torch.as_tensor(mask), jnp.asarray(mask)
    tg, jg = torch.as_tensor(gidx), jnp.asarray(gidx)

    def chain(P, xx, mm, gg, lazy):
        y = P.lazy(xx) if lazy else xx
        y = P.vcompress(y, mm)
        y = P.vslideup(y, 3)
        y = P.vslideup(y, 2)
        y = P.vrgather(y, gg)
        y = P.vslidedown(y, 7)
        return y.apply() if lazy else y

    with telemetry.delta() as d:
        got = chain(TP, tx, tm, tg, True)
    assert d()["apply_calls"] == 1
    assert_bitexact(got, chain(JP, jx, jm, jg, True))
    assert_bitexact(got, chain(TP, tx, tm, tg, False))
    expr = TP.vslideup(TP.vslideup(TP.lazy(tx), 3), 2)
    assert len(tpa._simplify_ops(expr.ops)) == 1     # slides fold


@pytest.mark.parametrize("backend", ["reference", "einsum", "kernel",
                                     "sparse"])
def test_rvv_ops_equal_reference(jax_ref, backend):
    rng = np.random.default_rng(7)
    x = rng.integers(-50, 50, (N, 3)).astype(np.int32)
    merge = rng.integers(-9, 9, (N, 3)).astype(np.int32)
    mask = rng.integers(0, 2, N).astype(bool)
    gidx = rng.integers(-5, N + 5, N).astype(np.int32)
    t = {k: torch.as_tensor(v) for k, v in
         dict(x=x, m=merge, mask=mask, g=gidx).items()}
    j = {k: jnp.asarray(v) for k, v in
         dict(x=x, m=merge, mask=mask, g=gidx).items()}
    cases = [
        lambda P, a, be: P.vrgather(a["x"], a["g"], mask=a["mask"],
                                    merge=a["m"], backend=be),
        lambda P, a, be: P.vrgather(a["x"], a["g"][:40], backend=be),
        lambda P, a, be: P.vcompress(a["x"], a["mask"], backend=be),
        lambda P, a, be: P.vcompress(a["x"], a["mask"], tail="bijective",
                                     backend=be),
        lambda P, a, be: P.vcompress(a["x"], a["mask"], tail="keep",
                                     merge=a["m"], backend=be),
        lambda P, a, be: P.vexpand(a["x"], a["mask"], merge=a["m"],
                                   backend=be),
        lambda P, a, be: P.vslideup(a["x"], 5, merge=a["m"], backend=be),
        lambda P, a, be: P.vslidedown(a["x"], 9, mask=a["mask"],
                                      backend=be),
        lambda P, a, be: P.vrgather(a["x"], a["g"][:48], group=2,
                                    backend=be),
    ]
    for fn in cases:
        assert_bitexact(fn(TP, t, backend), fn(JP, j, "reference"))


def test_single_slides_merge_and_batched(jax_ref):
    rng = np.random.default_rng(8)
    x = rng.integers(-50, 50, (6, 16, 2)).astype(np.int32)
    mask = rng.integers(0, 2, (6, 16)).astype(bool)
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    tm, jm = torch.as_tensor(mask), jnp.asarray(mask)
    assert_bitexact(TP.vslide1up(tx[0], 7), JP.vslide1up(jx[0], 7))
    assert_bitexact(TP.vslide1down(tx[0]), JP.vslide1down(jx[0]))
    assert_bitexact(TP.vmerge(tx[0], tx[1], tm[0]),
                    JP.vmerge(jx[0], jx[1], jm[0]))
    want = JP.batched(lambda a, m: JP.vcompress(a, m))(jx, jm)
    assert_bitexact(TP.batched(lambda a, m: TP.vcompress(a, m))(tx, tm),
                    want)
    for backend in ("einsum", "sparse", "kernel", "auto"):
        for tail in ("zero", "bijective"):
            assert_bitexact(
                TP.vcompress_batched(tx, tm, tail=tail, backend=backend),
                JP.vcompress_batched(jx, jm, tail=tail, backend="einsum"))
