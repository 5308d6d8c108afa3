"""The scatter inversion (``kernels.ref.invert_scatter``) against the JAX
reference, and the plain crossbars summing scatters through it.

A scatter runs as a gather once its control is inverted: for each output
row, the control entries ``e = i * K + j`` landing on it, in (i, j)
order.  For an output-injective scatter that is the reference's
``plan_algebra.to_gather``; on colliding plans the order is what keeps
REAL sums deterministic.  The plain versions sum scatters with one
``index_add_`` on the CPU and through the inversion on the card; both
give the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import crossbar as jxb
from repro.core import plan_algebra as jpa
from repro_torch.core import crossbar as txb
from repro_torch.core.semiring import GF2
from repro_torch.kernels import ops, ref
from test_torch_support import (assert_bitexact, jax_ref,  # noqa: F401
                                reset_torch_state)


def _injective_dest(rng, n_in, k, n_out, n_drop):
    """Distinct destinations for all but n_drop entries, which drop
    (DROP = -1 or out of range)."""
    dest = rng.permutation(n_out)[:n_in * k].astype(np.int32)
    drops = rng.choice(n_in * k, n_drop, replace=False)
    dest[drops] = rng.choice([-1, n_out, n_out + 7], n_drop)
    return dest.reshape(n_in, k)


def _gather_form(row_ptr, ent, k, w_flat):
    """(src, w) per output row from the CSR of an injective scatter."""
    hits = row_ptr[1:] - row_ptr[:-1]
    first = ent[row_ptr[:-1].clamp(max=max(ent.numel() - 1, 0))] \
        if ent.numel() else torch.zeros_like(hits)
    src = torch.where(hits > 0, first // k, -1).to(torch.int32)
    w = None
    if w_flat is not None:
        w = torch.where(hits > 0, w_flat[first], torch.zeros(()))
    return src, w


@pytest.mark.parametrize("k,weighted,seed", [
    (1, False, 0), (1, True, 1), (2, False, 2), (2, True, 3), (3, True, 4),
])
def test_inversion_of_injective_scatter_is_reference_to_gather(
        jax_ref, k, weighted, seed):
    rng = np.random.default_rng(seed)
    n_in, n_out = 97, 400
    dest = _injective_dest(rng, n_in, k, n_out, n_drop=23)
    w = rng.standard_normal((n_in, k)).astype(np.float32) if weighted \
        else None
    jplan = jpa.to_gather(jxb.scatter_plan(
        jnp.asarray(dest), n_out,
        weights=None if w is None else jnp.asarray(w)))
    row_ptr, ent = ref.invert_scatter(torch.as_tensor(dest), n_in, n_out)
    assert int((row_ptr[1:] - row_ptr[:-1]).max()) <= 1
    src, tw = _gather_form(row_ptr, ent, k,
                           None if w is None else torch.as_tensor(w)
                           .reshape(-1))
    assert_bitexact(src, np.asarray(jplan.idx)[:, 0])
    if weighted:
        assert_bitexact(tw, np.asarray(jplan.weights)[:, 0])


@pytest.mark.parametrize("n_out,k,seed", [(5, 3, 0), (64, 2, 1), (300, 4, 2),
                                          (1, 1, 3)])
def test_colliding_segments_are_in_input_select_order(n_out, k, seed):
    rng = np.random.default_rng(seed)
    n_in = 211
    dest = rng.integers(-3, n_out + 3, (n_in, k)).astype(np.int32)
    plan = txb.plan_from_numpy("scatter", dest, n_in, n_out, device="cpu")
    row_ptr, ent = ref.invert_scatter(plan.idx, n_in, n_out)
    flat = dest.reshape(-1)
    for o in range(n_out):
        seg = ent[row_ptr[o]:row_ptr[o + 1]].numpy()
        assert np.array_equal(seg, np.flatnonzero(flat == o))
    assert_bitexact(row_ptr[1:] - row_ptr[:-1] > 0, txb.coverage(plan))
    assert int(row_ptr[-1]) == int(((flat >= 0) & (flat < n_out)).sum())


def _index_add_sum(idx, x, weights, n_out):
    """A CPU ``index_add_`` over all (input row, select) contributions,
    the DROPs' as zeros on row 0."""
    n_in, d = x.shape
    k = idx.shape[1]
    xf = x.to(torch.float32)
    idx = idx[:n_in]
    valid = (idx >= 0) & (idx < n_out)
    dest = torch.where(valid, idx, torch.zeros_like(idx)).reshape(-1).long()
    contrib = xf[:, None, :].expand(n_in, k, d)
    if weights is not None:
        contrib = ref._weights_as_compute(weights, x)[:n_in, :, None] * contrib
    contrib = torch.where(valid[:, :, None], contrib,
                          torch.zeros_like(contrib)).reshape(n_in * k, d)
    acc = torch.zeros((n_out, d), dtype=torch.float32)
    acc.index_add_(0, dest, contrib)
    hits = torch.zeros((n_out,), dtype=torch.int64)
    hits.index_add_(0, dest, valid.reshape(-1).long())
    return acc, hits


def _scatter_case(case, rng):
    n_in, n_out = 260, 300
    dest = rng.integers(-4, n_out // 3, (n_in, 3)).astype(np.int32)
    w = rng.standard_normal((n_in, 3)).astype(np.float32)
    x = rng.standard_normal((n_in, 9)).astype(np.float32)
    merge = None
    if case == "weighted_f32":
        plan = txb.plan_from_numpy("scatter", dest, n_in, n_out, weights=w,
                                   device="cpu")
    elif case == "weighted_bf16":
        plan = txb.plan_from_numpy("scatter", dest, n_in, n_out, weights=w,
                                   device="cpu")
        x = torch.as_tensor(x).to(torch.bfloat16)
    elif case == "gf2_fold":
        plan = txb.plan_from_numpy("scatter", dest, n_in, n_out,
                                   semiring=GF2, device="cpu")
        x = rng.integers(0, 2, (n_in, 9)).astype(np.int32)
    elif case == "hot_row":                      # in-degree > n_in
        dest[:, 0] = 5
        plan = txb.plan_from_numpy("scatter", dest, n_in, n_out, weights=w,
                                   device="cpu")
    elif case == "merge_uncovered":
        plan = txb.plan_from_numpy("scatter", dest, n_in, n_out,
                                   device="cpu")
        merge = torch.as_tensor(rng.standard_normal((n_out, 9)).astype(
            np.float32))
    else:                                        # "d1"
        plan = txb.plan_from_numpy("scatter", dest, n_in, n_out, weights=w,
                                   device="cpu")
        x = x[:, :1]
    return plan, torch.as_tensor(x), merge


@pytest.mark.parametrize("case", ["weighted_f32", "weighted_bf16", "gf2_fold",
                                  "hot_row", "merge_uncovered", "d1"])
def test_plain_scatter_through_the_inversion_keeps_its_bits(case):
    plan, x, merge = _scatter_case(case, np.random.default_rng(7))
    idxp, xf, kw = ops.dense_operands(plan, x, merge=merge)
    acc, hits = _index_add_sum(idxp, xf, kw["weights"], plan.n_out)
    got_acc, got_hits = ref._contributions(idxp, xf, kw["weights"],
                                           "scatter", plan.n_out)
    assert_bitexact(got_acc, acc)
    assert_bitexact(got_hits, hits)
    # the card's plain sum: through the inversion, a segment position a step
    w = None if kw["weights"] is None else ref._weights_as_compute(
        kw["weights"], xf)
    inv_acc, inv_hits = ref._scatter_sum(idxp, xf.to(torch.float32), w,
                                         plan.n_out, inverted=True)
    assert_bitexact(inv_acc, acc)
    assert_bitexact(inv_hits, hits)
    want = ref._fold2(acc) if kw["fold_mod2"] else acc
    if merge is not None:
        want = torch.where(hits[:, None] > 0, want, merge)
    assert_bitexact(ref.crossbar_dense(idxp, xf, **kw), want.to(xf.dtype))

    args, skw = ops.sparse_operands(plan, x)
    skw["out"].fill_(-7.0)
    got = ref.crossbar_sparse(*args, **skw)
    sched = torch.zeros(plan.n_out, dtype=torch.bool)
    for t in args[0].tolist():
        sched[t * 128:(t + 1) * 128] = True
    want_s = ref._fold2(acc) if kw["fold_mod2"] else acc
    want_s = torch.where(sched[:, None], want_s, torch.full_like(want_s,
                                                                 -7.0))
    assert_bitexact(got, want_s.to(xf.dtype))


def test_unscheduled_rows_are_the_tiles_without_active_pairs():
    rng = np.random.default_rng(5)
    dest = rng.integers(0, 700, 600).astype(np.int32)
    dest[(dest >= 128) & (dest < 384)] = -1         # tiles 1 and 2 empty
    plan = txb.plan_from_numpy("scatter", dest, 600, 700, device="cpu")
    compiled = txb.compile_plan(plan)
    assert compiled.run_o.tolist() == [0, 3, 4, 5]
    assert_bitexact(compiled.idle_rows, np.arange(128, 384))
    x = torch.as_tensor(rng.standard_normal((600, 2)).astype(np.float32))
    assert_bitexact(txb.apply_plan(plan, x, backend="sparse"),
                    txb.apply_plan(plan, x, backend="reference"))
    # a ragged idle last tile (rows 640-699) repeats its first row
    dest[dest >= 640] = -1
    ragged = txb.compile_plan(txb.plan_from_numpy("scatter", dest, 600, 700,
                                                  device="cpu"))
    assert ragged.run_o.tolist() == [0, 3, 4]
    assert_bitexact(ragged.idle_rows, np.concatenate(
        [np.arange(128, 384), np.arange(640, 700), np.full(68, 640)]))
    full = txb.compile_plan(txb.plan_from_numpy(
        "scatter", np.arange(600, dtype=np.int32) % 700, 600, 700,
        device="cpu"))
    assert full.run_o.shape[0] == full.n_o_tiles - 1   # rows 640-699 idle
    every = txb.compile_plan(txb.plan_from_numpy(
        "scatter", (np.arange(600, dtype=np.int32) * 7) % 700, 600, 700,
        device="cpu"))
    assert every.run_o.shape[0] == every.n_o_tiles
    assert every.idle_rows.numel() == 0
