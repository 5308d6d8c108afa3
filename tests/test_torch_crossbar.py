"""Port vs reference: plans, schedules and apply_plan on every backend.

The port's 'kernel' and 'sparse' backends run their kernels' plain
versions here (CPU tensors); they are held against the JAX reference's
'reference'/'einsum' backends and, for a few cases, against the JAX
Pallas kernels in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import crossbar as jxb
from repro.core import semiring as jsr
from repro_torch.core import crossbar as txb
from repro_torch.core import semiring as tsr
from repro_torch.kernels import ops
from test_torch_support import (BF16_TOL, assert_bitexact, assert_close,
                                jax_ref, reset_torch_state)  # noqa: F401

N_IN, N_OUT, D = 300, 257, 5
TORCH_BACKENDS = ["reference", "einsum", "kernel", "sparse"]


def _case(mode, k, weighted, sr, seed):
    """numpy control + payload for one crossbar case."""
    rng = np.random.default_rng(seed)
    n_ctrl, bound = (N_OUT, N_IN) if mode == "gather" else (N_IN, N_OUT)
    idx = rng.integers(-20, bound + 20, (n_ctrl, k)).astype(np.int32)
    w = None
    if sr == "gf2":
        x = rng.integers(0, 2, (N_IN, D)).astype(np.int32)
        if weighted:
            w = rng.integers(0, 2, (n_ctrl, k)).astype(np.int32)
    elif weighted:
        x = rng.standard_normal((N_IN, D)).astype(np.float32)
        w = rng.standard_normal((n_ctrl, k)).astype(np.float32)
    else:
        x = rng.integers(-1000, 1000, (N_IN, D)).astype(np.int32)
    return idx, w, x


def _plans(mode, idx, w, sr):
    jfn = jxb.gather_plan if mode == "gather" else jxb.scatter_plan
    size = N_IN if mode == "gather" else N_OUT
    jplan = jfn(jnp.asarray(idx), size,
                weights=None if w is None else jnp.asarray(w),
                semiring=jsr.get(sr))
    tplan = txb.plan_from_numpy(mode, idx, N_IN, N_OUT, weights=w,
                                semiring=sr, device="cpu")
    return jplan, tplan


def _exact(sr, weighted):
    return sr == "gf2" or not weighted


@pytest.mark.parametrize("backend", TORCH_BACKENDS)
@pytest.mark.parametrize("mode,k,weighted,sr", [
    ("gather", 1, False, "real"), ("gather", 3, True, "real"),
    ("gather", 3, False, "gf2"), ("gather", 3, True, "gf2"),
    ("scatter", 1, False, "real"), ("scatter", 3, True, "real"),
    ("scatter", 3, False, "gf2"), ("scatter", 1, True, "real"),
])
def test_apply_plan_matches_reference(jax_ref, backend, mode, k, weighted,
                                      sr):
    idx, w, x = _case(mode, k, weighted, sr, seed=k + 7 * weighted)
    jplan, tplan = _plans(mode, idx, w, sr)
    want = jxb.apply_plan(jplan, jnp.asarray(x), backend="reference")
    got = txb.apply_plan(tplan, torch.as_tensor(x), backend=backend)
    assert got.dtype == torch.as_tensor(x).dtype
    if _exact(sr, weighted):
        assert_bitexact(got, want)
    else:
        assert_close(got, want)
    if backend == "einsum":
        jein = jxb.apply_plan(jplan, jnp.asarray(x), backend="einsum")
        (assert_bitexact if _exact(sr, weighted) else assert_close)(got, jein)


@pytest.mark.parametrize("backend", TORCH_BACKENDS)
@pytest.mark.parametrize("mode", ["gather", "scatter"])
def test_merge_and_out_mask(jax_ref, backend, mode):
    rng = np.random.default_rng(3)
    idx, w, x = _case(mode, 1, False, "real", seed=11)
    merge = rng.integers(-9, 9, (N_OUT, D)).astype(np.int32)
    mask = rng.integers(0, 2, N_OUT).astype(bool)
    jplan, tplan = _plans(mode, idx, w, "real")
    want = jxb.apply_plan(jplan, jnp.asarray(x), merge=jnp.asarray(merge),
                          out_mask=jnp.asarray(mask), backend="reference")
    got = txb.apply_plan(tplan, torch.as_tensor(x),
                         merge=torch.as_tensor(merge),
                         out_mask=torch.as_tensor(mask), backend=backend)
    assert_bitexact(got, want)


def test_one_dimensional_payload_and_bf16(jax_ref):
    idx, w, _ = _case("gather", 3, True, "real", seed=5)
    x = np.random.default_rng(5).standard_normal(N_IN).astype(np.float32)
    jplan, tplan = _plans("gather", idx, w, "real")
    want = jxb.apply_plan(jplan, jnp.asarray(x), backend="reference")
    for backend in TORCH_BACKENDS:
        got = txb.apply_plan(tplan, torch.as_tensor(x), backend=backend)
        assert tuple(got.shape) == (N_OUT,)
        assert_close(got, want)
    xb16 = torch.as_tensor(x).to(torch.bfloat16)
    wb16 = torch.as_tensor(w).to(torch.bfloat16).to(torch.float32)
    ref_b16 = txb.apply_plan(txb.gather_plan(tplan.idx, N_IN, weights=wb16),
                             xb16.to(torch.float32), backend="reference")
    for backend in ("kernel", "sparse"):
        got = txb.apply_plan(tplan, xb16, backend=backend)
        assert got.dtype == torch.bfloat16
        assert_close(got, ref_b16, BF16_TOL)


@pytest.mark.parametrize("case", ["gather_weighted_merge", "scatter_gf2"])
def test_kernel_plain_versions_match_pallas_interpret(jax_ref, case):
    if case == "gather_weighted_merge":
        mode, k, weighted, sr = "gather", 3, True, "real"
    else:
        mode, k, weighted, sr = "scatter", 3, False, "gf2"
    idx, w, x = _case(mode, k, weighted, sr, seed=21)
    jplan, tplan = _plans(mode, idx, w, sr)
    merge = None
    if case == "gather_weighted_merge":
        merge = np.random.default_rng(2).standard_normal(
            (N_OUT, D)).astype(np.float32)
    for backend in ("kernel", "sparse"):
        want = jxb.apply_plan(
            jplan, jnp.asarray(x), backend=backend, interpret=True,
            merge=None if merge is None else jnp.asarray(merge))
        got = txb.apply_plan(
            tplan, torch.as_tensor(x), backend=backend,
            merge=None if merge is None else torch.as_tensor(merge))
        (assert_bitexact if _exact(sr, weighted) else assert_close)(got,
                                                                    want)


@pytest.mark.parametrize("mode,blocks,batch", [
    ("gather", (128, 128), 1), ("gather", (64, 32), 1),
    ("scatter", (128, 128), 1), ("gather", (128, 128), 5),
])
def test_compile_plan_schedule_equals_reference(jax_ref, mode, blocks,
                                                batch):
    from repro.core import plan_algebra as jpa
    from repro_torch.core import plan_algebra as tpa
    idx, w, _ = _case(mode, 2, False, "real", seed=9)
    jplan, tplan = _plans(mode, idx, w, "real")
    if batch > 1:
        jplan, tplan = jpa.batch(jplan, batch), tpa.batch(tplan, batch)
    bo, bn = blocks
    jc = jxb.compile_plan(jplan, block_o=bo, block_n=bn)
    tc = txb.compile_plan(tplan, block_o=bo, block_n=bn)
    assert tc.num_active == jc.num_active
    assert (tc.n_o_tiles, tc.n_n_tiles) == (jc.n_o_tiles, jc.n_n_tiles)
    for name in ("occupancy", "pair_o", "pair_n", "active"):
        assert_bitexact(getattr(tc, name), getattr(jc, name))
    assert tc.density == pytest.approx(float(jc.density))
    # CSR runs cover exactly the active pairs, one run per output tile.
    run_o, run_ptr = tc.runs
    assert int(run_ptr[-1]) == tc.num_active
    assert_bitexact(torch.repeat_interleave(run_o, run_ptr.diff()),
                    tc.pair_o[:tc.num_active])


def test_compile_cache_lru_pin_and_guard():
    from repro_torch.core import integrity
    plan = txb.gather_plan(torch.arange(300, dtype=torch.int32).flip(0), 300)
    c1 = txb.compile_plan(plan)
    assert txb.compile_plan(plan) is c1
    info = txb.compile_cache_info()
    assert (info["hits"], info["misses"], info["size"]) == (1, 1, 1)
    assert txb.compile_plan(plan, pin=True) is c1
    assert txb.compile_cache_info()["pinned"] == 1
    assert txb.unpin_plan(plan) == 1
    c2 = txb.compile_plan(plan)
    with integrity.always_verify():
        c2.pair_n[0] += 1                      # corrupt the cached schedule
        with pytest.raises(integrity.IntegrityError):
            txb.compile_plan(plan)
    assert txb.compile_plan(plan) is not c2    # evicted and recompiled


def test_sparse_overlay_pins_unvisited_tiles(monkeypatch):
    rng = np.random.default_rng(4)
    src = rng.integers(0, 512, 512).astype(np.int32)
    src[128:384] = -1                          # output tiles 1 and 2 unvisited
    plan = txb.plan_from_numpy("gather", src, 512, 512, device="cpu")
    assert not bool(txb.compile_plan(plan).occupancy.any(dim=1).all())
    monkeypatch.setattr(ops, "_empty_out", lambda shape, dtype, device:
                        torch.full(shape, 12345.0, dtype=dtype,
                                   device=device))
    x = torch.as_tensor(rng.standard_normal((512, 3)).astype(np.float32))
    raw = ops.crossbar_permute_sparse(plan, x)
    assert bool((raw[128:384] == 12345.0).all())  # left unwritten
    out = txb.apply_plan(plan, x, backend="sparse")
    assert_bitexact(out, txb.apply_plan(plan, x, backend="reference"))
    assert bool((out[128:384] == 0).all())


def test_integer_bound_and_semiring_checks():
    plan = txb.gather_plan(torch.tensor([1, 0], dtype=torch.int32), 2)
    big = torch.tensor([[1 << 24], [3]], dtype=torch.int32)
    for backend in ("kernel", "sparse"):
        with pytest.raises(ValueError, match="2\\^24"):
            txb.apply_plan(plan, big, backend=backend)
    assert_bitexact(txb.apply_plan(plan, big, backend="einsum"),
                    np.array([[3], [1 << 24]], np.int32))
    gf = txb.gather_plan(plan.idx, 2, semiring=tsr.GF2)
    with pytest.raises(ValueError, match="integer"):
        txb.apply_plan(gf, torch.ones(2, 1), backend="einsum")
    g8 = txb.gather_plan(plan.idx, 2, semiring=tsr.GF2_8)
    small = torch.tensor([[0x1FF], [3]], dtype=torch.int32)
    assert_bitexact(txb.apply_plan(g8, small),
                    np.array([[3], [0xFF]], np.int32))
    g128 = txb.gather_plan(plan.idx, 2, semiring=tsr.gf2_k(128))
    with pytest.raises(ValueError, match="integer"):
        txb.apply_plan(g128, torch.ones(2, 16), backend="einsum")
    with pytest.raises(ValueError, match="device"):
        txb.apply_plan(plan, torch.ones(2, 1, dtype=torch.int32,
                                        device="meta"))


def test_einsum_integer_path_wraps_like_int32(jax_ref):
    idx = np.array([[0, 1], [1, 1]], np.int32)
    x = np.array([[2**30], [2**30 + 5]], np.int32)
    jplan = jxb.gather_plan(jnp.asarray(idx), 2)
    tplan = txb.plan_from_numpy("gather", idx, 2, 2, device="cpu")
    assert_bitexact(txb.apply_plan(tplan, torch.as_tensor(x)),
                    jxb.apply_plan(jplan, jnp.asarray(x), backend="einsum"))


def test_build_onehot_coverage_transpose(jax_ref):
    for mode, k in (("gather", 2), ("scatter", 2)):
        idx, w, _ = _case(mode, k, True, "real", seed=13)
        jplan, tplan = _plans(mode, idx, w, "real")
        assert_close(txb.build_onehot(tplan), jxb.build_onehot(jplan))
        assert_bitexact(txb.coverage(tplan), jxb.coverage(jplan))
        tt = txb.transpose_plan(tplan)
        assert tt.idx is tplan.idx and (tt.n_in, tt.n_out) == (N_OUT, N_IN)


def test_auto_backend_on_cpu_is_einsum():
    plan = txb.gather_plan(torch.arange(4096, dtype=torch.int32), 4096)
    assert txb._choose_backend(plan) == "einsum"
    x = torch.arange(4096, dtype=torch.int32)[:, None]
    txb.apply_plan(plan, x, backend="auto")
    assert txb.apply_calls_by_backend() == {"einsum": 1}
