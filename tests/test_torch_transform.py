"""Port vs reference: the control-information transforms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transform as jt
from repro_torch.core import transform as tt
from test_torch_support import assert_bitexact, reset_torch_state  # noqa: F401

SEEDS = [0, 1, 2]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 7, 64, 301])
def test_compress_destinations_and_keep_count(seed, n):
    mask = np.random.default_rng(seed).integers(0, 2, (3, n)).astype(bool)
    dest = tt.compress_destinations(torch.as_tensor(mask))
    assert_bitexact(dest, jt.compress_destinations(jnp.asarray(mask)))
    assert bool(tt.destinations_are_bijective(dest[0]))
    assert_bitexact(tt.compress_keep_count(torch.as_tensor(mask)),
                    jt.compress_keep_count(jnp.asarray(mask)))


@pytest.mark.parametrize("seed", SEEDS)
def test_prefix_sums(seed):
    x = np.random.default_rng(seed).integers(0, 5, (4, 33)).astype(np.int32)
    for axis in (0, -1):
        assert_bitexact(tt.exclusive_cumsum(torch.as_tensor(x), dim=axis),
                        jt.exclusive_cumsum(jnp.asarray(x), axis=axis))
        assert_bitexact(
            tt.exclusive_suffix_sum(torch.as_tensor(x), dim=axis),
            jt.exclusive_suffix_sum(jnp.asarray(x), axis=axis))


@pytest.mark.parametrize("offset", [-5, 0, 3, 64, 200])
@pytest.mark.parametrize("up", [True, False])
def test_slide_destinations(offset, up):
    want = jt.slide_destinations(100, offset, up=up)
    assert_bitexact(tt.slide_destinations(100, offset, up=up, device="cpu"),
                    want)
    assert_bitexact(tt.slide_destinations(
        100, torch.tensor(offset, dtype=torch.int32), up=up), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_gather_sources_from_destinations(seed):
    rng = np.random.default_rng(seed)
    dest = rng.integers(-3, 40, 30).astype(np.int32)
    src, cov = tt.gather_sources_from_destinations(torch.as_tensor(dest), 40)
    jsrc, jcov = jt.gather_sources_from_destinations(jnp.asarray(dest), 40)
    assert_bitexact(cov, jcov)
    assert_bitexact(src, jsrc)


def test_bijectivity_check_rejects_collisions():
    assert not bool(tt.destinations_are_bijective(
        torch.tensor([0, 0, 2], dtype=torch.int32)))
