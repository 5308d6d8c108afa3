"""Sub-element-width permutations in the port: pack/unpack against the
reference, and PRESENT's pLayer and 64-bit bit reversal through
``core.bitwidth`` at storage widths 1, 4 and 8 (bit-exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.crypto import bitperm as JB
from repro.kernels import ops as jops
from repro_torch.core import bitwidth as tbw
from repro_torch.core import telemetry
from repro_torch.crypto import bitperm as TB
from repro_torch.kernels import ops as tops
from test_torch_support import (assert_bitexact, jax_ref,
                                reset_torch_state)  # noqa: F401


@pytest.mark.parametrize("width,axis", [(1, 0), (4, 0), (8, 1), (31, -1)])
def test_pack_unpack_match_reference(width, axis):
    rng = np.random.default_rng(width)
    x = rng.integers(0, 1 << width, (6, 5)).astype(np.int32)
    bits = tops.unpack_bits(torch.as_tensor(x), width, axis=axis)
    assert_bitexact(bits, jops.unpack_bits(jnp.asarray(x), width, axis=axis))
    assert_bitexact(tops.pack_bits(bits, width, axis=axis), x)
    assert_bitexact(tops.pack_bits(bits, width, axis=axis),
                    jops.pack_bits(jnp.asarray(np.asarray(bits)), width,
                                   axis=axis))
    assert_bitexact(tops.bits_roundtrip(torch.as_tensor(x), width,
                                        axis=axis), x)


def test_pack_unpack_checks():
    with pytest.raises(ValueError, match="width"):
        tops.unpack_bits(torch.zeros(4, dtype=torch.int32), 32)
    with pytest.raises(ValueError, match="integer"):
        tops.unpack_bits(torch.zeros(4), 4)
    with pytest.raises(ValueError, match="multiple"):
        tops.pack_bits(torch.zeros(6, dtype=torch.int32), 4)
    assert_bitexact(tbw.to_bit_rows(torch.tensor([5, 2]), 3),
                    np.array([1, 0, 1, 0, 1, 0], np.int32))
    assert_bitexact(tbw.from_bit_rows(torch.tensor([1, 0, 1, 0, 1, 0]), 3),
                    np.array([5, 2], np.int32))


@pytest.mark.parametrize("backend", ["einsum", "kernel"])
@pytest.mark.parametrize("width", [1, 4, 8])
@pytest.mark.parametrize("which", ["present", "reverse64"])
def test_bit_permutations_match_reference(jax_ref, which, width, backend):
    if which == "present":
        tperm, jperm = TB.present_player("cpu"), JB.present_player()
    else:
        tperm, jperm = TB.bit_reversal(64, "cpu"), JB.bit_reversal(64)
    assert_bitexact(tperm.plan.idx, np.asarray(jperm.plan.idx))
    x = np.random.default_rng(width).integers(
        0, 1 << width, (64 // width, 3)).astype(np.int32)
    got = tperm(torch.as_tensor(x), width=width, backend=backend)
    assert_bitexact(got, jperm(jnp.asarray(x), width=width,
                               backend="einsum"))
    assert_bitexact(tperm.inverse()(got, width=width, backend=backend), x)


def test_present_player_moves_bits_and_fixed_latency():
    perm = TB.present_player("cpu")
    bits = torch.zeros(64, dtype=torch.int32)
    bits[1] = 1                                  # P(1) = 16
    assert int(perm(bits).nonzero()) == 16
    with telemetry.delta() as d:
        for seed in (0, 1):
            x = torch.as_tensor(np.random.default_rng(seed).integers(
                0, 16, (16, 2)).astype(np.int32))
            perm(x, width=4, backend="sparse", fixed_latency=True)
    assert d()["apply_calls"] == 2


def test_bit_permutation_checks():
    with pytest.raises(ValueError, match="bijection"):
        TB.BitPermutation("bit/bad", np.array([0, 0, 1]), device="cpu")
    with pytest.raises(ValueError, match="power-of-two"):
        TB.bit_reversal(12, "cpu")
    TB.BitPermutation("bit/swap", np.array([1, 0, 2, 3]), device="cpu")
    with pytest.raises(ValueError, match="already registered"):
        TB.BitPermutation("bit/swap", np.array([0, 1, 3, 2]), device="cpu")
    perm = TB.present_player("cpu")
    with pytest.raises(ValueError, match="bit rows"):
        perm(torch.zeros(10, dtype=torch.int32), width=4)
