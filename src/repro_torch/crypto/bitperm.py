"""Bit-granularity cipher permutations through the sub-element-width path.

Port of ``repro.crypto.bitperm``.  PRESENT/GIFT-style ciphers permute
individual bits of a 64-bit block.  ``BitPermutation`` wraps a static
bit-level plan (registered and schedule-pinned like every crypto plan)
behind ``core.bitwidth.bit_permute``: packed words unpack into 0/1 rows,
permute in ONE crossbar pass, and repack, for any storage width 1..31.

Built-ins: ``present_player()`` — the PRESENT pLayer from its closed
form ``P(i) = 16*i mod 63`` (``P(63) = 63``) — and ``bit_reversal(n)``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.core import bitwidth as bw
from repro_torch.core import crossbar as xb
from repro_torch.core import plan_algebra as pa
from repro_torch.crypto.registry import registry


class BitPermutation:
    """A named, registered bit-level permutation applied to packed words,
    its plan on ``device`` (None: the card)."""

    def __init__(self, key: str, dest: np.ndarray, device=None):
        """``dest[i]`` is the destination bit of input bit i (scatter
        form, as published cipher tables give it); a bijection on
        [0, n_bits)."""
        dest = np.asarray(dest, np.int32)
        if dest.ndim != 1:
            raise ValueError("bit permutation spec must be 1-D")
        if sorted(dest.tolist()) != list(range(dest.shape[0])):
            raise ValueError(
                f"bit permutation {key!r} is not a bijection on "
                f"[0, {dest.shape[0]})")
        self.device = resolve(device)
        self.key = key
        self.n_bits = int(dest.shape[0])
        self.plan = registry(self.device).get_or_register(
            key, lambda: pa.to_gather(xb.scatter_plan(
                torch.as_tensor(dest, device=self.device), self.n_bits)))
        # A key already registered from a different table would permute
        # with the wrong spec: a bijective scatter's gather normal form is
        # its inverse permutation, so the check is exact.
        inv = np.empty(self.n_bits, np.int32)
        inv[dest] = np.arange(self.n_bits, dtype=np.int32)
        if not np.array_equal(self.plan.idx[:, 0].cpu().numpy(), inv):
            raise ValueError(
                f"bit permutation {key!r} is already registered with a "
                "different destination table; static plans are immutable "
                "— use a new key")

    def inverse(self) -> "BitPermutation":
        """The transposed plan, registered under ``<key>/inv``."""
        inv = object.__new__(BitPermutation)
        inv.device = self.device
        inv.key = f"{self.key}/inv"
        inv.n_bits = self.n_bits
        inv.plan = registry(self.device).get_or_register(
            inv.key, lambda: pa.to_gather(pa.transpose(self.plan)))
        return inv

    def __call__(self, x, *, width: int = 1, backend: str = "einsum",
                 fixed_latency: bool = False) -> torch.Tensor:
        """Permute ``x``: (n_bits // width, ...) words of ``width`` bits,
        on the plan's device.  One crossbar pass at bit granularity."""
        x = torch.as_tensor(x, device=self.device)
        if not fixed_latency:
            return bw.bit_permute(self.plan, x, width=width, backend=backend)
        with registry(self.device).observe(
                ("bitperm", self.key, width),
                shapes=(tuple(x.shape), str(x.dtype)),
                backend=backend, plan_keys=(self.key,),
                expect_apply_calls=1):
            out = bw.bit_permute(self.plan, x, width=width, backend=backend)
        return out


def present_player(device=None) -> BitPermutation:
    """The PRESENT cipher's 64-bit pLayer: ``P(i) = 16*i mod 63``."""
    dest = np.array([16 * i % 63 if i != 63 else 63 for i in range(64)],
                    np.int32)
    return BitPermutation("bit/present", dest, device=device)


def bit_reversal(n_bits: int, device=None) -> BitPermutation:
    """Bit-index reversal on ``n_bits`` (a power of two) positions."""
    if n_bits & (n_bits - 1) or n_bits < 2:
        raise ValueError("bit_reversal needs a power-of-two size")
    width = n_bits.bit_length() - 1
    dest = np.array(
        [int(f"{i:0{width}b}"[::-1], 2) for i in range(n_bits)], np.int32)
    return BitPermutation(f"bit/reverse{n_bits}", dest, device=device)
