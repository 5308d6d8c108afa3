"""Weight semirings: the algebra a crossbar pass accumulates in.

Port of ``repro.core.semiring`` for the slice that carries SHA-3:
``REAL`` (multiply-add), ``GF2`` (XOR/AND; a sum of 0/1 products
reduced mod 2 is the XOR accumulation) and ``GF2_8`` (the AES field),
with the flags ``apply_plan`` dispatches on.  ``GF2_8`` plans can be
built and composed here, but executing them needs the GF(2) bit lift,
which comes with the AES/GCM slice together with the ``gf2_k`` family
and its limb arithmetic.

Semirings are interned singletons: identity and ``name`` are cache-key
material, exactly as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

AES_POLY = 0x11B


def gf2_8_xtime(a: torch.Tensor) -> torch.Tensor:
    """Multiply by x (i.e. 2) in GF(2^8)."""
    a = a.to(torch.int32)
    return ((a << 1) ^ ((a >> 7) * (AES_POLY & 0xFF))) & 0xFF


def gf2_8_mul(a, b) -> torch.Tensor:
    """Elementwise GF(2^8) product via the xtime chain (8 fixed steps)."""
    a = torch.as_tensor(a).to(torch.int32)
    b = torch.as_tensor(b, device=a.device).to(torch.int32)
    acc = a * 0 + b * 0
    for i in range(8):
        acc = acc ^ torch.where(((b >> i) & 1) != 0, a, torch.zeros_like(a))
        a = gf2_8_xtime(a)
    return acc


def _xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    out = torch.zeros_like(x.select(dim, 0)) if x.shape[dim] else \
        torch.zeros(x.shape[:dim] + x.shape[dim + 1:], dtype=x.dtype,
                    device=x.device)
    for i in range(x.shape[dim]):
        out = out ^ x.select(dim, i)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class Semiring:
    """A named (add, mul, zero, one) with backend execution hooks.

    Attributes mirror the reference: ``weight_dtype`` is the dtype
    weights materialise in, ``integer_carrier`` requires integer
    payloads, ``mod2_fold`` says a dense sum of products equals the
    accumulation after a parity fold, ``carrier_mask`` folds picked
    values into the carrier set, ``width``/``poly``/``limbs`` describe
    the GF(2^k) family (``is_gf2k`` plans run through the bit lift).
    """

    name: str
    add: Callable
    mul: Callable
    zero: int
    one: int
    weight_dtype: torch.dtype
    integer_carrier: bool = False
    mod2_fold: bool = False
    carrier_mask: int | None = None
    width: int = 0
    poly: int | None = None
    limbs: int = 0

    def __repr__(self) -> str:
        return f"Semiring({self.name!r})"

    @property
    def is_gf2k(self) -> bool:
        return self.width >= 2

    def reduce(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if self.name == "real":
            return torch.sum(x, dim=dim)
        return _xor_reduce(x, dim)

    def ones(self, shape, device=None) -> torch.Tensor:
        return torch.full(tuple(shape), self.one, dtype=self.weight_dtype,
                          device=device)


REAL = Semiring(
    name="real", add=lambda a, b: a + b, mul=lambda a, b: a * b,
    zero=0, one=1, weight_dtype=torch.float32)

GF2 = Semiring(
    name="gf2", add=torch.bitwise_xor, mul=torch.bitwise_and,
    zero=0, one=1, weight_dtype=torch.int32,
    integer_carrier=True, mod2_fold=True, carrier_mask=1, width=1)

GF2_8 = Semiring(
    name="gf2_8", add=torch.bitwise_xor, mul=gf2_8_mul,
    zero=0, one=1, weight_dtype=torch.int32,
    integer_carrier=True, carrier_mask=0xFF, width=8, poly=AES_POLY)

_BY_NAME = {s.name: s for s in (REAL, GF2, GF2_8)}


def get(name: str) -> Semiring:
    """Look a semiring up by its stable name."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(
            f"unknown semiring {name!r} (have {sorted(_BY_NAME)}; the "
            "gf2_k family comes with the AES/GCM slice)") from None


def join(s1: Semiring, s2: Semiring, *, neutral1: bool = False,
         neutral2: bool = False) -> Semiring:
    """The common semiring of two plans being combined.

    Equal semirings join to themselves; an unweighted REAL plan is
    semiring-neutral and adopts the other operand's algebra; anything
    else raises.
    """
    if s1 is s2:
        return s1
    if s1 is REAL and neutral1:
        return s2
    if s2 is REAL and neutral2:
        return s1
    raise ValueError(
        f"semiring mismatch: cannot combine plans over {s1.name!r} and "
        f"{s2.name!r}; reweight one side (plan_algebra.with_weights / "
        "with_semiring) so both agree")
