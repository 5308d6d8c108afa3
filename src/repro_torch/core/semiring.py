"""Weight semirings: the algebra a crossbar pass accumulates in.

Port of ``repro.core.semiring``: ``REAL`` (multiply-add), ``GF2``
(XOR/AND; a sum of 0/1 products reduced mod 2 is the XOR accumulation),
``GF2_8`` (the AES field) and the scalar ``gf2_k(width, poly)`` family
(widths 2..31, elements carried as int32), with the flags ``apply_plan``
dispatches on.  GF(2^k) plans execute through the GF(2) bit lift
(``core.crossbar.lift_gf2_k``), whose tables are built here on the host
in numpy: they are control information.  The field arithmetic takes
numpy arrays, Python ints or tensors alike.  Wider fields (multiples of
8 up to 128: GHASH's GF(2^128)) carry elements as little-endian 8-bit
LIMBS — a trailing axis of ``width // 8`` int32 values in [0, 256),
limb ``r`` holding field bits ``8r .. 8r+7`` — and execute only through
the bit lift (``limbs`` set on the semiring).

Semirings are interned singletons: identity and ``name`` are cache-key
material, exactly as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

AES_POLY = 0x11B

# Default reduction polynomials per width (x^4 + x + 1; Rijndael;
# x^16 + x^12 + x^3 + x + 1; GHASH's x^128 + x^7 + x^2 + x + 1).
DEFAULT_POLYS = {
    4: 0x13,
    8: AES_POLY,
    16: 0x1100B,
    128: (1 << 128) | 0x87,
}


def _int32_operands(a, b):
    """Both operands as int32 tensors when either is one (on its device),
    else as numpy int32 arrays; and the ``where`` that fits them."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        like = a if isinstance(a, torch.Tensor) else b
        a = torch.as_tensor(a, device=like.device).to(torch.int32)
        b = torch.as_tensor(b, device=like.device).to(torch.int32)
        return a, b, lambda c, v: torch.where(c, v, torch.zeros_like(v))
    return (np.asarray(a, np.int32), np.asarray(b, np.int32),
            lambda c, v: np.where(c, v, 0))


def _as_int32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.int32)
    return np.asarray(a, np.int32)


def gf2_8_xtime(a):
    """Multiply by x (i.e. 2) in GF(2^8)."""
    a = _as_int32(a)
    return ((a << 1) ^ ((a >> 7) * (AES_POLY & 0xFF))) & 0xFF


def gf2_8_mul(a, b):
    """Elementwise GF(2^8) product via the xtime chain (8 fixed steps).
    Tensors, numpy arrays and Python ints; broadcasting follows the
    operands."""
    a, b, where = _int32_operands(a, b)
    acc = a * 0 + b * 0
    for i in range(8):
        acc = acc ^ where(((b >> i) & 1) != 0, a)
        a = gf2_8_xtime(a)
    return acc


def gf2_8_pow(a: int, e: int) -> int:
    """Scalar GF(2^8) exponentiation (host-side table generation)."""
    acc, base = 1, a & 0xFF
    while e:
        if e & 1:
            acc = int(gf2_8_mul(np.int32(acc), np.int32(base)))
        base = int(gf2_8_mul(np.int32(base), np.int32(base)))
        e >>= 1
    return acc


def gf2_8_inv(a: int) -> int:
    """Multiplicative inverse in GF(2^8) (0 maps to 0, as the S-box)."""
    return 0 if a == 0 else gf2_8_pow(a, 254)


@functools.lru_cache(maxsize=None)
def gf2_8_bit_matrix_table() -> np.ndarray:
    """(256, 8, 8) int8: ``T[w, b, j]`` = bit ``b`` of ``w · 2^j``, the
    GF(2)-linear form of multiplication by each constant."""
    w = np.arange(256, dtype=np.int32)
    cols = np.empty((8, 256), np.int32)
    cur = w.copy()
    for j in range(8):
        cols[j] = cur
        cur = gf2_8_xtime(cur)
    bits = (cols[:, :, None] >> np.arange(8)) & 1      # (j, w, b)
    return bits.transpose(1, 2, 0).astype(np.int8)     # (w, b, j)


def _limb_count(width: int) -> int:
    """Limbs of a wide width (0 for scalar-carried widths <= 31)."""
    return 0 if width <= 31 else width // 8


def gf2k_xtime(a, width: int, poly: int):
    """Multiply by x in GF(2^width), scalar carriers (width <= 31)."""
    mask = (1 << width) - 1
    a = _as_int32(a)
    return ((a << 1) ^ (((a >> (width - 1)) & 1) * (poly & mask))) & mask


def gf2k_mul(a, b, width: int, poly: int):
    """Elementwise GF(2^width) product, scalar carriers (width <= 31):
    a branch-free xtime chain of ``width`` steps."""
    a, b, where = _int32_operands(a, b)
    acc = a * 0 + b * 0
    for i in range(width):
        acc = acc ^ where(((b >> i) & 1) != 0, a)
        a = gf2k_xtime(a, width, poly)
    return acc


def _poly_limbs(poly: int, limbs: int) -> np.ndarray:
    """The low ``limbs`` bytes of the reduction polynomial (what is XORed
    in on overflow), little-endian limb order."""
    return np.asarray([(poly >> (8 * r)) & 0xFF for r in range(limbs)],
                      np.int32)


def gf2k_xtime_limbs(a, width: int, poly: int):
    """Multiply by x for limbed carriers: a per-limb shift with carry
    ripple, then the reduction where bit width-1 falls off."""
    limbs = width // 8
    pl = _poly_limbs(poly, limbs)
    if isinstance(a, torch.Tensor):
        a = a.to(torch.int32)
        pl = torch.as_tensor(pl, device=a.device)
        cat, where = torch.cat, torch.where
    else:
        a = np.asarray(a, np.int32)
        cat, where = np.concatenate, np.where
    carry = (a >> 7) & 1
    shifted = (a << 1) & 0xFF
    shifted = cat([shifted[..., :1], shifted[..., 1:] | carry[..., :-1]],
                  -1)
    overflow = carry[..., -1:]
    return shifted ^ where(overflow != 0, pl, pl * 0)


def gf2k_mul_limbs(a, b, width: int, poly: int):
    """Elementwise GF(2^width) product over limbed carriers: ``a``, ``b``
    (..., width // 8) int32 byte limbs, leading axes broadcasting.
    ``width`` fixed xtime steps; host-side tables and weight folds, not a
    payload hot path."""
    a, b, where = _int32_operands(a, b)
    acc = a * 0 + b * 0                         # the broadcast shape
    cur = a + acc
    for bit in range(width):
        r, sh = divmod(bit, 8)
        bbit = (b[..., r] >> sh) & 1
        acc = acc ^ where(bbit[..., None] != 0, cur)
        cur = gf2k_xtime_limbs(cur, width, poly)
    return acc


def gf2k_to_limbs(v: int, width: int) -> np.ndarray:
    """Python int -> little-endian byte-limb vector (host helper)."""
    limbs = max(1, width // 8)
    return np.asarray([(v >> (8 * r)) & 0xFF for r in range(limbs)],
                      np.int32)


def gf2k_from_limbs(limbs_vec) -> int:
    """Byte-limb vector -> Python int (host helper)."""
    return sum(int(v) << (8 * r) for r, v in enumerate(np.asarray(limbs_vec)))


def gf2k_mul_int(a: int, b: int, width: int, poly: int) -> int:
    """Exact Python-int GF(2^width) product (the host-side oracle)."""
    mask = (1 << width) - 1
    a &= mask
    b &= mask
    acc = 0
    while b:
        if b & 1:
            acc ^= a
        b >>= 1
        a <<= 1
        if a >> width:
            a ^= poly
    return acc & mask


@functools.lru_cache(maxsize=8)
def gf2k_tile_table(width: int, poly: int) -> np.ndarray:
    """(256, width, width + 8·(L-1)) int8 tiled bit-lift table, L the
    8-bit tiles of a constant: ``E[v, b, m]`` = bit ``b`` of ``v · x^m
    mod P``.  A constant ``w = Σ_t limb_t · x^(8t)`` has the bit matrix
    ``M_w[b, j] = XOR_t E[limb_t, b, j + 8t]``; for width 8 this is
    ``gf2_8_bit_matrix_table``.  Wide widths build it on limbed
    carriers."""
    limbs = max(1, width // 8 if width > 31 else (width + 7) // 8)
    n_cols = width + 8 * (limbs - 1)
    out = np.empty((256, width, n_cols), np.int8)
    if width <= 31:
        cur = np.arange(256, dtype=np.int32) & ((1 << width) - 1)
        for m in range(n_cols):
            out[:, :, m] = (cur[:, None] >> np.arange(width)) & 1
            cur = gf2k_xtime(cur, width, poly)
        return out
    cur = np.zeros((256, width // 8), np.int32)
    cur[:, 0] = np.arange(256)
    for m in range(n_cols):
        bits = (cur[:, :, None] >> np.arange(8)) & 1        # (256, L, 8)
        out[:, :, m] = bits.reshape(256, width)
        cur = gf2k_xtime_limbs(cur, width, poly)
    return out


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
        if self.limbs:
            # the identity of a wide field is the limb vector [1, 0, ...]
            w = torch.zeros(tuple(shape) + (self.limbs,),
                            dtype=self.weight_dtype, device=device)
            w[..., 0] = 1
            return w
        return torch.full(tuple(shape), self.one, dtype=self.weight_dtype,
                          device=device)

    def cast_weights(self, w) -> torch.Tensor:
        return torch.as_tensor(w).to(self.weight_dtype)


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


def gf2_k(width: int, poly: int | None = None) -> Semiring:
    """The interned GF(2^width) semiring (default polynomial per width).

    ``gf2_k(8)`` with the Rijndael polynomial is ``GF2_8`` and
    ``gf2_k(1)`` is ``GF2``: one interning for the whole family, so
    identity comparison and cache keys stay sound.  Widths 2..31 carry
    elements and weights as int32 scalars; wider ones (multiples of 8 up
    to 128) as (..., width // 8) byte limbs, executed through the lift.
    """
    if width == 1:
        return GF2
    if poly is None:
        poly = DEFAULT_POLYS.get(width)
        if poly is None:
            raise ValueError(
                f"no default polynomial for width {width}; pass poly=")
    # one member per (width, poly), however the polynomial was named
    return _gf2_k(width, poly)


@functools.lru_cache(maxsize=None)
def _gf2_k(width: int, poly: int) -> Semiring:
    if poly >> width == 0 or poly >> (width + 1):
        raise ValueError(f"polynomial {poly:#x} is not degree-{width}")
    if width == 8 and poly == AES_POLY:
        return GF2_8
    name = f"gf2_{width}" + (
        "" if poly == DEFAULT_POLYS.get(width) else f"_p{poly:x}")
    if width <= 31:
        sr = Semiring(
            name=name, add=torch.bitwise_xor,
            mul=functools.partial(gf2k_mul, width=width, poly=poly),
            zero=0, one=1, weight_dtype=torch.int32,
            integer_carrier=True, carrier_mask=(1 << width) - 1,
            width=width, poly=poly)
    else:
        if width > 128 or width % 8:
            raise ValueError(
                f"wide GF(2^k) widths must be multiples of 8 up to 128, "
                f"got {width}")
        sr = Semiring(
            name=name, add=torch.bitwise_xor,
            mul=functools.partial(gf2k_mul_limbs, width=width, poly=poly),
            zero=0, one=1, weight_dtype=torch.int32,
            integer_carrier=True, width=width, poly=poly,
            limbs=width // 8)
    _BY_NAME.setdefault(sr.name, sr)
    return sr


def get(name: str) -> Semiring:
    """Look a semiring up by its stable name; ``"gf2_<w>"`` materialises
    the family member of width w with its default polynomial."""
    try:
        return _BY_NAME[name]
    except KeyError:
        pass
    if name.startswith("gf2_"):
        try:
            width = int(name.split("_")[1])
        except (IndexError, ValueError):
            width = -1
        if width > 1 and DEFAULT_POLYS.get(width) is not None:
            return gf2_k(width)
    raise ValueError(f"unknown semiring {name!r} (have {sorted(_BY_NAME)})")


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
