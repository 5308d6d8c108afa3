"""Sub-element-width permutation: the minimum-SEW knob, turned down.

Port of ``repro.core.bitwidth``.  A permutation at bit granularity over
payloads stored as w-bit words: words unpack into w one-bit rows
(``kernels.ops.unpack_bits``), the bit-level ``PermutePlan`` executes as
ONE crossbar pass on the widened N*w axis, and the rows pack back into
words.  Pack/unpack are branch-free shift/mask arithmetic, so the path
keeps the engine's data-independent latency.
"""

from __future__ import annotations

import torch

from repro_torch.core import crossbar as xb
from repro_torch.kernels import ops as kops


def to_bit_rows(x: torch.Tensor, width: int) -> torch.Tensor:
    """(N_words, ...) w-bit ints -> (N_words*w, ...) 0/1 int32 rows."""
    return kops.unpack_bits(x, width, axis=0)


def from_bit_rows(bits: torch.Tensor, width: int,
                  dtype=torch.int32) -> torch.Tensor:
    """(N_words*w, ...) bit rows -> (N_words, ...) packed words."""
    return kops.pack_bits(bits, width, axis=0, dtype=dtype)


def bit_permute(plan: xb.PermutePlan, x: torch.Tensor, *, width: int = 1,
                backend: str = "einsum") -> torch.Tensor:
    """Execute a bit-granularity plan over a word-packed payload.

    plan: over ``n_bits`` one-bit rows.  x: (n_bits // width, ...)
    integers of ``width`` bits each (``width=1``: the payload already is
    bit rows).  Returns x's shape and dtype, the permuted bits repacked:
    exactly one ``apply_plan`` call whatever the width.
    """
    if width == 1:
        if x.shape[0] != plan.n_in:
            raise ValueError(f"bit payload has {x.shape[0]} rows, plan "
                             f"consumes {plan.n_in}")
        return xb.apply_plan(plan, x, backend=backend)
    if x.shape[0] * width != plan.n_in:
        raise ValueError(f"{x.shape[0]} words of {width} bits != plan's "
                         f"{plan.n_in} bit rows")
    out = xb.apply_plan(plan, to_bit_rows(x, width), backend=backend)
    return from_bit_rows(out, width, dtype=x.dtype)
