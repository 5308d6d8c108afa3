"""CUDA wrapper of the fused vcompress (``csrc/fused_compress.cu``).

Port of ``repro/kernels/fused_compress.py`` (``fused_vcompress_pallas``).
This is the raw entry: a (N,) mask and an (N, D) payload on a CUDA
device; it checks what the kernel takes, allocates the output, picks the
launch geometry (``launch_geometry``), launches the one kernel on
PyTorch's current stream and counts the launch.  The mask reaches the
kernel in its own dtype (``mask_operand``).  The wrapper that also takes
CPU tensors (the plain version) is ``kernels.ops.fused_vcompress``.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import KernelLaunchError

TAILS = ("zero", "bijective")
_MAX_INT32 = 2**31 - 1

# Launch geometry (csrc/fused_compress.cu): rows a CTA owns are a multiple
# of ROW_ALIGN (so no 16-byte mask vector straddles two CTAs), at most
# CTAS_PER_SM CTAs an SM, each row moved by 1-32 lanes.
ROW_ALIGN = 16
CTAS_PER_SM = 2

LAUNCHES = {"fused_vcompress": 0}
_LOCK = threading.Lock()

_FLOAT_KEEP = {2: (0x7FFF7FFF, 0x7FFF7FFF), 4: (0x7FFFFFFF, 0x7FFFFFFF),
               8: (0xFFFFFFFF, 0x7FFFFFFF)}
_SM_COUNT: dict = {}


def check_tail(tail: str) -> None:
    if tail not in TAILS:
        raise ValueError(f"tail must be one of {TAILS}, got {tail!r}")


def mask_operand(mask):
    """(tensor, element bytes, keep_lo, keep_hi): the mask as the kernel
    reads it.  Bool, integer and float16/bfloat16/float32/float64 masks
    go in as they are — an element selects when its bits under
    keep_hi:keep_lo (the sign bit cleared for floats, so -0.0 does not)
    are not all zero; other dtypes (complex, fp8) are compared with 0
    first."""
    if mask.dtype.is_complex or mask.element_size() not in (1, 2, 4, 8) or (
            mask.dtype.is_floating_point and mask.element_size() == 1):
        mask = mask != 0
    es = mask.element_size()
    keep = (_FLOAT_KEEP[es] if mask.dtype.is_floating_point
            else (0xFFFFFFFF, 0xFFFFFFFF))
    return mask.contiguous(), es, keep[0], keep[1]


def _next_pow2(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def launch_geometry(n: int, row_bytes: int, mask_bytes: int, align: int,
                    sms: int) -> dict:
    """The kernel's launch geometry for n rows of row_bytes bytes.

    vec_bytes: the widest of 16/8/4/2/1 dividing the row size and
    ``align`` (the payload and output addresses OR-ed together).  Each
    row is moved by the power of two of lanes (1-32) that covers its
    vectors.  The grid is at most CTAS_PER_SM CTAs an SM; every CTA reads
    the whole mask, so the grid is also capped at row_bytes / mask_bytes,
    which keeps those reads below the payload's bytes for narrow rows.
    Each CTA owns rows_per_cta rows, a multiple of ROW_ALIGN.
    """
    vec = next(v for v in (16, 8, 4, 2, 1)
               if row_bytes % v == 0 and align % v == 0)
    lanes = min(32, _next_pow2(max(1, row_bytes // vec)))
    cap = max(1, min(CTAS_PER_SM * sms, row_bytes // mask_bytes))
    per = -(-max(1, -(-n // cap)) // ROW_ALIGN) * ROW_ALIGN
    return {"vec_bytes": vec, "lpr_log2": lanes.bit_length() - 1,
            "rows_per_cta": per, "grid": -(-n // per)}


def sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SM_COUNT[index]


def fused_vcompress_cuda(mask, x, *, tail: str = "zero"):
    """Launch the fused vcompress: selected rows of x packed to the top in
    order, the rest after them (``bijective``) or zeroed (``zero``).

    mask: (N,) bool, integer or floating, non-zero selects; x: (N, D)
    contiguous, any dtype (rows are moved as bits, so the move is exact).
    Returns (N, D) in x's dtype.  One device kernel a call.
    """
    check_tail(tail)
    if not x.is_cuda:
        raise ValueError(f"fused_vcompress kernel needs a CUDA payload, got "
                         f"{x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("payload must be a contiguous (N, D) tensor")
    n, d = x.shape
    if mask.device != x.device or tuple(mask.shape) != (n,):
        raise ValueError(f"mask must be ({n},) on the payload's device")
    row_bytes = d * x.element_size()
    if n > _MAX_INT32 or row_bytes > _MAX_INT32:
        raise ValueError(f"({n}, {d}) payload exceeds the kernel's int32 "
                         "row count or row size")
    m, mask_bytes, keep_lo, keep_hi = mask_operand(mask)
    out = torch.empty_like(x)
    if n == 0 or row_bytes == 0:
        return out
    geo = launch_geometry(n, row_bytes, mask_bytes,
                          x.data_ptr() | out.data_ptr(), sm_count(x.device))
    err = _build.library().fused_vcompress(
        m.data_ptr(), mask_bytes, keep_lo, keep_hi,
        int(m.data_ptr() % 16 == 0), x.data_ptr(), out.data_ptr(), n,
        row_bytes, geo["vec_bytes"], int(tail == "zero"), geo["grid"],
        geo["rows_per_cta"], geo["lpr_log2"],
        _build.stream_handle(x.device))
    with _LOCK:
        LAUNCHES["fused_vcompress"] += 1
    if err != 0:
        raise KernelLaunchError(f"fused_vcompress launch failed: cudaError "
                                f"{err}")
    return out
