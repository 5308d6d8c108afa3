"""Wrappers around the CUDA kernels: the crossbars, the MoE routing
transform and the fused vcompress.

Port of ``repro/kernels/ops.py``.  For the two crossbar kernels:

* control rows are padded to whole kernel tiles with DROP (padding is
  inert: a DROP select matches nothing), payload rows and columns are
  not padded — the kernels mask their ragged edges;
* integer and bool payloads ride the float32 datapath, which holds
  integers exactly only below 2^24: larger magnitudes are refused;
* complex payloads have no datapath and are refused with
  ``KernelLaunchError`` on every device, as the reference's kernels
  refuse them (a cast to float32 would drop the imaginary part);
* the plan's semiring picks the accumulate mode (REAL sums, GF2 folds
  mod 2 at emission);
* a CUDA payload launches the CUDA kernel or raises
  ``KernelLaunchError``; a CPU payload runs the kernel's plain version
  (``kernels/ref.py``), and so does a fake one (the constant-time
  audit's abstract evaluation: no data to launch on).  Nothing falls
  back from one to the other.

``moe_route_transform`` and ``fused_vcompress`` follow the same device
rule.  Neither pads: the CUDA kernels take any T and any N.

``unpack_bits`` / ``pack_bits`` / ``bits_roundtrip`` are the
sub-element-width helpers (plain shift/mask arithmetic, not kernels):
words narrower than a payload element split into 0/1 rows and fold back.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core import abstract as _abstract
from repro_torch.kernels import ref
from repro_torch.kernels._build import KernelBuildError
from repro_torch.kernels.crossbar_permute import (
    DEFAULT_BLOCK_O, KernelLaunchError, crossbar_permute_cuda,
    crossbar_permute_sparse_cuda)
from repro_torch.kernels.fused_compress import (check_tail,
                                                fused_vcompress_cuda)
from repro_torch.kernels.moe_route import check_geometry, moe_route_cuda

DROP = -1

_F32_EXACT_INT_BOUND = 1 << 24

__all__ = ["KernelBuildError", "KernelLaunchError", "bits_roundtrip",
           "crossbar_permute", "crossbar_permute_sparse", "fused_vcompress",
           "moe_route_transform", "pack_bits", "unpack_bits"]


@contextlib.contextmanager
def _surface_kernel_errors(kernel: str, plan):
    """Re-raise a build, load or launch failure with the plan's geometry.

    A build failure stays a ``KernelBuildError`` (nvcc missing or
    failing is not a fault of this launch, and the serving layer's
    fallback chain must see it as such).  Input-validation errors
    (``ValueError`` from the wrappers' checks) are not kernel failures
    and pass through untouched.
    """
    try:
        yield
    except (KernelLaunchError, OSError) as e:
        cls = KernelBuildError if isinstance(e, KernelBuildError) \
            else KernelLaunchError
        raise cls(
            f"{kernel} failed for plan (mode={plan.mode}, "
            f"{plan.n_in}->{plan.n_out}, k={plan.idx.shape[-1]}, "
            f"semiring={plan.semiring.name}): {type(e).__name__}: {e}"
        ) from e


def _launches(x) -> bool:
    """A CUDA payload launches the kernel; a CPU or fake one runs the
    plain version."""
    return x.is_cuda and not _abstract.is_fake(x)


def is_integer_payload(x) -> bool:
    """Integer or bool, the reference's rule (complex is not integer)."""
    return not (x.dtype.is_floating_point or x.dtype.is_complex)


def refuse_complex(x, kernel: str) -> None:
    """Raise ``KernelLaunchError`` naming the dtype of a complex payload:
    no kernel carries one, and the reference's kernels raise on it."""
    if x.dtype.is_complex:
        raise KernelLaunchError(
            f"{kernel} has no {x.dtype} datapath (the kernels carry real "
            "and integer payloads; a cast would drop the imaginary part); "
            "use backend='einsum'")


def _as_f32_payload(x):
    """Integer/bool payloads -> float32, refusing |x| >= 2^24."""
    if not is_integer_payload(x):
        return x
    # A fake payload (the constant-time audit's abstract evaluation) has
    # no values to check: the caller's responsibility, as a traced
    # payload is in the reference.
    if (x.dtype != torch.bool and x.element_size() > 2 and x.numel()
            and not _abstract.is_fake(x)):
        hi, lo = int(x.max()), int(x.min())
        if hi >= _F32_EXACT_INT_BOUND or -lo >= _F32_EXACT_INT_BOUND:
            raise ValueError(
                f"integer payload magnitude {max(hi, -lo)} >= 2^24: the "
                "crossbar kernels route integers through float32, which is "
                "only exact below 2^24. Split the payload or use the "
                "'einsum' backend (integer accumulation).")
    return x.to(torch.float32)


def _pad_rows(t, mult, value):
    pad = (-t.shape[0]) % mult
    if pad == 0:
        return t.contiguous()
    return torch.nn.functional.pad(t, (0, 0, 0, pad), value=value)


def _semiring_fold(plan) -> bool:
    """REAL accumulates natively; GF2 folds the exact sum mod 2."""
    sr = plan.semiring
    if sr.mod2_fold:
        return True
    if sr.name == "real":
        return False
    raise ValueError(
        f"semiring {sr.name!r} has no direct kernel path; execute via "
        "core.crossbar.apply_plan")


def _payload_dtype(x):
    return x.dtype if x.dtype in (torch.float32, torch.bfloat16) \
        else torch.float32


def dense_operands(plan, x, *, merge=None, block_o=DEFAULT_BLOCK_O):
    """The dense kernel's operands for a plan: (idx, x, kwargs).

    Gather control is DROP-padded to whole output tiles; the scatter
    kernel streams control in bounded chunks and needs no padding.
    """
    refuse_complex(x, "dense crossbar kernel")
    mode = plan.mode
    xf = _as_f32_payload(x).to(_payload_dtype(x)).contiguous()
    ctrl_block = block_o if mode == "gather" else 1
    idxp = _pad_rows(plan.idx, ctrl_block, DROP)
    wp = (None if plan.weights is None else
          _pad_rows(plan.weights.to(torch.float32), ctrl_block, 0.0))
    mp = None if merge is None else merge.to(xf.dtype).contiguous()
    return idxp, xf, dict(mode=mode, n_out=plan.n_out, weights=wp, merge=mp,
                          fold_mod2=_semiring_fold(plan))


def crossbar_permute(plan, x, *, merge=None, block_o=DEFAULT_BLOCK_O):
    """Execute a PermutePlan through the dense crossbar kernel.

    x: (n_in, D).  Returns (n_out, D) in x's dtype.
    """
    idxp, xf, kw = dense_operands(plan, x, merge=merge, block_o=block_o)
    if _launches(xf):
        with _surface_kernel_errors("dense crossbar kernel", plan):
            out = crossbar_permute_cuda(idxp, xf, block_o=block_o, **kw)
    else:
        out = ref.crossbar_dense(idxp, xf, **kw)
    return out.to(x.dtype)


def _empty_out(shape, dtype, device):
    """Output buffer of the tile-skipping kernel (rows of unvisited tiles
    keep whatever it holds)."""
    return torch.empty(shape, dtype=dtype, device=device)


def crossbar_permute_sparse(plan, x, *, compiled=None, block_o=128,
                            block_n=128):
    """Execute a PermutePlan through the tile-skipping crossbar kernel.

    Rows of output tiles the plan never touches are left unwritten —
    ``core.crossbar.apply_plan`` overlays merge/zero from the plan's
    coverage.  ``compiled`` may carry a CompiledPlan of this very plan
    and blocking; anything else is recompiled (a cache hit when the plan
    ran before).
    """
    args, kw = sparse_operands(plan, x, compiled=compiled, block_o=block_o,
                               block_n=block_n)
    out = kw["out"]
    if args[2].shape[0] == 0:          # no active pair: nothing to visit
        out.zero_()
    elif _launches(x):
        with _surface_kernel_errors("sparse crossbar kernel", plan):
            crossbar_permute_sparse_cuda(*args, **kw)
    else:
        ref.crossbar_sparse(*args, **kw)
    return out.to(x.dtype)


def sparse_operands(plan, x, *, compiled=None, block_o=128, block_n=128):
    """The tile-skipping kernel's operands for a plan: ((run_o, run_ptr,
    pair_n, idx, x), kwargs), with a fresh output buffer in kwargs."""
    from repro_torch.core import crossbar as xb  # the layer above: at use

    refuse_complex(x, "sparse crossbar kernel")
    mode = plan.mode
    xf = _as_f32_payload(x).to(_payload_dtype(x)).contiguous()
    # A schedule from a different plan (or blocking) would silently skip
    # tiles this plan occupies — only trust one built from this very idx.
    if (compiled is None or compiled.block_o != block_o
            or compiled.block_n != block_n
            or compiled.plan.idx is not plan.idx):
        compiled = xb.compile_plan(plan, block_o=block_o, block_n=block_n)
    ctrl_block = block_o if mode == "gather" else block_n
    idxp = _pad_rows(plan.idx, ctrl_block, DROP)
    wp = (None if plan.weights is None else
          _pad_rows(plan.weights.to(torch.float32), ctrl_block, 0.0))
    run_o, run_ptr = compiled.runs
    pair_n = compiled.pair_n[:compiled.num_active].contiguous()
    out = _empty_out((plan.n_out, xf.shape[1]), xf.dtype, xf.device)
    return ((run_o, run_ptr, pair_n, idxp, xf),
            dict(mode=mode, n_out=plan.n_out, out=out, weights=wp,
                 fold_mod2=_semiring_fold(plan), block_o=block_o,
                 block_n=block_n))


def moe_route_transform(expert_ids, *, num_experts, capacity):
    """Fused MoE position/destination transform.

    expert_ids: (T, K) integer ids of one routing group, or (G, T, K) for
    G groups (each group ranks its own queues).  Returns (positions,
    dest), int32 shaped like the ids: each assignment's rank in its
    expert's queue in t-major order, and ``e * C + pos`` or DROP when
    ``pos >= C`` or the id is outside [0, E).
    """
    if expert_ids.dim() not in (2, 3):
        raise ValueError(f"expert ids must be (T, K) or (G, T, K), got "
                         f"{tuple(expert_ids.shape)}")
    if expert_ids.dtype.is_floating_point or expert_ids.dtype == torch.bool:
        raise ValueError(f"expert ids must be integers, got "
                         f"{expert_ids.dtype}")
    check_geometry(num_experts, capacity)
    shape = expert_ids.shape
    rows = expert_ids.reshape(-1 if expert_ids.dim() == 3 else 1,
                              shape[-2] * shape[-1])
    rows = rows.to(torch.int32).contiguous()
    if _launches(rows):
        pos, dest = moe_route_cuda(rows, num_experts=num_experts,
                                   capacity=capacity)
    else:
        pos, dest = ref.moe_route_transform(rows, num_experts=num_experts,
                                            capacity=capacity)
    return pos.reshape(shape), dest.reshape(shape)


def fused_vcompress(mask, x, *, tail="zero"):
    """Fused mask -> destinations -> row-move compress.  x: (N, D) ->
    (N, D): selected rows packed to the top in order; the rest follow
    (``tail="bijective"``) or are zeros (``tail="zero"``).  mask: (N,)
    bool or 0/1 integers.  Any real or integer payload dtype: rows move
    as bits, so integers are exact at any magnitude (the reference routes
    them through float32 for its one-hot matmul and refuses |x| >= 2^24).
    A complex payload is refused, as the reference's kernel refuses it."""
    check_tail(tail)
    refuse_complex(x, "fused vcompress kernel")
    if x.dim() != 2 or tuple(mask.shape) != (x.shape[0],):
        raise ValueError(f"need mask (N,) and x (N, D), got "
                         f"{tuple(mask.shape)} and {tuple(x.shape)}")
    if _launches(x):
        return fused_vcompress_cuda(mask, x.contiguous(), tail=tail)
    return ref.fused_vcompress(mask, x, tail=tail)


# -- sub-element-width pack/unpack ------------------------------------------
# Elements narrower than a payload word (bit permutations of PRESENT- or
# GIFT-style ciphers) are exposed by unpacking each word into `width` 0/1
# rows, permuting at bit granularity, and packing back.  Both directions
# are branch-free shift/mask arithmetic, exact for values in [0, 2**width).

_MAX_PACK_WIDTH = 31  # packed words accumulate in int32


def _check_width(width: int, what: str) -> None:
    if not 1 <= width <= _MAX_PACK_WIDTH:
        raise ValueError(f"{what} width must be in [1, {_MAX_PACK_WIDTH}], "
                         f"got {width}")


def _bit_axis(width: int, axis: int, ndim: int, device) -> torch.Tensor:
    """0..width-1 shaped to broadcast on the new axis after ``axis``."""
    return torch.arange(width, dtype=torch.int32, device=device).reshape(
        (1,) * (axis + 1) + (width,) + (1,) * (ndim - axis - 1))


def unpack_bits(x, width, *, axis=0):
    """Split each integer element into ``width`` 0/1 int32 rows (LSB-first).

    ``(..., N, ...) -> (..., N*width, ...)`` along ``axis``: element i's
    bits occupy rows ``[i*width, (i+1)*width)``, least significant first.
    """
    _check_width(width, "unpack")
    if x.dtype.is_floating_point or x.dtype.is_complex:
        raise ValueError(f"unpack_bits needs an integer payload, got "
                         f"{x.dtype}")
    axis = axis % x.dim()
    xe = x.to(torch.int32).unsqueeze(axis + 1)
    bits = (xe >> _bit_axis(width, axis, x.dim(), x.device)) & 1
    shape = x.shape[:axis] + (x.shape[axis] * width,) + x.shape[axis + 1:]
    return bits.reshape(shape)


def pack_bits(bits, width, *, axis=0, dtype=torch.int32):
    """Inverse of :func:`unpack_bits`: fold ``width`` 0/1 rows per word,
    ``(..., N*width, ...) -> (..., N, ...)`` along ``axis``."""
    _check_width(width, "pack")
    axis = axis % bits.dim()
    n = bits.shape[axis]
    if n % width:
        raise ValueError(f"pack_bits: axis length {n} is not a multiple "
                         f"of width {width}")
    shape = bits.shape[:axis] + (n // width, width) + bits.shape[axis + 1:]
    grouped = bits.to(torch.int32).reshape(shape)
    weights = 1 << _bit_axis(width, axis, bits.dim(), bits.device)
    return torch.sum(grouped * weights, dim=axis + 1).to(dtype)


def bits_roundtrip(x, width, *, axis=0):
    """``pack_bits(unpack_bits(x))``: the identity for in-range payloads."""
    return pack_bits(unpack_bits(x, width, axis=axis), width, axis=axis,
                     dtype=x.dtype)
