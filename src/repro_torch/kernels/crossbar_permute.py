"""CUDA wrappers of the unified crossbar: dense and tile-skipping.

Port of the two Pallas kernels of ``repro/kernels/crossbar_permute.py``
(``crossbar_permute_pallas`` and ``crossbar_permute_sparse_pallas``);
the kernels themselves are ``csrc/crossbar_permute.cu``.  These are the
raw entries: they take already-padded control and a float32 or bf16
payload on a CUDA device, check what the kernel takes, allocate the
output and the scatter inversion's scratch, launch on PyTorch's current
stream and count the launch.  A call makes a fixed number of device
launches for its mode and shapes (the scatter inversion's passes and the
row gather); ``DEVICE_LAUNCHES`` keeps the last call's number per
kernel.  The plan-level wrappers (padding, integer payloads, semiring
fold, the CPU plain version) are ``kernels/ops.py``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import KernelLaunchError

GATHER, SCATTER = "gather", "scatter"
DEFAULT_BLOCK_O = 64        # dense: control rows are padded to this
_MAX_INT32 = 2**31 - 1

LAUNCHES = {"crossbar_dense": 0, "crossbar_sparse": 0}
DEVICE_LAUNCHES = {"crossbar_dense": 0, "crossbar_sparse": 0}
_LOCK = threading.Lock()


def _count(name: str, device_launches: int) -> None:
    with _LOCK:
        LAUNCHES[name] += 1
        DEVICE_LAUNCHES[name] = device_launches


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_common(idx, x, weights, mode):
    _check(x.is_cuda, f"CUDA crossbar needs a CUDA payload, got {x.device}")
    _check(x.dtype in (torch.float32, torch.bfloat16),
           f"CUDA crossbar takes float32/bf16 payloads, got {x.dtype}")
    _check(x.dim() == 2 and x.is_contiguous(),
           "payload must be a contiguous (n_in, D) tensor")
    _check(idx.device == x.device and idx.dtype == torch.int32
           and idx.dim() == 2 and idx.is_contiguous(),
           "idx must be contiguous (n_ctrl, K) int32 on the payload's device")
    if weights is not None:
        _check(weights.device == x.device and weights.dtype == torch.float32
               and weights.shape == idx.shape and weights.is_contiguous(),
               "weights must be contiguous float32 shaped like idx")
    _check(mode in (GATHER, SCATTER), f"bad mode {mode!r}")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise KernelLaunchError(f"{kernel} launch failed: cudaError {err}")


def _scratch(lib, mode, n_in, k, n_out, device):
    """The scatter inversion's CSR scratch (None when the call needs
    none: gather mode, or control small enough to invert per CTA)."""
    _check(n_in * k <= _MAX_INT32 and n_out < _MAX_INT32,
           "control entries and output rows must index in int32")
    n = lib.xb_scratch_ints(int(mode == SCATTER), n_in, k, n_out)
    return torch.empty(n, dtype=torch.int32, device=device) if n else None


def crossbar_permute_cuda(idx, x, *, mode, n_out, weights=None, merge=None,
                          fold_mod2=False, block_o=DEFAULT_BLOCK_O):
    """Dense crossbar kernel: ``out = P @ x`` with merge and GF(2) fold.

    idx: (n_ctrl_pad, K) int32 with DROP-padded control rows (at least
    n_out rows in gather mode, n_in in scatter mode); x: (n_in, D)
    float32/bf16; weights: like idx, float32; merge: (n_out, D) in x's
    dtype.  Returns (n_out, D) in x's dtype.  ``block_o`` is the control
    padding ``ops.dense_operands`` applied; the kernel reads the first
    n_out (gather) or n_in (scatter) control rows.
    """
    _check_common(idx, x, weights, mode)
    n_in, d = x.shape
    k = idx.shape[1]
    ctrl_need = n_out if mode == GATHER else n_in
    _check(idx.shape[0] >= ctrl_need,
           f"idx has {idx.shape[0]} rows, mode {mode} needs {ctrl_need}")
    if merge is not None:
        _check(merge.device == x.device and merge.dtype == x.dtype
               and tuple(merge.shape) == (n_out, d) and merge.is_contiguous(),
               "merge must be contiguous (n_out, D) in the payload dtype")
    out = torch.empty((n_out, d), dtype=x.dtype, device=x.device)
    if n_out == 0 or d == 0:
        return out
    lib = _build.library()
    scratch = _scratch(lib, mode, n_in, k, n_out, x.device)
    n_launch = ctypes.c_int(0)
    err = lib.xb_dense(
        _ptr(idx), _ptr(x), _ptr(weights), _ptr(merge), _ptr(out),
        _ptr(scratch), k, n_in, n_out, d, int(mode == SCATTER),
        int(x.dtype == torch.bfloat16), int(bool(fold_mod2)),
        _build.stream_handle(x.device), ctypes.byref(n_launch))
    _count("crossbar_dense", n_launch.value)
    _raise_on(err, "crossbar_dense")
    return out


def crossbar_permute_sparse_cuda(run_o, run_ptr, pair_n, idx, x, *, mode,
                                 n_out, out, weights=None, fold_mod2=False,
                                 block_o=128, block_n=128):
    """Tile-skipping crossbar kernel over an o-major schedule.

    run_o: (n_runs,) int32 output tile of each o-run; run_ptr:
    (n_runs + 1,) int32 CSR offsets into pair_n, the (num_active,) n-tile
    of each active pair.  ``out`` is the (n_out, D) buffer the caller
    allocated: the kernel writes every row of the run_o tiles and leaves
    the rest untouched.  Every select of a compiled plan lies in one of
    its active pairs, so the kernel does not consult run_ptr / pair_n
    (they are checked for shape only).  idx must be DROP-padded to whole
    control tiles.
    """
    _check_common(idx, x, weights, mode)
    n_in, d = x.shape
    k = idx.shape[1]
    for t in (run_o, run_ptr, pair_n):
        _check(t.device == x.device and t.dtype == torch.int32
               and t.dim() == 1 and t.is_contiguous(),
               "schedule arrays must be contiguous 1-D int32 on the device")
    n_runs = run_o.shape[0]
    _check(run_ptr.shape[0] == n_runs + 1, "run_ptr must have n_runs + 1 "
           "entries")
    _check(block_o > 0, f"sparse block_o must be positive, got {block_o}")
    _check(n_runs * block_o <= _MAX_INT32, f"{n_runs} o-runs exceed int32")
    ctrl_block = block_o if mode == GATHER else block_n
    ctrl_rows = n_out if mode == GATHER else n_in
    _check(idx.shape[0] >= -(-ctrl_rows // ctrl_block) * ctrl_block,
           "idx must be DROP-padded to whole control tiles")
    _check(out.device == x.device and out.dtype == x.dtype
           and tuple(out.shape) == (n_out, d) and out.is_contiguous(),
           "out must be a contiguous (n_out, D) buffer in x's dtype")
    if n_runs == 0 or d == 0:
        return out
    lib = _build.library()
    scratch = _scratch(lib, mode, n_in, k, n_out, x.device)
    n_launch = ctypes.c_int(0)
    err = lib.xb_sparse(
        _ptr(run_o), n_runs, _ptr(idx), _ptr(x), _ptr(weights), _ptr(out),
        _ptr(scratch), k, n_in, n_out, d, int(mode == SCATTER),
        int(x.dtype == torch.bfloat16), int(bool(fold_mod2)), block_o,
        _build.stream_handle(x.device), ctypes.byref(n_launch))
    _count("crossbar_sparse", n_launch.value)
    _raise_on(err, "crossbar_sparse")
    return out
