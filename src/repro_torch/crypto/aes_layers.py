"""AES permutation layers (ShiftRows and its inverse) as static plans.

Port of ``repro.crypto.aes_layers``.  The AES state is 16 bytes in
FIPS-197 column-major order (``flat[4c + r] = s[r, c]``).  ShiftRows
rotates row r left by r — a pure byte permutation, a 16-row crossbar
gather; the inverse is its transpose, gather-normalised and registered
on its own so both directions are gather-form and schedule-pinned.

Payloads are byte values (0..255), exact on every backend: the einsum
integer path accumulates in int32 and the kernels' float32 routing is
exact below 2^24.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.core import crossbar as xb
from repro_torch.core import plan_algebra as pa
from repro_torch.crypto.registry import registry

STATE_BYTES = 16


def _shift_rows_src() -> np.ndarray:
    """out[4c + r] = in[4*((c + r) % 4) + r]  (row r rotates left by r)."""
    src = np.zeros(STATE_BYTES, np.int32)
    for o in range(STATE_BYTES):
        r, c = o % 4, o // 4
        src[o] = 4 * ((c + r) % 4) + r
    return src


def _register(device=None) -> None:
    dev = resolve(device)
    reg = registry(dev)
    reg.get_or_register(
        "aes/shift_rows",
        lambda: xb.gather_plan(torch.as_tensor(_shift_rows_src(),
                                               device=dev), STATE_BYTES))
    reg.get_or_register(
        "aes/inv_shift_rows",
        lambda: pa.to_gather(pa.transpose(reg["aes/shift_rows"])))


def shift_rows(state: torch.Tensor, *, backend: str = "einsum",
               fixed_latency: bool = False) -> torch.Tensor:
    """ShiftRows on a (16, ...) byte-rows state, where it lies."""
    _register(state.device)
    return registry(state.device).execute(
        "aes/shift_rows", state, backend=backend,
        fixed_latency=fixed_latency)


def inv_shift_rows(state: torch.Tensor, *, backend: str = "einsum",
                   fixed_latency: bool = False) -> torch.Tensor:
    """InvShiftRows: the transposed (gather-normalised) plan."""
    _register(state.device)
    return registry(state.device).execute(
        "aes/inv_shift_rows", state, backend=backend,
        fixed_latency=fixed_latency)
