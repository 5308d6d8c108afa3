"""Device selection and the capability probe.

Entry points that make their own tensors take ``device=None``, which
means the card: ``default_device()`` returns CUDA and raises when there
is none.  The CPU is used only when a caller asks for it explicitly
(``device="cpu"``), as the CPU test-suite does — nothing in the port
falls back to the CPU on its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


class DeviceUnavailable(RuntimeError):
    """The card was asked for and this process has none.  Like a kernel
    build failure it is not a fault of one execution: the serving
    layer's fallback chain lets it escape instead of degrading."""


def default_device() -> torch.device:
    """The CUDA device the port runs on; raises when there is none."""
    if not torch.cuda.is_available():
        raise DeviceUnavailable(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' explicitly to run the plain PyTorch versions")
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device: DeviceLike) -> torch.device:
    """Normalise a device argument (``None`` -> the card, ``"cuda"`` ->
    the current CUDA device with its index)."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise DeviceUnavailable("device='cuda' requested but CUDA is not "
                               "available")
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def place(x, device: DeviceLike) -> torch.Tensor:
    """An entry point's array argument as a tensor: a tensor runs where it
    lies (a different ``device`` asked for raises); anything else goes to
    ``device`` (None: the card)."""
    if isinstance(x, torch.Tensor):
        if device is not None and resolve(device) != x.device:
            raise ValueError(f"state lies on {x.device}, device={device!r} "
                             "requested")
        return x
    return torch.as_tensor(np.asarray(x), device=resolve(device))


@contextlib.contextmanager
def no_tf32():
    """float32 products must be float32: TF32 off for the enclosed calls
    only, the caller's process-wide setting restored after them."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = saved


def find_nvcc() -> Optional[str]:
    """``nvcc`` on PATH, under ``$CUDA_HOME/bin`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.isfile(cand) and os.access(cand, os.X_OK):
                return cand
    return None


@dataclasses.dataclass(frozen=True)
class Capabilities:
    cuda: bool
    device_name: Optional[str]
    compute_capability: Optional[tuple]
    hopper: bool
    nvcc: Optional[str]

    @property
    def can_build_kernels(self) -> bool:
        return self.hopper and self.nvcc is not None


def capabilities() -> Capabilities:
    """What this process can run: CUDA, an sm_90 card, ``nvcc``."""
    cuda = torch.cuda.is_available()
    name = cap = None
    if cuda:
        name = torch.cuda.get_device_name(0)
        cap = tuple(torch.cuda.get_device_capability(0))
    return Capabilities(cuda=cuda, device_name=name, compute_capability=cap,
                        hopper=cap == (9, 0), nvcc=find_nvcc())
