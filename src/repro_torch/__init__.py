"""PyTorch/CUDA port of the unified RVV permutation engine.

Mirrors ``repro``'s layout module for module (``core.crossbar``,
``core.plan_algebra``, ``core.plan_program``, ``kernels.ops``,
``crypto.keccak``, ...).  The three Pallas kernels on the main path —
the dense crossbar, the tile-skipping crossbar and the plan-program
megakernel — are hand-written CUDA C++ for ``sm_90a``
(``kernels/csrc``), built with ``nvcc`` at first use and bound with
``ctypes``.  On CPU tensors every kernel wrapper runs its plain PyTorch
version (``kernels/ref.py``) instead.

The package imports ``torch`` and numpy only.
"""

from repro_torch._device import capabilities, default_device, resolve

__all__ = ["capabilities", "default_device", "resolve"]
