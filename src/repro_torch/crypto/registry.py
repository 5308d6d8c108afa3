"""The crypto subsystem's static plan registries, one per device.

Plans hold their control on a device, so each device gets its own
``StaticPlanRegistry`` (named ``"crypto@<device>"``) with the same keys
as the reference's single registry (``"<cipher>/<layer>"``, batch
variants ``"_x<B>"``).  Cipher modules register lazily on first use.
"""

from __future__ import annotations

from repro_torch._device import resolve
from repro_torch.core.static_registry import StaticPlanRegistry

_REGISTRIES: "dict[str, StaticPlanRegistry]" = {}

# The reference's single ``REGISTRY`` becomes one registry a device: this
# is the table of them, keyed by device name (``"cuda:0"``, ``"cpu"``).
REGISTRY = _REGISTRIES


def registry(device=None) -> StaticPlanRegistry:
    """The registry of ``device`` (``None`` -> the card)."""
    dev = resolve(device)
    key = str(dev)
    reg = _REGISTRIES.get(key)
    if reg is None:
        reg = _REGISTRIES[key] = StaticPlanRegistry(f"crypto@{key}")
    return reg


def reset_observations() -> None:
    """Drop recorded fixed-latency signatures (tests); plans stay."""
    for reg in _REGISTRIES.values():
        reg.reset_observations()
