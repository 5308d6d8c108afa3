"""Config registry: ``get_config(name)`` / ``--arch <id>`` resolution.

Port of ``repro.configs``.  Every assigned architecture is a module
exporting ``CONFIG``; reduced smoke-test variants come from
``base.reduced``.  ``models/model_zoo.py`` builds every family.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (ModelConfig, ShapeCell, SHAPES,
                                      cell_applicable, reduced)

_ARCHS = {
    "qwen1.5-110b": "qwen1_5_110b",
    "starcoder2-15b": "starcoder2_15b",
    "stablelm-12b": "stablelm_12b",
    "minicpm-2b": "minicpm_2b",
    "mixtral-8x22b": "mixtral_8x22b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "rwkv6-7b": "rwkv6_7b",
    "internvl2-26b": "internvl2_26b",
    "zamba2-2.7b": "zamba2_2_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

# short aliases accepted by --arch
_ALIASES = {
    "qwen": "qwen1.5-110b",
    "starcoder2": "starcoder2-15b",
    "stablelm": "stablelm-12b",
    "minicpm": "minicpm-2b",
    "mixtral": "mixtral-8x22b",
    "phi3.5-moe": "phi3.5-moe-42b-a6.6b",
    "rwkv6": "rwkv6-7b",
    "internvl2": "internvl2-26b",
    "zamba2": "zamba2-2.7b",
    "seamless": "seamless-m4t-large-v2",
}


def list_archs() -> list[str]:
    return sorted(_ARCHS)


def get_config(name: str) -> ModelConfig:
    name = _ALIASES.get(name, name)
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")
    return mod.CONFIG


__all__ = ["ModelConfig", "ShapeCell", "SHAPES", "cell_applicable",
           "reduced", "get_config", "list_archs"]
