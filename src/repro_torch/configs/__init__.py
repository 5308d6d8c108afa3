"""Model configurations of the port (the MoE family so far)."""

from repro_torch.configs.base import ModelConfig, reduced

__all__ = ["ModelConfig", "reduced"]
