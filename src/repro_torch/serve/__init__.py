"""Serving of the port's models."""

from repro_torch.serve.engine import ServeOptions, ServingEngine, sample_token

__all__ = ["ServeOptions", "ServingEngine", "sample_token"]
