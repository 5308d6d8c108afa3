"""Serving of the port: crypto request batching and the MoE models."""

from repro_torch.serve.batching import (BatchingEngine, BatchingOptions,
                                        Cancelled, Overloaded, Request)
from repro_torch.serve.engine import ServeOptions, ServingEngine, sample_token

__all__ = [
    "BatchingEngine",
    "BatchingOptions",
    "Cancelled",
    "Overloaded",
    "Request",
    "ServeOptions",
    "ServingEngine",
    "sample_token",
]
