"""Deterministic synthetic LM data pipeline with a sharded host loader.

Port of ``repro.data.pipeline``, with the same structure:

  * **deterministic and cursor-addressable** — ``batch(step)`` is a pure
    function of (seed, step), so exact resume after a checkpoint restore
    needs only the step counter (the "data cursor"), and every host can
    make its own shard without coordination;
  * **learnable** — tokens follow an order-2 Markov chain over a small
    latent alphabet lifted into the vocab (transition logits drawn from
    the seed), so cross-entropy falls well below the unigram floor within
    a few hundred steps (the loss-goes-down tests);
  * **sharded** — ``host_batch`` is a contiguous row slice of the global
    batch.

Each row draws from its own numpy generator seeded from (seed, step,
row), so a host shard is exactly the rows of the global batch.  The
reference's ``jax.random`` threefry streams are not reproduced: the same
(seed, step) gives other tokens here than there.  Batches are made on
the host (int32 CPU tensors); the trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataCursor:
    """Exact-resume cursor: the only state the pipeline needs."""
    seed: int
    step: int


@functools.lru_cache(maxsize=16)
def _transition_cdf(seed: int, latent: int) -> np.ndarray:
    """Cumulative next-token probabilities of the fixed order-2 chain,
    (latent, latent, latent) float64, from transition logits 2 * N(0, 1)
    (peaked but not deterministic)."""
    t = np.random.default_rng(seed ^ 0x5EED).standard_normal(
        (latent, latent, latent)) * 2.0
    p = np.exp(t - t.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    return np.cumsum(p, axis=-1)


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    latent: int = 61          # latent alphabet size (prime, < vocab)

    def batch(self, step) -> dict:
        """Global batch at ``step``: {tokens (B, S) int32}."""
        return self._gen(int(step), 0, self.global_batch)

    def host_batch(self, step, host_index: int, host_count: int) -> dict:
        """This host's slice of the global batch (contiguous block)."""
        per = self.global_batch // host_count
        return self._gen(int(step), host_index * per, per)

    def _gen(self, step: int, row0: int, rows: int) -> dict:
        cdf = _transition_cdf(self.seed, self.latent)
        init = np.empty((rows, 2), dtype=np.int64)
        u = np.empty((rows, self.seq_len))
        for r in range(rows):
            g = np.random.default_rng([self.seed, step, row0 + r])
            init[r] = g.integers(0, self.latent, 2)
            u[r] = g.random(self.seq_len)
        a, b = init[:, 0], init[:, 1]
        seq = np.empty((rows, self.seq_len), dtype=np.int64)
        for t in range(self.seq_len):
            c = np.minimum((u[:, t, None] >= cdf[a, b]).sum(axis=-1),
                           self.latent - 1)
            seq[:, t] = c
            a, b = b, c
        # lift latent ids into the vocab (spread across the table)
        stride = max(self.vocab_size // self.latent, 1)
        tokens = (seq * stride) % self.vocab_size
        return {"tokens": torch.as_tensor(tokens.astype(np.int32))}


def make_pipeline(cfg, shape, *, seed: int = 0) -> SyntheticLM:
    """Pipeline for a (model config, shape cell) pair."""
    return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                       global_batch=shape.global_batch, seed=seed)
