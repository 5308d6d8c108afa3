"""Batched serving example: prefill + decode with the slot engine.

Port of ``examples/serving.py`` on ``repro_torch``; runs on the CUDA
card by default, ``--device cpu`` elsewhere.  The sampled tokens come
from a seeded ``torch.Generator``, so they are not the JAX example's
(``jax.random`` draws other numbers); their count and range are.

Run:  PYTHONPATH=src python examples_torch/serving.py [--device cpu]
"""

import argparse

import torch

from repro_torch._device import resolve
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build
from repro_torch.serve import ServeOptions, ServingEngine

CONFIG = ModelConfig(name="serve-demo", family="dense", num_layers=4,
                     d_model=256, num_heads=8, num_kv_heads=4, d_ff=512,
                     vocab_size=4096, head_dim=32, compute_dtype="float32",
                     remat="none", attn_chunk=64)
PROMPTS = [[1, 17, 23], [5, 9], [101, 7, 42, 3], [2]]
MAX_NEW_TOKENS = 16


def main(argv=None, *, device=None, log_fn=print):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve(device if device is not None else args.device)
    cfg = CONFIG
    api = build(cfg, device=dev)
    params = api.init(torch.Generator(device=dev).manual_seed(0))

    engine = ServingEngine(api, ServeOptions(batch_slots=4,
                                             max_new_tokens=MAX_NEW_TOKENS,
                                             temperature=0.8, top_k=50),
                           max_seq=128)
    outs = engine.generate(params, PROMPTS,
                           generator=torch.Generator(device=dev).manual_seed(7))
    for p, o in zip(PROMPTS, outs):
        assert len(o) == MAX_NEW_TOKENS and all(
            0 <= t < cfg.vocab_size for t in o), o
        log_fn(f"prompt {p} -> {o}")

    # chunked prefill path (vrgather-style cache priming)
    logits, caches = T.prefill(params, torch.tensor([[1, 17, 23, 9]],
                                                    device=dev), cfg,
                               max_seq=64, cache_dtype=torch.float32)
    assert bool(torch.isfinite(logits).all())
    log_fn(f"prefill last-token logits: {tuple(logits.shape)}")
    return outs


if __name__ == "__main__":
    main()
