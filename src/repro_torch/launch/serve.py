"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Port of ``repro.launch.serve``; it serves on the card.  Builds the model
(the reduced config of the architecture by default, ``--full`` for the
published one) with seeded random weights and serves a synthetic batch
of prompts, ``(7i + j) mod V``, through the slot engine, one prompt a
slot, with float32 caches.

``main(argv, device=None)`` runs the same code from Python (``device=
"cpu"`` for a CPU run) and returns the generated token lists.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch._device import resolve
from repro_torch.configs import get_config, reduced
from repro_torch.models.model_zoo import build
from repro_torch.serve import ServeOptions, ServingEngine


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, required=True)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full", action="store_true",
                    help="the published config; default: reduced")
    return ap.parse_args(argv)


def prompts_for(slots: int, vocab_size: int) -> list:
    """The launcher's synthetic prompts: slot i holds 3 + i % 3 tokens
    ``(7i + j) mod V``."""
    return [[(7 * i + j) % vocab_size for j in range(3 + i % 3)]
            for i in range(slots)]


def main(argv=None, *, device=None, log_fn=print) -> list:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    dev = resolve(device)
    api = build(cfg, device=dev)
    params = api.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServingEngine(
        api, ServeOptions(batch_slots=args.slots,
                          max_new_tokens=args.max_new_tokens,
                          temperature=args.temperature),
        max_seq=args.max_seq, cache_dtype=torch.float32)
    prompts = prompts_for(args.slots, cfg.vocab_size)
    outs = engine.generate(params, prompts,
                           generator=torch.Generator(device=dev).manual_seed(1))
    for p, o in zip(prompts, outs):
        log_fn(f"{p} -> {o}")
    return outs


if __name__ == "__main__":
    main()
