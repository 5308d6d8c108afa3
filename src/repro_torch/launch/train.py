"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of ``repro.launch.train``; it trains on the card.  Runs use the
reduced config of the architecture by default; ``--full`` builds the
full assigned config at the shape cell's sequence length and global
batch (cluster scale: beyond one card for most architectures).  The
batches are uniform random tokens (``ModelAPI.make_batch``, generator
seeded by the step), as the reference's launcher draws them, or with
``--data synthetic`` the learnable Markov pipeline (``data.SyntheticLM``),
which yields tokens only: the vlm and encdec families, whose batches also
carry frontend embeddings, refuse it.

``main(argv, device=None)`` runs the same code from Python (``device=
"cpu"`` for a CPU run) and returns the trainer, its final state and the
per-step history.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch._device import resolve
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.data import SyntheticLM
from repro_torch.models.model_zoo import build
from repro_torch.train import TrainOptions, Trainer

# families whose batch carries frontend embeddings beside the tokens
FRONTEND_FAMILIES = ("vlm", "encdec")


class _RandomTokens:
    """``api.make_batch`` at each step, from a generator seeded by the
    step (deterministic: cursor == step)."""

    def __init__(self, api, batch, seq):
        self.api, self.b, self.s = api, batch, seq

    def batch(self, step):
        gen = torch.Generator(device=self.api.device).manual_seed(int(step))
        return self.api.make_batch(gen, self.b, self.s)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, required=True)
    ap.add_argument("--shape", type=str, default="train_4k",
                    choices=[k for k, v in SHAPES.items()
                             if v.kind == "train"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--full", action="store_true",
                    help="full config (cluster scale); default: reduced")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", choices=("random", "synthetic"),
                    default="random",
                    help="uniform random tokens (the reference launcher's) "
                         "or the learnable synthetic Markov pipeline")
    return ap.parse_args(argv)


def main(argv=None, *, device=None, log_fn=print) -> dict:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    if not args.full:
        cfg = reduced(cfg)
        seq, batch = args.seq_len, args.batch
    else:
        seq, batch = shape.seq_len, shape.global_batch
    if args.data == "synthetic" and cfg.family in FRONTEND_FAMILIES:
        raise ValueError(
            f"--data synthetic yields tokens only, and a {cfg.family} batch "
            f"also carries frontend embeddings ({cfg.name}); use --data "
            "random")

    log_fn(f"arch={cfg.name} family={cfg.family} "
           f"N={cfg.param_count()/1e6:.0f}M seq={seq} batch={batch} "
           f"schedule={cfg.lr_schedule}")

    api = build(cfg, device=resolve(device))
    pipe = (SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                        global_batch=batch)
            if args.data == "synthetic" else _RandomTokens(api, batch, seq))
    options = TrainOptions(peak_lr=args.lr, warmup_steps=10,
                           total_steps=max(args.steps, 20),
                           grad_accum=args.grad_accum,
                           schedule=cfg.lr_schedule)
    trainer = Trainer(api, options, pipeline=pipe, ckpt_dir=args.ckpt_dir)
    state = trainer.init_or_restore(0)
    state, hist = trainer.run(state, steps=args.steps,
                              ckpt_every=args.ckpt_every if args.ckpt_dir
                              else 0, log_every=10, log_fn=log_fn)
    log_fn(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return {"trainer": trainer, "state": state, "history": hist}


if __name__ == "__main__":
    main()
