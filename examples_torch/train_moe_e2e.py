"""End to end: train a ~100M-param MoE LM for a few hundred steps.

Port of ``examples/train_moe_e2e.py`` on ``repro_torch``; runs on the
CUDA card by default, ``--device cpu`` elsewhere.  The MoE routing runs
on the unified permutation engine's control transform (on the card the
hand-written ``moe_route`` kernel, once a layer a microbatch) and the
dispatch/combine on the ``einsum`` crossbar backend, which is what
autograd differentiates.  Loss falls well below the unigram floor within
a few hundred steps on the synthetic Markov data.

``main`` returns the trainer's history (one dict a step).

Run:  PYTHONPATH=src python examples_torch/train_moe_e2e.py [--steps 300] [--device cpu]
"""

import argparse
import os
import tempfile

from repro_torch._device import resolve
from repro_torch.configs.base import ModelConfig
from repro_torch.data import SyntheticLM
from repro_torch.models.model_zoo import build
from repro_torch.train import TrainOptions, Trainer

# ~100M active params: 8 layers, d=512, 8 experts top-2
CONFIG = ModelConfig(
    name="moe-100m", family="moe", num_layers=8, d_model=512,
    num_heads=8, num_kv_heads=8, d_ff=1408, vocab_size=8192,
    head_dim=64, num_experts=8, num_experts_per_tok=2,
    compute_dtype="float32", remat="none", attn_chunk=128)
SEQ_LEN, GLOBAL_BATCH, GRAD_ACCUM = 256, 8, 2
CKPT_EVERY = 100


def main(argv=None, *, device=None, log_fn=print):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", type=str, default=os.path.join(
        tempfile.gettempdir(), "repro_torch_moe_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve(device if device is not None else args.device)

    cfg = CONFIG
    log_fn(f"params: {cfg.param_count()/1e6:.0f}M total, "
           f"{cfg.active_param_count()/1e6:.0f}M active")

    api = build(cfg, device=dev)
    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ_LEN,
                       global_batch=GLOBAL_BATCH)
    options = TrainOptions(peak_lr=1e-3, warmup_steps=30,
                           total_steps=args.steps, grad_accum=GRAD_ACCUM)
    trainer = Trainer(api, options, pipeline=pipe, ckpt_dir=args.ckpt_dir,
                      keep=2)
    state = trainer.init_or_restore(0)
    state, hist = trainer.run(state, steps=args.steps,
                              ckpt_every=CKPT_EVERY, log_every=20,
                              log_fn=log_fn)
    log_fn(f"final loss {hist[-1]['loss']:.4f} "
           f"(start {hist[0]['loss']:.4f}); "
           f"dropped-token fraction {hist[-1].get('dropped', 0):.3f}")
    return hist


if __name__ == "__main__":
    main()
