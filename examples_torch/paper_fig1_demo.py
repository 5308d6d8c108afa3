"""Reproduce the paper's Fig. 1 + Fig. 3 walkthrough, printing every
intermediate of the unified datapath for vcompress.

Port of ``examples/paper_fig1_demo.py`` on ``repro_torch``; runs on the
CUDA card by default, ``--device cpu`` elsewhere.

Run:  PYTHONPATH=src python examples_torch/paper_fig1_demo.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.core import crossbar as xb
from repro_torch.core import transform as T


def main(argv=None, *, device=None, log_fn=print):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve(device if device is not None else args.device)

    # Paper Fig. 3: mask = [1,0,0,1,0,1,0,0] over an 8-element vector.
    mask = torch.tensor([1, 0, 0, 1, 0, 1, 0, 0], dtype=torch.int32,
                        device=dev)
    n = mask.shape[0]
    m = mask.cpu().numpy()
    log_fn(f"mask (vs2):              {m}")

    idx = np.arange(n)
    ones_below = np.concatenate([[0], np.cumsum(m)[:-1]])
    zeros_below = idx - ones_below
    ones_above = np.cumsum(m[::-1])[::-1] - m
    log_fn(f"prefix 1s (low->high):   {ones_below}")
    log_fn(f"prefix 0s:               {zeros_below}")
    log_fn(f"suffix 1s (high->low):   {ones_above}")

    dest = T.compress_destinations(mask)
    log_fn(f"per-input destinations:  {dest.cpu().numpy()}  (mask=1: "
           "i - zeros_below; mask=0: i + ones_above)")
    assert bool(T.destinations_are_bijective(dest)), "must be a permutation!"

    plan = xb.vcompress_plan(mask)
    P = xb.build_onehot(plan).cpu().numpy().astype(int)
    log_fn("crossbar operator (one-hot rows AND columns — Fig. 4):")
    log_fn(str(P))

    x = torch.arange(1, n + 1, dtype=torch.float32, device=dev)[:, None]
    out = xb.apply_plan(plan, x)
    log_fn(f"input elements:   {x.cpu().numpy()[:, 0]}")
    log_fn(f"crossbar output:  {out.cpu().numpy()[:, 0]}  (selected "
           "{1,4,6} packed to front, rest to tail)")


if __name__ == "__main__":
    main()
