"""Quickstart: the unified permutation engine in 30 lines.

Port of ``examples/quickstart.py`` on ``repro_torch``.  Runs on the CUDA
card by default (``backend="kernel"`` launches the dense crossbar kernel
once); ``--device cpu`` runs the plain PyTorch versions instead.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""

import argparse

import torch

from repro_torch._device import resolve
from repro_torch.core import permute as P


def main(argv=None, *, device=None, log_fn=print):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve(device if device is not None else args.device)

    def show(t):
        return t.cpu().numpy()

    x = torch.arange(8, dtype=torch.float32, device=dev)[:, None] \
        * torch.ones((8, 4), device=dev)

    # Output-driven: vrgather (paper Fig. 1a) — per-output source indices.
    idx = torch.tensor([3, 3, 0, 7, 1, 1, 5, 2], device=dev)
    log_fn(f"vrgather:\n {show(P.vrgather(x, idx)[:, 0])}")

    # Input-driven: vcompress (paper Fig. 1b) — mask-selected elements
    # packed to the front, order preserved.  Same crossbar, control
    # transformed via the bidirectional prefix-sum algorithm (Fig. 3).
    mask = torch.tensor([1, 0, 1, 1, 0, 0, 1, 0], device=dev)
    log_fn(f"vcompress:\n {show(P.vcompress(x, mask)[:, 0])}")

    # The datapath's native bijective form: unselected elements pack to
    # the tail (what makes every crossbar row one-hot — Sec. III-B.2).
    log_fn("vcompress (bijective tail):\n "
           f"{show(P.vcompress(x, mask, tail='bijective')[:, 0])}")

    # vslideup / vslidedown (paper Fig. 1c/d): offset added to input
    # index; slide-outs are dropped by the SAD out-of-bounds rule.
    log_fn(f"vslideup(3):\n {show(P.vslideup(x, 3)[:, 0])}")
    log_fn(f"vslidedown(2):\n {show(P.vslidedown(x, 2)[:, 0])}")

    # All of the above execute the SAME crossbar; backend='kernel' runs
    # it as the hand-written dense crossbar kernel on the card.
    matches = bool(torch.allclose(P.vcompress(x, mask, backend="kernel"),
                                  P.vcompress(x, mask)))
    log_fn(f"kernel backend matches: {matches}")
    assert matches


if __name__ == "__main__":
    main()
