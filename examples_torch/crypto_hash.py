"""SHA-3 on the permutation crossbar: the fixed-latency contract, live.

Port of ``examples/crypto_hash.py`` on ``repro_torch``; runs on the CUDA
card by default, ``--device cpu`` elsewhere.  Walks the crypto subsystem
end to end:

1. hash a message with SHA3-256 where every Keccak-f[1600] round's
   ρ∘π linear layer is ONE crossbar pass (a plan fused by
   ``plan_algebra.compose``), and check the digest against ``hashlib``;
2. count crossbar passes via ``core.telemetry`` — 24 per permutation,
   regardless of what is being hashed;
3. run the permutation under ``fixed_latency=True`` with three
   different payloads: the schedule signature recorded on the first
   call must match bit-for-bit on every later call;
4. hash a batch of sponge lanes through one block-diagonal plan and
   show its ~1/B tile occupancy (the sparse backend's regime).

Run:  PYTHONPATH=src python examples_torch/crypto_hash.py [--device cpu]
"""

import argparse
import hashlib

import numpy as np
import torch

from repro_torch import crypto
from repro_torch._device import resolve
from repro_torch.core import crossbar as xb
from repro_torch.core import plan_algebra as pa
from repro_torch.core import telemetry
from repro_torch.crypto import keccak as kk


def main(argv=None, *, device=None, log_fn=print):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve(device if device is not None else args.device)
    msg = b"the crossbar is the datapath"

    # 1. digest through the crossbar vs hashlib ---------------------------
    with telemetry.delta() as d:
        digest = crypto.sha3_256(msg, device=dev)
    want = hashlib.sha3_256(msg).digest()
    assert digest == want, "crossbar SHA3-256 disagrees with hashlib!"
    log_fn(f"SHA3-256({msg!r})\n  = {digest.hex()}")
    log_fn(f"  matches hashlib: {digest == want}")

    # 2. pass counting ----------------------------------------------------
    counts = d()
    log_fn(f"  crossbar passes for 1 absorb permutation: "
           f"{counts['apply_calls']} (24 rounds x 1 fused rho-pi pass)")
    bits = torch.as_tensor(np.random.default_rng(0).integers(0, 2, 1600),
                           dtype=torch.int32, device=dev)
    with telemetry.delta() as d:
        crypto.keccak_f1600(bits, fuse_rho_pi=False)
    log_fn(f"  without compose() fusion the same permutation pays "
           f"{d()['apply_calls']} passes")

    # 3. fixed-latency contract ------------------------------------------
    crypto.reset_observations()
    for seed in range(3):
        payload = torch.as_tensor(
            np.random.default_rng(seed).integers(0, 2, 1600),
            dtype=torch.int32, device=dev)
        crypto.keccak_f1600(payload, fixed_latency=True)
    log_fn("fixed_latency=True: 3 calls, 3 different payloads, one "
           "schedule signature -> contract holds")

    # 4. batched sponge lanes --------------------------------------------
    msgs = [b"lane-%d" % i for i in range(4)]
    digests = crypto.sha3_256_batched(msgs, device=dev)
    ok = all(g == hashlib.sha3_256(m).digest()
             for g, m in zip(digests, msgs))
    assert ok, "batched SHA3-256 disagrees with hashlib!"
    single = xb.compile_plan(kk.rho_pi_plan(dev))
    compiled = xb.compile_plan(pa.batch(kk.rho_pi_plan(dev), len(msgs)))
    log_fn(f"batched sponge: {len(msgs)} lanes, all digests match "
           f"hashlib: {ok}")
    log_fn(f"  block-diagonal occupancy: {float(single.density):.3f} for "
           f"one lane -> {float(compiled.density):.3f} at B={len(msgs)} "
           f"(1/B scaling; {int(compiled.num_active)} of "
           f"{compiled.n_pairs} operator tiles active)")


if __name__ == "__main__":
    main()
