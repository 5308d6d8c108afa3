"""AES-128 on the permutation crossbar: the weight semiring, live.

Port of ``examples/crypto_block.py`` on ``repro_torch``; runs on the
CUDA card by default, ``--device cpu`` elsewhere.  Walks the
block-cipher subsystem end to end:

1. encrypt the FIPS-197 Appendix C.1 plaintext and check the published
   ciphertext byte-for-byte, then decrypt it back;
2. show MixColumns as ONE GF(2^8)-weighted crossbar pass — the
   ``core.semiring`` abstraction: same plan machinery, finite-field
   (add, mul) — reproducing the spec's worked column example;
3. count crossbar passes: fused rounds (ShiftRows∘MixColumns composed
   by the plan algebra into one GF(2^8) plan) pay 20 passes per
   encryption; chained layers pay 29;
4. run three different plaintexts under ``fixed_latency=True`` — the
   schedule signature recorded on the first call must match exactly —
   and statically audit the round function for value-dependent host
   syncs (the constant-time check: the round runs under
   ``FakeTensorMode`` on a fake payload of the device's type).

Run:  PYTHONPATH=src python examples_torch/crypto_block.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch import crypto
from repro_torch._device import resolve
from repro_torch.core import telemetry
from repro_torch.crypto import aes
from repro_torch.crypto.registry import registry


def main(argv=None, *, device=None, log_fn=print):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve(device if device is not None else args.device)
    key = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")

    # 1. FIPS-197 Appendix C.1 --------------------------------------------
    ct = crypto.aes128_encrypt(key, pt, device=dev)
    log_fn(f"AES-128({pt.hex()})\n  = {ct.hex()}")
    assert ct.hex() == "69c4e0d86a7b0430d8cdb78070b4c55a", "FIPS mismatch!"
    log_fn("  matches FIPS-197 Appendix C.1: True")
    assert crypto.aes128_decrypt(key, ct, device=dev) == pt
    log_fn("  decrypts back: True")

    # 2. MixColumns as one GF(2^8)-weighted pass --------------------------
    state = torch.tensor([0xD4, 0xBF, 0x5D, 0x30] + [0] * 12,
                         dtype=torch.int32, device=dev)
    with telemetry.delta() as d:
        mixed = crypto.mix_columns(state)
    col = [hex(int(v)) for v in mixed[:4].cpu().numpy()]
    assert col == ["0x4", "0x66", "0x81", "0xe5"], col
    log_fn(f"\nMixColumns(d4 bf 5d 30) = {col} "
           f"(spec example: 04 66 81 e5)")
    log_fn(f"  crossbar passes: {d()['apply_calls']} — one GF(2^8) plan, "
           f"semiring = {aes.mix_columns_plan(device=dev).semiring.name}")

    # 3. fused vs chained pass counts -------------------------------------
    with telemetry.delta() as d:
        crypto.aes128_encrypt(key, pt, device=dev)
    fused = d()["apply_calls"]
    with telemetry.delta() as d:
        crypto.aes128_encrypt(key, pt, fuse_layers=False, device=dev)
    chained = d()["apply_calls"]
    log_fn(f"\npasses per encryption: fused rounds {fused}, "
           f"chained layers {chained}")
    log_fn("  (ShiftRows∘MixColumns composed into ONE plan by the "
           "algebra saves a pass per round)")

    # 4. fixed latency + constant-time audit ------------------------------
    crypto.reset_observations()
    rng = np.random.default_rng(0)
    for _ in range(3):
        block = bytes(rng.integers(0, 256, 16).astype(np.uint8))
        crypto.aes128_encrypt(key, block, fixed_latency=True, device=dev)
    log_fn("\n3 random plaintexts under fixed_latency=True: "
           "signatures identical")

    rks = torch.as_tensor(aes.key_expansion(key), dtype=torch.int32,
                          device=dev)
    registry(dev).audit_constant_time(
        "example-aes-round",
        lambda s: aes._cipher_state(s, rks, inverse=False,
                                    fuse_layers=True, backend="einsum"),
        torch.zeros((16, 1), dtype=torch.int32, device=dev))
    log_fn("constant-time audit (abstract trace, payload as tracer): clean")


if __name__ == "__main__":
    main()
