"""AES-128-GCM sealed in ONE program launch: the AEAD subsystem, live.

Port of ``examples/crypto_aead.py`` on ``repro_torch``; runs on the CUDA
card by default (``backend="fused"``: the plan-program megakernel),
``--device cpu`` elsewhere (the megakernel's plain VM).  Walks the fused
authenticated-encryption path end to end:

1. seal the NIST GCM spec's worked example (case 4: 60-byte plaintext,
   20-byte AAD) and check ciphertext and tag byte-for-byte against the
   published vector;
2. show the O(1)-launch property: a whole batch of records costs ONE
   megakernel launch and ZERO chained crossbar passes — the CTR
   keystream, the ciphertext XOR, every GHASH multiply-by-H, and the
   tag all live inside a single ``PlanProgram``;
3. open the sealed records back and demonstrate tamper detection — a
   single flipped ciphertext bit raises ``InvalidTagError`` with the
   failing record index, and nothing decrypts;
4. run the seal twice under ``fixed_latency=True`` so the registry
   pins the schedule signature — the data-independent-cost contract
   the drift monitor watches in serving.

Run:  PYTHONPATH=src python examples_torch/crypto_aead.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch._device import resolve
from repro_torch.core import plan_program as pp
from repro_torch.crypto import gcm

# NIST GCM spec test case 4 (also the CAVP anchor in tests/test_gcm.py)
KEY = bytes.fromhex("feffe9928665731c6d6a8f9467308308")
IV = bytes.fromhex("cafebabefacedbaddecaf888")
PT = bytes.fromhex(
    "d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
    "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b39")
AAD = bytes.fromhex("feedfacedeadbeeffeedfacedeadbeefabaddad2")
CT = bytes.fromhex(
    "42831ec2217774244b7221b784d0d49ce3aa212f2c02a4e035c17e2329aca12e"
    "21d514b25466931c7d8f6a5aac84aa051ba30b396a0aac973d58e091")
TAG = bytes.fromhex("5bc94fbc3221a5db94fae95ae7121a47")
BATCH = 8


def main(argv=None, *, device=None, log_fn=print):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve(device if device is not None else args.device)

    # 1. NIST worked example ----------------------------------------------
    sealed = gcm.aes128_gcm_seal(KEY, IV, PT, AAD, backend="fused",
                                 device=dev)
    log_fn(f"seal({len(PT)}B plaintext, {len(AAD)}B AAD)")
    log_fn(f"  ct  = {sealed[:-16].hex()[:48]}...")
    log_fn(f"  tag = {sealed[-16:].hex()}")
    assert sealed == CT + TAG, "NIST GCM case-4 mismatch!"
    log_fn("  matches the NIST GCM spec vector: True")

    # 2. O(1) launches for a whole batch ----------------------------------
    rng = np.random.default_rng(7)
    b = BATCH
    ivs = [rng.bytes(12) for _ in range(b)]
    pts = [rng.bytes(len(PT)) for _ in range(b)]
    aads = [rng.bytes(len(AAD)) for _ in range(b)]
    l0, p0 = pp.program_launch_count(), pp.passes_avoided_count()
    batch = gcm.aes128_gcm_seal_batch(KEY, ivs, pts, aads,
                                      backend="fused", device=dev)
    launches = pp.program_launch_count() - l0
    avoided = pp.passes_avoided_count() - p0
    log_fn(f"\nsealed {b} records: {launches} launch "
           f"({avoided} chained passes folded away)")
    assert launches == 1

    # 3. open + tamper detection ------------------------------------------
    opened = gcm.aes128_gcm_open_batch(KEY, ivs, batch, aads,
                                       backend="fused", device=dev)
    assert opened == pts
    log_fn("all records open back: True")
    forged = list(batch)
    forged[3] = bytes([forged[3][0] ^ 1]) + forged[3][1:]
    try:
        gcm.aes128_gcm_open_batch(KEY, ivs, forged, aads,
                                  backend="fused", device=dev)
        raise SystemExit("forgery was accepted!")
    except gcm.InvalidTagError as e:
        assert e.indices == (3,), e.indices
        log_fn(f"tampered record rejected: InvalidTagError{e.indices}")

    # 4. fixed-latency contract -------------------------------------------
    for _ in range(2):
        gcm.aes128_gcm_seal_batch(KEY, ivs, pts, aads, backend="fused",
                                  fixed_latency=True, device=dev)
    log_fn("fixed-latency schedule signature pinned: True")


if __name__ == "__main__":
    main()
