"""Fixed-latency crypto workloads on the crossbar engine.

Port of ``repro.crypto``: Keccak-f[1600] / SHA-3 / SHAKE, ChaCha20,
AES-128 (ECB block function and CTR), AES-128-GCM (seal/open, fused into
one megakernel launch or chained over the crossbars), AES ShiftRows
layers and PRESENT-style bit permutations.  Every plan is a program constant in
the per-device registry (``crypto.registry.registry(device)``;
``REGISTRY`` is the table of them); ``fixed_latency=True`` on any entry point
asserts the call's pass count and schedule fingerprints.  Entry points
take ``device=None``, meaning the card.
"""

from repro_torch.core.static_registry import FixedLatencyError
from repro_torch.crypto.aes import (aes128_ctr_keystream, aes128_ctr_xor,
                                    aes128_decrypt, aes128_encrypt,
                                    key_expansion, mix_columns, sub_bytes)
from repro_torch.crypto.aes_layers import inv_shift_rows, shift_rows
from repro_torch.crypto.bitperm import (BitPermutation, bit_reversal,
                                        present_player)
from repro_torch.crypto.gcm import (InvalidTagError, aes128_gcm_open,
                                    aes128_gcm_open_batch, aes128_gcm_seal,
                                    aes128_gcm_seal_batch, ghash)
from repro_torch.crypto.chacha import (chacha20_block, chacha20_blocks,
                                       chacha20_encrypt)
from repro_torch.crypto.keccak import (KECCAK_ROUNDS, keccak_f1600,
                                       rho_offsets, round_constants,
                                       sha3_256, sha3_256_batched, sha3_512,
                                       shake_128, shake_256)
from repro_torch.crypto.registry import REGISTRY, reset_observations

__all__ = [
    "REGISTRY", "reset_observations", "FixedLatencyError",
    "KECCAK_ROUNDS", "keccak_f1600", "rho_offsets", "round_constants",
    "sha3_256", "sha3_256_batched", "sha3_512", "shake_128", "shake_256",
    "chacha20_block", "chacha20_blocks", "chacha20_encrypt",
    "inv_shift_rows", "shift_rows",
    "aes128_ctr_keystream", "aes128_ctr_xor",
    "aes128_decrypt", "aes128_encrypt", "key_expansion", "mix_columns",
    "sub_bytes",
    "BitPermutation", "bit_reversal", "present_player",
    "aes128_gcm_seal", "aes128_gcm_seal_batch", "aes128_gcm_open",
    "aes128_gcm_open_batch", "ghash", "InvalidTagError",
]
