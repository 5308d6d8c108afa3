"""AES-128 on the crossbar: every layer is a pass over a static plan.

Port of ``repro.crypto.aes``.

* **MixColumns / InvMixColumns**: a 16-row crossbar whose per-select
  weights are GF(2^8) coefficients (the circulant {2,3,1,1} / {e,b,d,9}
  matrices over the Rijndael polynomial).  ONE ``apply_plan`` pass; the
  'einsum', 'kernel' and 'sparse' backends run its GF(2) bit lift (128
  bit rows, k = 32 selects, parity fold).
* **SubBytes / InvSubBytes**: the state is one-hot encoded (byte v ->
  basis vector e_v of length 256, an iota compare) and the S-box is a
  STATIC 256-row permutation plan ``e_v -> e_{S(v)}``: the lookup
  indices ride as payload and the table as control, so the schedule
  never sees the state's values.  The S-box is generated (GF(2^8)
  inversion and the affine map), not transcribed.
* **ShiftRows / InvShiftRows**: the byte permutations of
  ``crypto.aes_layers``.

With ``fuse_layers=True`` ShiftRows∘MixColumns is ONE GF(2^8) plan a
round (``plan_algebra.compose``): 20 passes a call instead of 29.
Decryption is the FIPS-197 §5.3.5 equivalent inverse cipher, so
InvShiftRows∘InvMixColumns fuses the same way (InvMixColumns folds into
round keys 1..9 on the host).  AddRoundKey is XOR between passes; the key
schedule runs on the host in numpy.

``aes128_encrypt``/``aes128_decrypt`` take B blocks as payload width
(state (16, B)), so a call costs the same passes whatever B.  CTR mode
(NIST SP 800-38A) makes its counter blocks on the host (128-bit
big-endian increment) and encrypts all of them as one batch.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch._device import place, resolve
from repro_torch.core import crossbar as xb
from repro_torch.core import plan_algebra as pa
from repro_torch.core import semiring as sr
from repro_torch.crypto import aes_layers
from repro_torch.crypto.registry import registry

STATE_BYTES = 16
ROUNDS = 10

# MixColumns circulants, M[r, j]: out[r] = XOR_j M[r,j] * in[j] per column.
_MC_MAT = np.array([[2, 3, 1, 1],
                    [1, 2, 3, 1],
                    [1, 1, 2, 3],
                    [3, 1, 1, 2]], np.int32)
_INV_MC_MAT = np.array([[14, 11, 13, 9],
                        [9, 14, 11, 13],
                        [13, 9, 14, 11],
                        [11, 13, 9, 14]], np.int32)


@functools.lru_cache(maxsize=None)
def sbox_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(sbox, inv_sbox) as (256,) int32, generated: inversion through
    exp/log tables over the generator 0x03, then the affine map
    ``b ^ rotl(b,1) ^ rotl(b,2) ^ rotl(b,3) ^ rotl(b,4) ^ 0x63``."""
    exp = np.zeros(256, np.int32)
    log = np.zeros(256, np.int32)
    v = 1
    for i in range(255):
        exp[i] = v
        log[v] = i
        v = int(sr.gf2_8_mul(np.int32(v), np.int32(3)))
    inv = np.zeros(256, np.int32)
    inv[1:] = exp[(255 - log[np.arange(1, 256)]) % 255]

    def rotl(b, n):
        return ((b << n) | (b >> (8 - n))) & 0xFF

    b = inv
    sbox = (b ^ rotl(b, 1) ^ rotl(b, 2) ^ rotl(b, 3) ^ rotl(b, 4)
            ^ 0x63).astype(np.int32)
    inv_sbox = np.zeros(256, np.int32)
    inv_sbox[sbox] = np.arange(256)
    return sbox, inv_sbox


# ---------------------------------------------------------------------------
# Static plans
# ---------------------------------------------------------------------------

def _mc_gather(mat: np.ndarray) -> tuple:
    """(idx, weights) of a column-circulant as a 16-row k=4 gather."""
    idx = np.zeros((STATE_BYTES, 4), np.int32)
    w = np.zeros((STATE_BYTES, 4), np.int32)
    for c in range(4):
        for r in range(4):
            idx[4 * c + r] = 4 * c + np.arange(4)
            w[4 * c + r] = mat[r]
    return idx, w


def mix_columns_plan(*, inverse: bool = False, device=None) -> xb.PermutePlan:
    dev = resolve(device)
    key = "aes/inv_mix_columns" if inverse else "aes/mix_columns"
    mat = _INV_MC_MAT if inverse else _MC_MAT

    def build():
        idx, w = _mc_gather(mat)
        return xb.gather_plan(torch.as_tensor(idx, device=dev), STATE_BYTES,
                              weights=torch.as_tensor(w, device=dev),
                              semiring=sr.GF2_8)

    return registry(dev).get_or_register(key, build)


def sbox_plan(*, inverse: bool = False, device=None) -> xb.PermutePlan:
    """The S-box as a static 256-row one-hot-domain permutation:
    ``out_onehot[v] = in_onehot[S^{-1}(v)]``."""
    dev = resolve(device)
    key = "aes/inv_sbox" if inverse else "aes/sbox"
    sbox, inv_sbox = sbox_tables()
    table = sbox if inverse else inv_sbox  # gather sources
    return registry(dev).get_or_register(
        key, lambda: xb.gather_plan(torch.as_tensor(table, device=dev), 256))


def round_linear_plan(*, inverse: bool = False,
                      device=None) -> xb.PermutePlan:
    """The fused round linear layer: ``compose(MC, SR)`` to encrypt,
    ``compose(InvMC, InvSR)`` for the equivalent inverse cipher — ONE
    GF(2^8) k=4 plan (the pure permutation adopts GF2_8 in compose)."""
    dev = resolve(device)
    reg = registry(dev)
    aes_layers._register(dev)
    if inverse:
        return reg.get_or_register(
            "aes/inv_shift_rows_inv_mix_columns",
            lambda: pa.compose(mix_columns_plan(inverse=True, device=dev),
                               reg["aes/inv_shift_rows"]))
    return reg.get_or_register(
        "aes/shift_rows_mix_columns",
        lambda: pa.compose(mix_columns_plan(device=dev),
                           reg["aes/shift_rows"]))


# ---------------------------------------------------------------------------
# Layer entry points (each exactly one crossbar pass)
# ---------------------------------------------------------------------------

def _canon_state(state: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    single = state.dim() == 1
    st = state[:, None] if single else state
    if st.shape[0] != STATE_BYTES:
        raise ValueError(f"AES state must have {STATE_BYTES} byte rows, "
                         f"got shape {tuple(state.shape)}")
    return st.to(torch.int32), single


def mix_columns(state, *, inverse: bool = False, backend: str = "einsum",
                fixed_latency: bool = False, device=None) -> torch.Tensor:
    """(Inv)MixColumns on a (16,) or (16, B) byte state: ONE GF(2^8) pass."""
    state = place(state, device)
    mix_columns_plan(inverse=inverse, device=state.device)
    key = "aes/inv_mix_columns" if inverse else "aes/mix_columns"
    st, single = _canon_state(state)
    out = registry(state.device).execute(key, st, backend=backend,
                                         fixed_latency=fixed_latency)
    out = out.to(state.dtype)
    return out[:, 0] if single else out


def _onehot_encode(st: torch.Tensor) -> torch.Tensor:
    """(16, B) byte values -> (256, 16, B) one-hot payload (iota compare)."""
    vals = torch.arange(256, dtype=torch.int32, device=st.device)
    return (st[None, :, :] == vals[:, None, None]).to(torch.int32)


def _onehot_decode(onehot: torch.Tensor) -> torch.Tensor:
    """(256, 16, B) one-hot -> (16, B) byte values (weighted sum)."""
    vals = torch.arange(256, dtype=torch.int32, device=onehot.device)
    return torch.sum(onehot * vals[:, None, None], dim=0,
                     dtype=torch.int32)


def sub_bytes(state, *, inverse: bool = False, backend: str = "einsum",
              fixed_latency: bool = False, device=None) -> torch.Tensor:
    """(Inv)SubBytes through the one-hot-domain S-box plan: ONE pass.
    Encode and decode are branch-free arithmetic around the crossbar."""
    state = place(state, device)
    sbox_plan(inverse=inverse, device=state.device)
    key = "aes/inv_sbox" if inverse else "aes/sbox"
    st, single = _canon_state(state)
    out = _onehot_decode(registry(state.device).execute(
        key, _onehot_encode(st), backend=backend,
        fixed_latency=fixed_latency))
    out = out.to(state.dtype)
    return out[:, 0] if single else out


def shift_rows(state: torch.Tensor, **kw) -> torch.Tensor:
    """Re-export of the registered byte permutation (crypto.aes_layers)."""
    return aes_layers.shift_rows(state, **kw)


def inv_shift_rows(state: torch.Tensor, **kw) -> torch.Tensor:
    return aes_layers.inv_shift_rows(state, **kw)


# ---------------------------------------------------------------------------
# Key schedule (host-side numpy; FIPS 197 §5.2)
# ---------------------------------------------------------------------------

def key_expansion(key: bytes) -> np.ndarray:
    """(11, 16) int32 round keys, flat in the state's column-major order."""
    if len(key) != 16:
        raise ValueError(f"AES-128 key must be 16 bytes, got {len(key)}")
    sbox, _ = sbox_tables()
    w = [np.frombuffer(key, np.uint8)[4 * i:4 * i + 4].astype(np.int32)
         for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        temp = w[i - 1]
        if i % 4 == 0:
            temp = sbox[np.roll(temp, -1)].copy()
            temp[0] ^= rcon
            rcon = int(sr.gf2_8_xtime(np.int32(rcon)))
        w.append(w[i - 4] ^ temp)
    return np.stack([np.concatenate(w[4 * r:4 * r + 4])
                     for r in range(ROUNDS + 1)]).astype(np.int32)


def _inv_mix_key(rk_flat: np.ndarray) -> np.ndarray:
    """InvMixColumns of one flat round key (host side, for §5.3.5 dw)."""
    s = rk_flat.reshape(4, 4).T           # s[r, c] = flat[4c + r]
    out = np.zeros_like(s)
    for r in range(4):
        for j in range(4):
            out[r] ^= sr.gf2_8_mul(np.int32(_INV_MC_MAT[r, j]), s[j])
    return out.T.reshape(16)


# ---------------------------------------------------------------------------
# The block function
# ---------------------------------------------------------------------------

def _passes(fuse_layers: bool) -> int:
    # 9 full rounds + final round; fused: (sbox + SR∘MC) * 9 + (sbox + SR).
    return (2 * 9 + 2) if fuse_layers else (3 * 9 + 2)


def _cipher_state(st: torch.Tensor, rks: torch.Tensor, *, inverse: bool,
                  fuse_layers: bool, backend: str) -> torch.Tensor:
    """The (equivalent inverse) cipher on a (16, B) state; ``rks`` is
    (11, 16) in application order."""
    run = functools.partial(registry(st.device).execute, backend=backend)

    def lut(s):
        return _onehot_decode(run(
            "aes/inv_sbox" if inverse else "aes/sbox", _onehot_encode(s)))

    sr_key = "aes/inv_shift_rows" if inverse else "aes/shift_rows"
    mc_key = "aes/inv_mix_columns" if inverse else "aes/mix_columns"
    fused_key = ("aes/inv_shift_rows_inv_mix_columns" if inverse
                 else "aes/shift_rows_mix_columns")

    st = st ^ rks[0][:, None]
    for rnd in range(1, ROUNDS):
        st = lut(st)
        if fuse_layers:
            st = run(fused_key, st)
        else:
            st = run(sr_key, st)
            st = run(mc_key, st)
        st = st ^ rks[rnd][:, None]
    st = lut(st)
    st = run(sr_key, st)
    return st ^ rks[ROUNDS][:, None]


def _ensure_plans(inverse: bool, fuse_layers: bool, dev) -> tuple:
    """Register every plan the cipher touches; return their keys."""
    aes_layers._register(dev)
    sbox_plan(inverse=inverse, device=dev)
    mix_columns_plan(inverse=inverse, device=dev)
    keys = ["aes/inv_sbox" if inverse else "aes/sbox",
            "aes/inv_shift_rows" if inverse else "aes/shift_rows",
            "aes/inv_mix_columns" if inverse else "aes/mix_columns"]
    if fuse_layers:
        round_linear_plan(inverse=inverse, device=dev)
        keys.append("aes/inv_shift_rows_inv_mix_columns" if inverse
                    else "aes/shift_rows_mix_columns")
    return tuple(keys)


def _blocks_to_state(data: bytes, dev) -> torch.Tensor:
    if len(data) == 0 or len(data) % STATE_BYTES:
        raise ValueError(
            f"data length must be a positive multiple of {STATE_BYTES} "
            f"bytes, got {len(data)} (the block function has no padding)")
    arr = np.frombuffer(data, np.uint8).reshape(-1, STATE_BYTES)
    return torch.as_tensor(np.ascontiguousarray(arr.T.astype(np.int32)),
                           device=dev)                   # (16, B)


def _state_to_blocks(st: torch.Tensor) -> bytes:
    return st.T.to(torch.uint8).cpu().numpy().tobytes()


def _run_cipher(key: bytes, data: bytes, *, inverse: bool, backend: str,
                fuse_layers: bool, fixed_latency: bool, device) -> bytes:
    dev = resolve(device)
    plan_keys = _ensure_plans(inverse, fuse_layers, dev)
    rks = key_expansion(key)
    if inverse:
        # Equivalent inverse cipher (§5.3.5): reverse application order,
        # InvMixColumns folded into the inner round keys on the host.
        order = [rks[ROUNDS]] + [_inv_mix_key(rks[r])
                                 for r in range(ROUNDS - 1, 0, -1)] + [rks[0]]
        rks = np.stack(order)
    rks_dev = torch.as_tensor(rks, device=dev)
    st = _blocks_to_state(data, dev)

    def run():
        return _cipher_state(st, rks_dev, inverse=inverse,
                             fuse_layers=fuse_layers, backend=backend)

    if not fixed_latency:
        return _state_to_blocks(run())
    with registry(dev).observe(
            ("aes128", "decrypt" if inverse else "encrypt", fuse_layers),
            shapes=(tuple(st.shape), str(st.dtype)),
            backend=backend, plan_keys=plan_keys,
            expect_apply_calls=_passes(fuse_layers)):
        out = run()
    return _state_to_blocks(out)


def aes128_encrypt(key: bytes, plaintext: bytes, *, backend: str = "einsum",
                   fuse_layers: bool = True, fixed_latency: bool = False,
                   device=None) -> bytes:
    """AES-128 encryption of B = len/16 blocks in one payload batch on
    ``device`` (None: the card): 20 crossbar passes a call fused, 29
    chained, whatever B; ``fixed_latency=True`` asserts it."""
    return _run_cipher(key, plaintext, inverse=False, backend=backend,
                       fuse_layers=fuse_layers, fixed_latency=fixed_latency,
                       device=device)


def aes128_decrypt(key: bytes, ciphertext: bytes, *,
                   backend: str = "einsum", fuse_layers: bool = True,
                   fixed_latency: bool = False, device=None) -> bytes:
    """AES-128 decryption (equivalent inverse cipher, §5.3.5)."""
    return _run_cipher(key, ciphertext, inverse=True, backend=backend,
                       fuse_layers=fuse_layers, fixed_latency=fixed_latency,
                       device=device)


# ---------------------------------------------------------------------------
# CTR mode (NIST SP 800-38A §6.5)
# ---------------------------------------------------------------------------

def _ctr_blocks(iv: bytes, n_blocks: int) -> bytes:
    """``n_blocks`` consecutive counter blocks from ``iv`` (128-bit
    big-endian increment, wrapping mod 2^128)."""
    if len(iv) != STATE_BYTES:
        raise ValueError(f"CTR initial counter block must be "
                         f"{STATE_BYTES} bytes, got {len(iv)}")
    if n_blocks < 1:
        raise ValueError(f"need at least one counter block, got {n_blocks}")
    base = int.from_bytes(iv, "big")
    return b"".join(
        ((base + i) % (1 << 128)).to_bytes(STATE_BYTES, "big")
        for i in range(n_blocks))


def aes128_ctr_keystream(key: bytes, iv: bytes, n_blocks: int, *,
                         backend: str = "einsum", fuse_layers: bool = True,
                         fixed_latency: bool = False, device=None) -> bytes:
    """``n_blocks * 16`` keystream bytes: one batched block-function call."""
    return aes128_encrypt(key, _ctr_blocks(iv, n_blocks), backend=backend,
                          fuse_layers=fuse_layers,
                          fixed_latency=fixed_latency, device=device)


def aes128_ctr_xor(key: bytes, iv: bytes, data: bytes, *,
                   backend: str = "einsum", fuse_layers: bool = True,
                   fixed_latency: bool = False, device=None) -> bytes:
    """CTR encrypt/decrypt (the same XOR both ways, any data length)."""
    if not data:
        return b""
    n_blocks = -(-len(data) // STATE_BYTES)
    ks = aes128_ctr_keystream(key, iv, n_blocks, backend=backend,
                              fuse_layers=fuse_layers,
                              fixed_latency=fixed_latency, device=device)
    buf = np.frombuffer(data, np.uint8)
    return (buf ^ np.frombuffer(ks, np.uint8)[:len(buf)]).tobytes()
