"""AES-128-GCM on the crossbar: authenticated encryption in O(1) launches.

Port of ``repro.crypto.gcm``.  AES-CTR is the byte-wide (GF(2^8))
pipeline of ``crypto.aes``; GHASH is a 128-bit-wide field multiply, the
top of the engine's element-width axis.  Two lowerings share the math:

* **Chained per-block lowering** (``backend='einsum'|'kernel'|'sparse'
  |'reference'``): the counter blocks go through the 20-pass AES plan
  pipeline as one batch, then GHASH absorbs one block a pass —
  ``ghash(..., mode='horner')`` multiplies the accumulator by H through
  ONE weighted PERMUTE over the ``gf2_128`` semiring (the matmul backends
  run its GF(2) bit lift, ``crossbar.lift_gf2_k``).  ``mode='powers'``
  weights each block by a host-computed power of H, so the whole
  Σ X_j·H^(M+1-j) is ONE pass.  The CAVP reference path.

* **Fused program** (``backend='fused'``): one ``PlanProgram`` per (key,
  record geometry) runs the whole seal or open — CTR keystream for every
  block, the ciphertext XOR, GHASH and the tag — as ONE megakernel
  launch for a batch of same-geometry records (records are payload
  lanes).  The state is a 0/1 bit matrix whose rows are
  ``[stream | Y | E(J0) | IV | LEN | AAD | one-hot scratch]``:

  - AES runs on 128 bit rows a block, its S-box factored through nibble
    one-hots (a REAL weighted PERMUTE spreads each byte's bits to 32
    candidate rows, ``EQ_CONST`` one-hots them, a k=16 GF(2) PERMUTE
    forms the low-nibble partial sums, an AND picks the high nibble's
    column, a k=16 fold reads S(v)'s bits back); the round's linear
    layer is the select-compacted lift of ShiftRows∘MixColumns.  The
    REAL spread and ``EQ_CONST`` make the program word-layout only.
  - Counter blocks never ride as input: each trip re-routes the IV bits
    and XORs a per-trip constant row carrying the 32-bit block counter
    and the whitening key.
  - GHASH's accumulator Y absorbs by Horner: ONE PERMUTE a trip shifts
    the stream, appends the new ciphertext block, keeps E(J0) and
    computes (Y ^ C_t)·H.  A partial final block masks its dead bit rows
    in that plan's control.

  Trip 0 encrypts J0 (the tag mask); the epilogue runs the last multiply
  and lands ``[ciphertext bits | tag bits]`` in register 0.

  One deliberate difference from the reference: the reference builds
  the absorb plan afresh in every trip, and the program builder dedups
  plans by identity, so its plan table grows as m × k × n int32 (about
  600 MB of control at 1500-byte records).  Here the full-block absorb
  plan (and, opening, the keystream route) is built once, and the
  masked last-trip plan once.  The step stream is the reference's step
  for step; only plan slot numbers differ.

``fixed_latency=True`` asserts 1 launch and 0 crossbar passes under the
registry's program fingerprint.  Each fused call runs inside a
``gcm_seal`` / ``gcm_open`` span, bumps four telemetry counters and
(sealing) observes the ``gcm_seal_latency_rec{N}b`` histogram; the
``ghash_lift_cache`` gauge exports the lift cache's occupancy.

Only 96-bit IVs (J0 = IV || 0^31 || 1, the SP 800-38D fast path and the
CAVP coverage target).  Entry points take ``device=None``, meaning the
card.
"""

from __future__ import annotations

import hashlib
import hmac
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch._device import resolve
from repro_torch.core import crossbar as xb
from repro_torch.core import plan_algebra as pa
from repro_torch.core import plan_program as pp
from repro_torch.core import semiring as sr
from repro_torch.core import telemetry
from repro_torch.crypto import aes as aes_mod
from repro_torch.crypto.registry import registry

BLOCK = 16
TAG_BYTES = 16
IV_BYTES = 12

# GHASH's field in the reflected-integer convention: block bit 8r+k (bit
# k of byte r, MSB first) is coefficient x^(8r+k), so mapping each byte
# through REV8 and reading the 16 bytes little-endian gives an integer
# whose bit e IS coefficient e.
GCM_POLY = (1 << 128) | 0x87

_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.int32)


class InvalidTagError(Exception):
    """Authentication failed for at least one record (``.indices`` says
    which); no plaintext is returned for any record in the batch."""

    def __init__(self, indices: Sequence[int]):
        self.indices = tuple(indices)
        super().__init__(f"GCM tag verification failed for record(s) "
                         f"{list(self.indices)}")


# ---------------------------------------------------------------------------
# Field plumbing (host-side control information)
# ---------------------------------------------------------------------------

def _block_to_field(b: bytes) -> int:
    """16-byte block -> reflected field integer (bit e = coeff x^e)."""
    return int.from_bytes(bytes(int(_REV8[x]) for x in b), "little")


def _field_to_block(v: int) -> bytes:
    return bytes(int(_REV8[x]) for x in v.to_bytes(BLOCK, "little"))


def _field_limbs(v: int) -> np.ndarray:
    """Field integer -> (16,) int32 byte limbs (the ``gf2_128``
    semiring's carrier layout)."""
    return np.frombuffer(v.to_bytes(BLOCK, "little"), np.uint8).astype(
        np.int32)


def _hpowers(h: int, n: int) -> List[int]:
    """[H^1, ..., H^n] in the reflected-integer field."""
    out, v = [], 1
    for _ in range(n):
        v = sr.gf2k_mul_int(v, h, 128, GCM_POLY)
        out.append(v)
    return out


_MUL_BITS_CACHE: dict = {}


def _mul_bits(factor: int) -> np.ndarray:
    """(128, 128) uint8 bit matrix of multiply-by-``factor`` in BLOCK row
    order (row 8j+b = value bit b of byte j, LSB first): out = M @ in over
    GF(2).  The per-byte bit reflection between block and field order is
    conjugated in, so the program's GHASH rows need no swap pass."""
    m = _MUL_BITS_CACHE.get(factor)
    if m is not None:
        return m
    m = np.zeros((128, 128), np.uint8)
    for r_in in range(128):
        jbyte, bval = r_in >> 3, r_in & 7
        e_in = 8 * jbyte + (7 - bval)
        prod = sr.gf2k_mul_int(factor, 1 << e_in, 128, GCM_POLY)
        while prod:
            e = prod.bit_length() - 1
            m[8 * (e >> 3) + (7 - (e & 7)), r_in] = 1
            prod ^= 1 << e
    _MUL_BITS_CACHE[factor] = m
    return m


def _key_digest(key: bytes) -> str:
    return hashlib.sha256(b"gcm-key:" + key).hexdigest()[:12]


# ---------------------------------------------------------------------------
# Host AES (control information: H = E_K(0), like the key schedule)
# ---------------------------------------------------------------------------

def _host_encrypt_block(rks: np.ndarray, block: bytes) -> bytes:
    """Pure-numpy AES-128 block encryption.  H and the program constants
    are functions of the key alone, computed on the host like the key
    schedule — never through the device data path."""
    sbox, _ = aes_mod.sbox_tables()
    st = np.frombuffer(block, np.uint8).astype(np.int32) ^ rks[0]
    for rnd in range(1, aes_mod.ROUNDS + 1):
        st = sbox[st]
        sq = st.reshape(4, 4)                     # sq[c, r] = st[4c + r]
        st = np.stack([sq[(np.arange(4) + r) % 4, r]
                       for r in range(4)], axis=1).reshape(16)
        if rnd < aes_mod.ROUNDS:
            ns = np.empty(16, np.int32)
            for c in range(4):
                col = st[4 * c:4 * c + 4]
                for r in range(4):
                    acc = 0
                    for j in range(4):
                        acc ^= int(sr.gf2_8_mul(
                            np.int32(aes_mod._MC_MAT[r, j]),
                            np.int32(col[j])))
                    ns[4 * c + r] = acc
            st = ns
        st = st ^ rks[rnd]
    return bytes(int(x) for x in st)


def _hash_key(key: bytes) -> int:
    """H = E_K(0^128) as a reflected field integer."""
    rks = aes_mod.key_expansion(key)
    return _block_to_field(_host_encrypt_block(rks, b"\x00" * BLOCK))


# ---------------------------------------------------------------------------
# GHASH as crossbar passes over the gf2_128 semiring (chained lowering)
# ---------------------------------------------------------------------------

def _ghash_plan_key(key_or_h, mode: str, m: int) -> str:
    h = key_or_h if isinstance(key_or_h, int) else _hash_key(key_or_h)
    hdig = hashlib.sha256(b"gcm-h:" + h.to_bytes(16, "little")).hexdigest()
    return f"gcm/ghash/{hdig[:12]}/{mode}{m}"


def ghash_plan(h: int, *, mode: str = "powers", m: int = 1,
               device=None) -> Tuple[xb.PermutePlan, str]:
    """The GHASH multiply as a registered ``gf2_128``-weighted plan on
    ``device``: mode='horner' a 1->1 multiply-by-H (one pass a block),
    mode='powers' an M->1 gather weighted by [H^M, ..., H^1] (the whole
    Σ X_j·H^(M+1-j) as ONE pass).  Returns (plan, registry key)."""
    dev = resolve(device)
    g = sr.gf2_k(128, GCM_POLY)
    key = _ghash_plan_key(h, mode, m)
    if mode == "horner":
        def build():
            w = torch.as_tensor(_field_limbs(h)[None, None, :], device=dev)
            return xb.gather_plan(
                torch.zeros((1, 1), dtype=torch.int32, device=dev), 1,
                weights=w, semiring=g)
    elif mode == "powers":
        def build():
            pw = _hpowers(h, m)[::-1]            # H^M first: weight of X_1
            w = torch.as_tensor(np.stack([_field_limbs(p) for p in pw])
                                [None, :, :], device=dev)
            return xb.gather_plan(
                torch.arange(m, dtype=torch.int32, device=dev)[None, :], m,
                weights=w, semiring=g)
    else:
        raise ValueError(f"unknown ghash mode {mode!r}")
    return registry(dev).get_or_register(key, build), key


def _blocks_to_limbs(data: bytes) -> np.ndarray:
    """Zero-padded blocks -> (M, 16) int32 field limbs (REV8 per byte)."""
    pad = (-len(data)) % BLOCK
    arr = np.frombuffer(data + b"\x00" * pad, np.uint8).reshape(-1, BLOCK)
    return _REV8[arr]


def ghash(h: int, data: bytes, *, mode: str = "powers",
          backend: str = "einsum", device=None) -> bytes:
    """GHASH_H(data) (whole blocks) via crossbar passes: one
    (mode='powers') or one a block (mode='horner')."""
    if len(data) % BLOCK:
        raise ValueError(f"GHASH input must be whole blocks, got "
                         f"{len(data)} bytes")
    if not data:
        return b"\x00" * BLOCK
    dev = resolve(device)
    reg = registry(dev)
    limbs = torch.as_tensor(_blocks_to_limbs(data), device=dev)
    m = limbs.shape[0]
    if mode == "powers":
        _, key = ghash_plan(h, mode="powers", m=m, device=dev)
        acc = reg.execute(key, limbs, backend=backend)[0]
    else:
        _, key = ghash_plan(h, mode="horner", device=dev)
        acc = torch.zeros((1, BLOCK), dtype=torch.int32, device=dev)
        for j in range(m):
            acc = reg.execute(key, acc ^ limbs[j][None, :], backend=backend)
        acc = acc[0]
    return bytes(int(_REV8[x & 0xFF]) for x in acc.cpu().tolist())


# ---------------------------------------------------------------------------
# The fused GCM plan program
# ---------------------------------------------------------------------------

# S-box scratch: per state byte, 32 nibble one-hot rows (16 low + 16
# high values) plus a 128-row product region (8 output bits x 16 high
# nibbles) where the low-nibble partial sums meet the high-nibble one-hot.
ONEHOT_ROWS = 32 * BLOCK
PRODUCT_ROWS = 128 * BLOCK


def _geometry(pt_len: int, aad_len: int) -> Tuple[int, int, int]:
    """(m blocks, last-block bytes, a AAD blocks) of a record shape."""
    m = -(-pt_len // BLOCK)
    last = pt_len - BLOCK * (m - 1) if m else 0
    a = -(-aad_len // BLOCK)
    return m, last, a


def _layout(m: int, a: int) -> dict:
    lay = {"stream": 0, "y": 128 * m, "ej0": 128 * m + 128,
           "iv": 128 * m + 256, "len": 128 * m + 352,
           "aad": 128 * m + 480, "onehot": 128}
    n = max(128 + ONEHOT_ROWS + PRODUCT_ROWS, lay["aad"] + 128 * a)
    lay["n"] = n + (-n) % 8
    return lay


def _ragged_gather(rows: List[List[int]], n: int, device, weights=None,
                   semiring=sr.GF2) -> xb.PermutePlan:
    """Row-indexed select lists -> a DROP-padded (n -> n) gather plan."""
    k = max([len(s) for s in rows if s] or [1])
    idx = np.full((n, k), pa.DROP, np.int32)
    w = None if weights is None else np.zeros((n, k), np.float32)
    for i, sel in enumerate(rows):
        idx[i, :len(sel)] = sel
        if w is not None:
            w[i, :len(sel)] = weights[i][:len(sel)]
    return xb.gather_plan(
        torch.as_tensor(idx, device=device), n,
        weights=None if w is None else torch.as_tensor(w, device=device),
        semiring=semiring)


def _aes_bit_plans(n: int, device) -> dict:
    """The in-program AES round plans, embedded in the n-row state:
    nspread/u_row/psel/hirep/nfold the nibble-factored one-hot S-box,
    linear the select-compacted GF(2) lift of ShiftRows∘MixColumns,
    sr_bits the final round's bit permutation."""
    sbox, _ = aes_mod.sbox_tables()
    onehot = 128                     # 32 rows a byte: lo | hi nibble
    prod = onehot + ONEHOT_ROWS      # 128 rows a byte: (bit b, hi h)

    rows: List[List[int]] = [[] for _ in range(n)]
    wts: List[List[int]] = [[] for _ in range(n)]
    for j in range(BLOCK):
        for u in range(32):
            base = 0 if u < 16 else 4        # low vs high nibble bits
            rows[onehot + 32 * j + u] = [8 * j + base + b for b in range(4)]
            wts[onehot + 32 * j + u] = [1 << b for b in range(4)]
    nspread = _ragged_gather(rows, n, device, weights=wts,
                             semiring=sr.REAL)

    u_row = np.full(n, -1, np.int32)
    for j in range(BLOCK):
        u_row[onehot + 32 * j:onehot + 32 * (j + 1)] = np.arange(32) % 16

    # P[b,h] = XOR_l sbox_bit(b, 16h+l) * onehot_lo[l]
    rows = [[] for _ in range(n)]
    for j in range(BLOCK):
        for b in range(8):
            for h in range(16):
                rows[prod + 128 * j + 16 * b + h] = [
                    onehot + 32 * j + lo for lo in range(16)
                    if (int(sbox[16 * h + lo]) >> b) & 1]
    psel = _ragged_gather(rows, n, device)

    # the high-nibble one-hot replicated across the 8 output-bit strips
    rows = [[] for _ in range(n)]
    for j in range(BLOCK):
        for b in range(8):
            for h in range(16):
                rows[prod + 128 * j + 16 * b + h] = [onehot + 32 * j + 16 + h]
    hirep = _ragged_gather(rows, n, device)

    # S(v) bit b = XOR_h (hi[h] AND P[b,h])
    rows = [[] for _ in range(n)]
    for j in range(BLOCK):
        for b in range(8):
            rows[8 * j + b] = [prod + 128 * j + 16 * b + h
                               for h in range(16)]
    nfold = _ragged_gather(rows, n, device)

    lin16 = pa.compact_selects(xb.lift_gf2_k(
        aes_mod.round_linear_plan(device=device)))
    lin_idx = lin16.idx.cpu().numpy()
    rows = [[] for _ in range(n)]
    for i in range(128):
        rows[i] = [int(s) for s in lin_idx[i] if s >= 0]
    linear = _ragged_gather(rows, n, device)

    aes_mod._ensure_plans(False, True, device)
    sr_idx = pa.to_gather(
        registry(device)["aes/shift_rows"]).idx.cpu().numpy()
    rows = [[] for _ in range(n)]
    for i in range(BLOCK):
        for b in range(8):
            rows[8 * i + b] = [8 * int(sr_idx[i, 0]) + b]
    sr_bits = _ragged_gather(rows, n, device)

    return {"nspread": nspread, "u_row": u_row, "psel": psel,
            "hirep": hirep, "nfold": nfold,
            "linear": linear, "sr_bits": sr_bits}


def _bits_row(block16: np.ndarray) -> np.ndarray:
    """(16,) byte values -> (128,) LSB-first bit rows."""
    return np.unpackbits(block16.astype(np.uint8),
                         bitorder="little").astype(np.int32)


def _live_bits(last: int) -> List[int]:
    """Bit rows of a block's first ``last`` bytes (the rest is the dead
    region of a partial final block)."""
    return [8 * j + b for j in range(last) for b in range(8)]


def _emit_aes_rounds(b: pp.ProgramBuilder, plans: dict,
                     rk_rows: np.ndarray) -> None:
    """SubBytes/linear/AddRoundKey for rounds 1..10 on register 0 (the
    whitening XOR is fused into the caller's counter constant)."""
    for rnd in range(1, aes_mod.ROUNDS + 1):
        b.permute(1, 0, plans["nspread"])
        b.eq_const(1, 1, plans["u_row"])
        b.permute(0, 1, plans["psel"])      # state dead: P -> r0
        b.permute(1, 1, plans["hirep"])     # one-hots dead after this
        b.and_(1, 0, 1)                     # t[b,h] = hi[h] & P[b,h]
        b.permute(0, 1, plans["nfold"])     # S(v) bits, full overwrite
        b.permute(0, 0,
                  plans["linear" if rnd < aes_mod.ROUNDS else "sr_bits"])
        b.xor_const(0, 0, rk_rows[rnd])


def build_gcm_program(key: bytes, pt_len: int, aad_len: int, *,
                      open_mode: bool = False,
                      device=None) -> Tuple[pp.PlanProgram, dict]:
    """The one-launch seal/open schedule for one (key, record geometry),
    its plans on ``device``.  Returns (program, layout); the program maps
    an ``(n, B)`` 0/1 bit state (``_pack_records``) to ``[ciphertext |
    plaintext bits, tag bits]`` in register 0."""
    dev = resolve(device)
    m, last, a = _geometry(pt_len, aad_len)
    lay = _layout(m, a)
    n = lay["n"]
    h = _hash_key(key)
    rks = aes_mod.key_expansion(key)
    plans = _aes_bit_plans(n, dev)

    def gather(rows):
        return _ragged_gather(rows, n, dev)

    rk_rows = np.zeros((aes_mod.ROUNDS + 1, n), np.int32)
    for r in range(aes_mod.ROUNDS + 1):
        rk_rows[r, :128] = _bits_row(rks[r])

    mulh = _mul_bits(h)
    mulh_sel = [np.nonzero(mulh[i])[0].tolist() for i in range(128)]
    hpow = _hpowers(h, max(a, 1))

    # d1: stream <- plaintext/ciphertext rows; Y <- the AAD Horner seed
    # Sum_j A_j H^(a-j+1) (each trip and the epilogue multiply by H once
    # more, landing A_j at H^(M+1-j) exactly).
    rows: List[List[int]] = [[] for _ in range(n)]
    for i in range(128 * m):
        rows[lay["stream"] + i] = [i]
    for j in range(1, a + 1):
        mj = _mul_bits(hpow[a - j])              # H^(a-j+1)
        base = lay["aad"] + 128 * (j - 1)
        for i in range(128):
            rows[lay["y"] + i].extend(base + int(c)
                                      for c in np.nonzero(mj[i])[0])
    d1 = gather(rows)

    # d2: keep IV in place; route LEN onto Y's rows so the epilogue's
    # whole-register XOR lands Y ^ LEN with no extra pass.
    rows = [[] for _ in range(n)]
    for i in range(96):
        rows[lay["iv"] + i] = [lay["iv"] + i]
    for i in range(128):
        rows[lay["y"] + i] = [lay["len"] + i]
    d2 = gather(rows)

    # Per-trip counter load: IV bits to rows 0..95 (the 32-bit counter
    # and the whitening key arrive as the trip's constant row).
    rows = [[] for _ in range(n)]
    for i in range(96):
        rows[i] = [lay["iv"] + i]
    ctr = gather(rows)

    def ctr_const(t: int) -> np.ndarray:
        row = rk_rows[0].copy()
        ctr_bytes = np.zeros(BLOCK, np.int32)
        ctr_bytes[12:] = np.frombuffer(int(t + 1).to_bytes(4, "big"),
                                       np.uint8)
        row[:128] ^= _bits_row(ctr_bytes)
        return row

    # Trip 0 epilogue: park E_K(J0) (the tag mask) in its stream rows.
    rows = [[] for _ in range(n)]
    for i in range(128):
        rows[lay["ej0"] + i] = [i]
    place_ej0 = gather(rows)

    def absorb_plan(src_c: int, dead: List[int]) -> xb.PermutePlan:
        """Shift the stream, append C, keep E(J0), Y <- (Y ^ C_t)·H: one
        gather.  ``src_c``: where C's bit rows sit in the source register;
        ``dead`` C rows (a partial final block) are dropped from absorb
        and append."""
        dead_set = set(dead)
        rows = [[] for _ in range(n)]
        for i in range(128 * (m - 1)):
            rows[lay["stream"] + i] = [lay["stream"] + 128 + i]
        for r in range(128):
            if r not in dead_set:
                rows[lay["stream"] + 128 * (m - 1) + r] = [src_c + r]
        for i in range(128):
            rows[lay["y"] + i] = ([lay["y"] + c for c in mulh_sel[i]]
                                  + [src_c + c for c in mulh_sel[i]
                                     if c not in dead_set])
        for i in range(128):
            rows[lay["ej0"] + i] = [lay["ej0"] + i]
        return gather(rows)

    def route_ks(dead: List[int]) -> xb.PermutePlan:
        """Open trips: keystream bits routed onto the appended C block's
        rows (the XOR that turns it into plaintext)."""
        dead_set = set(dead)
        rows = [[] for _ in range(n)]
        for r in range(128):
            if r not in dead_set:
                rows[lay["stream"] + 128 * (m - 1) + r] = [r]
        return gather(rows)

    # Epilogue output: ciphertext stream + tag = (Y ^ LEN)·H ^ E(J0).
    rows = [[] for _ in range(n)]
    for i in range(128 * m):
        rows[lay["stream"] + i] = [lay["stream"] + i]
    for i in range(128):
        rows[128 * m + i] = ([lay["y"] + c for c in mulh_sel[i]]
                             + [lay["ej0"] + i])
    e2 = gather(rows)

    dead_last = ([r for r in range(128) if r not in set(_live_bits(last))]
                 if m else [])
    # Each distinct plan is built once (see the module docstring): the
    # full-block trips share one plan, the masked last trip has its own.
    if m:
        if open_mode:
            absorb = absorb_plan(lay["stream"], [])
            ks_full = route_ks([])
            ks_last = route_ks(dead_last) if dead_last else ks_full
        else:
            absorb = absorb_plan(lay["stream"], [])
            absorb_last = (absorb_plan(lay["stream"], dead_last)
                           if dead_last else absorb)

    b = pp.ProgramBuilder(
        f"gcm_{'open' if open_mode else 'seal'}_m{m}", n, n_regs=4)
    b.permute(2, 0, d1)
    b.permute(3, 0, d2)
    for t in range(m + 1):
        b.permute(0, 3, ctr)
        b.xor_const(0, 0, ctr_const(t))
        _emit_aes_rounds(b, plans, rk_rows)
        if t == 0:
            b.permute(1, 0, place_ej0)
            b.xor(2, 2, 1)
        elif not open_mode:
            b.xor(1, 0, 2)          # rows 0..127: C_t = ks ^ pt front
            b.permute(2, 1, absorb_last if t == m else absorb)
        else:
            # Absorb the received C_t straight from the stream, then
            # overlay the keystream on the appended copy -> PT_t.
            b.permute(1, 2, absorb)
            b.permute(0, 0, ks_last if t == m else ks_full)
            b.xor(2, 1, 0)
    b.xor(1, 2, 3)
    b.permute(0, 1, e2)
    return b.build(), lay


def _program_key(key: bytes, pt_len: int, aad_len: int,
                 open_mode: bool) -> str:
    m, last, a = _geometry(pt_len, aad_len)
    mode = "open" if open_mode else "seal"
    return f"gcm/aes128/{_key_digest(key)}/{mode}/m{m}.{last}a{a}"


def gcm_program(key: bytes, pt_len: int, aad_len: int, *,
                open_mode: bool = False,
                device=None) -> Tuple[str, pp.PlanProgram, dict]:
    """The registry-cached fused program of one (key, geometry) on
    ``device``: (registry key, program, row layout)."""
    dev = resolve(device)
    prog_key = _program_key(key, pt_len, aad_len, open_mode)

    def build():
        return build_gcm_program(key, pt_len, aad_len, open_mode=open_mode,
                                 device=dev)[0]

    program = registry(dev).get_or_register_program(prog_key, build)
    m, _, a = _geometry(pt_len, aad_len)
    return prog_key, program, _layout(m, a)


def seal_device_fn(key: bytes, pt_len: int, aad_len: int, *,
                   open_mode: bool = False, device=None):
    """(fn, layout) where ``fn(bits)`` is the whole device part of a fused
    seal or open: one program launch from packed record bits to
    ciphertext+tag bits.  This is the region
    ``StaticPlanRegistry.audit_constant_time`` abstract-evaluates;
    everything outside it is host marshalling of data the schedule never
    reads."""
    _, program, lay = gcm_program(key, pt_len, aad_len, open_mode=open_mode,
                                  device=device)

    def fn(bts: torch.Tensor) -> torch.Tensor:
        return pp.run_program(program, bts, backend="megakernel")

    return fn, lay


# ---------------------------------------------------------------------------
# Record packing (host <-> bit-state marshalling)
# ---------------------------------------------------------------------------

def _bits_matrix(records: Sequence[bytes], nbytes: int) -> np.ndarray:
    """B same-geometry byte strings -> (8*nbytes, B) LSB-first bit rows
    (zero-padded to ``nbytes``)."""
    arr = np.zeros((len(records), nbytes), np.uint8)
    for i, rec in enumerate(records):
        arr[i, :len(rec)] = np.frombuffer(rec, np.uint8)
    return np.unpackbits(arr, axis=1, bitorder="little").T.astype(np.int32)


def _len_block(aad_len: int, pt_len: int) -> bytes:
    return (8 * aad_len).to_bytes(8, "big") + (8 * pt_len).to_bytes(8, "big")


def _pack_records(lay: dict, ivs: Sequence[bytes], data: Sequence[bytes],
                  aads: Sequence[bytes], pt_len: int,
                  aad_len: int) -> np.ndarray:
    m, _, a = _geometry(pt_len, aad_len)
    bts = np.zeros((lay["n"], len(ivs)), np.int32)
    if m:
        bts[lay["stream"]:lay["stream"] + 128 * m] = _bits_matrix(
            data, BLOCK * m)
    bts[lay["iv"]:lay["iv"] + 96] = _bits_matrix(ivs, IV_BYTES)
    bts[lay["len"]:lay["len"] + 128] = _bits_matrix(
        [_len_block(aad_len, pt_len)], BLOCK)
    if a:
        bts[lay["aad"]:lay["aad"] + 128 * a] = _bits_matrix(
            aads, BLOCK * a)
    return bts


def _unpack_records(out: np.ndarray, m: int, pt_len: int
                    ) -> Tuple[List[bytes], List[bytes]]:
    """(n, B) output bits -> per-record (body bytes, 16-byte tag)."""
    body = np.packbits(out[:128 * m].T.astype(np.uint8), axis=1,
                       bitorder="little")[:, :pt_len]
    tags = np.packbits(out[128 * m:128 * m + 128].T.astype(np.uint8),
                       axis=1, bitorder="little")
    return ([r.tobytes() for r in body], [t.tobytes() for t in tags])


def _size_bucket(nbytes: int) -> int:
    b = 16
    while b < nbytes:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# Fused batch seal/open
# ---------------------------------------------------------------------------

def _check_batch(ivs, records, aads):
    if not ivs:
        raise ValueError("empty record batch")
    if aads is None:
        aads = [b""] * len(ivs)
    if not (len(ivs) == len(records) == len(aads)):
        raise ValueError(
            f"batch length mismatch: {len(ivs)} IVs, {len(records)} "
            f"records, {len(aads)} AADs")
    for iv in ivs:
        if len(iv) != IV_BYTES:
            raise ValueError(f"GCM nonce must be {IV_BYTES} bytes "
                             f"(96-bit IV fast path), got {len(iv)}")
    if len({len(r) for r in records}) != 1 or len({len(x)
                                                   for x in aads}) != 1:
        raise ValueError(
            "fused GCM batches share one record geometry (same plaintext "
            "and AAD lengths); route mixed sizes through separate batches")
    return aads


def _run_fused(key: bytes, ivs, records, aads, pt_len: int, aad_len: int,
               *, open_mode: bool, fixed_latency: bool, device):
    dev = resolve(device)
    m, _, a = _geometry(pt_len, aad_len)
    prog_key, program, lay = gcm_program(key, pt_len, aad_len,
                                         open_mode=open_mode, device=dev)
    bts = torch.as_tensor(_pack_records(lay, ivs, records, aads, pt_len,
                                        aad_len), device=dev)
    op = "gcm_open" if open_mode else "gcm_seal"
    launches0 = pp.program_launch_count()
    passes0 = pp.passes_avoided_count()
    t0 = time.perf_counter()

    def run():
        with _obs.span(op, records=len(ivs), blocks=m, aad_blocks=a,
                       program=prog_key):
            return pp.run_program(program, bts, backend="megakernel")

    if fixed_latency:
        with registry(dev).observe(
                (op, m, a, pt_len % BLOCK),
                shapes=(tuple(bts.shape), str(bts.dtype)),
                backend="megakernel", program_keys=(prog_key,),
                expect_apply_calls=0, expect_program_launches=1):
            out = run()
    else:
        out = run()
    out_np = out.cpu().numpy()
    elapsed = time.perf_counter() - t0
    telemetry.incr(f"{op}_calls")
    telemetry.incr(f"{op}_records", len(ivs))
    telemetry.incr(f"{op}_launches", pp.program_launch_count() - launches0)
    telemetry.incr("gcm_passes_avoided",
                   pp.passes_avoided_count() - passes0)
    if not open_mode:
        _obs.metrics.histogram(
            f"gcm_seal_latency_rec{_size_bucket(pt_len)}b").observe(elapsed)
    return _unpack_records(out_np, m, pt_len)


# ---------------------------------------------------------------------------
# Chained per-block lowering (the four-backend reference path)
# ---------------------------------------------------------------------------

def _seal_chained_core(key: bytes, iv: bytes, data: bytes, aad: bytes, *,
                       open_mode: bool, backend: str,
                       device) -> Tuple[bytes, bytes]:
    """(body, tag) via chained passes: one batched CTR keystream call (J0
    and every block counter as payload width), then one GHASH Horner pass
    a block."""
    m = -(-len(data) // BLOCK)
    j0 = iv + b"\x00\x00\x00\x01"
    ks = aes_mod.aes128_ctr_keystream(key, j0, m + 1, backend=backend,
                                      device=device)
    tag_mask, ks = ks[:BLOCK], ks[BLOCK:]
    body = bytes(a ^ b for a, b in zip(data, ks))
    ct = data if open_mode else body
    h = _hash_key(key)
    pad_c = ct + b"\x00" * ((-len(ct)) % BLOCK)
    pad_a = aad + b"\x00" * ((-len(aad)) % BLOCK)
    s = ghash(h, pad_a + pad_c + _len_block(len(aad), len(data)),
              mode="horner", backend=backend, device=device)
    tag = bytes(a ^ b for a, b in zip(s, tag_mask))
    return body, tag


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def aes128_gcm_seal_batch(key: bytes, ivs: Sequence[bytes],
                          plaintexts: Sequence[bytes],
                          aads: Optional[Sequence[bytes]] = None, *,
                          backend: str = "fused",
                          fixed_latency: bool = False,
                          device=None) -> List[bytes]:
    """Seal B same-geometry records; returns ``ciphertext || tag`` each.

    backend='fused' runs the whole batch as ONE plan-program launch; a
    crossbar backend name runs the chained per-block lowering record by
    record (the CAVP reference path).
    """
    aads = _check_batch(ivs, plaintexts, aads)
    pt_len, aad_len = len(plaintexts[0]), len(aads[0])
    if backend == "fused":
        bodies, tags = _run_fused(key, ivs, plaintexts, aads, pt_len,
                                  aad_len, open_mode=False,
                                  fixed_latency=fixed_latency, device=device)
        return [c + t for c, t in zip(bodies, tags)]
    out = []
    for iv, pt, aad in zip(ivs, plaintexts, aads):
        c, t = _seal_chained_core(key, iv, pt, aad, open_mode=False,
                                  backend=backend, device=device)
        out.append(c + t)
    return out


def aes128_gcm_open_batch(key: bytes, ivs: Sequence[bytes],
                          ciphertexts: Sequence[bytes],
                          aads: Optional[Sequence[bytes]] = None, *,
                          backend: str = "fused",
                          fixed_latency: bool = False,
                          device=None) -> List[bytes]:
    """Open B sealed records (``ciphertext || tag`` each); raises
    ``InvalidTagError`` (with the failing indices) unless every tag
    verifies — no plaintext escapes a failed batch."""
    aads = _check_batch(ivs, ciphertexts, aads)
    if any(len(c) < TAG_BYTES for c in ciphertexts):
        raise ValueError("sealed record shorter than the 16-byte tag")
    bodies_in = [c[:-TAG_BYTES] for c in ciphertexts]
    tags_in = [c[-TAG_BYTES:] for c in ciphertexts]
    pt_len, aad_len = len(bodies_in[0]), len(aads[0])
    if backend == "fused":
        bodies, tags = _run_fused(key, ivs, bodies_in, aads, pt_len,
                                  aad_len, open_mode=True,
                                  fixed_latency=fixed_latency, device=device)
    else:
        bodies, tags = [], []
        for iv, ct, aad in zip(ivs, bodies_in, aads):
            b_, t_ = _seal_chained_core(key, iv, ct, aad, open_mode=True,
                                        backend=backend, device=device)
            bodies.append(b_)
            tags.append(t_)
    bad = [i for i, (got, want) in enumerate(zip(tags, tags_in))
           if not hmac.compare_digest(got, want)]
    if bad:
        raise InvalidTagError(bad)
    return bodies


def aes128_gcm_seal(key: bytes, iv: bytes, plaintext: bytes,
                    aad: bytes = b"", *, backend: str = "fused",
                    fixed_latency: bool = False, device=None) -> bytes:
    """Seal one record: returns ``ciphertext || 16-byte tag``."""
    return aes128_gcm_seal_batch(key, [iv], [plaintext], [aad],
                                 backend=backend,
                                 fixed_latency=fixed_latency,
                                 device=device)[0]


def aes128_gcm_open(key: bytes, iv: bytes, sealed: bytes,
                    aad: bytes = b"", *, backend: str = "fused",
                    fixed_latency: bool = False, device=None) -> bytes:
    """Open one sealed record; raises ``InvalidTagError`` on a bad tag."""
    return aes128_gcm_open_batch(key, [iv], [sealed], [aad],
                                 backend=backend,
                                 fixed_latency=fixed_latency,
                                 device=device)[0]


# The lift cache backs every GHASH bit lift the matmul backends run; its
# occupancy is a lazy gauge (no hot-path counter).
_obs.metrics.gauge_fn("ghash_lift_cache",
                      lambda: xb.lift_cache_info()["size"])
