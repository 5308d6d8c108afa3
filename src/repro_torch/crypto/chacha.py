"""ChaCha20 block function with crossbar-executed diagonal rounds.

Port of ``repro.crypto.chacha``.  The SIMD formulation alternates column
quarter-rounds with a diagonalisation of the 4x4 word matrix (row r
rotates left by r) and its inverse; the rotations are ONE block-diagonal
plan (``block_diag`` of per-row rotations) and its transpose, so a
double round costs exactly two crossbar passes — 20 a block call,
asserted under the fixed-latency contract.  Counter blocks batch as a
block-diagonal (B*16)-word plan (``batch_mode="block_diag"``) or as
payload width of the single-block plan (``"payload"``).

Words are held as their int32 bit patterns (torch's uint32 has no add or
shift); the quarter-round's wrapping adds and rotates run on int64
carriers masked to 32 bits.  The crossbar passes route int32 patterns:
the einsum backend's integer path is exact at any magnitude, while the
'kernel' and 'sparse' backends route through float32 and refuse words
of 2^24 and more, as the reference does.

``backend="megakernel"`` runs the whole block function as one plan
program (``core.plan_program``): a 42-step double round — the
quarter-round's adds, xors and word rotates as ADD/XOR/ROTLV steps, its
operand alignment and the (un)diagonalisation as routing plans — run 10
times in ONE launch, B counter blocks as payload width.  The program is
not bit-sliceable, so it takes the megakernel's word layout.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.core import crossbar as xb
from repro_torch.core import plan_algebra as pa
from repro_torch.core import plan_program as pp
from repro_torch.crypto.registry import registry

_WORDS = 16
_CONSTANTS = np.frombuffer(b"expand 32-byte k", dtype="<u4")
_DOUBLE_ROUNDS = 10
PASSES_PER_BLOCK = 2 * _DOUBLE_ROUNDS
_MASK32 = 0xFFFFFFFF


def _rotate_row_plan(r: int, device) -> xb.PermutePlan:
    """Rotate a 4-word row left by r: out[j] = in[(j + r) % 4]."""
    return xb.gather_plan(torch.as_tensor((np.arange(4) + r) % 4,
                                          dtype=torch.int32, device=device),
                          4)


def diag_plan(device=None) -> xb.PermutePlan:
    dev = resolve(device)
    return registry(dev).get_or_register(
        "chacha/diag",
        lambda: pa.block_diag([_rotate_row_plan(r, dev) for r in range(4)]))


def undiag_plan(device=None) -> xb.PermutePlan:
    dev = resolve(device)
    return registry(dev).get_or_register(
        "chacha/undiag", lambda: pa.transpose(diag_plan(dev)))


# ---------------------------------------------------------------------------
# The megakernel program: 10 double rounds as one schedule
# ---------------------------------------------------------------------------

MEGAKERNEL_PROGRAM_KEY = "chacha/block_program"

# Quarter-round operand alignment as routing plans: ``x op= y`` over the
# four vectorised lanes gathers y's rows onto x's rows (DROP elsewhere,
# contributing the operand identity), then one elementwise step.  Row
# blocks: a=0..3, b=4..7, c=8..11, d=12..15.
_QR_MAPS = {
    "qr_b_to_a": (0, 4),     # a += b : rows 0..3  <- rows 4..7
    "qr_a_to_d": (12, 0),    # d ^= a : rows 12..15 <- rows 0..3
    "qr_d_to_c": (8, 12),    # c += d : rows 8..11 <- rows 12..15
    "qr_c_to_b": (4, 8),     # b ^= c : rows 4..7  <- rows 8..11
}


def _qr_map_plan(key: str, device=None) -> xb.PermutePlan:
    dev = resolve(device)
    dst0, src0 = _QR_MAPS[key]

    def build():
        src = np.full(_WORDS, pa.DROP, np.int32)
        src[dst0:dst0 + 4] = np.arange(src0, src0 + 4)
        return xb.gather_plan(torch.as_tensor(src, device=dev), _WORDS)

    return registry(dev).get_or_register(f"chacha/{key}", build)


def _rot_amounts(rows: range, amount: int) -> np.ndarray:
    amt = np.zeros(_WORDS, np.int32)
    amt[list(rows)] = amount
    return amt


def _build_megakernel_program(dev) -> pp.PlanProgram:
    """The ChaCha20 rounds as a 42-step double round x 10 trips.

    Each ``x op= y; x <<<= r`` is a routing gather (operand alignment),
    the elementwise ADD/XOR, and a per-row ROTLV whose amount row is
    non-zero only on x's rows (every other row rotates by 0).
    """
    b = pp.ProgramBuilder("chacha20_block", _WORDS, n_regs=2)
    b2a = _qr_map_plan("qr_b_to_a", dev)
    a2d = _qr_map_plan("qr_a_to_d", dev)
    d2c = _qr_map_plan("qr_d_to_c", dev)
    c2b = _qr_map_plan("qr_c_to_b", dev)
    d_rows, b_rows = range(12, 16), range(4, 8)

    def column_round():
        for rot_d, rot_b in ((16, 12), (8, 7)):
            b.permute(1, 0, b2a)
            b.add(0, 0, 1)                             # a += b
            b.permute(1, 0, a2d)
            b.xor(0, 0, 1)                             # d ^= a
            b.rotlv(0, 0, _rot_amounts(d_rows, rot_d))
            b.permute(1, 0, d2c)
            b.add(0, 0, 1)                             # c += d
            b.permute(1, 0, c2b)
            b.xor(0, 0, 1)                             # b ^= c
            b.rotlv(0, 0, _rot_amounts(b_rows, rot_b))

    column_round()
    b.permute(0, 0, diag_plan(dev))
    column_round()
    b.permute(0, 0, undiag_plan(dev))
    return b.build(rounds=_DOUBLE_ROUNDS)


def megakernel_program(device=None) -> pp.PlanProgram:
    dev = resolve(device)
    return registry(dev).get_or_register_program(
        MEGAKERNEL_PROGRAM_KEY, lambda: _build_megakernel_program(dev))


# ---------------------------------------------------------------------------
# 32-bit word arithmetic
# ---------------------------------------------------------------------------

def _u32(v: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 carriers of their uint32 values."""
    return v.to(torch.int64) & _MASK32


def _i32(v: torch.Tensor) -> torch.Tensor:
    """int64 carriers -> the int32 bit patterns of their low 32 bits."""
    return ((((v & _MASK32) + (1 << 31)) & _MASK32) - (1 << 31)).to(
        torch.int32)


def _add32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Wrapping 32-bit add of two int32 bit-pattern tensors."""
    return _i32(_u32(a) + _u32(b))


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) | (x >> (32 - n))) & _MASK32


def _column_round(v: torch.Tensor) -> torch.Tensor:
    """One quarter-round over all four columns.  v: (B, 16) int64
    carriers of uint32 words."""
    a, b, c, d = v[:, 0:4], v[:, 4:8], v[:, 8:12], v[:, 12:16]
    a = (a + b) & _MASK32
    d = _rotl(d ^ a, 16)
    c = (c + d) & _MASK32
    b = _rotl(b ^ c, 12)
    a = (a + b) & _MASK32
    d = _rotl(d ^ a, 8)
    c = (c + d) & _MASK32
    b = _rotl(b ^ c, 7)
    return torch.cat([a, b, c, d], dim=1)


def _setup_states(key: bytes, counter: int, nonce: bytes,
                  n_blocks: int) -> np.ndarray:
    """(n_blocks, 16) uint32 RFC 8439 input states."""
    if len(key) != 32:
        raise ValueError("chacha20 key must be 32 bytes")
    if len(nonce) != 12:
        raise ValueError("chacha20 nonce must be 12 bytes (RFC 8439)")
    base = np.concatenate([
        _CONSTANTS,
        np.frombuffer(key, dtype="<u4"),
        np.zeros(1, np.uint32),
        np.frombuffer(nonce, dtype="<u4"),
    ])
    states = np.tile(base, (n_blocks, 1))
    states[:, 12] = (counter + np.arange(n_blocks)) & _MASK32
    return states


def _chacha_core(states: torch.Tensor, *, backend: str, batch_mode: str,
                 fixed_latency: bool) -> torch.Tensor:
    """20 rounds + feed-forward on (B, 16) int32 bit-pattern states."""
    dev = states.device
    reg = registry(dev)
    b = states.shape[0]

    if backend == "megakernel":
        # The whole block function as ONE program launch: B counter blocks
        # ride as payload width of the (16, B) word matrix; the
        # feed-forward is the only arithmetic outside the kernel.
        program = megakernel_program(dev)

        def run_fused() -> torch.Tensor:
            words = states.T.contiguous().view(torch.uint32)
            out = pp.run_program(program, words, backend="megakernel")
            return _add32(out.view(torch.int32).T, states)

        if not fixed_latency:
            return run_fused()
        with reg.observe(
                ("chacha20", "megakernel"),
                shapes=(tuple(states.shape), str(states.dtype)),
                backend=backend, program_keys=(MEGAKERNEL_PROGRAM_KEY,),
                expect_apply_calls=0, expect_program_launches=1):
            out = run_fused()
        return out

    use_block_diag = batch_mode == "block_diag" and b > 1
    diag_plan(dev), undiag_plan(dev)  # register the base plans
    width = b if use_block_diag else 1
    p_diag, k_diag = reg.batch_variant("chacha/diag", width)
    p_undiag, k_undiag = reg.batch_variant("chacha/undiag", width)

    def permute(v: torch.Tensor, plan: xb.PermutePlan) -> torch.Tensor:
        as_i32 = _i32(v)
        if use_block_diag:
            out = xb.apply_plan(plan, as_i32.reshape(b * _WORDS),
                                backend=backend).reshape(b, _WORDS)
        else:
            out = xb.apply_plan(plan, as_i32.T, backend=backend).T
        return _u32(out)

    def run() -> torch.Tensor:
        v = _u32(states)
        for _ in range(_DOUBLE_ROUNDS):
            v = _column_round(v)
            v = permute(v, p_diag)
            v = _column_round(v)
            v = permute(v, p_undiag)
        return _add32(_i32(v), states)

    if not fixed_latency:
        return run()
    with reg.observe(
            ("chacha20", batch_mode),
            shapes=(tuple(states.shape), str(states.dtype)),
            backend=backend, plan_keys=(k_diag, k_undiag),
            expect_apply_calls=PASSES_PER_BLOCK):
        out = run()
    return out


def chacha20_block(key: bytes, counter: int, nonce: bytes, *,
                   backend: str = "einsum", fixed_latency: bool = False,
                   device=None) -> bytes:
    """One 64-byte keystream block (RFC 8439 state layout)."""
    return chacha20_blocks(key, counter, nonce, 1, backend=backend,
                           fixed_latency=fixed_latency, device=device)


def chacha20_blocks(key: bytes, counter: int, nonce: bytes, n_blocks: int,
                    *, backend: str = "einsum",
                    batch_mode: str = "block_diag",
                    fixed_latency: bool = False, device=None) -> bytes:
    """``n_blocks`` consecutive keystream blocks as one batched core call
    on ``device`` (None: the card).  backend: a crossbar backend for the
    per-round path, or 'megakernel' (one program launch)."""
    if batch_mode not in ("block_diag", "payload"):
        raise ValueError(f"unknown batch_mode {batch_mode!r}")
    host = _setup_states(key, counter, nonce, n_blocks).view(np.int32)
    states = torch.as_tensor(host, device=resolve(device))
    out = _chacha_core(states, backend=backend, batch_mode=batch_mode,
                       fixed_latency=fixed_latency)
    return out.cpu().numpy().astype("<i4").tobytes()


def chacha20_encrypt(key: bytes, counter: int, nonce: bytes,
                     plaintext: bytes, *, backend: str = "einsum",
                     batch_mode: str = "block_diag",
                     fixed_latency: bool = False, device=None) -> bytes:
    """XOR-encrypt/decrypt ``plaintext`` with the ChaCha20 keystream."""
    n_blocks = -(-len(plaintext) // 64) or 1
    stream = chacha20_blocks(key, counter, nonce, n_blocks, backend=backend,
                             batch_mode=batch_mode,
                             fixed_latency=fixed_latency, device=device)
    data = np.frombuffer(plaintext, np.uint8)
    ks = np.frombuffer(stream, np.uint8)[:len(data)]
    return (data ^ ks).tobytes()
