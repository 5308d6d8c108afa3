"""Keccak-f[1600] and the SHA-3 / SHAKE sponges on the crossbar engine.

Port of ``repro.crypto.keccak``.  The state is carried at bit
granularity: 1600 rows of 0/1 int32 in FIPS 202 order (``A[x, y, z] =
S[64*(5y + x) + z]``).  Per round, ρ∘π is ONE composed gather plan and
therefore one ``apply_plan`` pass; θ/χ/ι are branch-free XOR/AND
between passes.  ``batch_mode="block_diag"`` puts B states on one
(B*1600)-row block-diagonal plan (tile occupancy 1/B, the sparse
kernel's regime); ``"payload"`` carries B as the payload width.

``backend="megakernel"`` runs the whole permutation as ONE plan-program
launch: per round the θ∘ρ∘π linear layer as a single k=11 GF(2) plan,
χ's two lane shifts as gathers, the not-and, and ι — 24 rounds, zero
``apply_plan`` passes, B lanes as payload width.

Rotation offsets and round constants are generated from the FIPS 202
recurrences.  Plans live in the per-device crypto registry.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch._device import place, resolve
from repro_torch.core import crossbar as xb
from repro_torch.core import plan_algebra as pa
from repro_torch.core import plan_program as pp
from repro_torch.core.semiring import GF2
from repro_torch.crypto.registry import registry
from repro_torch.dist.annotate import annotate

KECCAK_ROUNDS = 24
STATE_BITS = 1600
_LANE = 64


def _flat(x: int, y: int, z: int) -> int:
    """FIPS 202 state-bit index: A[x, y, z] = S[64*(5y + x) + z]."""
    return _LANE * (5 * y + x) + z


@functools.lru_cache(maxsize=None)
def rho_offsets() -> tuple:
    """The 25 ρ rotation offsets from the (t+1)(t+2)/2 walk, ``[x][y]``."""
    r = np.zeros((5, 5), np.int64)
    x, y = 1, 0
    for t in range(24):
        r[x, y] = ((t + 1) * (t + 2) // 2) % _LANE
        x, y = y, (2 * x + 3 * y) % 5
    return tuple(tuple(int(v) for v in row) for row in r)


@functools.lru_cache(maxsize=None)
def round_constants() -> tuple:
    """The 24 ι round constants as 64-bit ints, from the FIPS 202 LFSR."""
    out = []
    lfsr = 1
    for _ in range(KECCAK_ROUNDS):
        rc = 0
        for j in range(7):
            lfsr = ((lfsr << 1) ^ ((lfsr >> 7) * 0x71)) % 256
            if lfsr & 2:
                rc |= 1 << ((1 << j) - 1)
        out.append(rc)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _iota_bits() -> np.ndarray:
    """(24, 1600) int32 — each round constant as a full-state bit mask."""
    bits = np.zeros((KECCAK_ROUNDS, STATE_BITS), np.int32)
    for rnd, rc in enumerate(round_constants()):
        for z in range(_LANE):
            if (rc >> z) & 1:
                bits[rnd, _flat(0, 0, z)] = 1
    return bits


def _rho_src() -> np.ndarray:
    """ρ gather sources: out bit (x, y, z) <- in bit (x, y, z - r)."""
    r = rho_offsets()
    src = np.zeros(STATE_BITS, np.int32)
    for x in range(5):
        for y in range(5):
            for z in range(_LANE):
                src[_flat(x, y, z)] = _flat(x, y, (z - r[x][y]) % _LANE)
    return src


def _pi_src() -> np.ndarray:
    """π gather sources: out lane (x', y') <- in lane (x'+3y', x')."""
    src = np.zeros(STATE_BITS, np.int32)
    for xp in range(5):
        for yp in range(5):
            x, y = (xp + 3 * yp) % 5, xp
            for z in range(_LANE):
                src[_flat(xp, yp, z)] = _flat(x, y, z)
    return src


def _theta_src() -> np.ndarray:
    """θ as a k=11 GF(2) crossbar: every output bit XORs 11 input bits."""
    src = np.zeros((STATE_BITS, 11), np.int32)
    for x in range(5):
        for y in range(5):
            for z in range(_LANE):
                o = _flat(x, y, z)
                src[o, 0] = o
                for yp in range(5):
                    src[o, 1 + yp] = _flat((x - 1) % 5, yp, z)
                    src[o, 6 + yp] = _flat((x + 1) % 5, yp,
                                           (z - 1) % _LANE)
    return src


def _chi_shift_src(shift: int) -> np.ndarray:
    """χ lane shift: out (x,y,z) <- (x+shift,y,z)."""
    src = np.zeros(STATE_BITS, np.int32)
    for x in range(5):
        for y in range(5):
            for z in range(_LANE):
                src[_flat(x, y, z)] = _flat((x + shift) % 5, y, z)
    return src


def _gather(src: np.ndarray, device, semiring=None) -> xb.PermutePlan:
    kw = {} if semiring is None else {"semiring": semiring}
    return xb.gather_plan(torch.as_tensor(src, device=device), STATE_BITS,
                          **kw)


def rho_plan(device=None) -> xb.PermutePlan:
    dev = resolve(device)
    return registry(dev).get_or_register(
        "keccak/rho", lambda: _gather(_rho_src(), dev))


def pi_plan(device=None) -> xb.PermutePlan:
    dev = resolve(device)
    return registry(dev).get_or_register(
        "keccak/pi", lambda: _gather(_pi_src(), dev))


def rho_pi_plan(device=None) -> xb.PermutePlan:
    """ρ∘π as ONE plan: the algebra's compose, not a hand-built table."""
    dev = resolve(device)
    return registry(dev).get_or_register(
        "keccak/rho_pi", lambda: pa.compose(pi_plan(dev), rho_plan(dev)))


def theta_plan(device=None) -> xb.PermutePlan:
    dev = resolve(device)
    return registry(dev).get_or_register(
        "keccak/theta", lambda: _gather(_theta_src(), dev, GF2))


def theta_rho_pi_plan(device=None) -> xb.PermutePlan:
    """θ→ρ→π as ONE composed k=11 GF(2) plan."""
    dev = resolve(device)
    return registry(dev).get_or_register(
        "keccak/theta_rho_pi",
        lambda: pa.compose(rho_pi_plan(dev), theta_plan(dev)))


def chi_shift_plan(shift: int, device=None) -> xb.PermutePlan:
    dev = resolve(device)
    return registry(dev).get_or_register(
        f"keccak/chi_shift{shift}",
        lambda: _gather(_chi_shift_src(shift), dev))


MEGAKERNEL_PROGRAM_KEY = "keccak/f1600_program"


def _build_megakernel_program(dev) -> pp.PlanProgram:
    """6 steps a round x 24 trips: θρπ (k=11 GF(2)), two χ shifts,
    χ's not-and + XOR, ι (const_stride=1 walks the 24 ι rows)."""
    b = pp.ProgramBuilder("keccak_f1600", STATE_BITS, n_regs=3)
    linear = theta_rho_pi_plan(dev)
    shift1, shift2 = chi_shift_plan(1, dev), chi_shift_plan(2, dev)
    iota_base = b.add_const_rows(_iota_bits())
    b.permute(0, 0, linear)               # r0 = θρπ(r0)
    b.permute(1, 0, shift1)               # r1 = A[x+1, y, z]
    b.permute(2, 0, shift2)               # r2 = A[x+2, y, z]
    b.andn(1, 1, 2)                       # r1 = ~A[x+1] & A[x+2]
    b.xor(0, 0, 1)                        # χ
    b.xor_const_at(0, 0, iota_base)       # ι (row iota_base + round)
    return b.build(rounds=KECCAK_ROUNDS, const_stride=1)


def megakernel_program(device=None) -> pp.PlanProgram:
    dev = resolve(device)
    return registry(dev).get_or_register_program(
        MEGAKERNEL_PROGRAM_KEY, lambda: _build_megakernel_program(dev))


# ---------------------------------------------------------------------------
# θ, χ on (B, 5, 5, 64) bit tensors [b, y, x, z]
# ---------------------------------------------------------------------------

def _theta(a: torch.Tensor) -> torch.Tensor:
    c = a[:, 0] ^ a[:, 1] ^ a[:, 2] ^ a[:, 3] ^ a[:, 4]      # (B, x, z)
    d = torch.roll(c, 1, dims=1) ^ torch.roll(
        torch.roll(c, -1, dims=1), 1, dims=2)               # C[x-1]^rot(C[x+1])
    return a ^ d[:, None, :, :]


def _chi(a: torch.Tensor) -> torch.Tensor:
    a1 = torch.roll(a, -1, dims=2)                          # A[x+1, y]
    a2 = torch.roll(a, -2, dims=2)                          # A[x+2, y]
    return a ^ ((a1 ^ 1) & a2)


def keccak_f1600(bits, *, backend: str = "einsum", fuse_rho_pi: bool = True,
                 batch_mode: str = "block_diag", fixed_latency: bool = False,
                 device=None) -> torch.Tensor:
    """Apply Keccak-f[1600] to one (1600,) or B (B, 1600) 0/1 int32 states.

    A tensor runs where it lies; a numpy state goes to ``device`` (None:
    the card).  backend: a crossbar backend for the per-round path, or
    'megakernel' (one program launch for all 24 rounds).  fuse_rho_pi:
    one pass a round (ρ∘π) or two (ρ, π).  batch_mode: 'block_diag' or
    'payload'.  fixed_latency: observe the call under the registry's
    contract — 24 (fused) / 48 passes, or for the megakernel exactly one
    launch and zero passes, fingerprints invariant across calls.
    """
    if batch_mode not in ("block_diag", "payload"):
        raise ValueError(f"unknown batch_mode {batch_mode!r}")
    bits = place(bits, device)
    dev = bits.device
    reg = registry(dev)
    single = bits.dim() == 1
    if bits.shape[-1] != STATE_BITS:
        raise ValueError(f"keccak state must have {STATE_BITS} bits, got "
                         f"shape {tuple(bits.shape)}")
    b = 1 if single else bits.shape[0]

    if backend == "megakernel":
        program = megakernel_program(dev)
        flat = bits.reshape(b, STATE_BITS).T           # (1600, B) lanes

        def run_fused() -> torch.Tensor:
            out = pp.run_program(program, flat, backend="megakernel")
            return out.T.reshape(bits.shape)

        if not fixed_latency:
            return run_fused()
        with reg.observe(
                ("keccak_f1600", "megakernel"),
                shapes=(tuple(bits.shape), str(bits.dtype)),
                backend=backend, program_keys=(MEGAKERNEL_PROGRAM_KEY,),
                expect_apply_calls=0, expect_program_launches=1):
            out = run_fused()
        return out

    if fuse_rho_pi:
        builders = (("keccak/rho_pi", rho_pi_plan),)
    else:
        builders = (("keccak/rho", rho_plan), ("keccak/pi", pi_plan))
    use_block_diag = (not single) and batch_mode == "block_diag" and b > 1
    plans, plan_keys = [], []
    for key, build in builders:
        build(dev)
        plan, variant_key = reg.batch_variant(key, b if use_block_diag
                                              else 1)
        plans.append(plan)
        plan_keys.append(variant_key)
    plan_keys = tuple(plan_keys)

    iota = torch.as_tensor(_iota_bits(), device=dev).to(bits.dtype).reshape(
        KECCAK_ROUNDS, 5, 5, _LANE)

    def linear(a4: torch.Tensor) -> torch.Tensor:
        if use_block_diag:
            flat = a4.reshape(b * STATE_BITS)
            for p in plans:
                flat = xb.apply_plan(p, flat, backend=backend)
            return flat.reshape(b, 5, 5, _LANE)
        flat = a4.reshape(b, STATE_BITS).T             # (1600, B) lanes
        for p in plans:
            flat = xb.apply_plan(p, flat, backend=backend)
        return flat.T.reshape(b, 5, 5, _LANE)

    def run() -> torch.Tensor:
        a = bits.reshape(b, 5, 5, _LANE)
        for rnd in range(KECCAK_ROUNDS):
            a = _theta(a)
            a = linear(a)
            a = _chi(a)
            a = a ^ iota[rnd]
        return a.reshape(bits.shape)

    if not fixed_latency:
        return run()
    with reg.observe(
            ("keccak_f1600", fuse_rho_pi, batch_mode),
            shapes=(tuple(bits.shape), str(bits.dtype)),
            backend=backend, plan_keys=plan_keys,
            expect_apply_calls=KECCAK_ROUNDS * len(plans)):
        out = run()
    return out


# ---------------------------------------------------------------------------
# Sponges (SHA-3 fixed-output and SHAKE XOFs)
# ---------------------------------------------------------------------------

def _pad101(data: bytes, rate_bytes: int, domain: int) -> np.ndarray:
    """Multi-rate padding -> (n_blocks, rate_bytes*8) bit blocks."""
    msg = bytearray(data)
    msg.append(domain)
    msg.extend(b"\x00" * (-len(msg) % rate_bytes))
    msg[-1] ^= 0x80
    bits = np.unpackbits(np.frombuffer(bytes(msg), np.uint8),
                         bitorder="little")
    return bits.reshape(-1, rate_bytes * 8).astype(np.int32)


def _squeeze(state_bits: np.ndarray, rate_bytes: int) -> bytes:
    return np.packbits(state_bits[:rate_bytes * 8].astype(np.uint8),
                       bitorder="little").tobytes()


def _sponge(data: bytes, *, rate_bytes: int, out_bytes: int, domain: int,
            backend: str, fixed_latency: bool, device) -> bytes:
    dev = resolve(device)
    blocks = _pad101(data, rate_bytes, domain)
    state = torch.zeros((STATE_BITS,), dtype=torch.int32, device=dev)
    pad_tail = np.zeros(STATE_BITS - rate_bytes * 8, np.int32)
    for blk in blocks:
        state = state ^ torch.as_tensor(np.concatenate([blk, pad_tail]),
                                        device=dev)
        state = keccak_f1600(state, backend=backend,
                             fixed_latency=fixed_latency)
    out = bytearray()
    while True:
        out += _squeeze(state.cpu().numpy(), rate_bytes)
        if len(out) >= out_bytes:
            return bytes(out[:out_bytes])
        state = keccak_f1600(state, backend=backend,
                             fixed_latency=fixed_latency)


def sha3_256(data: bytes, *, backend: str = "einsum",
             fixed_latency: bool = False, device=None) -> bytes:
    return _sponge(data, rate_bytes=136, out_bytes=32, domain=0x06,
                   backend=backend, fixed_latency=fixed_latency,
                   device=device)


def sha3_512(data: bytes, *, backend: str = "einsum",
             fixed_latency: bool = False, device=None) -> bytes:
    return _sponge(data, rate_bytes=72, out_bytes=64, domain=0x06,
                   backend=backend, fixed_latency=fixed_latency,
                   device=device)


def shake_128(data: bytes, out_bytes: int, *, backend: str = "einsum",
              fixed_latency: bool = False, device=None) -> bytes:
    return _sponge(data, rate_bytes=168, out_bytes=out_bytes, domain=0x1F,
                   backend=backend, fixed_latency=fixed_latency,
                   device=device)


def shake_256(data: bytes, out_bytes: int, *, backend: str = "einsum",
              fixed_latency: bool = False, device=None) -> bytes:
    return _sponge(data, rate_bytes=136, out_bytes=out_bytes, domain=0x1F,
                   backend=backend, fixed_latency=fixed_latency,
                   device=device)


def sha3_256_batched(messages, *, backend: str = "einsum",
                     batch_mode: str = "block_diag",
                     fixed_latency: bool = False, device=None) -> list:
    """SHA3-256 of B equal-length messages as ONE batched sponge: all B
    lanes advance through each permutation together (one block-diagonal
    pass a round, or B payload lanes of one megakernel launch).

    The lanes are independent sponges: the states carry the "batch"
    logical-axis annotation (``dist.annotate``), and the column-sharded
    program executor (``dist.mesh_exec.run_program_sharded``) runs such
    lanes over a mesh with nothing moving between shards."""
    rate_bytes = 136
    msgs = list(messages)
    if not msgs:
        return []
    if len({len(m) for m in msgs}) != 1:
        raise ValueError("sha3_256_batched needs equal-length messages "
                         "(schedule-aligned sponge lanes)")
    dev = resolve(device)
    blocks = np.stack([_pad101(m, rate_bytes, 0x06) for m in msgs])
    b, n_blocks = blocks.shape[:2]
    pad_tail = np.zeros((b, STATE_BITS - rate_bytes * 8), np.int32)
    states = annotate(torch.zeros((b, STATE_BITS), dtype=torch.int32,
                                  device=dev), "batch")
    for i in range(n_blocks):
        full = np.concatenate([blocks[:, i], pad_tail], axis=1)
        states = states ^ torch.as_tensor(full, device=dev)
        states = annotate(keccak_f1600(states, backend=backend,
                                       batch_mode=batch_mode,
                                       fixed_latency=fixed_latency),
                          "batch")
    host = states.cpu().numpy()
    return [_squeeze(host[i], rate_bytes)[:32] for i in range(b)]
