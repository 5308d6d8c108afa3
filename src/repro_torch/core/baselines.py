"""The paper's BASELINE vector processor: separate permutation datapaths.

Port of ``repro.core.baselines``.  The paper compares its unified unit
against a baseline that executes (Sec. IV):
  (a) ``vrgather``  — the same crossbar logic (Fig. 2);
  (b) ``vslide``    — a *separate* logarithmic shifter at byte level;
  (c) ``vcompress`` — a *sequential* datapath moving ONE element with an
      asserted mask bit per cycle (multi-cycle, like Saturn [19]).

Same observable semantics as the unified ops, the baseline *structure*:

  * the log-shifter is staged power-of-two selects (log2(N) mux stages);
  * the sequential compress is a fixed-trip Python loop carrying a write
    cursor — one element per step, so its latency is proportional to N
    (on the card, a few small launches a step): the property the unified
    design removes, kept on purpose because it is what is measured;
  * gather reuses the crossbar (the einsum backend);
  * the MoE dispatch baseline sorts tokens by (expert, arrival).

Differential tests assert unified == baseline on all inputs.
"""

from __future__ import annotations

import torch

from repro_torch.core import crossbar as xb


def gather_baseline(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(a) Baseline vrgather: same crossbar structure as the unified unit."""
    plan = xb.vrgather_plan(idx.to(torch.int32), x.shape[0])
    return xb.apply_plan(plan, x, backend="einsum")


def _log_shift_stage(x, amount: int, bit, *, up: bool):
    """One mux stage of the logarithmic shifter: shift by ``amount`` iff
    bit."""
    if not amount:
        return x
    pad = torch.zeros_like(x[:amount])
    shifted = (torch.cat([pad, x[:-amount]], dim=0) if up
               else torch.cat([x[amount:], pad], dim=0))
    return torch.where(bit, shifted, x)


def slide_baseline(x: torch.Tensor, offset, *, up: bool) -> torch.Tensor:
    """(b) Baseline vslide: logarithmic shifter (log2 N stages of muxes).

    Stage s shifts by 2**s iff bit s of the offset is set.  ``offset``:
    an int or a 0-d integer tensor; offsets >= n clear the register.
    """
    n = x.shape[0]
    off = torch.as_tensor(offset, dtype=torch.int32, device=x.device)
    out = x
    s = 0
    while (1 << s) < n:
        bit = ((off >> s) & 1).to(torch.bool)
        out = _log_shift_stage(out, 1 << s, bit, up=up)
        s += 1
    return torch.where(off >= n, torch.zeros_like(out), out)


def compress_baseline_sequential(x: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
    """(c) Baseline vcompress: one element per cycle (multi-cycle datapath).

    N steps over the input elements carrying (output_register,
    write_cursor): each step adds the element times its mask bit into
    the cursor's one-hot row and advances the cursor by the bit.  The
    trip count is fixed (N); the number of useful steps depends on the
    mask.
    """
    n = x.shape[0]
    x2 = x.reshape(n, -1)
    m = mask.to(torch.int32)
    iota = torch.arange(n, dtype=torch.int32, device=x.device)
    out = torch.zeros_like(x2)
    cursor = torch.zeros((), dtype=torch.int32, device=x.device)
    for i in range(n):
        row = (iota == cursor).to(x2.dtype)[:, None]          # (n, 1)
        out = out + row * x2[i][None, :] * m[i].to(x2.dtype)
        cursor = cursor + m[i]
    return out.reshape(x.shape)


def moe_dispatch_argsort_baseline(x: torch.Tensor, expert_ids: torch.Tensor,
                                  num_experts: int,
                                  capacity: int) -> torch.Tensor:
    """Sort-based MoE dispatch baseline (the ragged/argsort lineage).

    Tokens are argsorted by (expert, arrival) and accumulated into
    (E, C, D) buffers — equal to the unified crossbar dispatch for top-1
    routing, but built on a data-dependent sort instead of a fixed
    crossbar.  Ids must lie in [0, E).
    """
    t, d = x.shape
    e1 = expert_ids[:, 0].to(torch.int64)     # top-1 only for the baseline
    arrival = torch.arange(t, dtype=torch.int64, device=x.device)
    order = torch.argsort(e1 * t + arrival, stable=True)
    sorted_ids = e1[order]
    experts = torch.arange(num_experts, dtype=torch.int64, device=x.device)
    onehot = (sorted_ids[:, None] == experts).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) - onehot    # position in its group
    pos = torch.sum(pos * onehot, dim=-1)
    keep = pos < capacity
    buf = torch.zeros((num_experts, capacity, d), dtype=x.dtype,
                      device=x.device)
    vals = torch.where(keep[:, None], x[order], torch.zeros_like(x))
    buf.index_put_((sorted_ids, pos.clamp(0, capacity - 1).to(torch.int64)),
                   vals, accumulate=True)
    return buf
