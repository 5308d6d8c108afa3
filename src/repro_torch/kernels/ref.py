"""Plain PyTorch versions of the CUDA kernels.

Each function computes what its kernel computes, on the same operands,
with the same arithmetic: the crossbar in float32 with rounded
multiply-then-add in the kernel's summation order (select order; a
scatter through its inversion, ``invert_scatter``, in (input row,
select) order), bf16 payloads against bf16-rounded weights, merge by
coverage and the GF(2) parity fold; the sparse crossbar over the same
schedule, leaving unvisited output tiles unwritten; the plan-program
VM as a Python loop over rounds and steps in wrapping 32-bit
arithmetic, its packed layout bit-sliced on the kernel's tables and its
word layout's row walk on that layout's tables;
the MoE routing transform as a one-hot exclusive cumsum per group; the
fused vcompress as prefix sums and a row copy.  The kernel
wrappers use them for CPU tensors; the tests and ``chip_smoke.py`` hold
the kernels against them.
"""

from __future__ import annotations

import torch

from repro_torch.core import abstract as _abstract
from repro_torch.core import transform as _t

GATHER, SCATTER = "gather", "scatter"
_MASK32 = 0xFFFFFFFF


def _weights_as_compute(weights, x):
    """Float32 weights as the payload's compute dtype sees them."""
    if x.dtype == torch.bfloat16:
        return weights.to(torch.bfloat16).to(torch.float32)
    return weights.to(torch.float32)


def _fold2(r):
    return r - 2.0 * torch.floor(r * 0.5)


def invert_scatter(idx, n_in, n_out):
    """The scatter inversion: for each output row, the control entries
    ``e = i * K + j`` landing on it, as a CSR ``(row_ptr, ent)`` (int64),
    each row's segment in (i, j) order.  DROPs and out-of-range entries
    land nowhere; a row's segment length is its coverage.  The CUDA
    kernels build the same CSR on the device (a stable radix sort of the
    entries by output row).
    """
    dest = idx[:n_in].reshape(-1).long()
    valid = (dest >= 0) & (dest < n_out)
    ent = torch.nonzero(valid).reshape(-1)
    ent = ent[torch.argsort(dest[ent], stable=True)]
    counts = torch.bincount(dest[valid], minlength=n_out)[:n_out]
    row_ptr = torch.zeros(n_out + 1, dtype=torch.int64, device=idx.device)
    row_ptr[1:] = torch.cumsum(counts, 0)
    return row_ptr, ent


def _scatter_sum(idx, xf, w, n_out, *, inverted=None):
    """(acc, hits) of a scatter: float32 sums of its contributions in
    (input row, select) order, and hit counts.

    ``inverted`` sums through the inversion's segments, one segment
    position at a time (each step writes a row at most once, so the order
    holds on any device); otherwise one ``index_add_``, which adds in
    index order on the CPU (the same bits) and in no fixed order on CUDA.
    The default is the inversion on every device but the CPU.
    """
    n_in, d = xf.shape
    k = idx.shape[1]
    if inverted is None:
        inverted = xf.device.type != "cpu"
    acc = torch.zeros((n_out, d), dtype=torch.float32, device=xf.device)
    w_flat = None if w is None else w[:n_in].reshape(-1)
    if not inverted:
        dest = idx[:n_in].reshape(-1).long()
        e = torch.nonzero((dest >= 0) & (dest < n_out)).reshape(-1)
        vals = xf[e // k]
        if w_flat is not None:
            vals = w_flat[e][:, None] * vals
        acc.index_add_(0, dest[e], vals)
        return acc, torch.bincount(dest[e], minlength=n_out)
    row_ptr, ent = invert_scatter(idx, n_in, n_out)
    hits = row_ptr[1:] - row_ptr[:-1]
    # rows by descending in-degree: those with more than r entries are a
    # prefix, whose length for every r comes from one host read
    order = torch.argsort(hits, descending=True, stable=True)
    deeper = torch.bincount(hits, minlength=1).flip(0).cumsum(0).flip(0)
    for r, n_rows in enumerate(deeper[1:].tolist()):
        rows = order[:n_rows]
        e = ent[row_ptr[rows] + r]
        vals = xf[e // k]
        if w_flat is not None:
            vals = w_flat[e][:, None] * vals
        acc[rows] = acc[rows] + vals
    return acc, hits


def _contributions(idx, x, weights, mode, n_out):
    """(acc, hits): float32 sums in the kernel's order, and hit counts.

    Gather rows add their K selects in select order; scatter rows add
    their contributions in (input row, select) order (``_scatter_sum``).
    """
    n_in, d = x.shape
    k = idx.shape[1]
    xf = x.to(torch.float32)
    w = None if weights is None else _weights_as_compute(weights, x)
    if mode == GATHER:
        acc = torch.zeros((n_out, d), dtype=torch.float32, device=x.device)
        idx = idx[:n_out]
        valid = (idx >= 0) & (idx < n_in)
        hits = valid.sum(dim=1)
        for j in range(k):
            vals = xf[idx[:, j].clamp(0, max(n_in - 1, 0))]
            if w is not None:
                vals = w[:n_out, j:j + 1] * vals
            acc = acc + torch.where(valid[:, j:j + 1], vals,
                                    torch.zeros_like(vals))
        return acc, hits
    return _scatter_sum(idx, xf, w, n_out)


def crossbar_dense(idx, x, *, mode, n_out, weights=None, merge=None,
                   fold_mod2=False):
    """Plain dense crossbar: ``out = P @ x`` with merge and GF(2) fold.

    Same operands as ``crossbar_permute_cuda``; control rows past the
    plan (DROP padding) are ignored.
    """
    acc, hits = _contributions(idx, x, weights, mode, n_out)
    if fold_mod2:
        acc = _fold2(acc)
    if merge is not None:
        acc = torch.where(hits[:, None] > 0, acc, merge.to(torch.float32))
    return acc.to(x.dtype)


def schedule_runs(pair_o):
    """CSR form of an o-major schedule: (run_o, run_ptr) int32."""
    run_o, counts = torch.unique_consecutive(pair_o, return_counts=True)
    run_ptr = torch.zeros(run_o.shape[0] + 1, dtype=torch.int32,
                          device=pair_o.device)
    run_ptr[1:] = torch.cumsum(counts, 0)
    return run_o.to(torch.int32), run_ptr


def crossbar_sparse(run_o, run_ptr, pair_n, idx, x, *, mode, n_out, out,
                    weights=None, fold_mod2=False, block_o=128, block_n=128):
    """Plain tile-skipping crossbar over the same schedule.

    Every row of the run_o output tiles is written into ``out``, the
    rest of ``out`` is left as it was.  Every select of a compiled plan
    lies in one of its active pairs, so the pairs (run_ptr, pair_n) and
    block_n do not change the result and are not consulted.
    """
    acc, _ = _contributions(idx, x, weights, mode, n_out)
    if fold_mod2:
        acc = _fold2(acc)
    tiles = torch.zeros(-(-n_out // block_o), dtype=torch.bool,
                        device=x.device)
    tiles[run_o.long()] = True
    rows = torch.repeat_interleave(tiles, block_o)[:n_out]
    out.copy_(torch.where(rows[:, None], acc.to(out.dtype), out))
    return out


def _to_u32(t):
    """int32/uint32 tensor -> int64 holding the uint32 value."""
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    return t.to(torch.int64) & _MASK32


def _from_u32(v, dtype):
    bits = (((v + (1 << 31)) & _MASK32) - (1 << 31)).to(torch.int32)
    return bits.view(torch.uint32) if dtype == torch.uint32 else bits


def plan_program_vm(state, steps, plan_tbl, koff, kcnt, folds, w_flat, woff,
                    consts, *, n_regs, rounds=1, const_stride=0):
    """Plain VM: the megakernel's operands, a Python loop over rounds and
    steps, wrapping 32-bit arithmetic on int64 carriers (a PERMUTE sums
    its selects a chunk at a time: the sum mod 2^32 and the parity are
    those of the select-by-select loop)."""
    from repro_torch.kernels.plan_program_kernel import OPCODES

    n = state.shape[0]
    regs = [_to_u32(state)] + [torch.zeros_like(_to_u32(state))
                               for _ in range(n_regs - 1)]
    # The walk reads the program's static control (real under the audit's
    # fake mode, refused if it were derived from the payload).
    with _abstract.concrete(steps, koff, kcnt, folds, woff):
        rows = steps.tolist()
        koff_l, kcnt_l, folds_l, woff_l = (t.tolist() for t in
                                           (koff, kcnt, folds, woff))
    tbl = plan_tbl.to(torch.int64)
    # Selects are gathered a chunk at a time, the chunk's (c, n, D) int64
    # block held to 2^22 elements.
    chunk = max(1, min(32, (1 << 22) // max(1, n * state[0].numel())))
    wts = None if w_flat is None else _to_u32(w_flat)
    cst = _to_u32(consts)
    for rnd in range(rounds):
        for code, dst, a, b, p, c in rows:
            op = OPCODES[code]
            av = regs[a]
            if op == "permute":
                acc_add = torch.zeros_like(av)
                acc_xor = torch.zeros_like(av)
                for j0 in range(0, kcnt_l[p], chunk):
                    j1 = min(j0 + chunk, kcnt_l[p])
                    src = tbl[koff_l[p] + j0:koff_l[p] + j1]      # (c, n)
                    valid = ((src >= 0) & (src < n))[..., None]
                    g = av[src.clamp(0, n - 1)]                  # (c, n, D)
                    if woff_l[p] >= 0:
                        w = wts[woff_l[p] + j0:woff_l[p] + j1]
                        g = (g * w[..., None]) & _MASK32
                    g = torch.where(valid, g, torch.zeros_like(g))
                    acc_add = (acc_add + g.sum(0)) & _MASK32
                    acc_xor = acc_xor ^ ((g & 1).sum(0) & 1)
                val = acc_xor if folds_l[p] else acc_add
            elif op == "xor":
                val = av ^ regs[b]
            elif op == "and":
                val = av & regs[b]
            elif op == "andn":
                val = (av ^ _MASK32) & regs[b]
            elif op == "add":
                val = (av + regs[b]) & _MASK32
            else:
                k = cst[c + rnd * const_stride][:, None]
                if op == "rotlv":
                    left = torch.where(k < 32, (av << k.clamp(max=32)) &
                                       _MASK32, torch.zeros_like(av))
                    val = left | (av >> ((32 - k) & 31))
                elif op == "xor_const":
                    val = av ^ k
                else:  # eq_const
                    val = (av == k).to(torch.int64)
            regs[dst] = val
    return _from_u32(regs[0], state.dtype)


def plan_program_rows(state, ctl):
    """Plain version of the word layout's row walk, on the kernel's own
    tables (``core.plan_program.word_tables``): the step table of
    ``w_rounds`` rounds, the last ``w_cycle`` of them repeating (3 int4 a
    step: opcode and flags, registers; const row and further ranges; the
    first range), the constant rows advancing by the program's stride a
    round, each step computing only
    the rows of its ranges and leaving every other row of its destination
    as it is, a PERMUTE row folding its live selects from the CSR (row
    pointer, or a uniform count from the range's base), wrapping 32-bit
    arithmetic on int64 carriers.  For tests and ``chip_smoke.py``: the
    port runs the plain VM (``plan_program_vm``) on CPU states."""
    from repro_torch.core import plan_program as pp
    from repro_torch.kernels.plan_program_kernel import OPCODES

    n, d = state.shape
    steps = ctl["w_steps"].cpu().tolist()
    ranges = ctl["w_ranges"].cpu().tolist()
    rp = ctl["w_rp"].cpu().to(torch.int64)
    cols = ctl["w_cols"].cpu().to(torch.int64)
    wts = None if ctl["w_wts"] is None else _to_u32(ctl["w_wts"].cpu())
    cst = _to_u32(ctl["consts"].cpu())
    t_rounds, cycle = ctl["w_rounds"], ctl["w_cycle"]
    n_steps = len(steps) // t_rounds
    regs = torch.zeros((ctl["n_phys"], n, d), dtype=torch.int64)
    regs[0] = _to_u32(state.cpu())
    for rnd in range(ctl["rounds"]):
        t_rnd = (rnd if rnd < t_rounds else t_rounds - cycle
                 + (rnd - t_rounds + cycle) % cycle)
        base_s = t_rnd * n_steps
        for row in steps[base_s:base_s + n_steps]:
            flags, dst, a, b, c, roff, rcnt = row[:7]
            op = OPCODES[flags & 0xFF]
            for lo, hi, rflags, base in [row[8:12]] + ranges[roff:roff
                                                             + rcnt]:
                if hi <= lo:
                    continue
                av = regs[a, lo:hi]
                if op == "permute":
                    r = torch.arange(lo, hi)
                    if rflags & pp.WR_RAGGED:
                        j0, j1 = rp[base + r], rp[base + r + 1]
                    else:
                        j0 = base + (r - lo) * (rflags >> 16)
                        j1 = j0 + (rflags >> 16)
                    cnt = j1 - j0
                    row_of = torch.repeat_interleave(torch.arange(hi - lo),
                                                     cnt)
                    j = (torch.arange(int(cnt.sum()))
                         - torch.repeat_interleave(torch.cumsum(cnt, 0)
                                                   - cnt, cnt)
                         + torch.repeat_interleave(j0, cnt))
                    g = regs[a][cols[j]]                        # (s, d)
                    if flags & pp.WS_WEIGHTED:
                        g = (g * wts[j][:, None]) & _MASK32
                    acc = torch.zeros((hi - lo, d), dtype=torch.int64)
                    acc.index_add_(0, row_of, g if not flags
                                   & pp.WS_XOR_FOLD else g & 1)
                    val = acc & (1 if flags & pp.WS_XOR_FOLD else _MASK32)
                elif op == "xor":
                    val = av ^ regs[b, lo:hi]
                elif op == "and":
                    val = av & regs[b, lo:hi]
                elif op == "andn":
                    val = (av ^ _MASK32) & regs[b, lo:hi]
                elif op == "add":
                    val = (av + regs[b, lo:hi]) & _MASK32
                else:
                    k = cst[c + rnd * ctl["const_stride"], lo:hi][:, None]
                    if op == "rotlv":
                        left = torch.where(k < 32, (av << k.clamp(max=32)) &
                                           _MASK32, torch.zeros_like(av))
                        val = left | (av >> ((32 - k) & 31))
                    elif op == "xor_const":
                        val = av ^ k
                    else:  # eq_const
                        val = (av == k).to(torch.int64)
                regs[dst, lo:hi] = val
    return _from_u32(regs[ctl["out_reg"]], state.dtype).to(state.device)


def plan_program_packed(state, ctl):
    """Plain bit-sliced emulation of the packed megakernel layout, on the
    kernel's own control: bit 0 of 32 lanes a word (int64 carriers), the
    renamed step table (8 ints a step: opcode, the registers' word
    offsets, the plan's row offset and selects, the const row, the
    barrier flag), PERMUTE as the XOR of the gathered words (16-bit plan
    rows, n = no source: the register's zero pad row), XOR/AND/ANDN
    word-wise, XOR_CONST against 0 or ~0 a row from the constant bits;
    out, each lane's bit as 0/1.  For tests and ``chip_smoke.py``: the
    port runs the plain VM (``plan_program_vm``) on CPU states."""
    from repro_torch.kernels.plan_program_kernel import OPCODES

    if ctl["blob"] is None:
        raise ValueError("this program is not bit-sliceable")
    n, d = state.shape
    blob = ctl["blob"].cpu()
    off_cbits = ctl["off_cbits"]
    period, n_steps = ctl["period"], ctl["n_steps"]
    rows = ctl["packed_steps"].tolist()
    plan = blob[:off_cbits].view(torch.int16).to(torch.int64)
    stride = n + 1                  # a register's words: n rows, a zero pad
    cw = -(-n // 32)
    cbits = blob[off_cbits:off_cbits + ctl["consts"].shape[0] * cw].reshape(
        -1, cw).to(torch.int64) & _MASK32
    nw = -(-d // 32)
    shifts = torch.arange(32, dtype=torch.int64)
    bits = torch.zeros((n, nw * 32), dtype=torch.int64)
    bits[:, :d] = _to_u32(state.cpu()) & 1
    regs = [(bits.reshape(n, nw, 32) << shifts).sum(-1)]
    regs += [torch.zeros_like(regs[0]) for _ in range(ctl["n_phys"] - 1)]
    r_idx = torch.arange(n)
    for rnd in range(ctl["rounds"]):
        for code, dst, a, b, poff, cnt, c, _ in rows[
                (rnd % period) * n_steps:(rnd % period + 1) * n_steps]:
            op = OPCODES[code]
            dst, a, b = dst // stride, a // stride, b // stride
            av = regs[a]
            if op == "permute":
                val = torch.zeros_like(av)
                for j in range(cnt):
                    src = plan[poff + j * n:poff + (j + 1) * n]
                    g = av[src.clamp(max=n - 1)]      # n: the pad row, 0
                    val = val ^ torch.where((src < n)[:, None], g,
                                            torch.zeros_like(g))
            elif op == "xor":
                val = av ^ regs[b]
            elif op == "and":
                val = av & regs[b]
            elif op == "andn":
                val = (av ^ _MASK32) & regs[b]
            elif op == "xor_const":
                row = cbits[c + rnd * ctl["const_stride"]]
                val = av ^ (((row[r_idx >> 5] >> (r_idx & 31)) & 1)
                            * _MASK32)[:, None]
            else:
                raise ValueError(f"{op} has no packed form")
            regs[dst] = val
    out = ((regs[ctl["out_reg"]][:, :, None] >> shifts) & 1).reshape(
        n, nw * 32)[:, :d]
    return _from_u32(out, state.dtype).to(state.device)


def moe_route_transform(ids, *, num_experts, capacity):
    """Plain routing transform: ids (G, T*K) int32, rows t-major.

    Rank of each assignment among the earlier ones of its expert (one-hot
    exclusive cumsum down the row); ``dest = e * C + pos``, DROP (-1)
    when ``pos >= C`` or the id is outside [0, E), whose pos is 0.
    Returns (pos, dest), each (G, T*K) int32.
    """
    valid = (ids >= 0) & (ids < num_experts)
    experts = torch.arange(num_experts, dtype=ids.dtype, device=ids.device)
    onehot = (ids[..., None] == experts).to(torch.int32)
    before = torch.cumsum(onehot, dim=-2) - onehot
    pos = torch.sum(before * onehot, dim=-1).to(torch.int32)
    dest = torch.where(valid & (pos < capacity),
                       ids.to(torch.int64) * capacity + pos, -1)
    return pos, dest.to(torch.int32)


def moe_route_tiled(ids, geometry, *, num_experts, capacity):
    """The routing transform decomposed as the kernel decomposes it on
    ``geometry`` (``moe_route.launch_geometry``); for the tests, which
    hold it against ``moe_route_transform`` and the TPU kernel.

    Warp form: a rank among the earlier lanes of the group's segment.
    Cluster form: each CTA's slice in chunks, each chunk's warps in rounds
    of 32 lanes; a rank is the lane's rank in its round, plus the warp's
    running count over its earlier rounds, the earlier warps' counts in
    the chunk (an exclusive scan of the (warps, E) table), the earlier
    chunks' counts (the chunk carry) and the earlier CTAs' totals (the
    cluster exchange).  Returns (pos, dest) like ``moe_route_transform``.
    """
    g, tk = ids.shape
    e = num_experts
    valid = (ids >= 0) & (ids < e)
    key = torch.where(valid, ids, e).long()          # bin e is not counted

    def earlier_peers(x):                            # (..., L) -> (..., L)
        n = x.shape[-1]
        same = (x[..., :, None] == x[..., None, :]) & (x[..., None, :] < e)
        before = torch.ones(n, n, dtype=torch.bool,
                            device=x.device).tril(-1)
        return (same & before).sum(-1)

    if geometry["form"] == "warp":
        seg = 1 << geometry["seg_log2"]
        pos = earlier_peers(torch.nn.functional.pad(
            key, (0, seg - tk), value=e))[:, :tk]
    else:
        c, sl = geometry["cluster"], geometry["slice"]
        ch, r, w = (geometry["chunks"], geometry["per_thread"],
                    geometry["threads"] // 32)
        x = torch.nn.functional.pad(key, (0, c * sl - tk), value=e)
        x = torch.nn.functional.pad(x.reshape(g, c, sl),
                                    (0, ch * w * r * 32 - sl), value=e)
        x = x.reshape(g, c, ch, w, r, 32)
        local = earlier_peers(x)                     # rank in the round
        hist = torch.zeros((g, c, ch, w, e + 1), dtype=torch.long,
                           device=ids.device)
        for j in range(r):                           # the warp's rounds
            local[..., j, :] += hist.gather(-1, x[..., j, :])
            hist.scatter_add_(-1, x[..., j, :], torch.ones_like(x[..., j, :]))
        earlier_warps = hist.cumsum(3) - hist
        chunk_tot = hist.sum(3)
        carry = chunk_tot.cumsum(2) - chunk_tot
        cta_tot = chunk_tot.sum(2)
        base = cta_tot.cumsum(1) - cta_tot
        flat = x.reshape(g, c, ch, w, r * 32)
        local = (local.reshape(g, c, ch, w, r * 32)
                 + earlier_warps.gather(-1, flat)
                 + carry.gather(-1, flat.reshape(g, c, ch, -1)).reshape(
                     flat.shape)
                 + base.gather(-1, flat.reshape(g, c, -1)).reshape(
                     flat.shape))
        pos = local.reshape(g, c, -1)[:, :, :sl].reshape(g, -1)[:, :tk]
    pos = torch.where(valid, pos, 0).to(torch.int32)
    dest = torch.where(valid & (pos < capacity),
                       ids.to(torch.int64) * capacity + pos, -1)
    return pos, dest.to(torch.int32)


def fused_vcompress(mask, x, *, tail="zero"):
    """Plain fused vcompress: ``out[dest[i]] = x[i]``, with the tail rows
    (unselected) zeroed for ``tail="zero"``."""
    src = x
    if tail == "zero":
        src = torch.where((mask != 0)[:, None], x, torch.zeros_like(x))
    out = torch.empty_like(x)
    out[_t.compress_destinations(mask != 0).long()] = src
    return out
