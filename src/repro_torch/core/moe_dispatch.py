"""MoE token routing as crossbar permutations.

Port of ``repro.core.moe_dispatch``.  Token dispatch is ``vcompress``:
the tokens routed to expert ``e`` are a mask over the token axis, a
token's slot in the expert's buffer is the prefix count of that mask,
and capacity overflow is the out-of-range drop — fixed shapes, no sort
of the tokens, no data-dependent control flow.  Dispatch runs as a
scatter-mode crossbar into the flattened (E*C, D) buffer; combine is the
transposed crossbar with the router gates as per-select weights.

Every function takes one routing group — router logits (T, E), tokens
(T, D) — or a batch of G groups with a leading axis, the counterpart of
the reference's ``jax.vmap`` over groups: the G groups then dispatch as
one block-diagonal plan (``plan_algebra.batched_scatter_plan``), so a
batch costs one dispatch pass and one combine pass.

Positions and destinations come from ``kernels.ops.moe_route_transform``:
the moe_route CUDA kernel for CUDA tensors, its plain version for CPU
tensors.  For in-range ids that function is ``compute_positions`` plus
the capacity check.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import no_tf32
from repro_torch.core import crossbar as xb
from repro_torch.core import plan_algebra as pa
from repro_torch.core import transform as _t
from repro_torch.kernels import ops as _kops


@dataclasses.dataclass
class Routing:
    """Routing decision for T tokens (or G groups of T, leading axis).

    expert_ids: (..., T, K) int32 — chosen experts per token.
    gates:      (..., T, K) f32   — combine weights (post-normalisation).
    positions:  (..., T, K) int32 — rank within each expert's queue.
    dest:       (..., T, K) int32 — flattened buffer slot e*C + pos, or DROP.
    probs:      (..., T, E) f32   — full router probabilities (aux losses).
    num_experts / capacity: geometry.
    """

    expert_ids: torch.Tensor
    gates: torch.Tensor
    positions: torch.Tensor
    dest: torch.Tensor
    probs: torch.Tensor
    num_experts: int
    capacity: int


def top_k(values: torch.Tensor, k: int):
    """The k largest entries of the last axis, in ``jax.lax.top_k``'s
    order: descending, ties to the lower index.  ``torch.topk`` promises
    no order among ties on CUDA; a stable descending sort does."""
    vals, ids = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def compute_positions(expert_ids: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Rank of each (token, slot) assignment within its expert's queue.

    Flatten the (T, K) assignments row-major (earlier tokens, then
    earlier slots, win lower positions), one-hot against the expert
    axis, exclusive-cumsum down the flattened axis, read back each
    assignment's own column.
    """
    shape = expert_ids.shape
    flat = expert_ids.reshape(shape[:-2] + (shape[-2] * shape[-1],))
    experts = torch.arange(num_experts, dtype=flat.dtype, device=flat.device)
    onehot = (flat[..., None] == experts).to(torch.int32)
    before = _t.exclusive_cumsum(onehot, dim=-2)
    return torch.sum(before * onehot, dim=-1).reshape(shape)


def topk_route(router_logits: torch.Tensor, k: int, *,
               renormalize: bool = True):
    """Top-k routing (softmax over the selected k logits).

    Returns (expert_ids (..., T, K) int32, gates (..., T, K) f32,
    probs (..., T, E) f32).
    """
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    top_logits, expert_ids = top_k(router_logits, k)
    if renormalize:
        gates = torch.softmax(top_logits.to(torch.float32), dim=-1)
    else:
        gates = torch.gather(probs, -1, expert_ids)
    return expert_ids.to(torch.int32), gates, probs


def make_routing(router_logits: torch.Tensor, *, num_experts: int, k: int,
                 capacity: int, renormalize: bool = True) -> Routing:
    """Full routing decision: top-k -> positions -> capacity-checked
    destinations.  router_logits: (T, E) or (G, T, E)."""
    expert_ids, gates, probs = topk_route(router_logits, k,
                                          renormalize=renormalize)
    pos, dest = _kops.moe_route_transform(
        expert_ids, num_experts=num_experts, capacity=capacity)
    # Gates of dropped assignments are zeroed so combine ignores them.
    gates = torch.where(pos < capacity, gates, 0.0)
    return Routing(expert_ids, gates.to(torch.float32), pos, dest, probs,
                   num_experts, capacity)


def dispatch_plan(routing: Routing) -> xb.PermutePlan:
    """Scatter-mode plan: token t -> buffer slots dest[t, :] (one
    block-diagonal plan over the groups of a batched routing)."""
    slots = routing.num_experts * routing.capacity
    if routing.dest.dim() == 2:
        return xb.scatter_plan(routing.dest, slots)
    return pa.batched_scatter_plan(routing.dest, slots)


def combine_plan(routing: Routing) -> xb.PermutePlan:
    """``transpose(dispatch_plan)`` with the gates as weights: derived
    from the same ``dest`` array, not rebuilt."""
    k = routing.gates.shape[-1]
    return pa.with_weights(pa.transpose(dispatch_plan(routing)),
                           routing.gates.reshape(-1, k))


def dispatch(x: torch.Tensor, routing: Routing, *,
             backend: str = "einsum") -> torch.Tensor:
    """(..., T, D) tokens -> (..., E, C, D) expert buffers (dropped
    tokens vanish, unfilled slots are zero).  backend: any
    ``core.crossbar`` backend."""
    d = x.shape[-1]
    out = xb.apply_plan(dispatch_plan(routing), x.reshape(-1, d),
                        backend=backend)
    return out.reshape(x.shape[:-2] + (routing.num_experts,
                                       routing.capacity, d))


def combine(y: torch.Tensor, routing: Routing, *,
            backend: str = "einsum") -> torch.Tensor:
    """(..., E, C, D) expert outputs -> (..., T, D) gate-weighted token
    outputs."""
    d = y.shape[-1]
    out = xb.apply_plan(combine_plan(routing), y.reshape(-1, d),
                        backend=backend)
    return out.reshape(routing.dest.shape[:-1] + (d,))


# -- auxiliary losses (one value per group; a scalar for one group) -----------

def load_balance_loss(routing: Routing) -> torch.Tensor:
    """Switch/Mixtral auxiliary loss: E * sum_e f_e * p_e, with f_e the
    fraction of assignments routed to e (before drops) and p_e the mean
    router probability of e."""
    e = routing.num_experts
    experts = torch.arange(e, device=routing.expert_ids.device)
    onehot = (routing.expert_ids[..., None] == experts).to(torch.float32)
    f = torch.mean(torch.sum(onehot, dim=-2), dim=-2)
    p = torch.mean(routing.probs, dim=-2)
    return e * torch.sum(f * p, dim=-1)


def router_z_loss(router_logits: torch.Tensor) -> torch.Tensor:
    """mean(logsumexp(logits)^2) over every token (ST-MoE)."""
    z = torch.logsumexp(router_logits.to(torch.float32), dim=-1)
    return torch.mean(z ** 2)


def dropped_fraction(routing: Routing) -> torch.Tensor:
    """Fraction of (token, slot) assignments that slid out."""
    return torch.mean((routing.dest == _t.DROP).to(torch.float32),
                      dim=(-2, -1))


# -- dense reference (for differential tests) ---------------------------------

def dense_reference(x: torch.Tensor, routing: Routing, expert_fn):
    """O(T*E*C) reference of dispatch -> expert -> combine for one group:
    explicit (T, E, C) one-hot dispatch/combine tensors, contracted
    densely in float32."""
    e, c = routing.num_experts, routing.capacity
    dev = x.device
    slot = (routing.positions[..., None] ==
            torch.arange(c, device=dev)).to(torch.float32)        # (T,K,C)
    exp = (routing.expert_ids[..., None] ==
           torch.arange(e, device=dev)).to(torch.float32)         # (T,K,E)
    keep = (routing.dest != _t.DROP).to(torch.float32)[..., None]
    with no_tf32():
        disp = torch.einsum("tke,tkc->tec", exp, slot * keep)
        comb = torch.einsum("tk,tke,tkc->tec", routing.gates, exp, slot)
        buf = torch.einsum("tec,td->ecd", disp, x.to(torch.float32))
    y = expert_fn(buf)
    with no_tf32():
        return torch.einsum("tec,ecd->td", comb,
                            y.to(torch.float32)).to(x.dtype)
