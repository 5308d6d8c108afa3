"""Mixture-of-Experts decoder LM (phi3.5-moe, mixtral).

Port of ``repro.models.moe``.  The MoE layer routes tokens through the
permutation engine (``core/moe_dispatch.py``): top-k routing -> the
moe_route kernel's positions and capacity-checked destinations ->
scatter-mode crossbar dispatch into (B, E, C, D) -> expert SwiGLU ->
transposed weighted crossbar combine.  Each sequence is a routing group
with its own capacity; the B groups of a batch dispatch as one
block-diagonal plan (the reference's ``vmap``), so a layer costs one
dispatch pass and one combine pass.

The expert FFNs are batched matmuls over the (B, E, C, D) buffer, plain
PyTorch as the reference leaves them to XLA.  Under the sharded
executor's model-axis group every rank of a window routes and
dispatches the window's groups (the router's product, made once, is
shared along "model"); the buffer then splits as the reference annotates it:
E over "model" when the experts divide the axis (each rank runs its E/k
experts; the results return by an all-gather for ``combine``), else
each expert's d_ff (the columns of wi / wg, the rows of wo, whose
float32 partial sums are all-reduced and rounded once; in a decode step
wo's columns on the gathered activation).  The
load-balance and z losses are the first rank's, equal to one device's.  Training differentiates
the 'einsum' dispatch backend, as the reference does; the crossbar
kernels have no gradient (``core.crossbar.apply_plan`` refuses them
under grad).  Parameters: nested dicts as in the reference, with
``blocks`` a list of per-layer dicts (the reference stacks them on a
leading L axis for ``lax.scan``).  Decode updates the stacked caches in
place.
"""

from __future__ import annotations

import math

import torch

from repro_torch._device import resolve
from repro_torch.core import moe_dispatch as md
from repro_torch.dist import annotate as ann
from repro_torch.dist.annotate import Parts, annotate
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def moe_mlp_init(gen, cfg, device):
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": L.dense_init(gen, d, e, scale=0.02, device=device),
        "wi": L.truncated_normal(gen, (e, d, f), 1.0 / math.sqrt(d), device),
        "wg": L.truncated_normal(gen, (e, d, f), 1.0 / math.sqrt(d), device),
        "wo": L.truncated_normal(gen, (e, f, d), 1.0 / math.sqrt(f), device),
    }


def _expert_axis(cfg, g):
    """'tp' when the experts divide the model axis of group ``g``
    (expert parallel), else None (each expert's d_ff split over
    'model')."""
    return "tp" if cfg.num_experts % g.k == 0 else None


def _experts_apply(p, buf, dtype, cfg=None):
    """buf (G, E, C, D) -> (G, E, C, D): batched SwiGLU per expert."""
    if isinstance(buf, Parts):
        return _experts_split(p, buf, dtype, cfg)
    wi, wg, wo = (p[n].to(dtype) for n in ("wi", "wg", "wo"))
    g = L.einsum_f32("gecd,edf->gecf", buf, wg)
    h = L.einsum_f32("gecd,edf->gecf", buf, wi)
    h = (torch.nn.functional.silu(g) * h).to(dtype)
    return L.einsum("gecf,efd->gecd", h, wo)


def _experts_split(p, buf, dtype, cfg):
    """Each rank's experts (E split) or each expert's column blocks; the
    result placed replicated for ``combine``, in ``dtype``."""
    g = buf.g
    ea = _expert_axis(cfg, g)
    ff = None if ea == "tp" else "tp"

    def split(w):
        """The dimension of a (G, E, C, .) product that w's block splits:
        E for an expert block, the last for a column block."""
        return None if w.dim is None else (1 if w.dim == 0 else 3)

    def gate(wg, wi, b):
        return (L.einsum_f32("gecd,edf->gecf", b, wg.to(dtype)),
                L.einsum_f32("gecd,edf->gecf", b, wi.to(dtype)))
    gg, hh = g.map(gate, p["wg"], p["wi"], buf, dim=split(p["wi"]))
    gg = annotate(gg, "batch", ea, None, ff)
    hh = annotate(hh, "batch", ea, None, ff)
    h = g.map(lambda a, c: (torch.nn.functional.silu(a) * c).to(dtype), gg,
              hh, dim=gg.dim)
    if ea == "tp" or p["wo"].dim != 1:
        if ea != "tp":
            h = annotate(h, "batch")     # a decode step's: d_ff gathered
        out = g.map(lambda hr, wo: L.einsum("gecf,efd->gecd", hr,
                                            wo.to(dtype)),
                    h, p["wo"], dim=split(p["wo"]))
        out = annotate(out, "batch", ea, None, None)
    else:
        # each expert's d_ff rows of wo: float32 partial sums, joined
        # over "model" and rounded once
        out = g.map(lambda hr, wo: L.einsum_f32("gecf,efd->gecd", hr,
                                                wo.to(dtype)),
                    ann.reshard(h, 3), p["wo"], dim=ann.SUM)
        out = L.cast(annotate(out, "batch", ea, None, None), dtype)
    return annotate(out, "batch")


def capacity_of(cfg, tokens_per_group: int) -> int:
    """Expert buffer capacity per routing group.  It decides which
    tokens are dropped, so it is kept exactly as the reference has it:
    rounded up to 128 from 512 tokens a group on."""
    c = int(cfg.capacity_factor * tokens_per_group *
            cfg.num_experts_per_tok / cfg.num_experts)
    if tokens_per_group >= 512:
        return max(128, ((c + 127) // 128) * 128)
    return max(cfg.num_experts_per_tok, c)


def moe_mlp_apply(p, x, cfg):
    """x (B, S, D) -> (y (B, S, D), aux {lb_loss, z_loss, dropped}).

    Group-wise dispatch: each sequence routes within its own capacity.
    """
    if isinstance(x, Parts):
        return _moe_split(p, x, cfg)
    _, s, _ = x.shape
    cap = capacity_of(cfg, s)
    router_logits = L.dense(p["router"], x, torch.bfloat16).to(torch.float32)
    routing = md.make_routing(router_logits, num_experts=cfg.num_experts,
                              k=cfg.num_experts_per_tok, capacity=cap)
    buf = md.dispatch(x, routing, backend=cfg.dispatch_backend)
    buf = _experts_apply(p, buf, x.dtype, cfg)
    y = md.combine(buf, routing, backend=cfg.dispatch_backend)
    aux = {
        "lb_loss": torch.mean(md.load_balance_loss(routing)),
        "z_loss": md.router_z_loss(router_logits),
        "dropped": torch.mean(md.dropped_fraction(routing)),
    }
    return y.to(x.dtype), aux


def _moe_split(p, x, cfg):
    g = x.g
    dtype = x.first().dtype
    x = annotate(x, "batch")                     # the sequence gathered
    cap = capacity_of(cfg, x.shape[1])
    # the router's bf16 product on the first rank, shared by a sum: its
    # backward is then one product of the ranks' summed gradient, rounded
    # to bf16 once, as on one device
    first = g.run[0]
    logits = g.map(lambda r, w, xr: L.dense(w, xr, torch.bfloat16).to(
        torch.float32) if r == first else xr.new_zeros(
            xr.shape[:-1] + (cfg.num_experts,), dtype=torch.float32),
        p["router"], x, rank=True, dim=ann.SUM)
    logits = annotate(logits, "batch")
    routing = g.map(lambda lg: md.make_routing(
        lg, num_experts=cfg.num_experts, k=cfg.num_experts_per_tok,
        capacity=cap), logits)
    buf = g.map(lambda xr, rt: md.dispatch(xr, rt,
                                           backend=cfg.dispatch_backend),
                x, routing)                      # (B, E, C, D)
    buf = annotate(buf, "batch", _expert_axis(cfg, g), None, None)
    buf = _experts_apply(p, buf, dtype, cfg)
    y = g.map(lambda bg, rt: md.combine(bg, rt,
                                        backend=cfg.dispatch_backend).to(
        dtype), buf, routing)
    y = annotate(y, "batch", "tp", None)         # the carry's placement
    rt, lg = g.one(routing), g.one(logits)
    aux = {
        "lb_loss": torch.mean(md.load_balance_loss(rt)),
        "z_loss": md.router_z_loss(lg),
        "dropped": torch.mean(md.dropped_fraction(rt)),
    }
    return y, aux


def block_init(gen, cfg, device):
    return {
        "ln1": L.norm_init(cfg.d_model, cfg.norm, device),
        "attn": A.attn_init(gen, cfg, device),
        "ln2": L.norm_init(cfg.d_model, cfg.norm, device),
        "moe": moe_mlp_init(gen, cfg, device),
    }


def block_apply(p, x, cfg, *, positions=None):
    h = A.attn_apply(p["attn"], L.apply_norm(p["ln1"], x, cfg.norm), cfg,
                     positions=positions)
    x = x + h
    h, aux = moe_mlp_apply(p["moe"], L.apply_norm(p["ln2"], x, cfg.norm), cfg)
    return x + h, aux


def lm_init(gen, cfg, device=None):
    """Seeded random parameters, drawn from ``gen`` on ``device`` (the
    card by default; ``gen`` must live on the same device)."""
    device = resolve(device)
    params = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device),
        "blocks": L.stack_layer_params(
            lambda g: block_init(g, cfg, device), gen, cfg.num_layers),
        "final_norm": L.norm_init(cfg.d_model, cfg.norm, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                         device)
    return params


def lm_hidden(params, tokens, cfg):
    """tokens (B, S) -> (final hidden (B, S, D), aux averaged over
    layers).  The stack runs through ``layers.scan`` (per-layer remat
    under ``cfg.remat == "full"``: each layer's routing, moe_route launch
    included, runs again in the backward pass)."""
    x = L.embed_lookup(params["embed"], tokens, L.dtype_of(cfg.compute_dtype))

    def body(h, layer_params):
        h = annotate(h, "batch", "tp", None)  # sequence-parallel carry
        return block_apply(layer_params, h, cfg)

    x, auxes = L.scan(cfg, body, x, params["blocks"])
    aux = {k: torch.mean(torch.stack([a[k] for a in auxes]))
           for k in auxes[0]}
    return L.apply_norm(params["final_norm"], x, cfg.norm), aux


def lm_loss(params, batch, cfg, *, lb_coef=0.01, z_coef=1e-3):
    """Next-token CE plus the routing losses (load balance and router z,
    each averaged over layers).  Returns (loss, metrics)."""
    tokens = batch["tokens"]
    hidden, aux = lm_hidden(params, tokens, cfg)
    logits = T.lm_logits(params, hidden, cfg)
    ce = L.cross_entropy(logits[:, :-1], tokens[:, 1:],
                         mask=batch.get("loss_mask"))
    loss = ce + lb_coef * aux["lb_loss"] + z_coef * aux["z_loss"]
    return loss, {"loss": loss, "ce": ce, **aux}


# -- serving -------------------------------------------------------------------

def block_decode(p, x1, cache, pos, cfg):
    h, cache = A.decode_attn_apply(p["attn"],
                                   L.apply_norm(p["ln1"], x1, cfg.norm),
                                   cache, pos, cfg)
    x1 = x1 + h
    h, _ = moe_mlp_apply(p["moe"], L.apply_norm(p["ln2"], x1, cfg.norm), cfg)
    return x1 + h, cache


init_caches = T.init_caches


def decode_step(params, tokens1, caches, pos, cfg):
    """One token for every slot.  tokens1 (B, 1); caches from
    ``init_caches`` (updated in place).  Returns (logits (B, 1, V),
    caches)."""
    x = L.embed_lookup(params["embed"], tokens1,
                       L.dtype_of(cfg.compute_dtype))
    for i, blk in enumerate(params["blocks"]):
        layer_cache = {name: c[i] for name, c in caches.items()}
        x, _ = block_decode(blk, x, layer_cache, pos, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return L.gathered(T.lm_logits(params, x, cfg)), caches
