"""Shared model building blocks (functional: init dicts + apply fns).

Port of ``repro.models.layers``.  Conventions, as in the reference:

* parameters are nested dicts of tensors, each weight in the
  reference's ``(d_in, d_out)`` layout;
* weights are stored in ``param_dtype`` (float32 master) and cast to
  ``compute_dtype`` at use;
* a product the reference accumulates in float32 and then casts to the
  compute dtype runs in the compute dtype here (one rounding of a
  float32 accumulation either way); a product whose float32 result the
  reference keeps (attention scores, logits, the expert gate) runs in
  float32 on operands rounded to the compute dtype (``einsum_f32``).

The initialisers draw from a ``torch.Generator`` on the device their
caller resolved (``moe.lm_init``), which every one of them requires;
they do not reproduce the reference's ``jax.random`` bits (weights are
carried across with ``models.params.params_from_numpy``).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import no_tf32

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name (``"float32"`` / ``"bfloat16"``) as a torch
    dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``einsum`` in the operands' dtype; float32 products stay float32
    whatever the process-wide TF32 setting (``no_tf32``)."""
    with no_tf32():
        return torch.einsum(eq, *operands)


def einsum_f32(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``einsum`` with a float32 result: the reference's
    ``preferred_element_type=float32`` over compute-dtype operands
    (bf16 widens to float32 exactly; float32 products, never TF32)."""
    return einsum(eq, *(o.to(torch.float32) for o in operands))


# -- initialisers --------------------------------------------------------------

def truncated_normal(gen: torch.Generator, shape, scale: float,
                     device) -> torch.Tensor:
    """Normal draws truncated to two standard deviations, times scale."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale)


def dense_init(gen, d_in, d_out, *, device, bias=False, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": truncated_normal(gen, (d_in, d_out), scale, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
    return p


def norm_init(d, kind, device):
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def embed_init(gen, vocab, d, device, scale=0.02):
    return {"table": truncated_normal(gen, (vocab, d), scale, device)}


# -- apply ---------------------------------------------------------------------

def dense(p, x, compute_dtype=torch.bfloat16):
    """``x @ w (+ b)`` in the compute dtype."""
    w = p["w"].to(compute_dtype)
    xc = x.to(compute_dtype)
    if "b" in p:   # the bias joins the float32 accumulation
        y = einsum_f32("...d,df->...f", xc, w) + p["b"].to(torch.float32)
        return y.to(compute_dtype)
    with no_tf32():
        return torch.matmul(xc, w)


def apply_norm(p, x, kind="rmsnorm", eps=1e-6):
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def embed_lookup(p, tokens, compute_dtype=torch.bfloat16):
    """Table row gather (rows gathered, then cast: the same values as
    casting the whole table first)."""
    return p["table"][tokens.long()].to(compute_dtype)


def logits_projection(p, x, compute_dtype=torch.bfloat16):
    """``x @ table^T`` -> (..., vocab), float32."""
    return einsum_f32("...d,vd->...v", x.to(compute_dtype),
                      p["table"].to(compute_dtype))


# -- rotary position embedding -------------------------------------------------

def rope_freqs(hd_rot: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd_rot, 2, dtype=torch.float32,
                        device=device) / hd_rot
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, *, theta: float, rotary_pct: float = 1.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    hd_rot = int(hd * rotary_pct)
    hd_rot -= hd_rot % 2
    if hd_rot == 0:
        return x
    freqs = rope_freqs(hd_rot, theta, x.device)            # (hd_rot/2,)
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xr, xp = x[..., :hd_rot], x[..., hd_rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


# -- MLPs ----------------------------------------------------------------------

def mlp_init(gen, d, f, *, act="swiglu", device):
    if act == "swiglu":
        return {"wi": dense_init(gen, d, f, device=device),
                "wg": dense_init(gen, d, f, device=device),
                "wo": dense_init(gen, f, d, device=device)}
    return {"wi": dense_init(gen, d, f, device=device),
            "wo": dense_init(gen, f, d, device=device)}


def mlp_apply(p, x, *, act="swiglu", compute_dtype=torch.bfloat16):
    """SwiGLU or GELU MLP; the activation runs in float32.  GELU is the
    tanh approximation, ``jax.nn.gelu``'s default."""
    f32 = torch.float32
    if act == "swiglu":
        h = torch.nn.functional.silu(dense(p["wg"], x, compute_dtype).to(f32))
        h = h * dense(p["wi"], x, compute_dtype).to(f32)
        return dense(p["wo"], h.to(compute_dtype), compute_dtype)
    h = torch.nn.functional.gelu(dense(p["wi"], x, compute_dtype).to(f32),
                                 approximate="tanh")
    return dense(p["wo"], h.to(compute_dtype), compute_dtype)


# -- layer stacks --------------------------------------------------------------

def stack_layer_params(init_fn, gen, n_layers):
    """``n_layers`` layers of one structure, drawn in turn from ``gen``:
    the port's list of per-layer dicts (the reference stacks them on a
    leading L axis)."""
    return [init_fn(gen) for _ in range(n_layers)]


def scan(cfg, body, carry, xs):
    """``lax.scan`` over a layer stack: ``body(carry, xs[i]) -> (carry,
    y)`` for each i in turn; returns (carry, [y, ...]).

    With ``cfg.remat == "full"`` and grad enabled, each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): only its inputs are kept
    and its forward runs again in the backward pass — the reference's
    per-layer ``jax.checkpoint``.  ``xs[i]`` is read inside the
    checkpointed body, so a stack whose items are made when read (the
    sharded executor's per-layer gather, ``dist.spmd``) makes layer i
    again for the recompute and keeps none of it between the passes.
    ``cfg.scan_unroll`` has nothing to unroll here.
    """
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    ys = []
    for i in range(len(xs)):
        if remat:
            carry, y = checkpoint(_item_body, body, carry, xs, i,
                                  use_reentrant=False)
        else:
            carry, y = body(carry, xs[i])
        ys.append(y)
    return carry, ys


def _item_body(body, carry, xs, i):
    return body(carry, xs[i])


# -- loss ----------------------------------------------------------------------

def cross_entropy(logits, labels, *, mask=None):
    """Token-level CE with an optional validity mask; logits (..., V).

    The gold logit is picked with a gather (``take_along_dim``), never a
    one-hot contraction: a (B, S, V) float32 one-hot is far larger than
    the logits at a 150k vocabulary.
    """
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(),
                                dim=-1)[..., 0]
    nll = lse - gold
    if mask is not None:
        m = mask.to(torch.float32)
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)
