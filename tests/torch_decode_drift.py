"""bf16 decode against the parallel forward, on the CPU, in the JAX
reference or in the port: SeamlessM4T-large-v2's decoder, RWKV6-7B and
Zamba2-2.7B.

A decode step multiplies a few rows (one token a request) where the
parallel decoder multiplies many, and a bf16 product's rounding depends on
its row count.  This reads how far that carries over the 24 decoder
layers, as the worst row's relative L2 difference of the logits at each of
16 greedy steps from BOS 0, so the port's reading on a card can be set
beside the reference's own.  The port also decodes every step one
position late, the reading of a planted fault.

Published widths and vocabulary, the whole decoder, seeded weights (each
package its own draw); the encoder is cut to 2 layers and 256 frames a
request: it only feeds the cross K/V.

``--model rwkv`` / ``--model hybrid``: RWKV6-7B at 2 layers and
Zamba2-2.7B at one group (6 Mamba2 layers and one shared attention
application), published widths and vocabularies, seeded weights: 4 x 64
random tokens through ``lm_hidden`` and the logits projection, then the
same tokens through 64 ``decode_step`` calls (float32 caches), each
step's logits against the parallel forward's at its position, in bf16
and in float32 compute.  The port also decodes every step one token late
(the reading of a planted fault).

Not a test: pytest does not collect it.  Run one package a process (the
weights are ~4.5 GB in float32 for SeamlessM4T, ~4 GB for RWKV6-7B at 2
layers, ~2 GB for Zamba2-2.7B at one group):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_decode_drift.py --impl jax
    PYTHONPATH=src python tests/torch_decode_drift.py --impl torch
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_decode_drift.py --impl jax --model rwkv
    PYTHONPATH=src python tests/torch_decode_drift.py --impl torch --model hybrid
"""

import argparse
import dataclasses
import time

import numpy as np

BATCH, STEPS, ENC_LAYERS, FRAMES = 4, 16, 2, 256
TOKENS = 64
RECURRENT = {"rwkv": ("rwkv6-7b", 2), "hybrid": ("zamba2-2.7b", 6)}


def worst_rows(steps, parallel):
    """Worst row L2 relative error of each step's logits (B, V) against
    the parallel decoder's position j (B, S, V), as numpy float64."""
    out = []
    for j, lg in enumerate(steps):
        want = parallel[:, j].astype(np.float64)
        got = lg.astype(np.float64)
        out.append(float((np.linalg.norm(got - want, axis=-1)
                          / np.linalg.norm(want, axis=-1)).max()))
    return out


def run_jax():
    import jax
    import jax.numpy as jnp
    from jax._src import core as jax_core
    jax.core.trace_state_clean = jax_core.trace_state_clean
    from repro.configs import get_config
    from repro.core.sequence import shift_right
    from repro.models import encdec as E
    from repro.models import layers as L
    from repro.models import model_zoo

    cfg = dataclasses.replace(get_config("seamless-m4t-large-v2"),
                              encoder_layers=ENC_LAYERS)
    params = model_zoo.build(cfg).init(jax.random.PRNGKey(0))
    dtype = jnp.dtype(cfg.compute_dtype)
    rng = np.random.default_rng(1)
    frames = jnp.asarray(rng.standard_normal(
        (BATCH, FRAMES, cfg.d_model)) * 0.02, dtype)
    enc = E.encode(params, frames, cfg)
    cross = E.prime_cross(params, enc, cfg, jnp.float32)
    caches = E.init_caches(cfg, BATCH, STEPS, jnp.float32)
    tok = jnp.zeros((BATCH, 1), jnp.int32)
    steps, fed = [], []
    for j in range(STEPS):
        logits, caches = E.decode_step(params, tok, caches, j, cfg,
                                       cross=cross)
        steps.append(np.asarray(logits[:, -1], np.float32))
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        fed.append(tok)
    x = L.embed_lookup(params["embed"],
                       shift_right(jnp.concatenate(fed, 1), axis=-1, fill=0),
                       dtype)
    for i in range(cfg.num_layers):
        blk = jax.tree.map(lambda t: t[i], params["dec_blocks"])
        x = E.dec_block_apply(blk, x, enc, cfg)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    parallel = np.asarray(L.logits_projection(params["lm_head"], x, dtype),
                          np.float32)
    return cfg, {"bf16 decode": worst_rows(steps, parallel)}


def run_torch():
    import torch

    from repro_torch.configs import seamless_m4t_large_v2
    from repro_torch.models import encdec as E
    from repro_torch.models import layers as L
    from repro_torch.models import params as MP

    cfg = dataclasses.replace(seamless_m4t_large_v2.CONFIG,
                              encoder_layers=ENC_LAYERS)
    params = MP.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dtype = L.dtype_of(cfg.compute_dtype)
    rng = np.random.default_rng(1)
    frames = torch.as_tensor(rng.standard_normal(
        (BATCH, FRAMES, cfg.d_model)) * 0.02).to(dtype)
    readings = {}
    with torch.inference_mode():
        enc = E.encode(params, frames, cfg)
        cross = E.prime_cross(params, enc, cfg, torch.float32)
        fed = None
        for name, late in (("bf16 decode", 0),
                           ("bf16 decode one position late", 1)):
            caches = E.init_caches(cfg, BATCH, STEPS + 1, torch.float32,
                                   "cpu")
            tok = torch.zeros((BATCH, 1), dtype=torch.int32)
            steps, greedy = [], []
            for j in range(STEPS):
                logits, caches = E.decode_step(params, tok, caches, j + late,
                                               cfg, cross=cross)
                steps.append(logits[:, -1].float().numpy())
                greedy.append(logits[:, -1].argmax(-1).to(torch.int32)[:, None])
                # the planted run is fed the sound run's tokens
                tok = greedy[-1] if fed is None else fed[j]
            if fed is None:
                fed = greedy
                hidden = E.decode_hidden(params, torch.cat(fed, dim=1), enc,
                                         cfg)
                parallel = L.logits_projection(params["lm_head"], hidden,
                                               hidden.dtype).float().numpy()
            readings[name] = worst_rows(steps, parallel)
    return cfg, readings


def _tokens(cfg):
    return np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, TOKENS)).astype(np.int32)


def _recurrent_cfg(get_config, model, layers, attn_chunk):
    arch, default = RECURRENT[model]
    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=layers or default,
                               attn_chunk=attn_chunk or cfg.attn_chunk)


def run_jax_recurrent(model, layers=None, attn_chunk=None):
    import jax
    import jax.numpy as jnp
    from jax._src import core as jax_core
    jax.core.trace_state_clean = jax_core.trace_state_clean
    from repro.configs import get_config
    from repro.models import hybrid, model_zoo, rwkv
    from repro.models import layers as L

    M = rwkv if model == "rwkv" else hybrid
    base = _recurrent_cfg(get_config, model, layers, attn_chunk)
    params = model_zoo.build(base).init(jax.random.PRNGKey(0))
    toks = jnp.asarray(_tokens(base))
    readings = {}
    for compute in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base, compute_dtype=compute)
        api = model_zoo.build(cfg)

        @jax.jit
        def parallel_logits(p, t):
            hidden = M.lm_hidden(p, t, cfg)
            return L.logits_projection(p.get("lm_head", p["embed"]), hidden,
                                       hidden.dtype)

        parallel = np.asarray(parallel_logits(params, toks), np.float32)
        decode = jax.jit(api.decode_fn)
        caches = api.init_caches(BATCH, TOKENS, jnp.float32)
        steps = []
        for j in range(TOKENS):
            logits, caches = decode(params, toks[:, j:j + 1], caches, j)
            steps.append(np.asarray(logits[:, -1], np.float32))
        readings[f"{compute} decode"] = worst_rows(steps, parallel)
    return base, readings


def run_torch_recurrent(model, layers=None, attn_chunk=None):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import hybrid, model_zoo, rwkv

    M = rwkv if model == "rwkv" else hybrid
    base = _recurrent_cfg(get_config, model, layers, attn_chunk)
    toks = torch.as_tensor(_tokens(base))
    readings = {}
    with torch.inference_mode():
        params = model_zoo.build(base, device="cpu").init(
            torch.Generator().manual_seed(0))
        for compute in ("bfloat16", "float32"):
            cfg = dataclasses.replace(base, compute_dtype=compute)
            api = model_zoo.build(cfg, device="cpu")
            parallel = M.lm_logits(params, M.lm_hidden(params, toks, cfg))
            parallel = parallel.float().numpy()
            for late in ((0, 1) if compute == "bfloat16" else (0,)):
                caches = api.init_caches(BATCH, TOKENS + 1, torch.float32)
                steps = []
                for j in range(TOKENS):
                    src = max(j - late, 0)
                    logits, caches = api.decode_fn(
                        params, toks[:, src:src + 1], caches, j)
                    steps.append(logits[:, -1].float().numpy())
                name = f"{compute} decode" + (" one token late" if late
                                              else "")
                readings[name] = worst_rows(steps, parallel)
    return base, readings


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--model", choices=("seamless",) + tuple(RECURRENT),
                    default="seamless")
    ap.add_argument("--layers", type=int, default=None,
                    help="rwkv / hybrid: depth (default 2 / 6)")
    ap.add_argument("--attn-chunk", type=int, default=None,
                    help="rwkv / hybrid: the SSD chunk bound (default: the "
                    "config's)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if args.model != "seamless":
        run = run_jax_recurrent if args.impl == "jax" else run_torch_recurrent
        cfg, readings = run(args.model, args.layers, args.attn_chunk)
        print(f"{args.impl}: {cfg.name}, {cfg.num_layers} of its layers, "
              f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, attn_chunk "
              f"{cfg.attn_chunk}, {BATCH} x {TOKENS} tokens, "
              f"{time.perf_counter() - t0:.1f} s")
    else:
        cfg, readings = run_jax() if args.impl == "jax" else run_torch()
        print(f"{args.impl}: seamless-m4t-large-v2, {cfg.encoder_layers} "
              f"encoder + {cfg.num_layers} decoder layers, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab_size}, {BATCH} x {FRAMES} "
              f"frames, {cfg.compute_dtype} compute, "
              f"{time.perf_counter() - t0:.1f} s")
    for name, rel in readings.items():
        print(f"  {name}: worst row L2 relative error a step "
              + ", ".join(f"{r:.3e}" for r in rel)
              + f"; max {max(rel):.3e}")


if __name__ == "__main__":
    main()
