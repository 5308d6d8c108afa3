"""Which products of a split over "model" equal one device's, bit for
bit, on the card.

The sharded executor (``dist.spmd``) holds its split steps to one
device's at tight bars (``chip_smoke.py``'s sharding phase: a bf16 MoE
step's loss within 1e-5, greedy decode tokens equal).  A bf16 router or
a greedy argmax turns one-ulp differences into different experts or
tokens, so the split has to reproduce one device's products exactly
where it can.  This reads, on the card, which ways of cutting a product
do:

* ``gemm``: a bf16 GEMM's column half and row half against the whole
  product's, and two float32 partial products over the halves of K,
  summed and cast once, against the bf16 GEMM, at training shapes (2048
  and 5120 rows) and decode shapes (2 and 4 rows), with cuBLAS's
  reduced-precision split-K reduction allowed and disallowed;
* ``experts``: the batched expert products (``einsum`` over E) of half
  and a quarter of the experts against all of them, at Phi-3.5-MoE's
  training and Mixtral-8x22B's decode shapes;
* ``decode``: MiniCPM-2B's, Mixtral-8x22B's and RWKV6-7B's (its time
  and channel mix matrices at the attention's and MLP's shapes) decode
  products at 2
  rows (a window) against 4 (one device), each cut in half as the split
  cuts it: q / k / wo / MLP by columns, the logits by vocabulary, the
  attention's batched products by kv heads; and the column half run at
  the whole width (the block among zeros);
* ``wkv``: RWKV6-7B's WKV recurrence (64 heads of 64) on one position
  in the chunk form and in decode's step form (``rwkv._wkv_step``) and
  on a training chunk of 16, a window's 2 rows, all 64 heads and 32 of
  them (as the split over "model" runs it), against one device's 4 rows
  on all 64, and the 32 heads run among zeros of all 64;
* ``lora``: RWKV6-7B's float32 LoRA products (the ddlerp's 4096 x 160,
  the decay's 4096 x 64 and 64 x 4096) on a window's 2 rows of one
  device's 4, summed in float32 and in float64 (``rwkv._lora``);
* ``rwkv_layers``: RWKV6-7B's first 2 layers' bf16 decode step from
  zero state on 2 rows against one device's 4, intermediate by
  intermediate;
* ``rwkv_windows``: RWKV6-7B's 4 layers, 8 bf16 decode steps of 4
  slots: one device on 2 of the slots and the sharded decode on (2, 1),
  (1, 2) and (2, 2) of the card against one device, with decode's WKV
  and LoRA sums in float32 (the chunk form) and in float64;
* ``rwkv_moments``: the same 4 layers' float32 training split over (2,
  1), (1, 2) and (2, 2), 2 steps at 4 x 512: its first moments against
  one device's, the largest distances by leaf.

Not a test: pytest does not collect it.  On a card:

    PYTHONPATH=src python tests/torch_split_numerics.py \\
        [gemm|experts|decode|wkv|lora|rwkv_layers|rwkv_windows|rwkv_moments]
"""

import argparse
import subprocess

import torch

from repro_torch.models import layers as L

BF = torch.bfloat16


def _gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


def _rnd(g, dev, *shape, scale=1.0, dtype=BF):
    return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)


def _frac(a, b) -> float:
    return float((a != b).float().mean())


def gemm(dev):
    g = _gen(dev)
    shapes = [(2048, 4096, 4096), (2048, 6400, 4096), (5120, 6144, 6144),
              (2, 6144, 6144), (4, 6144, 6144), (2, 5760, 2304),
              (2, 2304, 2304), (2, 6144, 1024), (2, 16384, 6144)]
    for allow in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            allow)
        for m, k, n in shapes:
            x = _rnd(g, dev, m, k)
            w = _rnd(g, dev, k, n, scale=k ** -0.5)
            whole = x @ w
            cols = all(torch.equal(whole[:, i * n // 2:(i + 1) * n // 2],
                                   x @ w[:, i * n // 2:(i + 1) * n // 2])
                       for i in range(2))
            rows = torch.equal(whole[: max(1, m // 2)],
                               x[: max(1, m // 2)] @ w)
            halves = (x[:, : k // 2].float() @ w[: k // 2].float()
                      + x[:, k // 2:].float() @ w[k // 2:].float()).to(BF)
            one = (x.float() @ w.float()).to(BF)
            print(f"gemm {m}x{k}x{n} reduced-precision reduction {allow}: "
                  f"column halves bit-equal {cols}, row half {rows}; "
                  f"float32 K-halves cast once differ at "
                  f"{_frac(halves, whole):.3e}, one float32 GEMM cast at "
                  f"{_frac(one, whole):.3e} of entries")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True


def experts(dev):
    g = _gen(dev)
    for G, E, C, D, F in ((2, 16, 160, 4096, 6400), (2, 8, 2, 6144, 16384),
                          (4, 8, 2, 6144, 16384)):
        buf = _rnd(g, dev, G, E, C, D)
        w = _rnd(g, dev, E, D, F, scale=D ** -0.5)
        whole = L.einsum_f32("gecd,edf->gecf", buf, w)
        for parts in (2, 4):
            n = E // parts
            same = [torch.equal(whole[:, r * n:(r + 1) * n], L.einsum_f32(
                "gecd,edf->gecf", buf[:, r * n:(r + 1) * n],
                w[r * n:(r + 1) * n])) for r in range(parts)]
            print(f"experts G{G} E{E} C{C} D{D} F{F}: blocks of {n} experts "
                  f"bit-equal {same}")


def decode(dev):
    g = _gen(dev)
    cfgs = {"minicpm": (2304, 36, 36, 64, 5760, 122880, 72),
            "mixtral": (6144, 48, 8, 128, 16384, 32768, 32),
            "rwkv6": (4096, 64, 64, 64, 14336, 65536, 32)}
    for name, (d, h, kv, hd, f, v, win) in cfgs.items():
        x = _rnd(g, dev, 4, 1, d)
        for what, (k, n) in (("wq", (d, h * hd)), ("wk", (d, kv * hd)),
                             ("attention wo", (h * hd, d)), ("wi", (d, f)),
                             ("MLP wo", (f, d))):
            w = _rnd(g, dev, k, n, scale=k ** -0.5)
            xx = x if k == d else _rnd(g, dev, 4, 1, k)
            whole = L.dense({"w": w}, xx, BF)[:2, :, : n // 2]
            half = L.dense({"w": w[:, : n // 2].contiguous()}, xx[:2], BF)
            wide = torch.zeros_like(w)
            wide[:, : n // 2] = w[:, : n // 2]
            padded = L.dense({"w": wide}, xx[:2], BF)[..., : n // 2]
            print(f"decode {name} {what} ({k}x{n}): column half at 2 rows "
                  f"differs from one device's 4 at {_frac(half, whole):.3e}"
                  f" of entries; at the whole width {_frac(padded, whole):.3e}")
        t = _rnd(g, dev, v, d, scale=0.02, dtype=torch.float32)
        whole = L.logits_projection({"table": t}, x, BF)[:2, :, : v // 2]
        half = L.logits_projection({"table": t[: v // 2].contiguous()},
                                   x[:2], BF)
        print(f"decode {name} logits: vocabulary half differs at "
              f"{_frac(half, whole):.3e}")
        rep = h // kv
        q = _rnd(g, dev, 4, 1, kv, rep, hd)
        ck, cv = _rnd(g, dev, 4, win, kv, hd), _rnd(g, dev, 4, win, kv, hd)
        whole = L.einsum_f32("bckrh,bskh->bkrcs", q, ck)[:2, : kv // 2]
        half = L.einsum_f32("bckrh,bskh->bkrcs", q[:2, :, : kv // 2],
                            ck[:2, :, : kv // 2])
        pr = torch.softmax(torch.randn(4, kv, rep, 1, win, generator=g,
                                       device=dev), -1).to(BF)
        pv = L.einsum_f32("bkrcs,bskh->bckrh", pr, cv)[:2, :, : kv // 2]
        pv_half = L.einsum_f32("bkrcs,bskh->bckrh", pr[:2, : kv // 2],
                               cv[:2, :, : kv // 2])
        print(f"decode {name} attention over half the kv heads: scores "
              f"differ at {_frac(half, whole):.3e}, outputs at "
              f"{_frac(pv_half, pv):.3e}")


def wkv(dev):
    from repro_torch.models import rwkv as R
    g = _gen(dev)
    h, n = 64, 64
    f32 = torch.float32
    mine = slice(0, h // 2)

    def zeros(t, dim):
        z = torch.zeros_like(t)
        z.narrow(dim, 0, h // 2).copy_(t.narrow(dim, 0, h // 2))
        return z
    for c, form, fn in ((1, "chunk form", R._wkv_chunk),
                        (1, "step form", R._wkv_step),
                        (16, "chunk form", R._wkv_chunk)):
        r, k, v = (_rnd(g, dev, 4, c, h, n) for _ in range(3))
        lw = -torch.exp(_rnd(g, dev, 4, c, h, n, scale=0.5, dtype=f32) - 4)
        u = _rnd(g, dev, h, n, scale=0.1, dtype=f32)
        st = _rnd(g, dev, 4, h, n, n, dtype=f32)
        out, state = fn(r, k, v, lw, u, st)
        half, half_st = fn(*(t[:2, :, mine] for t in (r, k, v, lw)), u[mine],
                           st[:2, mine])
        rows, rows_st = fn(*(t[:2] for t in (r, k, v, lw)), u, st[:2])
        wide, wide_st = fn(*(zeros(t[:2], 2) for t in (r, k, v, lw)), u,
                           zeros(st[:2], 1))
        print(f"wkv {form}, chunk of {c}: 2 rows of all 64 heads differ from "
              f"4 rows' at {_frac(rows, out[:2]):.3e} of outputs, "
              f"{_frac(rows_st, state[:2]):.3e} of the state; 2 rows of 32 "
              f"heads at {_frac(half, out[:2, :, mine]):.3e} / "
              f"{_frac(half_st, state[:2, mine]):.3e}; the 32 among zeros "
              f"of 64 at {_frac(wide[:, :, mine], out[:2, :, mine]):.3e} / "
              f"{_frac(wide_st[:, mine], state[:2, mine]):.3e}")


def lora(dev):
    g = _gen(dev)
    f32, f64 = torch.float32, torch.float64
    for d, e in ((4096, 160), (4096, 64), (64, 4096)):
        x = _rnd(g, dev, 4, 1, d, dtype=f32)
        w = _rnd(g, dev, d, e, scale=0.01, dtype=f32)
        for name, fn in (
                ("float32", lambda a: L.einsum("bsd,de->bse", a, w)),
                ("float64 sums", lambda a: L.einsum(
                    "bsd,de->bse", a.to(f64), w.to(f64)).to(f32))):
            print(f"rwkv6 LoRA ({d} x {e}) in {name}: a window's 2 rows "
                  f"differ from one device's 4 at "
                  f"{_frac(fn(x[:2]), fn(x)[:2]):.3e} of entries")


def rwkv_layers(dev):
    import dataclasses

    from repro_torch.configs import rwkv6_7b
    from repro_torch.models import model_zoo
    from repro_torch.models import rwkv as R
    cfg = dataclasses.replace(rwkv6_7b.CONFIG, num_layers=2)
    params = model_zoo.build(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    h, n = R._head_geometry(cfg)
    tok = torch.randint(0, cfg.vocab_size, (4, 1), dtype=torch.int32,
                        generator=_gen(dev), device=dev)
    x = L.apply_norm(params["ln0"], L.embed_lookup(params["embed"], tok, BF),
                     "layernorm")

    def layer(p, x1, b, step):
        """``block_decode`` from zero state, its intermediates kept, the
        WKV by ``step``."""
        out = {}
        t, c = p["tmix"], p["cmix"]
        z = torch.zeros((b, 1, cfg.d_model), device=dev)
        xn = out["ln1"] = L.apply_norm(p["ln1"], x1, "layernorm")
        xr, xk, xv, xw, xg = R._ddlerp(t, xn, R._shift(xn, z) - xn)
        out["ddlerp"] = torch.stack([xr, xk, xv, xw, xg])
        for nm, xx in (("r", xr), ("k", xk), ("v", xv)):
            out[nm] = L.dense(t["w" + nm], xx, BF).reshape(b, 1, h, n)
        r, k, v = out["r"], out["k"], out["v"]
        gate = out["g"] = L.dense(t["wg"], xg, BF)
        lw = out["lw"] = R._decay_logw(t, xw).reshape(b, 1, h, n)
        o, _ = step(r, k, v, lw, t["bonus"],
                    torch.zeros((b, h, n, n), device=dev))
        out["wkv"] = o
        o = out["norm gate"] = R._norm_gate(o, gate, t["ln_x"], BF)
        x1 = x1 + L.dense(t["wo"], o, BF)
        xn = out["ln2"] = L.apply_norm(p["ln2"], x1, "layernorm")
        xk, xr = R._cmix_inputs(c, xn, z)
        kk = torch.square(torch.relu(L.dense(c["wk"], xk, BF).float()))
        out["cmix kv"] = kv = L.dense(c["wv"], kk.to(BF), BF)
        rr = torch.sigmoid(L.dense(c["wr"], xr, BF).float()).to(BF)
        out["x"] = x1 = x1 + rr * kv
        return x1, out

    with torch.no_grad():
        for form, step in (("chunk", R._wkv_chunk), ("step", R._wkv_step)):
            xs = {4: x, 2: x[:2].clone()}
            for i, blk in enumerate(params["blocks"]):
                got = {}
                for b in (4, 2):
                    xs[b], got[b] = layer(blk, xs[b], b, step)
                # the ddlerp's five streams lead its rows
                rows = {nm: t[:, :2] if nm == "ddlerp" else t[:2]
                        for nm, t in got[4].items()}
                dx = (xs[2] - rows["x"]).float()
                print(f"rwkv6 layer {i}'s decode step from zero state, the "
                      f"WKV in the {form} form, 2 rows against one device's "
                      f"4: " + ", ".join(
                          f"{nm} {_frac(got[2][nm], t):.3e}"
                          for nm, t in rows.items()) + " of entries differ;"
                      f" the output's L2 relative distance "
                      f"{float(dx.norm() / rows['x'].float().norm()):.3e}")


def _rwkv(dev, layers, dtype):
    import dataclasses

    from repro_torch.configs import rwkv6_7b
    from repro_torch.models import model_zoo
    cfg = dataclasses.replace(rwkv6_7b.CONFIG, num_layers=layers,
                              compute_dtype=dtype)
    api = model_zoo.build(cfg, device=dev)
    return cfg, api, api.init(torch.Generator(device=dev).manual_seed(0))


def _meshes():
    from repro_torch.launch.mesh import make_host_mesh
    return {shape: make_host_mesh(data=shape[0], model=shape[1])
            for shape in ((2, 1), (1, 2), (2, 2))}


def rwkv_windows(dev):
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import spmd
    from repro_torch.models import model_zoo
    from repro_torch.models import rwkv as R
    steps, slots = 8, 4
    cfg, api, params = _rwkv(dev, 4, "bfloat16")
    meta = model_zoo.build(cfg, device="meta")
    dims = spmd.cache_batch_dims(lambda b: meta.init_caches(b, steps))
    step, lora = R._wkv_step, R._lora
    float32 = (R._wkv_chunk,
               lambda eq, x, w: L.einsum(eq, x.to(torch.float32), w))
    for form, (R._wkv_step, R._lora) in (("float32", float32),
                                         ("float64", (step, lora))):
        tok = torch.randint(0, cfg.vocab_size, (slots, 1), dtype=torch.int32,
                            generator=_gen(dev), device=dev)
        caches = {b: api.init_caches(b, steps) for b in (slots, 2)}
        runs = {}
        for shape, mesh in _meshes().items():
            c = api.init_caches(slots, steps)
            runs[shape] = [mesh, shd.device_put(params, shd.param_shardings(
                params, mesh)), shd.device_put(c, shd.cache_shardings(c, mesh))]
        with torch.no_grad():
            for j in range(steps):
                lg = {}
                for b in (slots, 2):
                    lg[b], caches[b] = api.decode_fn(params, tok[:b],
                                                     caches[b], j)
                errs = {"one device on 2 slots": lg[2]}
                for shape, run in runs.items():
                    errs[shape], run[2] = spmd.sharded_decode_step(
                        api.decode_fn, run[0], run[1], tok, run[2], j,
                        batch_dims=dims)
                want = lg[slots][:, -1].float()

                def row(got):
                    got = got[:, -1].float()
                    return float((torch.linalg.vector_norm(
                        got - want[:got.shape[0]], dim=-1) / torch.linalg
                        .vector_norm(want[:got.shape[0]], dim=-1)).max())
                print(f"rwkv6 4 layers bf16 decode, WKV and LoRA sums in "
                      f"{form}, step {j}: worst logit row's L2 relative "
                      f"distance from one device's 4 slots: " + ", ".join(
                          f"{k} {row(v):.3e}" for k, v in errs.items()))
                tok = lg[slots][:, -1].argmax(-1).to(torch.int32)[:, None]
        R._wkv_step, R._lora = step, lora


def rwkv_moments(dev):
    from repro_torch import _tree
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import spmd
    from repro_torch.train import TrainOptions, make_train_step
    from repro_torch.train.trainer import init_state
    cfg, api, p0 = _rwkv(dev, 4, "float32")
    gen = _gen(dev)
    batches = [api.make_batch(gen, 4, 512) for _ in range(2)]
    opts = TrainOptions(peak_lr=1e-3)
    fresh = lambda: init_state(_tree.tree_map(lambda t: t.clone(), p0))
    st, step = fresh(), make_train_step(api.loss_fn, opts)
    for b in batches:
        st, _ = step(st, b)
    want = _tree.leaves_with_path(st.opt.mu)
    del st
    for shape, mesh in _meshes().items():
        st = fresh()
        sh = (spmd.train_state_shardings(st, mesh, cfg),
              shd.batch_shardings(batches[0], mesh))
        placed = shd.device_put(st, sh[0])
        del st
        step = spmd.make_sharded_train_step(api.loss_fn, opts, mesh, *sh)
        for b in batches:
            placed, _ = step(placed, shd.device_put(b, sh[1]))
        errs = sorted(((float(torch.linalg.vector_norm(shd.gather(a) - w)
                              / torch.linalg.vector_norm(w)),
                        "/".join(map(str, path)))
                       for (path, w), a in zip(want,
                                               _tree.leaves(placed.opt.mu))),
                      reverse=True)
        print(f"rwkv6 4 layers float32, 2 steps at 4 x 512 over {shape}: "
              f"first moments' L2 relative distance from one device's, "
              f"largest " + ", ".join(f"{n} {e:.3e}" for e, n in errs[:4]))
        del placed
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("what", nargs="*",
                    default=["gemm", "experts", "decode", "wkv", "lora",
                             "rwkv_layers", "rwkv_windows", "rwkv_moments"])
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"gpu: {smi}; torch {torch.__version__}")
    dev = torch.device("cuda", 0)
    for what in args.what:
        {"gemm": gemm, "experts": experts, "decode": decode, "wkv": wkv,
         "lora": lora, "rwkv_layers": rwkv_layers,
         "rwkv_windows": rwkv_windows, "rwkv_moments": rwkv_moments}[what](dev)


if __name__ == "__main__":
    main()
