"""How far a bf16 training step of Zamba2, split over "model", lies from
a float32 step on one device, beside one bf16 device's own distance.

Two bf16 runs of one step differ wherever their products round
differently, so the split step is read against a third run: the same
state and batches in float32 compute on one device (the witness).  For
every parameter's first moment (the step's gradient) it prints the
relative L2 distance from the witness of one bf16 device and of the
bf16 sharded executor on each mesh, and the losses' distances.

``--scan all-heads`` runs each rank's SSD scan among zeros of all H
heads (the shapes one device's scan takes), and ``--rows whole`` every
product split by wo's rows (Mamba2's ``out_proj``, the shared block's
wo and its MLP's) on the whole matrix and the gathered input, as one
device computes it: each tells one part of the split apart from the
rest.

Not a test: pytest does not collect it.  On a card:

    PYTHONPATH=src python tests/torch_hybrid_bf16_split.py [--layers 12]

and on the CPU at a narrowed width:

    PYTHONPATH=src python tests/torch_hybrid_bf16_split.py --device cpu \\
        --narrow --seq 128
"""

import argparse
import dataclasses

import torch

from repro_torch import _tree
from repro_torch.configs import zamba2_2_7b
from repro_torch.dist import sharding as shd
from repro_torch.dist import spmd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model_zoo
from repro_torch.models import ssm as S
from repro_torch.train import TrainOptions, make_train_step
from repro_torch.train.trainer import init_state


def _scan_all_heads(heads, cfg):
    """``ssm._heads`` run among zeros of all ``heads`` heads, the first
    ones the caller's."""
    inner = S._heads

    def run(xs, bt, ct, dt_raw, a_log, dt_bias, d_skip, state, pp, chunk):
        hr = dt_raw.shape[-1]
        if hr == heads:
            return inner(xs, bt, ct, dt_raw, a_log, dt_bias, d_skip, state,
                         pp, chunk)

        def pad(t, dim):
            shape = list(t.shape)
            shape[dim] = shape[dim] * heads // hr
            out = t.new_zeros(shape)
            out.narrow(dim, 0, t.shape[dim]).copy_(t)
            return out
        y, st = inner(pad(xs, -1), bt, ct, pad(dt_raw, -1), pad(a_log, 0),
                      pad(dt_bias, 0), pad(d_skip, 0),
                      None if state is None else pad(state, 1), pp, chunk)
        return y.narrow(-1, 0, xs.shape[-1]), st.narrow(1, 0, hr)
    return run


def _rows_whole():
    """``layers.project_out`` with a row-split wo gathered whole and the
    product computed on the gathered input on every rank, then placed
    as the carry."""
    from repro_torch.dist.annotate import annotate
    from repro_torch.models import layers as L
    inner = L.project_out

    def run(wo, h, dtype):
        if wo["w"].dim != 0:
            return inner(wo, h, dtype)
        w = annotate(wo["w"], None, None)
        y = h.g.map(lambda wr, hr: L.dense({"w": wr}, hr, dtype), w,
                    annotate(h, "batch"))
        return annotate(y, "batch", "tp", None)
    L.project_out = run


def rel(a, b) -> float:
    nb = float(torch.linalg.vector_norm(b.detach()))
    return float(torch.linalg.vector_norm((a - b).detach())) / nb if nb else 0.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--narrow", action="store_true",
                    help="d_model 256, d_ff 512, vocab 1000, 4 heads of 64")
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--meshes", default="2x1,2x2")
    ap.add_argument("--scan", choices=("heads", "all-heads"),
                    default="heads")
    ap.add_argument("--rows", choices=("split", "whole"), default="split")
    ap.add_argument("--top", type=int, default=8)
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    cfg = dataclasses.replace(zamba2_2_7b.CONFIG, num_layers=a.layers)
    if a.narrow:
        cfg = dataclasses.replace(cfg, d_model=256, d_ff=512,
                                  vocab_size=1000, num_heads=4,
                                  num_kv_heads=4, head_dim=64)
    if a.scan == "all-heads":
        S._heads = _scan_all_heads(S.geometry(cfg)[1], cfg)
    if a.rows == "whole":
        _rows_whole()
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    api, api32 = (model_zoo.build(c, device=dev) for c in (cfg, f32))
    state = init_state(api.init(torch.Generator(device=dev).manual_seed(0)))
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [api.make_batch(gen, a.batch, a.seq) for _ in range(a.steps)]
    opts = TrainOptions(peak_lr=1e-3)
    copy = lambda: _tree.tree_map(lambda t: t.clone(), state)

    def single(fn):
        st, losses = copy(), []
        step = make_train_step(fn, opts)
        for b in batches:
            st, m = step(st, b)
            losses.append(float(m["loss"]))
        return losses, list(_tree.leaves_with_path(st.opt.mu)), list(
            _tree.leaves_with_path(st.params))

    def sharded(data, model):
        devices = None if dev.type == "cuda" else [a.device] * (data * model)
        mesh = make_host_mesh(data=data, model=model, devices=devices)
        st = copy()
        sh = (spmd.train_state_shardings(st, mesh, cfg),
              shd.batch_shardings(batches[0], mesh))
        placed = shd.device_put(st, sh[0])
        del st
        step = spmd.make_sharded_train_step(api.loss_fn, opts, mesh, *sh)
        losses = []
        for b in batches:
            placed, m = step(placed, shd.device_put(b, sh[1]))
            losses.append(float(m["loss"]))
        return losses, *([(p, shd.gather(t)) for p, t in
                          _tree.leaves_with_path(tree)]
                         for tree in (placed.opt.mu, placed.params))

    runs = {"witness f32": single(api32.loss_fn),
            "bf16 one device": single(api.loss_fn)}
    for m in a.meshes.split(","):
        d, k = (int(v) for v in m.split("x"))
        runs[f"bf16 ({d}, {k})"] = sharded(d, k)
    wl, wmu, wpar = runs.pop("witness f32")
    print(f"config: {cfg.name}, d_model {cfg.d_model}, {cfg.num_layers} "
          f"layers, batch {a.batch} x {a.seq}, {a.steps} steps, scan "
          f"{a.scan}, rows {a.rows}, {dev}")
    print(f"witness losses {wl}")
    dist, pdist = {}, {}
    for name, (losses, mu, par) in runs.items():
        dl = [abs(l / w - 1) for l, w in zip(losses, wl)]
        dist[name] = {"/".join(map(str, p)): rel(t, w)
                      for (p, t), (_, w) in zip(mu, wmu)}
        pdist[name] = {"/".join(map(str, p)): rel(t, w)
                       for (p, t), (_, w) in zip(par, wpar)}
        d = sorted(dist[name].items(), key=lambda kv: -kv[1])
        print(f"{name}: losses {losses}, relative distance from the witness "
              f"{['%.3e' % v for v in dl]}; first moments furthest: "
              + ", ".join(f"{p} {v:.3e}" for p, v in d[:a.top]))
    one = dist.pop("bf16 one device")
    pone = pdist.pop("bf16 one device")
    for name, d in pdist.items():
        ratio = sorted(((d[p] / pone[p] if pone[p] else 0.0), p) for p in d)
        print(f"{name} / one device, parameters' distances: the largest "
              "ratios " + ", ".join(f"{p} {r:.2f} ({d[p]:.3e} / "
                                    f"{pone[p]:.3e})"
                                    for r, p in ratio[::-1][:a.top])
              + f"; median {ratio[len(ratio) // 2][0]:.2f}")
    for name, d in dist.items():
        ratio = sorted(((d[p] / one[p] if one[p] else 0.0), p) for p in d)
        print(f"{name} / one device, first moments' distances: the largest "
              "ratios " + ", ".join(f"{p} {r:.2f} ({d[p]:.3e} / "
                                    f"{one[p]:.3e})"
                                    for r, p in ratio[::-1][:a.top])
              + f"; median {ratio[len(ratio) // 2][0]:.2f}")


if __name__ == "__main__":
    main()
