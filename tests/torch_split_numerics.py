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
* ``decode``: MiniCPM-2B's and Mixtral-8x22B's decode products at 2
  rows (a window) against 4 (one device), each cut in half as the split
  cuts it: q / k / wo / MLP by columns, the logits by vocabulary, the
  attention's batched products by kv heads; and the column half run at
  the whole width (the block among zeros).

Not a test: pytest does not collect it.  On a card:

    PYTHONPATH=src python tests/torch_split_numerics.py [gemm|experts|decode]
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
            "mixtral": (6144, 48, 8, 128, 16384, 32768, 32)}
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("what", nargs="*", default=["gemm", "experts", "decode"])
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"gpu: {smi}; torch {torch.__version__}")
    dev = torch.device("cuda", 0)
    for what in args.what:
        {"gemm": gemm, "experts": experts, "decode": decode}[what](dev)


if __name__ == "__main__":
    main()
