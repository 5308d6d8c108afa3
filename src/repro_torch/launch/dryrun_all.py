"""Resumable dry-run sweep: one subprocess a cell
(``python -m repro_torch.launch.dryrun``), results as
``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json``.

Port of ``repro.launch.dryrun_all``, writing beside the reference's
``experiments/dryrun/``, never into it.  Single-pod cells run the full
roofline extraction; multi-pod cells run ``--skip-cost`` (the multi-pod
pass proves the 'pod' axis shards; the roofline table is single-pod
only, as the reference's).  A cell whose JSON says ``ok`` or
``skipped`` is not run again unless ``--force``; a failed or timed-out
cell leaves a ``FAILED`` record with the end of its stderr.

Usage:  python -m repro_torch.launch.dryrun_all [--multi-pod] [--only arch[,arch]]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))  # repo root


def _status(path: str) -> str:
    try:
        with open(path) as f:
            return json.load(f)[0]["status"]
    except (OSError, ValueError, KeyError, IndexError, TypeError):
        return "corrupt"


def main(argv=None, *, log_fn=print) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--only", type=str, default="")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import SHAPES, list_archs
    mesh_tag = "2x16x16" if args.multi_pod else "16x16"
    outdir = os.path.join(HERE, "experiments", "dryrun_torch", mesh_tag)
    os.makedirs(outdir, exist_ok=True)

    archs = args.only.split(",") if args.only else list_archs()
    cells = [(a, s) for a in archs for s in SHAPES]
    t_start = time.time()
    n_ok = n_skip = n_fail = 0
    for i, (arch, shape) in enumerate(cells):
        out = os.path.join(outdir, f"{arch}__{shape}.json")
        if os.path.exists(out) and not args.force:
            st = _status(out)
            if st in ("ok", "skipped"):
                n_ok += st == "ok"
                n_skip += st == "skipped"
                continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", out]
        if args.multi_pod:
            cmd += ["--multi-pod", "--skip-cost"]
        t0 = time.time()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=args.timeout,
                                  env={**os.environ,
                                       "PYTHONPATH": os.path.join(HERE,
                                                                  "src")})
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            rc = -9
            proc = None
        dt = time.time() - t0
        status = _status(out) if os.path.exists(out) else "?"
        if rc != 0 and status not in ("ok", "skipped"):
            n_fail += 1
            err = (proc.stderr[-800:] if proc else "TIMEOUT")
            with open(out, "w") as f:
                json.dump([{"arch": arch, "shape": shape, "mesh": mesh_tag,
                            "status": "FAILED", "error": err}], f, indent=1)
            log_fn(f"[{i+1}/{len(cells)}] FAIL {arch} x {shape} ({dt:.0f}s)")
        else:
            n_ok += status == "ok"
            n_skip += status == "skipped"
            log_fn(f"[{i+1}/{len(cells)}] {status:7s} {arch} x {shape} "
                   f"({dt:.0f}s)")
    log_fn(f"done in {time.time()-t_start:.0f}s: ok={n_ok} "
           f"skipped={n_skip} failed={n_fail}")
    return {"ok": n_ok, "skipped": n_skip, "failed": n_fail}


if __name__ == "__main__":
    main()
