#!/usr/bin/env python3
"""Solves chip_smoke.py's headline batch for several trees of this
repository in one run on one CUDA card, in turns, to tell a change in a
batch's wall time from its run-to-run spread.

    python3 tools/torch_batch_trees.py --trees chip_check/parent . \\
        [--linsys indirect] [--batch 1024] [--family spectral] \\
        [--mode f64-state|pure] --out batch_trees.json

The batch is --batch planted problems of bench.py's headline family
(z=40, l=120, eight SOC blocks, n=100, seeds from 1000), or with --family
spectral of phase 13's spectral headline family
(`models/spectral_cones.headline_spectral_spec`), solved by
make_chunked_batch_solver with Settings(linsys=--linsys, chunk_iters=250)
in its default mode (mixed, float32 state on the card), as phases 5 and 7
of chip_smoke.py do, or with --mode f64-state (fast_f32=False) or pure
(mixed_precision=False), as phase 13 solves the spectral batch. Each run
is a fresh process that imports the tree's scs_tpu_torch and solves
through this tree's chip_smoke.solve_batch, with
its correctness gates (status, SCS's termination test in float64, the
objective within 5e-3 (1 + |opt|) of the planted optimum). The trees run
in the order given and then in reverse (A B B A for two). For each run:
wall, lane-iterations and their rate, lockstep steps, ms per step, and
the slowest lanes with their iteration counts; every lane's count is kept
in the output, beside the card's nvidia-smi name and power limit.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SLOWEST = 5


def worker(tree: str, linsys: str, B: int, family: str, mode: str) -> dict:
    root = Path(tree).resolve()
    sys.path.insert(0, str(root))
    mod = importlib.util.spec_from_file_location("chip_smoke",
                                                 ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(cs)
    pkg = Path(cs.dsmatvec.__file__).resolve()
    if not pkg.is_relative_to(root):
        raise RuntimeError(f"{tree}: scs_tpu_torch imported from {pkg}")
    cs._build.build()
    spec = (cs.spectral_cones.headline_spectral_spec()
            if family == "spectral" else cs.HEADLINE)
    batch = cs.headline_batch(spec, B, 1000)
    kw = {"f64-state": dict(fast_f32=False),
          "pure": dict(mixed_precision=False)}.get(mode, {})
    res = cs.solve_batch(spec, batch,
                         cs.Settings(linsys=linsys, chunk_iters=250, **kw),
                         f"{tree}: {family} batch {linsys} {mode}", tol=5e-3)
    iters = np.asarray(res["iters"])
    slow = np.argsort(-iters, kind="stable")[:SLOWEST]
    return {"tree": tree, "card": cs.card_line(), "wall_s": res["wall"],
            "lane_iterations": int(iters.sum()),
            "lane_iterations_per_s": float(iters.sum() / res["wall"]),
            "steps": int(res["steps"]),
            "ms_per_step": res["wall"] / max(res["steps"], 1) * 1e3,
            "f32_state": bool(res["f32_state"]),
            "slowest": [{"lane": int(i), "seed": 1000 + int(i),
                         "iters": int(iters[i])} for i in slow],
            "median_iters": float(np.median(iters)),
            "iters": iters.tolist()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--linsys", default="indirect",
                    choices=("indirect", "direct"))
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--family", default="headline",
                    choices=("headline", "spectral"))
    ap.add_argument("--mode", default="default",
                    choices=("default", "f64-state", "pure"))
    ap.add_argument("--out", default="batch_trees.json")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        res = worker(args.worker, args.linsys, args.batch, args.family,
                     args.mode)
        Path(args.out).write_text(json.dumps(res))
        return 0

    out = Path(args.out).resolve()
    out.parent.mkdir(parents=True, exist_ok=True)
    order = list(args.trees) + list(reversed(args.trees))
    runs = []
    for i, tree in enumerate(order):
        part = out.parent / f"batch_trees_run{i}.json"
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", tree, "--linsys", args.linsys,
                        "--batch", str(args.batch), "--family", args.family,
                        "--mode", args.mode, "--out", str(part)],
                       check=True, timeout=1200)
        runs.append(json.loads(part.read_text()))
        part.unlink()
        r = runs[-1]
        print(f"{tree}: wall {r['wall_s']:.3f} s, {r['lane_iterations']} "
              f"lane-iterations, {r['lane_iterations_per_s']:.0f} /s, "
              f"{r['steps']} steps, {r['ms_per_step']:.3f} ms/step, "
              f"median lane {r['median_iters']:.0f} iterations, slowest "
              + ", ".join(f"lane {s['lane']} (seed {s['seed']}) "
                          f"{s['iters']}" for s in r["slowest"]),
              flush=True)
    print(runs[0]["card"])
    same = {t: all(r["iters"] == runs[order.index(t)]["iters"]
                   for r in runs if r["tree"] == t) for t in args.trees}
    print("every lane's iterations equal across a tree's runs: "
          + ", ".join(f"{t} {v}" for t, v in same.items()))
    out.write_text(json.dumps({"card": runs[0]["card"], "order": order,
                               "linsys": args.linsys, "batch": args.batch,
                               "family": args.family, "mode": args.mode,
                               "same_iters_per_tree": same, "runs": runs},
                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
