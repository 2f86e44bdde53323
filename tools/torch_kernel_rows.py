#!/usr/bin/env python3
"""Times chip_smoke.py's phase-2 kernel rows (K1-K4) for several trees of
this repository in one run on one CUDA card, in turns, so that two
versions of the kernels are compared on the same card.

    python3 tools/torch_kernel_rows.py --trees chip_check/parent . \\
        --out kernel_rows.json

A tree is a checkout of the repository, for example a parent commit from
`git archive` unpacked into a gitignored directory. Each run is a fresh
process that imports the tree's scs_tpu_torch, builds that tree's
kernels, and checks and times every row of this tree's chip_smoke.py
(K1_SHAPES ... K4_SHAPES) with this tree's case functions and timer
(CUDA events, median of 30 L2-flushed launches; device time only, and
again without the spin, which counts the host's enqueue too): the
harness is the same for every tree, only the kernels and their wrappers
differ. The trees run in the order given and then in reverse (A B B A
for two); every run is kept in the output, with the card's nvidia-smi
name and power limit; library times are the medians over all runs.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def rows() -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    return {"k1": cs.K1_SHAPES, "k2": cs.K2_SHAPES, "k3": cs.K3_SHAPES,
            "k4": cs.K4_SHAPES}


def worker(tree: str, spec: dict) -> dict:
    """Every row through this tree's chip_smoke case functions, with
    `tree`'s scs_tpu_torch."""
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
    out = {"tree": tree, "card": cs.card_line(), "k1": [], "k2": [],
           "k3": [], "k4": []}
    for i, (m, n) in enumerate(spec["k1"]):
        out["k1"].append(cs.ds_matvec_case(m, n, seed=i))
    for key in ("k2", "k3"):
        for i, (B, m, n, st, x32, pair) in enumerate(spec[key]):
            out[key].append(cs.ds_matvec_batched_case(
                B, m, n, seed=20 + i, strided=st, x32=x32, pair=pair))
    for i, (a, b) in enumerate(spec["k4"]):
        out["k4"].append(cs.ds_matmul_case(tuple(a), tuple(b), seed=40 + i))
    return out


def label(key: str, c: dict) -> str:
    shape = c["shape"]
    if key == "k4":
        return f"K4 {tuple(shape[0])}x{tuple(shape[1])}"
    name = {"k1": "K1", "k2": "K2", "k3": "K3"}[key]
    extra = "".join([" x strided" if c.get("strided_x") else "",
                     " x f32" if c.get("x32") else ""])
    return f"{name} {'x'.join(map(str, shape))}{extra}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--out", default="kernel_rows.json")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--spec", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        res = worker(args.worker, json.loads(Path(args.spec).read_text()))
        Path(args.out).write_text(json.dumps(res))
        return 0

    out_dir = Path(args.out).resolve().parent
    out_dir.mkdir(parents=True, exist_ok=True)
    spec_path = out_dir / "kernel_rows_spec.json"
    spec_path.write_text(json.dumps(rows()))
    order = list(args.trees) + list(reversed(args.trees))
    runs = []
    for i, tree in enumerate(order):
        part = out_dir / f"kernel_rows_run{i}.json"
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", tree, "--spec", str(spec_path),
                        "--out", str(part)], check=True, timeout=900)
        runs.append(json.loads(part.read_text()))
        part.unlink()
    spec_path.unlink()
    print(runs[0]["card"])
    print("order: " + ", ".join(order))
    header = "row | " + " | ".join(f"{t} ms" for t in order) + \
        " | bound ms | library ms | without the spin: " + \
        " | ".join(f"{t} ms" for t in order) + " | library ms"
    print(header)
    summary = []
    for key in ("k1", "k2", "k3", "k4"):
        for j, c in enumerate(runs[0][key]):
            row = {"row": label(key, c), "bound_ms": c["bound_ms"]}
            for timer in ("", "_no_spin"):
                ms = [r[key][j]["ms" + timer] for r in runs]
                row["ms" + timer] = ms
                row["median_ms" + timer] = {t: statistics.median(
                    [r[key][j]["ms" + timer] for r in runs
                     if r["tree"] == t]) for t in args.trees}
                row["library_ms" + timer] = statistics.median(
                    r[key][j]["library_ms" + timer] for r in runs)
            summary.append(row)
            print(f"{row['row']} | "
                  + " | ".join(f"{v:.4f}" for v in row["ms"])
                  + f" | {c['bound_ms']:.4f} | {row['library_ms']:.4f} | "
                  + " | ".join(f"{v:.4f}" for v in row["ms_no_spin"])
                  + f" | {row['library_ms_no_spin']:.4f}")
    Path(args.out).write_text(json.dumps(
        {"card": runs[0]["card"], "order": order, "rows": summary,
         "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
