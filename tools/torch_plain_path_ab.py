#!/usr/bin/env python3
"""The one-problem solve's plain path (no phase clock, no trace) of two
checkouts of the port, timed in turns (A B B A by default) on one
device: the large SOCP (n = 2048, m = 8192, direct mixed on the card,
1400 iterations) and the headline SOCP (n = 100, m = 299), each solved
once to warm up, then the large SOCP twice and the headline five times,
each timed as Info.solve_time over its iterations.

    python tools/torch_plain_path_ab.py ROOT_A ROOT_B [--order ABBABAAB]
        [--device cpu --n 256]

Each ROOT is a checkout of the repo (for example the parent commit
unpacked with `git archive` into a directory that .gitignore lists). Each
turn runs in a process of its own that imports that checkout's
scs_tpu_torch and, on the card, builds its kernels first. Both checkouts
must reach the same iterations and the same bits of x. One line a turn,
then the card's name and power limit, then a JSON object of ms per
iteration by checkout and problem.
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time


def child(root: str, device: str, n: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import scs_tpu_torch
    from scs_tpu_torch import Settings, Workspace
    from scs_tpu_torch.demo_socp import make_spec
    from scs_tpu_torch.models import gen_planted
    from scs_tpu_torch.types import ConeSpec

    assert os.path.dirname(scs_tpu_torch.__file__).startswith(
        os.path.abspath(root)), scs_tpu_torch.__file__
    torch.set_num_threads(1 if device == "cpu" else torch.get_num_threads())
    if device == "cuda":
        from scs_tpu_torch.ops import _build
        _build.build()
    big_spec = make_spec(n, 0.1, np.random.RandomState(7))
    head_spec = ConeSpec(z=40, l=120, q=(20, 34, 14, 51, 22, 31, 1, 67))
    cases = (("large SOCP", big_spec, gen_planted(big_spec, n=n, seed=7,
                                                  density=0.3), 2),
             ("headline", head_spec, gen_planted(head_spec, n=100, seed=1000,
                                                 density=0.1), 5))
    out = {}
    for label, spec, p, reps in cases:
        runs = []
        for _ in range(reps + 1):
            ws = Workspace(p.problem, spec, p.cone_data,
                           Settings(linsys="direct"), device=device)
            sol, info = ws.solve()
            if device == "cuda":
                torch.cuda.synchronize()
            runs.append((info.solve_time / max(info.iter, 1), info.iter,
                         hashlib.sha256(np.ascontiguousarray(
                             sol.x).tobytes()).hexdigest()[:16]))
        out[label] = {"ms_per_it": [r[0] for r in runs[1:]],
                      "iter": runs[-1][1], "x_sha": runs[-1][2],
                      "mixed": bool(ws._mixed)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--order", default="ABBA",
                    help="the turns, a string of A and B")
    ap.add_argument("--child", default=None)
    a = ap.parse_args()
    if a.child is not None:
        print(json.dumps(child(a.child, a.device, a.n)))
        return 0
    if a.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("torch_plain_path_ab: no CUDA device", file=sys.stderr)
            return 1
    root_a, root_b = a.roots
    results = {root_a: [], root_b: []}
    for root in ({"A": root_a, "B": root_b}[t] for t in a.order):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             os.path.abspath(root),
             "--device", a.device, "--n", str(a.n)],
            capture_output=True, text=True, timeout=900,
            cwd=os.path.abspath(root))
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results[root].append(res)
        print(f"{root}: " + "; ".join(
            f"{k} {v['iter']} iterations (mixed {v['mixed']}), x "
            f"{v['x_sha']}, ms/iteration "
            + ", ".join(f"{t!r}" for t in v["ms_per_it"])
            for k, v in res.items())
            + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    ref = results[root_a][0]
    for root, turns in results.items():
        for res in turns:
            for k, v in res.items():
                if (v["iter"], v["x_sha"]) != (ref[k]["iter"],
                                               ref[k]["x_sha"]):
                    print(f"{root} {k}: iterations or bits differ from "
                          f"{root_a}'s", file=sys.stderr)
                    return 1
    if a.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    print(json.dumps({root: {k: statistics.median(
        t for res in turns for t in res[k]["ms_per_it"]) for k in turns[0]}
        for root, turns in results.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
