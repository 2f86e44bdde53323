#!/usr/bin/env python3
"""The mixed-cone headline batch of chip_smoke.py phase 11
(`models/mixed_cones.headline_mixed_spec`, n = 100, m = 400, seeds from
1000) on one CUDA card, solved by make_chunked_batch_solver with the
direct backend in up to four modes:

  * "pure f64": Settings(mixed_precision=False);
  * "mixed, float64 state": Settings(fast_f32=False);
  * "mixed, float64 state, exp float32": the same with exp_f32=True (the
    JAX package's precision for the exp cones on the mixed fast phase);
  * "mixed, float32 state" (the default; with --f32-state).

    python3 tools/torch_mixed_cone_gates.py [--batch 1024] [--f32-state] \\
        [--large] [--out mixed_cone_gates.json]

For each mode: wall, lane-iterations, the statuses, each lane's distance
|pobj - opt| / (1 + |opt|) to the planted optimum (the five largest, with
their seeds), the seeds of the lanes that fail SCS's termination test
recomputed in float64 (chip_smoke.termination_failures), and each lane's
objective distance to the pure-f64 run's, |pobj - pobj64| / (1 + |pobj64|).
--large also solves the large mixed-cone program (n = 2048, m = 8192)
through Workspace, direct mixed, with exp in float64 and in float32.
Every lane's numbers go to --out, beside the card's nvidia-smi name and
power limit.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from scs_tpu_torch import Settings, Workspace  # noqa: E402
from scs_tpu_torch.models import mixed_cones  # noqa: E402
from scs_tpu_torch.ops import _build  # noqa: E402
from scs_tpu_torch.parallel import make_chunked_batch_solver  # noqa: E402

SEED0 = 1000
TOP = 5


def run_mode(spec, batch, stg, label, pure=None) -> dict:
    A, b, c, opts, bu, bl = batch
    solver = make_chunked_batch_solver(spec, stg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver(A, b, c, bu, bl)
    status = res.status.cpu().numpy()
    wall = time.perf_counter() - t0
    iters = res.iters.cpu().numpy()
    pobj = res.pobj.cpu().numpy()
    err = np.abs(pobj - opts) / (1 + np.abs(opts))
    fails = cs.termination_failures(batch, res, stg)
    out = {"mode": label, "wall_s": wall,
           "lane_iterations": int(iters.sum()), "max_iters": int(iters.max()),
           "statuses": {int(k): int(v) for k, v in
                        zip(*np.unique(status, return_counts=True))},
           "iters": iters.tolist(), "pobj": pobj.tolist(),
           "planted_err": err.tolist(),
           "fails": {k: (SEED0 + np.flatnonzero(v)).tolist()
                     for k, v in fails.items()}}
    top = np.argsort(-err, kind="stable")[:TOP]
    line = (f"{label}: wall {wall:.3f} s, {out['lane_iterations']} "
            f"lane-iterations (max {out['max_iters']}), statuses "
            f"{out['statuses']}, planted error max {err.max():.3e}, "
            f"largest (seed: error, iterations) "
            f"{', '.join(f'{SEED0 + i}: {err[i]:.3e}, {iters[i]}' for i in top)}"
            f"; seeds failing SCS's termination test "
            f"{ {k: v for k, v in out['fails'].items() if v} }")
    if pure is not None:
        pobj64 = np.asarray(pure["pobj"])
        agree = np.abs(pobj - pobj64) / (1 + np.abs(pobj64))
        out["vs_pure"] = agree.tolist()
        i = int(np.argmax(agree))
        line += (f"; objective vs pure f64 max {agree[i]:.3e} (seed "
                 f"{SEED0 + i}), lanes with equal iterations to pure "
                 f"{int((iters == np.asarray(pure['iters'])).sum())}")
    print(line, flush=True)
    return out


def large(exp_f32: bool) -> dict:
    spec = mixed_cones.large_mixed_spec()
    p = mixed_cones.gen_mixed(spec, 2048, 7, 0.3)
    ws = Workspace(p.problem, spec, p.cone_data,
                   Settings(linsys="direct", exp_f32=exp_f32))
    t0 = time.perf_counter()
    sol, info = ws.solve()
    wall = time.perf_counter() - t0
    err = abs(info.pobj - p.opt) / (1 + abs(p.opt))
    print(f"large mixed cones direct mixed, exp {'float32' if exp_f32 else 'float64'}: "
          f"{info.status}, {info.iter} iterations, {wall:.3f} s, pobj "
          f"{info.pobj!r} (planted {p.opt!r}, error {err:.3e})", flush=True)
    return {"exp_f32": exp_f32, "status": info.status, "iter": info.iter,
            "wall_s": wall, "pobj": info.pobj, "opt": p.opt, "err": err}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--f32-state", action="store_true")
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    _build.build()
    spec = mixed_cones.headline_mixed_spec()
    batch = cs.headline_batch(spec, args.batch, SEED0, bounds=True)
    base = dict(linsys="direct", chunk_iters=250)
    runs = [run_mode(spec, batch, Settings(mixed_precision=False, **base),
                     "pure f64")]
    modes = [("mixed, float64 state", dict(fast_f32=False)),
             ("mixed, float64 state, exp float32",
              dict(fast_f32=False, exp_f32=True))]
    if args.f32_state:
        modes.append(("mixed, float32 state", {}))
    for label, kw in modes:
        runs.append(run_mode(spec, batch, Settings(**base, **kw), label,
                             runs[0]))
    out = {"card": card, "batch": args.batch, "runs": runs}
    if args.large:
        out["large"] = [large(False), large(True)]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f)
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
