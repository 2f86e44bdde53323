#!/usr/bin/env python3
"""How far last-bit rounding moves the iteration count of one solve: the
planted instance of tests/test_torch_cuda.py's
test_indirect_solve_on_the_card_matches_the_plain_version (z=5, l=20,
q=(5, 5, 5, 10), n=30, seed 3, density 0.3) through Workspace, once as
generated and then --runs - 1 times with b changed by one ulp, up or
down, in a random third of its entries (numpy seed 0), each count
printed. The indirect backend's CG stops on data-dependent tests, so a
1-ulp change can move the ADMM count by a check interval (25).

    python tools/torch_iteration_spread.py [--device cpu] [--mixed] \\
        [--linsys indirect] [--runs 12]

Pure float64 unless --mixed; on "cuda" (the default) the CG blocks run
as CUDA graphs and --mixed goes through the K1 kernel, on "cpu" through
the kernels' plain versions.
"""

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from scs_tpu_torch import Settings, Workspace  # noqa: E402
from scs_tpu_torch.models import gen_planted  # noqa: E402
from scs_tpu_torch.types import ConeSpec  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mixed", action="store_true")
    ap.add_argument("--linsys", default="indirect")
    ap.add_argument("--runs", type=int, default=12)
    args = ap.parse_args()
    spec = ConeSpec(z=5, l=20, q=(5, 5, 5, 10))
    p = gen_planted(spec, n=30, seed=3, density=0.3)
    rng = np.random.RandomState(0)
    kw = {} if args.device == "cuda" else dict(device="cpu",
                                               ds_split=args.mixed)
    stg = Settings(linsys=args.linsys, mixed_precision=args.mixed)
    counts = []
    for k in range(args.runs):
        prob = p.problem
        if k:
            ulp = np.spacing(np.abs(prob.b.numpy()))
            step = rng.choice([-1.0, 0.0, 1.0], ulp.shape) * ulp
            prob = dataclasses.replace(
                prob, b=prob.b + torch.as_tensor(step, dtype=prob.b.dtype))
        _, info = Workspace(prob, spec, p.cone_data, stg, **kw).solve()
        counts.append(info.iter)
    print(f"{args.linsys} {'mixed' if args.mixed else 'pure f64'} on "
          f"{args.device}: iterations as generated {counts[0]}, with b "
          f"moved by one ulp {counts[1:]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
