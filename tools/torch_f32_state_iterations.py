"""Lane-iterations of the port's mixed batched solve with float32 state
(`Settings.fast_f32`) against float64 state, on the headline family
(z=40, l=120, eight SOC blocks, n=100, density 0.1) and on the same
family with its zero-cone rows made nonnegative rows (z=0, l=160).

The float32-state phase straggles on the headline family; this script
separates the zero cone, whose rows carry r_y = 1/(1000 scale), from the
rest of the problem.

    python tools/torch_f32_state_iterations.py --device cpu --lanes 16

On the CPU the mixed path runs the kernels' plain versions (ds_split);
on "cuda" it runs the CUDA kernels. Each line gives one (zero rows,
state) pair: the sum, median and max of the per-lane iterations.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from scs_tpu_torch import Settings  # noqa: E402
from scs_tpu_torch.models import gen_planted  # noqa: E402
from scs_tpu_torch.parallel import make_chunked_batch_solver  # noqa: E402
from scs_tpu_torch.types import ConeSpec  # noqa: E402

SOC = (20, 34, 14, 51, 22, 31, 1, 67)


def run(z: int, f32_state: bool, lanes: int, seed0: int, device: str,
        max_iters: int) -> np.ndarray:
    spec = ConeSpec(z=z, l=160 - z, q=SOC)
    probs = [gen_planted(spec, n=100, seed=seed0 + i, density=0.1)
             for i in range(lanes)]
    A, b, c = (torch.stack([getattr(p.problem, k) for p in probs]).to(device)
               for k in ("A", "b", "c"))
    bnd = torch.zeros(lanes, 0, dtype=torch.float64, device=device)
    stg = Settings(linsys="direct", chunk_iters=250, mixed_precision=True,
                   fast_f32=f32_state, max_iters=max_iters)
    solver = make_chunked_batch_solver(
        spec, stg, device=device,
        ds_split=True if device == "cpu" else None)
    res = solver(A, b, c, bnd, bnd)
    if not bool((res.status == 1).all()):
        raise RuntimeError(f"z={z} float32 state {f32_state}: statuses "
                           f"{res.status.tolist()}")
    return res.iters.cpu().numpy()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=16)
    ap.add_argument("--seed0", type=int, default=1000)
    ap.add_argument("--max-iters", type=int, default=20000)
    args = ap.parse_args()
    for z in (40, 0):
        for f32_state in (True, False):
            it = run(z, f32_state, args.lanes, args.seed0, args.device,
                     args.max_iters)
            print(f"zero rows {z:2d}, {'float32' if f32_state else 'float64'}"
                  f" state: lane-iterations {int(it.sum())}, median "
                  f"{float(np.median(it)):g}, max {int(it.max())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
