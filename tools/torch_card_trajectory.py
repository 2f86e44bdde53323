#!/usr/bin/env python3
"""Where the card's trajectory of one small indirect solve leaves the
CPU's: the planted instance of tests/test_torch_cuda.py's indirect test
(z=5, l=20, q=(5, 5, 5, 10), n=30, seed 3, density 0.3), pure float64,
indirect backend, stepped one iteration at a time through
`Workspace._iteration.step` on the card and on the CPU from the same
start.

    python tools/torch_card_trajectory.py [--seed 3] [--iters 400]

Prints the largest difference between the card's and the CPU's
equilibrated A, scalings D and E and Jacobi preconditioner, then, for
each of two runs of the card (its CG blocks as CUDA graphs, the solver's
path; and eager, `indirect._pcg(eager=True)`), the first iteration at
which the iterates u and v differ at all and by more than 1e-12 relative
to max(1, |u|), the first iteration whose CG iteration count differs,
the difference every 25 iterations, and each device's iteration count
at termination. Needs a CUDA card.
"""

import argparse
import functools
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from scs_tpu_torch import Settings, Workspace, config  # noqa: E402
from scs_tpu_torch.linsys import indirect  # noqa: E402
from scs_tpu_torch.models import gen_planted  # noqa: E402
from scs_tpu_torch.types import ConeSpec  # noqa: E402


def trajectory(ws: Workspace, iters: int):
    """(u, v, CG iterations) after each iteration, on the host, and the
    iteration count at termination."""
    st = ws._init_state(None)
    out = []
    cg_prev = 0
    while st.status == config.UNFINISHED and st.iter < iters:
        st = ws._iteration.step(ws.data, st)
        cg = int(st.tot_cg_its)
        out.append((st.u.double().cpu().numpy(), st.v.double().cpu().numpy(),
                    cg - cg_prev))
        cg_prev = cg
    return out, st.iter


def rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(1.0, float(np.abs(b).max())))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--iters", type=int, default=400)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_card_trajectory: no CUDA device", file=sys.stderr)
        return 1
    spec = ConeSpec(z=5, l=20, q=(5, 5, 5, 10))
    p = gen_planted(spec, n=30, seed=args.seed, density=0.3)
    stg = Settings(mixed_precision=False)
    cpu = Workspace(p.problem, spec, p.cone_data, stg, device="cpu")
    ref, ref_it = trajectory(cpu, args.iters)
    card = Workspace(p.problem, spec, p.cone_data, stg)
    for name, a, b in (("A", card.data.A, cpu.data.A),
                       ("D", card.data.scal.D, cpu.data.scal.D),
                       ("E", card.data.scal.E, cpu.data.scal.E),
                       ("Jacobi M", card.derived, cpu.derived)):
        print(f"setup: {name} card against CPU, max relative difference "
              f"{rel(a.cpu().numpy(), b.numpy()):.3e}")
    pcg = indirect._pcg
    for mode in ("CG as CUDA graphs", "CG eager"):
        if mode == "CG eager":
            indirect._pcg = functools.partial(pcg, eager=True)
        try:
            card = Workspace(p.problem, spec, p.cone_data, stg)
            got, got_it = trajectory(card, args.iters)
        finally:
            indirect._pcg = pcg
        n = min(len(got), len(ref))
        diffs = [max(rel(got[k][0], ref[k][0]), rel(got[k][1], ref[k][1]))
                 for k in range(n)]
        first_any = next((k + 1 for k in range(n) if diffs[k] > 0), None)
        first_big = next((k + 1 for k in range(n) if diffs[k] > 1e-12), None)
        first_cg = next((k + 1 for k in range(n)
                         if got[k][2] != ref[k][2]), None)
        print(f"{mode}: card {got_it} iterations, CPU {ref_it}; first "
              f"iteration differing at all {first_any}, by more than 1e-12 "
              f"{first_big}; first iteration with another CG count "
              f"{first_cg}" + (f" (card {got[first_cg - 1][2]}, CPU "
                               f"{ref[first_cg - 1][2]})" if first_cg
                               else ""))
        print(f"{mode}: difference after iterations "
              + ", ".join(f"{k}: {diffs[k - 1]:.2e}"
                          for k in [1, 2, 3, 5, 10] + list(range(25, n + 1,
                                                                  25))
                          if k <= n))
        if first_big:
            k = first_big
            print(f"{mode}: CG counts around iteration {k}: card "
                  f"{[g[2] for g in got[max(k - 4, 0):k + 2]]}, CPU "
                  f"{[r[2] for r in ref[max(k - 4, 0):k + 2]]}")
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
