"""Phase 17 of chip_smoke.py alone on the card: the kernels' build, then
row sharding (two gloo ranks on the one card, a (1, 2) mesh) with its
gates and the unsharded references.

    python tools/torch_rowshard_phase.py [--lanes 0,5,...]

The float32-state part solves 8 lanes of the headline batch's first 64:
`--lanes`, or else the 8 with the fewest iterations in an unsharded
float32-state solve of the 64 capped at 3000 iterations (chip_smoke.py
takes them from phase 5's solve). Prints what phase 17 prints and the
phase's wall time.
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.chdir(ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", default=None)
    args = ap.parse_args()
    if not cs.torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line())
    t0 = time.perf_counter()
    cs._build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    if args.lanes:
        easy = np.asarray([int(i) for i in args.lanes.split(",")])
    else:
        from scs_tpu_torch.parallel import make_batch_solver
        batch = cs.headline_batch(cs.HEADLINE, 64, 1000)
        e = cs.torch.zeros(64, 0, dtype=cs.torch.float64, device="cuda")
        res = make_batch_solver(cs.HEADLINE, cs.Settings(**cs.ROWSHARD_F32),
                                max_iters=3000)(*batch[:3], e, e)
        iters = res.iters.cpu().numpy()
        easy = np.sort(np.argsort(iters, kind="stable")[:8])
        print(f"lanes {easy.tolist()}: {iters[easy].tolist()} iterations "
              f"(float32 state, unsharded)")
    cs.atexit.register(cs.BatchChild.stop_all)
    rows = cs.rowshard_rows()
    t1 = time.perf_counter()
    cs.rowshard_phase(cs.rowshard_start(easy), rows, easy)
    print(f"phase 17 wall {time.perf_counter() - t1:.1f} s")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
