#!/usr/bin/env python3
"""Phase 14 of chip_smoke.py alone on the card: build the kernels, then
the sparse (blocked-ELL) kernel rows, the demo_sparse instance through
the indirect backend mixed and pure float64, the cut instance through the
direct backend (sparse against dense) and twice through the indirect
backend, with every gate of the phase, and the profile of 25 mixed
iterations of the instance that phase 9 takes.

    python tools/torch_sparse_phase.py [--stages K]

--stages: the instance's stage count (500, the full size, by default;
fewer for a quick check of a change). For iterating on the sparse path
without the other phases' ~14 minutes.
"""

import argparse
import os
import sys
import time
import types

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from scs_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", type=int, default=500)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sparse_phase: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(card)
    t0 = time.perf_counter()
    for name, res in _build.build().items():
        print(f"build {name}: {res['seconds']:.1f} s")
    print(f"build {time.perf_counter() - t0:.1f} s")
    out = chip_smoke.sparse_phase(card, args.stages)
    chip_smoke.profile_iterations(
        types.SimpleNamespace(problem=out["prob"], cone_data=None),
        out["spec"], True, 25, "demo_sparse indirect mixed",
        linsys="indirect")
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
