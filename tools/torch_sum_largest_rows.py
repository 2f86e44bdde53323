#!/usr/bin/env python3
"""The sum-of-k-largest kernel's times (K7, `scs_tpu_torch/csrc/
sumlargest.cu`) on phase 13's inputs (`chip_smoke.sum_largest_kernel_inputs`:
1024 cones of order 6 with k = 2, one of 40 with k = 4), beside an empty
kernel's launch, the floor of a launch (where the tree has
`ops/sumlargest.empty_launch`). Times are `chip_smoke.median_ms`: CUDA
events, L2 flushed, device time.

    python tools/torch_sum_largest_rows.py [--tree DIR] [--sweep] [--out FILE]

`--tree DIR` times the kernel of another checkout (the parent unpacked
into the gitignored chip_check/, say) with this tree's inputs and timer.
`--sweep` (a tree with `sumlargest.STAGE_MIN_N`) also times 1024 cones
and one cone at n = 4 .. 64, k = n // 3, with the rows staged in shared
memory and read in place, the data behind STAGE_MIN_N. The JSON goes to
`--out` (default chiprun_out/sum_largest_rows.json).
"""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_NS = (4, 6, 8, 10, 12, 14, 16, 20, 24, 32, 40, 64)


def _chip_smoke(tree: str):
    """This tree's chip_smoke.py, importing scs_tpu_torch from `tree`."""
    sys.path.insert(0, os.path.abspath(tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def _sweep(cs, sumlargest) -> list:
    """[(n, cones, staged ms, in place ms)]: launch_config forced each way
    through STAGE_MIN_N."""
    rng = np.random.RandomState(5)
    rows = []
    keep = sumlargest.STAGE_MIN_N
    try:
        for n in SWEEP_NS:
            for count in (1024, 1):
                x = -torch.sort(-torch.as_tensor(
                    rng.randn(count, n) * 2.0)).values.cuda()
                t0 = torch.as_tensor(rng.randn(count) * 2.0).cuda()
                k = max(1, n // 3)
                times = []
                for stage_min in (0, n + 1):
                    sumlargest.STAGE_MIN_N = stage_min
                    times.append(cs.median_ms(
                        lambda: sumlargest.sum_largest_sorted(t0, x, k)))
                rows.append({"n": n, "cones": count, "k": k,
                             "staged_ms": times[0], "in_place_ms": times[1]})
                print(f"n={n} cones={count} k={k}: staged {times[0]:.4f} ms,"
                      f" in place {times[1]:.4f} ms")
    finally:
        sumlargest.STAGE_MIN_N = keep
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "sum_largest_rows.json"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sum_largest_rows: no CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke(a.tree)
    from scs_tpu_torch.models import spectral_cones
    from scs_tpu_torch.ops import sumlargest
    card = cs.card_line()
    print(card)
    print(f"kernel of {os.path.abspath(a.tree)} "
          f"({os.path.dirname(sumlargest.__file__)})")
    floor = (cs.median_ms(sumlargest.empty_launch)
             if hasattr(sumlargest, "empty_launch") else None)
    print(f"empty kernel launch: {floor} ms")
    rows = []
    for spec, lead, seed in (
            (spectral_cones.headline_spectral_spec(), (1024,), 320),
            (spectral_cones.large_spectral_spec(), (), 330)):
        for ns, k, count, args in cs.sum_largest_kernel_inputs(spec, lead,
                                                               seed):
            dev = [x.cuda() for x in args]
            ms = cs.median_ms(lambda: sumlargest.sum_largest_sorted(*dev, k))
            layout = (tuple(sumlargest.launch_config(ns))
                      if hasattr(sumlargest, "launch_config") else None)
            rows.append({"ns": ns, "k": k, "cones": count, "ms": ms,
                         "layout": layout})
            print(f"sum_largest_sorted n={ns} k={k} cones={count}: "
                  f"{ms:.4f} ms, layout {layout}")
    sweep = (_sweep(cs, sumlargest)
             if a.sweep and hasattr(sumlargest, "STAGE_MIN_N") else None)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    out = {"card": card, "tree": os.path.abspath(a.tree), "empty_ms": floor,
           "cases": rows, "sweep": sweep}
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"empty_ms": floor, "cases": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
