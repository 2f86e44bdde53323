#!/usr/bin/env python3
"""Phase 16 of chip_smoke.py alone on the card: build the kernels, then
differentiation through the solve (reverse and forward mode at the
headline widths, the box, exp and power cones against the CPU), the
one-rank NCCL group and the five examples, every gate of the phase, one
after another in this process (chip_smoke.py runs (a) and (d) in
processes of their own beside phases 11-14).

    python tools/torch_diff_phase.py [--examples-only | --no-examples]

For iterating on the phase without the other phases' ~15 minutes.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from scs_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_diff_phase: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line())
    t0 = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    batch = chip_smoke.headline_batch(chip_smoke.HEADLINE, 64, 1000)
    if "--examples-only" in sys.argv:
        chip_smoke.examples_on_the_card()
    elif "--no-examples" in sys.argv:
        chip_smoke.diff_headline(False)
        chip_smoke.diff_headline(True)
        chip_smoke.diff_small_cones()
        chip_smoke.nccl_one_rank(batch)
    else:
        # the phase's parts one after another, in this process
        chip_smoke.diff_headline(False)
        chip_smoke.diff_headline(True)
        chip_smoke.diff_small_cones()
        chip_smoke.nccl_one_rank(batch)
        chip_smoke.examples_on_the_card()
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
