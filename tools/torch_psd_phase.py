#!/usr/bin/env python3
"""Phase 12 of chip_smoke.py alone on the card: build the kernels, then
the PSD and complex-PSD cones' projections against float64 numpy eigh,
the large PSD program in three modes and the PSD batch of 1024 in three
modes with BatchWorkspace on 64 lanes, every gate of the phase.

    python tools/torch_psd_phase.py

For iterating on the PSD path without the other phases' ~15 minutes.
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
        print("torch_psd_phase: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(card)
    t0 = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    chip_smoke.psd_phase(card)
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
