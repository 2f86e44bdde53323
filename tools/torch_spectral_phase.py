#!/usr/bin/env python3
"""Phase 13 of chip_smoke.py alone on the card: build the kernels, then
the logdet kernel against its plain version, the spectral cones'
projections against the CPU's, the large spectral program in three modes
and the spectral batch in three modes, every gate of the phase.

    python tools/torch_spectral_phase.py

For iterating on the spectral path without the other phases' ~17 minutes.
"""

import atexit
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
        print("torch_spectral_phase: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(card)
    t0 = time.perf_counter()
    for name, res in _build.build().items():
        print(f"build {name}: {res['seconds']:.1f} s")
        for line in _build.resources(res["log"]):
            print(f"  {line}")
    print(f"build {time.perf_counter() - t0:.1f} s")
    # its float32-state batch in a process of its own, as chip_smoke.py
    # runs it
    atexit.register(chip_smoke.BatchChild.stop_all)
    chip_smoke.spectral_phase(card, chip_smoke.BatchChild("spectral"))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
