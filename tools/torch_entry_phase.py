#!/usr/bin/env python3
"""Phase 15 of chip_smoke.py alone on the card: build the kernels, then
the entry points (the tracked-rank PSD projection on the planted low-rank
SDP, the large PSD program and 64 lanes of the PSD batch; files, compat,
the CLI; checkpoint/resume; the CSV trace, the phase timers and verbose on
the large SOCP), every gate of the phase.

    python tools/torch_entry_phase.py

For iterating on the entry points without the other phases' ~15 minutes.
"""

import atexit
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from scs_tpu_torch.demo_socp import make_spec  # noqa: E402
from scs_tpu_torch.models import gen_planted  # noqa: E402
from scs_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_entry_phase: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line())
    t0 = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    # its psd_rank batch in a process of its own, as chip_smoke.py runs it
    atexit.register(chip_smoke.BatchChild.stop_all)
    child = chip_smoke.BatchChild("psd-rank")
    spec = make_spec(2048, 0.1, np.random.RandomState(7))
    big_p = gen_planted(spec, n=2048, seed=7, density=0.3)
    head_p = gen_planted(chip_smoke.HEADLINE, n=100, seed=1000, density=0.1)
    chip_smoke.entry_phase(head_p, big_p, spec, child)
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
