#!/usr/bin/env python3
"""Where a small batch's lockstep step goes on the card: 8 lanes of the
headline family with SOC, PSD and spectral cones, 100 float32-state steps
of each under torch.profiler (`chip_smoke.profile_batched`: wall and
device busy time a step, CUDA launches a step, the top kernels and host
operators).

    python tools/torch_batch_step_profile.py [--lanes 8] [--steps 100]

The float32-state batches' straggler lanes run thousands of such steps
for a handful of lanes; this shows what each of them costs.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from scs_tpu_torch.models import psd_cones, spectral_cones  # noqa: E402
from scs_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_batch_step_profile: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line())
    _build.build()
    for name, spec in (("soc", chip_smoke.HEADLINE),
                       ("psd", psd_cones.headline_psd_spec()),
                       ("spectral", spectral_cones.headline_spectral_spec())):
        batch = chip_smoke.headline_batch(spec, args.lanes, 1000)
        chip_smoke.profile_batched(spec, batch, args.steps,
                                   f" {name} {args.lanes} lanes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
