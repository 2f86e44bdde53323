#!/usr/bin/env python3
"""How much one float32-state batch's lockstep step slows when other
processes step their batches on the same card at the same time.

    python tools/torch_shared_card_steps.py [--steps 300] [--lanes 8]

chip_smoke.py runs the float32-state batches of its phases 11, 12 and 13
(mixed cones, PSD, spectral) each in a process of its own, beside its
other phases. Their steps are host-bound (5-9 ms of launches and syncs a
step, the card 5-10 % busy), so processes can overlap on one card; what
they cost each other is this tool's question. It times up to `--steps`
steps of the batched solver's fast phase (float32 state, as the default
mixed solve runs it; from a cold start after 25 warm-up steps, lanes that
converge sooner leaving the step to the others) on the first `--lanes`
lanes of each family: each family alone on the card, then the three at
once, every process in its own Python with its own CUDA context. Prints
ms a step, alone and shared, per family, and the card's name and power
limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from scs_tpu_torch import Settings  # noqa: E402
from scs_tpu_torch.linsys import direct  # noqa: E402
from scs_tpu_torch.models import (mixed_cones, psd_cones,  # noqa: E402
                                  spectral_cones)
from scs_tpu_torch.parallel import batch as batch_mod  # noqa: E402
from scs_tpu_torch.parallel import make_solver_parts  # noqa: E402
from scs_tpu_torch.solver_batched import BatchedIteration  # noqa: E402

FAMILIES = ("mixed-cone", "psd", "spectral")


def worker(family: str, lanes: int, steps: int, start_at: float) -> dict:
    """`steps` fast-phase steps of `lanes` lanes of `family`, started at
    the wall-clock time `start_at`: ms a step."""
    torch.set_num_threads(1)
    spec = {"mixed-cone": mixed_cones.headline_mixed_spec,
            "psd": psd_cones.headline_psd_spec,
            "spectral": spectral_cones.headline_spectral_spec}[family]()
    batch = chip_smoke.headline_batch(spec, lanes, 1000,
                                      bounds=family == "mixed-cone")
    stg = Settings(linsys="direct")
    init_fn, _, _ = make_solver_parts(spec, stg)
    data, st = init_fn(batch[0], None, batch[1], batch[2], *batch[4:])
    fdata, st0 = batch_mod.f32_view(batch_mod._floored_data(data), st,
                                    direct)
    it32 = BatchedIteration(spec, stg, True, f32_state=True)
    it32.run(fdata, st0, 25)
    torch.cuda.synchronize()
    while time.time() < start_at:
        time.sleep(0.01)
    t0 = time.perf_counter()
    st, _, ran = it32.run(fdata, st0, steps)
    st.u.sum().item()
    return {"family": family, "steps": ran,
            "ms_per_step": (time.perf_counter() - t0) * 1e3 / max(ran, 1)}


def run_together(families, lanes: int, steps: int) -> list:
    start_at = time.time() + 30.0
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", fam,
         "--lanes", str(lanes), "--steps", str(steps), "--start-at",
         repr(start_at)], stdout=subprocess.PIPE, text=True)
        for fam in families]
    out = []
    for p in procs:
        text, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"a worker failed ({p.returncode})")
        out.append(json.loads(text.strip().splitlines()[-1]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--worker")
    ap.add_argument("--start-at", type=float, default=0.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_shared_card_steps: no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        print(json.dumps(worker(args.worker, args.lanes, args.steps,
                                args.start_at)))
        return 0
    print(chip_smoke.card_line())
    alone = {}
    for fam in FAMILIES:
        alone[fam] = run_together([fam], args.lanes, args.steps)[0]
    shared = {r["family"]: r for r in run_together(FAMILIES, args.lanes,
                                                   args.steps)}
    for fam in FAMILIES:
        a, s = alone[fam]["ms_per_step"], shared[fam]["ms_per_step"]
        print(f"{fam} B={args.lanes} float32 state, {alone[fam]['steps']} "
              f"steps: alone {a:.3f} ms/step, beside the other two "
              f"{s:.3f} ms/step ({s / a:.2f}x)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
