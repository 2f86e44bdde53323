#!/usr/bin/env python3
"""Where the logdet cascade kernel's launch time goes (K6,
`scs_tpu_torch/csrc/logdet.cu`), on phase 13's inputs
(`chip_smoke.logdet_kernel_inputs`: 1024 cones of order 6, one of 60,
four of 16).

For each case the kernel is timed (`chip_smoke.median_ms`: CUDA events,
L2 flushed, device time) on all cones, on the cones that Newton settles
alone (info < 1000) and on the cones that run the IPM. Then every cone is timed alone (CUDA events, median of
3, no flush), and for the slowest the script prints its Newton
iterations, the trial points of its Newton line searches, its IPM
iterations and merit evaluations (the plain version's counts on the CPU,
`chip_smoke.logdet_plain_work`). Where
the tree has `ops/sumlargest.empty_launch`, an empty kernel's launch is
timed the same way, the floor of a launch.

    python tools/torch_logdet_chain.py [--tree DIR] [--out FILE]

`--tree DIR` times the kernel of another checkout (the parent unpacked
into the gitignored chip_check/, say) with this tree's inputs and timer;
the JSON goes to `--out` (default chiprun_out/logdet_chain.json).
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke(tree: str):
    """This tree's chip_smoke.py, importing scs_tpu_torch from `tree`."""
    sys.path.insert(0, os.path.abspath(tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def _alone_ms(fn, reps: int = 3) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "logdet_chain.json"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_logdet_chain: no CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke(a.tree)
    from scs_tpu_torch.models import spectral_cones
    from scs_tpu_torch.ops import logdet
    card = cs.card_line()
    print(card)
    print(f"kernel of {os.path.abspath(a.tree)} "
          f"({os.path.dirname(logdet.__file__)})")
    cases = (cs.logdet_kernel_inputs(spectral_cones.headline_spectral_spec(),
                                     (1024,), 300)
             + cs.logdet_kernel_inputs(spectral_cones.large_spectral_spec(),
                                       (), 310))
    from scs_tpu_torch.ops import sumlargest
    floor = (cs.median_ms(sumlargest.empty_launch)
             if hasattr(sumlargest, "empty_launch") else None)
    print(f"empty kernel launch: {floor} ms")
    rows = []
    for ns, count, args in cases:
        dev = [x.cuda() for x in args]
        info = logdet.logdet_cone(*dev)[3].cpu()
        row = {"ns": ns, "cones": count, "empty_ms": floor,
               "all_ms": cs.median_ms(lambda: logdet.logdet_cone(*dev))}
        for name, mask in (("newton", info < 1000), ("ipm", info >= 1000)):
            idx = torch.nonzero(mask).squeeze(-1)
            row[f"{name}_cones"] = int(idx.numel())
            row[f"{name}_ms"] = None
            if idx.numel():
                sub = [x[idx.cuda()] for x in dev]
                row[f"{name}_ms"] = cs.median_ms(
                    lambda sub=sub: logdet.logdet_cone(*sub))
        alone = [_alone_ms(lambda i=i: logdet.logdet_cone(
            *(x[i:i + 1] for x in dev))) for i in range(count)]
        slow = max(range(count), key=alone.__getitem__)
        row.update(slowest=slow, slowest_alone_ms=alone[slow],
                   slowest_info=int(info[slow]),
                   **cs.logdet_plain_work([x[slow:slow + 1]
                                           for x in args])[1])
        newton_alone = [t for t, i in zip(alone, info.tolist()) if i < 1000]
        row["newton_alone_ms_max"] = max(newton_alone, default=None)
        print(f"logdet_cone ns={ns} cones={count}: all {row['all_ms']:.4f} "
              f"ms; {row['newton_cones']} Newton-only cones "
              f"{row['newton_ms'] or 0:.4f} ms (slowest alone "
              f"{row['newton_alone_ms_max'] or 0:.4f}); {row['ipm_cones']} "
              f"IPM cones {row['ipm_ms'] or 0:.4f} ms; slowest cone {slow} "
              f"alone {alone[slow]:.4f} ms, info {row['slowest_info']}: "
              f"Newton {row['newton_its']} iterations, "
              f"{row['newton_trials']} trial points (at most "
              f"{row['newton_trials_max']} a search), IPM iterations "
              f"{row['ipm_its']}, merit evaluations at least "
              f"{row['ipm_merits']} (plain version)")
        rows.append(row)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump({"card": card, "tree": os.path.abspath(a.tree),
                   "cases": rows}, f, indent=1)
    print(json.dumps({"cases": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
