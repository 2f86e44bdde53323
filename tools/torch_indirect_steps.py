#!/usr/bin/env python3
"""Times the indirect backend of scs_tpu_torch on its two main-path
problems, with the CG blocks run eagerly or as CUDA graphs, in turns:

  * the large planted SOCP of bench.py's large_socp_leg (n=2048, m=8192,
    seed 7, density 0.3), mixed (the card's default) and pure float64:
    ms per ADMM iteration, CG iterations and host reads per iteration;
  * the headline batch (z=40, l=120, eight SOC blocks, n=100; seeds from
    1000) at --batch lanes through make_chunked_batch_solver in the
    default mode: ms per lockstep step, CG iterations per lane-iteration,
    lane-iterations/s.

    python tools/torch_indirect_steps.py [--batch 256] [--max-iters N]
        [--n 2048] [--skip-socp] [--device cuda]

Prints one line per run, beside the card's name and power limit. On the
CPU (--device cpu, small --batch) it runs the plain versions: CPU rates,
for rehearsal only.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from scs_tpu_torch import Settings, Workspace  # noqa: E402
from scs_tpu_torch.demo_socp import make_spec  # noqa: E402
from scs_tpu_torch.linsys import indirect  # noqa: E402
from scs_tpu_torch.models import gen_planted  # noqa: E402
from scs_tpu_torch.parallel import make_chunked_batch_solver  # noqa: E402
from scs_tpu_torch.types import ConeSpec  # noqa: E402


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def cg_blocks(graphs: bool):
    """The CG blocks as CUDA graphs (the solver's own path) or, with
    `graphs` False, launched one kernel at a time (`_pcg(eager=True)`)."""
    pcg = indirect._pcg
    if not graphs:
        indirect._pcg = functools.partial(pcg, eager=True)
    try:
        yield
    finally:
        indirect._pcg = pcg


def large_socp(device, graphs: bool, n: int, max_iters: int) -> None:
    spec = make_spec(n, 0.1, np.random.RandomState(7))
    p = gen_planted(spec, n=n, seed=7, density=0.3)
    for mode, stg in (("mixed", Settings(mixed_precision=True,
                                         max_iters=max_iters)),
                      ("pure f64", Settings(mixed_precision=False,
                                            max_iters=max_iters))):
        indirect.host_reads = 0
        ws = Workspace(p.problem, spec, p.cone_data, stg, device=device,
                       ds_split=device.type == "cuda" and stg.mixed_precision)
        _sync(device)
        t0 = time.perf_counter()
        with cg_blocks(graphs):
            _, info = ws.solve()
            _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        it = max(info.iter, 1)
        print(f"large SOCP n={n} indirect {mode}, graphs {graphs}: "
              f"{info.status}, {info.iter} iterations, {ms / it:.3f} "
              f"ms/iteration, {ws.tot_cg_its / it:.1f} CG iterations and "
              f"{indirect.host_reads / it:.2f} host reads per iteration, "
              f"pobj {info.pobj!r} (planted {p.opt!r})", flush=True)


def headline_batch(device, graphs: bool, B: int, max_iters: int) -> None:
    head = ConeSpec(z=40, l=120, q=(20, 34, 14, 51, 22, 31, 1, 67))
    probs = [gen_planted(head, n=100, seed=1000 + i, density=0.1)
             for i in range(B)]
    A, b, c = (torch.stack([getattr(q.problem, k) for q in probs]).to(device)
               for k in ("A", "b", "c"))
    bnd = torch.zeros(B, 0, dtype=torch.float64, device=device)
    indirect.host_reads = 0
    stg = Settings(chunk_iters=250, mixed_precision=True,
                   max_iters=max_iters)
    solver = make_chunked_batch_solver(head, stg, device=device,
                                       ds_split=True)
    _sync(device)
    t0 = time.perf_counter()
    with cg_blocks(graphs):
        res = solver(A, b, c, bnd, bnd)
        status = res.status.cpu().numpy()
    wall = time.perf_counter() - t0
    iters = res.iters.cpu().numpy()
    steps = sum(lv[3] for lv in solver.levels)
    opts = np.asarray([q.opt for q in probs])
    err = np.abs(res.pobj.cpu().numpy() - opts) / (1 + np.abs(opts))
    cg = int(res.tot_cg_its.sum())
    print(f"headline batch B={B} indirect mixed (float32 state "
          f"{solver.machinery.f32_state}), graphs {graphs}: "
          f"{int((status == 1).sum())}/{B} solved, wall {wall:.3f} s, "
          f"{int(iters.sum())} lane-iterations (max {iters.max()}), "
          f"{iters.sum() / wall:.0f} lane-iterations/s, {steps} steps, "
          f"{wall / max(steps, 1) * 1e3:.3f} ms/step, "
          f"{cg / max(iters.sum(), 1):.1f} CG iterations per "
          f"lane-iteration, {indirect.host_reads / max(steps, 1):.1f} host "
          f"reads per step, max pobj rel err {err.max():.2e}, levels "
          f"{[(ph, bk, al, k, round(s, 2)) for ph, bk, al, k, s in solver.levels]}",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--n", type=int, default=2048,
                    help="large SOCP width (m = 4n)")
    ap.add_argument("--max-iters", type=int, default=100000,
                    help="iteration cap of every solve (Settings.max_iters)")
    ap.add_argument("--skip-socp", action="store_true")
    a = ap.parse_args()
    device = torch.device(a.device)
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        print(card, flush=True)
    for graphs in (True, False) if device.type == "cuda" else (False,):
        if not a.skip_socp:
            large_socp(device, graphs, a.n, a.max_iters)
        headline_batch(device, graphs, a.batch, a.max_iters)


if __name__ == "__main__":
    main()
