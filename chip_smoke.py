#!/usr/bin/env python3
"""Drives scs_tpu_torch's main path on one CUDA card and checks it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit; build every kernel from csrc/;
  2. each kernel against its plain PyTorch version at the shapes the main
     path gives it, with times (CUDA events, median of 30 launches, L2
     flushed before each) beside the least time the card could take and
     beside one PyTorch library call that computes the same function;
  3. the main path: the large planted SOCP of bench.py's large_socp_leg
     (n=2048, m=8192, density 0.3) solved through Workspace on the card,
     mixed precision (the default there), with the kernel launch counts
     read around the solve; then the same instance in pure float64;
  4. the headline problem of bench.py (z=40, l=120, 8 SOC blocks, n=100);
  5. a profile of 100 iterations of the large SOCP, mixed and pure
     (launches, device busy share, the kernels that take the most device
     time, the operators that take the most host time).
The second-to-last line is a JSON object with one entry per kernel, the
last line {"ok": true, "device": {...}}.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from scs_tpu_torch import Settings, Workspace
from scs_tpu_torch.demo_socp import make_spec
from scs_tpu_torch.models import gen_planted
from scs_tpu_torch.ops import _build, dsmatvec
from scs_tpu_torch.types import ConeSpec

# H100 SXM, NVIDIA's data sheet: HBM3 bandwidth and float64 (non-tensor)
# peak, both at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
REPS = 30


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


_flush = None


def median_ms(fn) -> float:
    """Median time of one call of fn on the card, the 50 MB L2 flushed
    before each timed call."""
    global _flush
    if _flush is None:
        _flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        _flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ds_matvec_case(m: int, n: int, seed: int) -> dict:
    """K1 against its plain version at one (m, n); times of the kernel,
    the plain version and torch.mv on the float64 matrix."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(m, n, generator=gen, dtype=torch.float64, device="cuda")
    x = torch.randn(n, generator=gen, dtype=torch.float64, device="cuda")
    split = dsmatvec.split_operand(A)
    A64 = split.hi.double() + split.lo.double()
    y = dsmatvec.ds_matvec(split, x)
    torch.cuda.synchronize()
    ref = dsmatvec.ds_matvec_plain(split, x)
    err = float((y - ref).abs().max())
    tol = 1e-12 * float((A64.abs() @ x.abs()).max())
    check(math.isfinite(err) and err <= tol,
          f"ds_matvec {m}x{n}: max|kernel - plain| = {err:.3e} > {tol:.3e}")
    nbytes = 8 * m * n + 8 * n + 8 * m      # hi+lo read, x read, y written
    flops = 3 * m * n                        # hi+lo add, then an FMA
    bound = max(nbytes / HBM_BYTES_PER_S, flops / FP64_FLOPS) * 1e3
    return {
        "shape": [m, n], "max_abs_err": err, "tol": tol,
        "ms": median_ms(lambda: dsmatvec.ds_matvec(split, x)),
        "plain_ms": median_ms(lambda: dsmatvec.ds_matvec_plain(split, x)),
        "library_ms": median_ms(lambda: torch.mv(A64, x)),
        "bound_ms": bound,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / FP64_FLOPS else "operations"),
    }


def solve_planted(p, spec, label):
    """Planted problem solved on the card, mixed (the default there) and
    pure float64; returns the mixed run's numbers."""
    n = p.x.shape[0]
    torch.cuda.synchronize()
    dsmatvec.launches = 0
    ws = Workspace(p.problem, spec, p.cone_data, Settings(linsys="direct"))
    sol, info = ws.solve()
    torch.cuda.synchronize()
    launches = dsmatvec.launches
    check(ws._mixed, f"{label}: the default solve on the card is not mixed")
    err = abs(info.pobj - p.opt) / (1 + abs(p.opt))
    print(f"{label} mixed: {info.status}, {info.iter} iterations, setup "
          f"{info.setup_time:.1f} ms, solve {info.solve_time:.1f} ms, "
          f"{info.solve_time / max(info.iter, 1):.3f} ms/iteration, "
          f"pobj {info.pobj!r} (planted {p.opt!r}, rel err {err:.2e}), "
          f"ds_matvec launches {launches}")
    check(info.status == "solved", f"{label} mixed: status {info.status}")
    check(err <= 1e-3, f"{label} mixed: objective error {err:.2e}")
    check(np.all(np.isfinite(sol.x)) and sol.x.shape == (n,),
          f"{label} mixed: x not finite of shape ({n},)")
    check(launches >= 4 * info.iter,
          f"{label}: {launches} ds_matvec launches < 4 x {info.iter}")

    dsmatvec.launches = 0
    ws64 = Workspace(p.problem, spec, p.cone_data,
                     Settings(linsys="direct", mixed_precision=False))
    _, info64 = ws64.solve()
    print(f"{label} pure f64: {info64.status}, {info64.iter} iterations, "
          f"setup {info64.setup_time:.1f} ms, solve {info64.solve_time:.1f}"
          f" ms, {info64.solve_time / max(info64.iter, 1):.3f} ms/iteration,"
          f" pobj {info64.pobj!r}, ds_matvec launches "
          f"{dsmatvec.launches}")
    check(info64.status == info.status,
          f"{label}: pure status {info64.status} != mixed {info.status}")
    agree = abs(info.pobj - info64.pobj) / (1 + abs(info64.pobj))
    check(agree <= 1e-3, f"{label}: mixed vs pure pobj differ by {agree:.2e}")
    return {"iter": info.iter, "setup_ms": info.setup_time,
            "solve_ms": info.solve_time, "launches": launches}


def warm_workspace(p, spec, mixed: bool, iters: int):
    """A workspace capped at `iters` iterations, solved once, with the
    ms per iteration of that solve (allocator, library handles and kernel
    modules were set up by the solves before it)."""
    stg = Settings(linsys="direct", mixed_precision=mixed, max_iters=iters)
    ws = Workspace(p.problem, spec, p.cone_data, stg)
    _, info = ws.solve()
    torch.cuda.synchronize()
    return ws, info.solve_time / max(info.iter, 1)


def profile_iterations(p, spec, mixed: bool, iters: int, label: str) -> None:
    """Where the time of `iters` iterations goes: host wall time per
    iteration, device busy time per iteration (kernels and copies seen by
    torch.profiler), CUDA launches per iteration, and the kernels that
    take the most device time and the operators that take the most host
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ws, _ = warm_workspace(p, spec, mixed, iters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, info = ws.solve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, launches, by_name = 0.0, 0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                        "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += 1
    it = max(info.iter, 1)
    print(f"{label} profile, {info.iter} iterations (setup "
          f"{info.setup_time:.1f} ms): wall {wall_ms / it:.3f} ms/iteration "
          f"under the profiler, {launches / it:.1f} CUDA launches/iteration")
    if not by_name:
        print(f"{label} profile: device time not measured (the profiler "
              f"saw no device events)")
        return
    print(f"{label} profile: device busy {busy_us / 1e3 / it:.3f} "
          f"ms/iteration, {100 * busy_us / 1e3 / wall_ms:.1f}% of wall")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us / 1e3 / it:8.4f} ms/iteration  {name[:100]}")
    print(f"{label} profile: host time by operator (self)")
    ops = sorted(prof.key_averages(), key=lambda k: -k.self_cpu_time_total)
    for k in ops[:10]:
        print(f"    {k.self_cpu_time_total / 1e3 / it:8.4f} ms/iteration "
              f"{k.count / it:6.1f} calls/iteration  {k.key[:80]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 1. build every kernel from the checkout's sources
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, res in built.items():
        print(f"  {name}: {res['seconds']:.1f} s")
        for line in res["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")

    # 2. K1 against its plain version at the main path's shapes
    n_big, m_big = 2048, 8192
    shapes = [(m_big, n_big), (n_big, m_big), (n_big, n_big),  # A, A', K
              (400, 100), (100, 400),                          # headline
              (37, 101), (7, 3), (16, 3000)]                   # ragged
    cases = [ds_matvec_case(m, n, seed=i) for i, (m, n) in enumerate(shapes)]
    for c in cases:
        print(f"ds_matvec {c['shape'][0]}x{c['shape'][1]}: max_abs_err "
              f"{c['max_abs_err']:.3e} (tol {c['tol']:.3e}), kernel "
              f"{c['ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']}), plain {c['plain_ms']:.4f} ms, torch.mv "
              f"{c['library_ms']:.4f} ms")

    # host cost of one call: the wrapper's checks and the ctypes launch,
    # against torch.mv's dispatch, at a size where the device is idle
    split = dsmatvec.split_operand(torch.ones(7, 3, dtype=torch.float64,
                                              device="cuda"))
    x = torch.ones(3, dtype=torch.float64, device="cuda")
    host_us = {}
    for name, fn in (("ds_matvec", lambda: dsmatvec.ds_matvec(split, x)),
                     ("torch.mv", lambda: torch.mv(split.hi, split.lo[0]))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        host_us[name] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    print(f"host time per call, 7x3, 1000 calls: ds_matvec "
          f"{host_us['ds_matvec']:.1f} us, torch.mv {host_us['torch.mv']:.1f}"
          f" us")

    # 3. the main path: the large SOCP, counts set to 0 just before
    spec = make_spec(n_big, 0.1, np.random.RandomState(7))
    big_p = gen_planted(spec, n=n_big, seed=7, density=0.3)
    big = solve_planted(big_p, spec, "large SOCP")
    per_launch = statistics.mean(
        [cases[0]["ms"], cases[1]["ms"], cases[2]["ms"], cases[2]["ms"]])
    print(f"large SOCP: ds_matvec {big['launches']} launches x "
          f"{per_launch:.4f} ms (mean of A, A', K, K) = "
          f"{big['launches'] * per_launch:.1f} ms, "
          f"{100 * big['launches'] * per_launch / big['solve_ms']:.1f}% "
          f"of solve time")

    # 4. the headline problem
    head = ConeSpec(z=40, l=120, q=(20, 34, 14, 51, 22, 31, 1, 67))
    solve_planted(gen_planted(head, n=100, seed=1000, density=0.1), head,
                  "headline")

    # 5. where the time of an iteration goes, mixed and pure, on the large
    # SOCP (100 iterations each): first unprofiled, in turns, then under
    # the profiler. Last: the profiler's tracing may slow launches after
    # it stops, so nothing timed above runs after it.
    turns = {True: [], False: []}
    for mixed in (True, False, False, True):
        turns[mixed].append(warm_workspace(big_p, spec, mixed, 100)[1])
    print(f"large SOCP, 100 iterations, warm, in turns mixed, pure, pure, "
          f"mixed: mixed {turns[True][0]:.3f}, {turns[True][1]:.3f} "
          f"ms/iteration; pure f64 {turns[False][0]:.3f}, "
          f"{turns[False][1]:.3f} ms/iteration")
    profile_iterations(big_p, spec, True, 100, "large SOCP mixed")
    profile_iterations(big_p, spec, False, 100, "large SOCP pure f64")

    main_case = cases[0]
    kernels = [{
        "name": "ds_matvec", "route": "cuda",
        "source": "scs_tpu_torch/csrc/dsmatvec.cu",
        "replaces": "scs_tpu/ops/dsmatvec.py:91",
        "launches": big["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
