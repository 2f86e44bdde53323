#!/usr/bin/env python3
"""Drives scs_tpu_torch's main path on one CUDA card and checks it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit; build every kernel from csrc/;
  2. each kernel against its plain PyTorch version at the shapes the main
     path gives it and at one shape for each variant its launcher picks,
     with times (CUDA events, device time only, median of 30 launches,
     L2 flushed before each) beside the least time the card could take,
     the share of it reached, and one PyTorch library call that computes
     the same function;
  3. the main path: the large planted SOCP of bench.py's large_socp_leg
     (n=2048, m=8192, density 0.3) solved through Workspace on the card,
     mixed precision (the default there), with the kernel launch counts
     read around the solve; then the same instance in pure float64;
  4. the headline problem of bench.py (z=40, l=120, 8 SOC blocks, n=100);
  5. the headline batch of bench.py: B=1024 problems of that family
     (seeds 1000-2023) through make_chunked_batch_solver, mixed (the
     default there, its fast phase with float32 state) with the launch
     counts of kernels K2 and K3 read around the solve; then the same
     batch mixed with float64 state (fast_f32=False) and in pure float64;
  6. BatchWorkspace at B=64 in its default mode (mixed, float32 state;
     the 64 lanes whose phase-5 solve was shortest): a cold solve, b
     shifted by 1 %, a warm solve; then the first 64 lanes at eps 1e-7,
     mixed with float64 state, below the fast phase's floor, so that
     every lane goes through the polish phase;
  7. the indirect backend (the default `Settings.linsys`): the large SOCP
     mixed (the card's default) and pure float64, with its CG iterations
     and host reads, against the planted optimum and the direct solve;
     then the headline batch at B=1024 in the default mode (mixed,
     float32 state) and mixed with float64 state, every lane held to
     SCS's termination test;
  8. the roofline probe `roofline.measure(n=4096, iters=400, reps=3)`,
     the path of kernel K5, and K4's entry point `ds_matmul`;
  9. a profile of 100 iterations of the large SOCP, mixed and pure, and
     mixed through the indirect backend, and of 50 batched steps of the
     headline batch's float32-state phase (launches, device busy share,
     the kernels that take the most device time, the operators that take
     the most host time), and the batched Anderson QR against
     torch.linalg.qr.
Phase 2 also holds K2 and K3 against their plain versions at the batched
shapes, and K4 and K5 against theirs.
Phases 3-6 run the direct backend (`Settings(linsys="direct")`).
The second-to-last line is a JSON object with one entry per kernel (K1-K5),
the last line {"ok": true, "device": {...}}.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from scs_tpu_torch import Settings, Workspace, accel
from scs_tpu_torch.demo_socp import make_spec
from scs_tpu_torch.linsys import direct, indirect
from scs_tpu_torch.models import gen_planted
from scs_tpu_torch.ops import _build, dsmatmul, dsmatvec, roofline
from scs_tpu_torch.parallel import (BatchWorkspace,
                                    make_chunked_batch_solver,
                                    make_solver_parts)
from scs_tpu_torch.parallel import batch as batch_mod
from scs_tpu_torch.solver_batched import BatchedIteration
from scs_tpu_torch.types import ConeSpec

# H100 SXM, NVIDIA's data sheet: HBM3 bandwidth, float64 peak outside
# and inside the tensor cores, float32 peak outside them, all at the full
# 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
FP64_TENSOR_FLOPS = 67e12
FP32_FLOPS = 67e12
REPS = 30

# bench.py's headline family (_headline_problem): n = 100, m = 400
HEADLINE = ConeSpec(z=40, l=120, q=(20, 34, 14, 51, 22, 31, 1, 67))


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


# cycles the card spins before each timed call (~0.5 ms at 1.98 GHz), so
# that the host has enqueued the whole call before its start event runs
SPIN_CYCLES = 1_000_000


def median_ms(fn, spin: bool = True) -> float:
    """Median device time of one call of fn on the card, the 50 MB L2
    flushed before each timed call. With `spin`, the card spins
    (torch.cuda._sleep) between the flush and the start event while the
    host enqueues the call, so the time is the device's alone and not the
    host's launch cost. Without it, as timed before the spin was added,
    the host's enqueue time is counted too wherever it outlasts the
    flush."""
    global _flush
    if spin and not hasattr(torch.cuda, "_sleep"):
        raise RuntimeError("median_ms: this PyTorch has no torch.cuda._sleep"
                           ", which the device-time timer spins the card "
                           "with")
    if _flush is None:
        _flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        _flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def both_timers(kernel, library) -> dict:
    """The kernel's and the library call's times with the spin, and again
    without it (`*_no_spin`), the timer that includes the host's enqueue."""
    return {"ms": median_ms(kernel), "library_ms": median_ms(library),
            "ms_no_spin": median_ms(kernel, spin=False),
            "library_ms_no_spin": median_ms(library, spin=False)}


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
        **both_timers(lambda: dsmatvec.ds_matvec(split, x),
                      lambda: torch.mv(A64, x)),
        "plain_ms": median_ms(lambda: dsmatvec.ds_matvec_plain(split, x)),
        "bound_ms": bound,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / FP64_FLOPS else "operations"),
    }


def ds_matvec_batched_case(B: int, m: int, n: int, seed: int,
                           strided: bool = False, x32: bool = False,
                           pair: bool = False) -> dict:
    """K2 (or K3, `pair`) against its plain version at one (B, m, n), each
    lane held to 1e-12 max(|A[b]| |x[b]|) (K3: the pair's sum); times of
    the kernel, the plain version and torch.matmul on the float64 stack.
    strided: x is a column slice of a wider (B, n + 13) tensor, as the
    solver passes u[:, :n]. x32: x in float32 (the float32-state
    phase)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(B, m, n, generator=gen, dtype=torch.float64,
                    device="cuda")
    if strided:
        x = torch.randn(B, n + 13, generator=gen, dtype=torch.float64,
                        device="cuda")[:, 5:5 + n]
    else:
        x = torch.randn(B, n, generator=gen, dtype=torch.float64,
                        device="cuda")
    if x32:
        x = x.to(torch.float32)
    split = dsmatvec.split_operand(A)
    A64 = split.hi.double() + split.lo.double()
    if pair:
        kernel, plain = (dsmatvec.ds_matvec_pair_batched,
                         dsmatvec.ds_matvec_pair_batched_plain)
    else:
        kernel, plain = (dsmatvec.ds_matvec_batched,
                         dsmatvec.ds_matvec_batched_plain)

    def value(out):
        return out.hi.double() + out.lo.double() if pair else out.double()

    y = value(kernel(split, x))
    torch.cuda.synchronize()
    ref = value(plain(split, x))
    x64 = x.double()
    err_lane = (y - ref).abs().amax(dim=1)
    tol_lane = 1e-12 * torch.matmul(A64.abs(), x64.abs().unsqueeze(-1)
                                    ).squeeze(-1).amax(dim=1)
    if x32 and not pair:
        # a float32 y: both sides round the float64 sum once
        tol_lane = tol_lane + 2.0 ** -23 * ref.abs().amax(dim=1)
    err = float(err_lane.max())
    name = "ds_matvec_pair_batched" if pair else "ds_matvec_batched"
    check(bool(torch.isfinite(err_lane).all())
          and bool((err_lane <= tol_lane).all()),
          f"{name} {B}x{m}x{n}: max|kernel - plain| = {err:.3e} above "
          f"its limit in some lane")
    xb, yb = (4 if x32 else 8), (8 if pair or not x32 else 4)
    nbytes = 8 * B * m * n + xb * B * n + yb * B * m
    flops = 3 * B * m * n
    bound = max(nbytes / HBM_BYTES_PER_S, flops / FP64_FLOPS) * 1e3
    xc = x64.unsqueeze(-1)
    return {
        "name": name, "shape": [B, m, n], "strided_x": strided,
        "x32": x32, "max_abs_err": err, "tol": float(tol_lane.min()),
        **both_timers(lambda: kernel(split, x),
                      lambda: torch.matmul(A64, xc)),
        "plain_ms": median_ms(lambda: plain(split, x)),
        "bound_ms": bound,
        "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                     >= flops / FP64_FLOPS else "operations"),
    }


def ds_matmul_case(ashape, bshape, seed: int) -> dict:
    """K4 against its plain version at one pair of shapes, held to 1e-13
    max(|A| |B|) (both sum the same exact float64 products in another
    order); times of the kernel, the plain version and torch.matmul on
    the float64 stack (the yardstick, timed only here)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(*ashape, generator=gen, dtype=torch.float64,
                    device="cuda")
    B = torch.randn(*bshape, generator=gen, dtype=torch.float64,
                    device="cuda")
    a, b = dsmatvec.split_operand(A), dsmatvec.split_operand(B)
    A64 = a.hi.double() + a.lo.double()
    B64 = b.hi.double() + b.lo.double()
    C = dsmatmul.ds_matmul_pairs(a, b)
    torch.cuda.synchronize()
    ref = dsmatmul.ds_matmul_plain(a, b)
    err = float((C - ref).abs().max())
    tol = 1e-13 * float(torch.matmul(A64.abs(), B64.abs()).max())
    check(math.isfinite(err) and err <= tol,
          f"ds_matmul {ashape}x{bshape}: max|kernel - plain| = {err:.3e} "
          f"> {tol:.3e}")
    nb, m, k = ashape
    n = bshape[2]
    nbytes = 8 * nb * (m * k + k * n) + 8 * nb * m * n
    flops = 2 * nb * m * n * k
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / FP64_TENSOR_FLOPS
    return {
        "shape": [list(ashape), list(bshape)], "max_abs_err": err,
        "tol": tol,
        **both_timers(lambda: dsmatmul.ds_matmul_pairs(a, b),
                      lambda: torch.matmul(A64, B64)),
        "plain_ms": median_ms(lambda: dsmatmul.ds_matmul_plain(a, b)),
        "bound_ms": max(by_bytes, by_ops) * 1e3,
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
    }


def read_rowsum_case(m: int, n: int, seed: int, split: bool) -> dict:
    """K5 against its plain version at one (m, n), each row held to
    4 ceil(log2 n) 2^-24 sum |a + b| (float32 sums in two orders; the
    kernel adds at most 39 terms in sequence at these shapes); times of
    the kernel, the plain version and a.sum(1) + b.sum(1) (no single
    PyTorch call computes this function: that pair of calls reads the
    same bytes and stands beside it, not as its yardstick). split: a and
    b are the (hi, lo) split of a float64 matrix, the probe's input;
    else b is of a's magnitude, where a kernel that dropped b or read a
    twice would miss the limit by orders of magnitude."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if split:
        a, b = dsmatvec.split_operand(torch.randn(
            m, n, generator=gen, dtype=torch.float64, device="cuda"))
    else:
        a = torch.randn(m, n, generator=gen, device="cuda")
        b = torch.randn(m, n, generator=gen, device="cuda")
    o = roofline.read_rowsum(a, b)
    torch.cuda.synchronize()
    ref = roofline.read_rowsum_plain(a, b)
    err_row = (o - ref).abs()
    tol_row = (4 * math.ceil(math.log2(n)) * 2.0 ** -24
               * (a + b).abs().sum(1, keepdim=True))
    check(bool(torch.isfinite(err_row).all())
          and bool((err_row <= tol_row).all()),
          f"read_rowsum {m}x{n} ({'split' if split else 'b like a'}): "
          f"max|kernel - plain| = {float(err_row.max()):.3e} above its "
          f"limit in some row")
    nbytes = 2 * 4 * m * n + 4 * m
    flops = 2 * m * n
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return {
        "shape": [m, n], "split": split, "max_abs_err": float(err_row.max()),
        "tol": float(tol_row.min()),
        "ms": median_ms(lambda: roofline.read_rowsum(a, b)),
        "plain_ms": median_ms(lambda: roofline.read_rowsum_plain(a, b)),
        "two_sums_ms": median_ms(lambda: a.sum(1) + b.sum(1)),
        "library_ms": None,
        "bound_ms": max(by_bytes, by_ops) * 1e3,
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
    }


def headline_batch(spec, B: int, seed0: int):
    """B planted problems of the headline family, stacked on the card."""
    probs = [gen_planted(spec, n=100, seed=seed0 + i, density=0.1)
             for i in range(B)]
    A, b, c = (torch.stack([getattr(p.problem, k) for p in probs]).cuda()
               for k in ("A", "b", "c"))
    return A, b, c, np.asarray([p.opt for p in probs])


def verify_termination(batch, res, stg, label) -> None:
    """SCS's termination test for every lane, recomputed in float64 from
    the original A, b, c and the returned x, y, s (the reference test
    suite's verify_solution_correct, test/problem_utils.h:107-249):
    primal and dual residuals and the gap within eps_abs + eps_rel times
    their scale, with 1 % slack for the round-off between this recomputation
    and the solver's own check."""
    A, b, c, _ = batch
    x, y, s = res.x, res.y, res.s
    ax = torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)
    aty = torch.matmul(A.transpose(1, 2), y.unsqueeze(-1)).squeeze(-1)
    ctx, bty = (c * x).sum(1), (b * y).sum(1)

    def inf(t):
        return t.abs().amax(1)

    tests = {
        "res_pri": (inf(ax + s - b),
                    torch.maximum(torch.maximum(inf(b), inf(s)), inf(ax))),
        "res_dual": (inf(aty + c), torch.maximum(inf(c), inf(aty))),
        "gap": ((ctx + bty).abs(), torch.maximum(ctx.abs(), bty.abs())),
    }
    for name, (val, scl) in tests.items():
        lim = 1.01 * (stg.eps_abs + stg.eps_rel * scl)
        bad = int((~(val <= lim)).sum())
        check(bad == 0, f"{label}: {bad} lanes fail SCS's {name} test "
              f"recomputed from the original data")


def solve_batch(spec, batch, stg, label, tol=1e-3):
    """The batch through make_chunked_batch_solver on the card, with the
    K2 and K3 launch counts read around the solve. Returns the numbers."""
    A, b, c, opts = batch
    B = A.shape[0]
    bnd = torch.zeros(B, 0, dtype=torch.float64, device="cuda")
    solver = make_chunked_batch_solver(spec, stg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dsmatvec.launches = 0
    dsmatvec.batched_launches = 0
    dsmatvec.pair_launches = 0
    indirect.host_reads = 0
    indirect.refine_passes = 0
    t0 = time.perf_counter()
    res = solver(A, b, c, bnd, bnd)
    status = res.status.cpu().numpy()
    wall = time.perf_counter() - t0
    launches = dsmatvec.batched_launches
    pair = dsmatvec.pair_launches
    check(dsmatvec.launches == 0, f"{label}: the batch launched K1")
    iters = res.iters.cpu().numpy()
    pobj = res.pobj.cpu().numpy()
    steps = sum(lv[3] for lv in solver.levels)
    by_phase = {}
    for lv in solver.levels:
        by_phase[lv[0]] = by_phase.get(lv[0], 0) + lv[3]
    err = np.abs(pobj - opts) / (1 + np.abs(opts))
    levels = [(ph, bk, al, n, round(sec, 3))
              for ph, bk, al, n, sec in solver.levels]
    cg = int(res.tot_cg_its.sum())
    cg_note = (f", CG iterations {cg} ({cg / max(int(iters.sum()), 1):.1f} "
               f"per lane-iteration), CG host reads {indirect.host_reads} "
               f"({indirect.host_reads / max(steps, 1):.1f} per step), "
               f"refinement passes {indirect.refine_passes} "
               f"({indirect.refine_passes / max(steps, 1):.2f} per step)"
               if stg.linsys == "indirect" else "")
    slow = np.argsort(-iters, kind="stable")[:3]
    print(f"{label}: B={B}, wall {wall:.3f} s, {int(iters.sum())} "
          f"lane-iterations ({iters.min()}-{iters.max()} per lane, median "
          f"{int(np.median(iters))}; slowest lanes (lane: iterations) "
          f"{', '.join(f'{i}: {iters[i]}' for i in slow)}), "
          f"{iters.sum() / wall:.0f} "
          f"lane-iterations/s, {steps} lockstep steps, "
          f"{wall / max(steps, 1) * 1e3:.3f} ms/step, levels (phase, "
          f"bucket, alive at end, steps, s) {levels}, "
          f"{solver.machinery.polished} lanes polished, float32 state "
          f"{solver.machinery.f32_state}, K2 launches {launches}, K3 "
          f"launches {pair}, max pobj rel err {err.max():.2e}, max res_pri "
          f"{float(res.res_pri.max()):.2e}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB{cg_note}")
    check(bool(np.all(status == 1)),
          f"{label}: statuses {np.unique(status, return_counts=True)}")
    check(bool(np.all(err <= tol)), f"{label}: objective error "
          f"{err.max():.2e} above {tol:.0e}")
    check(bool(torch.isfinite(res.x).all()), f"{label}: x not finite")
    verify_termination(batch, res, stg, label)
    return {"status": status, "pobj": pobj, "iters": iters, "wall": wall,
            "steps": steps, "launches": launches, "pair": pair,
            "by_phase": by_phase, "polished": solver.machinery.polished,
            "f32_state": solver.machinery.f32_state,
            "cg": int(res.tot_cg_its.sum())}


def warm_batch(spec, batch):
    """BatchWorkspace on the card in its default mode (mixed, fast phase
    with float32 state): cold solve, b shifted by 1 %, warm solve (the
    examples/mpc_warm_batch.py pattern), the K3 launches of the
    float32-state phase counted around the two solves."""
    A, b, c, _ = batch
    ws = BatchWorkspace(spec, Settings(linsys="direct", chunk_iters=250),
                        A, None, b, c)
    check(ws.machinery.f32_state, "BatchWorkspace: the default mixed solve "
          "on the card does not run float32 state")
    torch.cuda.synchronize()
    dsmatvec.pair_launches = 0
    t0 = time.perf_counter()
    cold = ws.solve()
    cold_it = cold.iters.cpu().numpy()
    t1 = time.perf_counter()
    ws.update(b=b * 1.01)
    warm = ws.solve(warm_start=True)
    warm_it = warm.iters.cpu().numpy()
    t2 = time.perf_counter()
    pair = dsmatvec.pair_launches
    print(f"BatchWorkspace B={A.shape[0]}, float32 state: cold "
          f"{int(cold_it.sum())} lane-iterations (max {cold_it.max()}) in "
          f"{t1 - t0:.3f} s, warm after b *= 1.01 {int(warm_it.sum())} "
          f"lane-iterations (max {warm_it.max()}) in {t2 - t1:.3f} s, K3 "
          f"launches {pair}, warm levels "
          f"{[(ph, bk, al, n, round(sec, 3)) for ph, bk, al, n, sec in ws.levels]}")
    for label, r in (("cold", cold), ("warm", warm)):
        check(bool((r.status == 1).all()),
              f"BatchWorkspace {label}: not every lane solved")
    check(pair > 0, "BatchWorkspace: no K3 launch, so no float32-state step")
    check(warm_it.sum() < cold_it.sum(),
          f"BatchWorkspace: warm {warm_it.sum()} lane-iterations not below "
          f"cold {cold_it.sum()}")


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
            "solve_ms": info.solve_time, "launches": launches,
            "pobj64": info64.pobj}


def solve_indirect(p, spec, label, direct_pobj: float):
    """The planted problem through the indirect backend on the card, mixed
    (the default there) and pure float64, each with its counts set to 0
    just before: status, ADMM and CG iterations, ms per iteration, K1
    launches and the CG loops' host reads, and the objective against the
    planted optimum and the direct solve. The direct runs' gates."""
    out = {}
    for mode, stg in (("mixed", Settings()),
                      ("pure f64", Settings(mixed_precision=False))):
        torch.cuda.synchronize()
        dsmatvec.launches = 0
        indirect.host_reads = 0
        indirect.refine_passes = 0
        ws = Workspace(p.problem, spec, p.cone_data, stg)
        sol, info = ws.solve()
        torch.cuda.synchronize()
        launches, reads = dsmatvec.launches, indirect.host_reads
        passes = indirect.refine_passes
        it = max(info.iter, 1)
        err = abs(info.pobj - p.opt) / (1 + abs(p.opt))
        agree = abs(info.pobj - direct_pobj) / (1 + abs(direct_pobj))
        print(f"{label} indirect {mode}: {info.status}, {info.iter} "
              f"iterations, {ws.tot_cg_its} CG iterations "
              f"({ws.tot_cg_its / it:.1f} per iteration), setup "
              f"{info.setup_time:.1f} ms, solve {info.solve_time:.1f} ms, "
              f"{info.solve_time / it:.3f} ms/iteration, ds_matvec launches "
              f"{launches} ({launches / it:.2f} per iteration), CG host reads "
              f"{reads} ({reads / it:.2f} per iteration), refinement passes "
              f"{passes} ({passes / it:.2f} per iteration), pobj "
              f"{info.pobj!r} (planted {p.opt!r}, rel err {err:.2e}; direct "
              f"{direct_pobj!r}, rel diff {agree:.2e})")
        check(info.lin_sys_solver == indirect.METHOD_NAME,
              f"{label} indirect {mode}: solved by {info.lin_sys_solver}")
        check(info.status == "solved",
              f"{label} indirect {mode}: status {info.status}")
        check(err <= 1e-3, f"{label} indirect {mode}: objective error "
              f"{err:.2e}")
        check(agree <= 1e-3, f"{label} indirect {mode}: objective differs "
              f"from the direct solve's by {agree:.2e}")
        check(np.all(np.isfinite(sol.x)), f"{label} indirect {mode}: x not "
              f"finite")
        out[mode] = {"iter": info.iter, "cg": ws.tot_cg_its,
                     "solve_ms": info.solve_time, "launches": launches,
                     "reads": reads, "mixed": ws._mixed}
    check(out["mixed"]["mixed"] and out["mixed"]["launches"] >= 2 *
          out["mixed"]["iter"], f"{label} indirect: the default solve on the "
          f"card is not mixed or launched K1 {out['mixed']['launches']} "
          f"times in {out['mixed']['iter']} iterations")
    check(out["pure f64"]["launches"] == 0,
          f"{label} indirect pure f64 launched K1")
    return out


def warm_workspace(p, spec, mixed: bool, iters: int,
                   linsys: str = "direct"):
    """A workspace capped at `iters` iterations, solved once, with the
    ms per iteration of that solve (allocator, library handles and kernel
    modules were set up by the solves before it)."""
    stg = Settings(linsys=linsys, mixed_precision=mixed, max_iters=iters)
    ws = Workspace(p.problem, spec, p.cone_data, stg)
    _, info = ws.solve()
    torch.cuda.synchronize()
    return ws, info.solve_time / max(info.iter, 1)


def profile_iterations(p, spec, mixed: bool, iters: int, label: str,
                       linsys: str = "direct") -> None:
    """Where the time of `iters` iterations goes: host wall time per
    iteration, device busy time per iteration (kernels and copies seen by
    torch.profiler), CUDA launches per iteration, and the kernels that
    take the most device time and the operators that take the most host
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ws, _ = warm_workspace(p, spec, mixed, iters, linsys)
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


def profile_batched(spec, batch, steps: int) -> None:
    """`profile_iterations` for `steps` lockstep steps of the batched
    solver's fast phase as the default mixed solve runs it on the card:
    float32 state, floored targets."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    A, b, c, _ = batch
    stg = Settings(linsys="direct")
    init_fn, _, _ = make_solver_parts(spec, stg)
    data, st = init_fn(A, None, b, c)
    fdata, st0 = batch_mod.f32_view(batch_mod._floored_data(data), st,
                                    direct)
    it32 = BatchedIteration(spec, stg, True, f32_state=True)
    it32.run(fdata, st0, steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = it32.run(fdata, st0, steps)[0]
        st.u.sum().item()
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
    ran = int(st.iter.max())
    label = f"batch B={A.shape[0]} mixed float32-state profile"
    print(f"{label}, {ran} steps from a cold start: wall "
          f"{wall_ms / ran:.3f} ms/step under the profiler, "
          f"{launches / ran:.1f} CUDA launches/step")
    if not by_name:
        print(f"{label}: device time not measured (the profiler saw no "
              f"device events)")
        return
    print(f"{label}: device busy {busy_us / 1e3 / ran:.3f} ms/step, "
          f"{100 * busy_us / 1e3 / wall_ms:.1f}% of wall")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us / 1e3 / ran:8.4f} ms/step  {name[:100]}")
    print(f"{label}: host time by operator (self)")
    ops = sorted(prof.key_averages(), key=lambda k: -k.self_cpu_time_total)
    for k in ops[:10]:
        print(f"    {k.self_cpu_time_total / 1e3 / ran:8.4f} ms/step "
              f"{k.count / ran:6.1f} calls/step  {k.key[:80]}")


def anderson_qr_times(B: int, L: int, mem: int) -> None:
    """The batched Anderson step's least-squares factorization at the
    headline batch's shape, float32 (the mixed path's gammas): the port's
    batched Householder QR against torch.linalg.qr on the same stack
    followed by Q'c, each the median of 30 calls."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    A_aug = torch.randn(B, L, mem, generator=gen, device="cuda")
    c_aug = torch.randn(B, L, 1, generator=gen, device="cuda")
    R, qc = accel._householder_apply(A_aug, c_aug)
    Q, R_lib = torch.linalg.qr(A_aug, mode="reduced")
    qc_lib = Q.transpose(1, 2) @ c_aug
    # the two agree up to the signs of R's rows
    sgn = torch.sign(torch.diagonal(R, dim1=1, dim2=2)
                     * torch.diagonal(R_lib, dim1=1, dim2=2))
    diff = float((qc - sgn.unsqueeze(-1) * qc_lib).abs().max())
    check(diff <= 1e-3 * float(qc_lib.abs().max()),
          f"Anderson QR: batched Householder and torch.linalg.qr differ by "
          f"{diff:.2e}")
    ours = median_ms(lambda: accel._householder_apply(A_aug, c_aug))

    def lib():
        Qm, _ = torch.linalg.qr(A_aug, mode="reduced")
        return Qm.transpose(1, 2) @ c_aug

    print(f"Anderson QR ({B}, {L}, {mem}) float32: batched Householder "
          f"{ours:.4f} ms, torch.linalg.qr + Q'c {median_ms(lib):.4f} ms, "
          f"max |Q'c difference| {diff:.2e}")


# phase 2's rows; tools/torch_kernel_rows.py times the same rows for two
# trees in one run on one card
K1_SHAPES = [(8192, 2048), (2048, 8192), (2048, 2048),  # large SOCP A, A', K
             (400, 100), (100, 400),                    # headline
             (37, 101), (7, 3), (16, 3000),             # ragged
             (128, 128), (64, 200), (64, 1000),         # 8, 16, 64 a row
             (128, 129)]                                # A unaligned, n 129
# (B, m, n, x strided, x float32, pair output)
K2_SHAPES = [(1024, 400, 100, False, False, False),     # A, float64 state
             (1024, 100, 400, False, False, False),     # A'
             (1024, 100, 100, False, False, False),     # K
             (3, 37, 101, False, False, False),         # ragged
             (1024, 400, 100, True, False, False),      # x a slice
             (1024, 400, 100, False, True, False),      # A, float32 state
             (1024, 100, 400, True, True, False),       # A' y, a slice
             (1, 2048, 2048, True, False, False)]       # B = 1, x a slice
K3_SHAPES = [(1024, 100, 100, False, True, True),       # K3: G x
             (3, 37, 101, False, True, True),           # ragged
             (1024, 100, 100, True, True, True)]        # x a slice
K4_SHAPES = [((2, 37, 53), (2, 53, 29)),                # the tests' shape
             ((4, 512, 512), (4, 512, 512)),
             ((7, 33, 1), (7, 1, 30)),                  # k = 1, B = 7
             ((1, 70, 130), (1, 130, 66))]              # k, n not 4 k


def share(c: dict) -> str:
    return (f"{100 * c['bound_ms'] / c['ms']:.0f}% of bound; without the "
            f"spin: kernel {c['ms_no_spin']:.4f} ms, library "
            f"{c['library_ms_no_spin']:.4f} ms")


def kernel_rows_k1_k3():
    """Phase 2's K1, K2 and K3 rows, checked and timed, each printed."""
    cases = [ds_matvec_case(m, n, seed=i)
             for i, (m, n) in enumerate(K1_SHAPES)]
    for c in cases:
        print(f"ds_matvec {c['shape'][0]}x{c['shape'][1]}: max_abs_err "
              f"{c['max_abs_err']:.3e} (tol {c['tol']:.3e}), kernel "
              f"{c['ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']}), {share(c)}, plain {c['plain_ms']:.4f} "
              f"ms, torch.mv {c['library_ms']:.4f} ms")
    bcases, pcases = ([ds_matvec_batched_case(B, m, n, seed=20 + i,
                                              strided=st, x32=x32,
                                              pair=pair)
                       for i, (B, m, n, st, x32, pair) in enumerate(shapes)]
                      for shapes in (K2_SHAPES, K3_SHAPES))
    for c in bcases + pcases:
        print(f"{c['name']} {'x'.join(map(str, c['shape']))}"
              f"{' (x strided)' if c['strided_x'] else ''}"
              f"{' (x float32)' if c['x32'] else ''}: max_abs_err "
              f"{c['max_abs_err']:.3e} (tol >= {c['tol']:.3e} per lane), "
              f"kernel {c['ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']}), {share(c)}, plain {c['plain_ms']:.4f} "
              f"ms, torch.matmul (float64) {c['library_ms']:.4f} ms")
    return cases, bcases, pcases


def kernel_rows_k4():
    """Phase 2's K4 rows, checked and timed, each printed."""
    mcases = [ds_matmul_case(a, b, seed=40 + i)
              for i, (a, b) in enumerate(K4_SHAPES)]
    for c in mcases:
        print(f"ds_matmul {c['shape'][0]} x {c['shape'][1]}: max_abs_err "
              f"{c['max_abs_err']:.3e} (tol {c['tol']:.3e}), kernel "
              f"{c['ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']}), {share(c)}, plain {c['plain_ms']:.4f} "
              f"ms, torch.matmul (float64) {c['library_ms']:.4f} ms")
    return mcases


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
        for line in _build.resources(res["log"]):
            print(f"    {line}")

    # 2. K1-K3 against their plain versions at the main path's shapes and
    # at one shape for each variant the launcher can pick
    cases, bcases, pcases = kernel_rows_k1_k3()
    n_big = 2048

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
    # 2c. K4 at the tests' shape, at (4, 512, 512)^2 and at its ragged
    # edges; K5 at the probe's 4096 x 4096 and a ragged shape
    mcases = kernel_rows_k4()
    rcases = [read_rowsum_case(4096, 4096, seed=50, split=True),
              read_rowsum_case(4096, 4096, seed=52, split=False),
              read_rowsum_case(37, 101, seed=51, split=True),
              read_rowsum_case(37, 101, seed=53, split=False)]
    for c in rcases:
        print(f"read_rowsum {c['shape'][0]}x{c['shape'][1]} "
              f"({'(hi, lo) split' if c['split'] else 'b like a'}): max_abs_err "
              f"{c['max_abs_err']:.3e} (tol >= {c['tol']:.3e} per row), "
              f"kernel {c['ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']}), plain {c['plain_ms']:.4f} ms, "
              f"a.sum(1) + b.sum(1) {c['two_sums_ms']:.4f} ms")

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
    head = HEADLINE
    solve_planted(gen_planted(head, n=100, seed=1000, density=0.1), head,
                  "headline")

    # 5. the headline batch, mixed (the K2 and K3 counts set to 0 just
    # before): its fast phase runs float32 state, K2 for A' z and A x and
    # K3 for the two refinement residuals of every step. Then mixed with
    # float64 state (K2 four times a step) and pure float64.
    # objectives: SCS's eps 1e-4 bounds the residuals and the gap, which
    # every run is held to (verify_termination), not the distance to the
    # planted optimum. The float64-state runs land within 1e-3 (1 + |opt|)
    # of it and of each other; the float32-state phase ends farther out on
    # a few lanes (at most 1.2e-3 to 2.0e-3 over four runs on an H100: the
    # zero cone's rows amplify the float32 rounding, PERF.md), so its gates
    # are 5e-3.
    batch = headline_batch(head, 1024, 1000)
    mixed_b = solve_batch(head, batch,
                          Settings(linsys="direct", chunk_iters=250),
                          "headline batch mixed", tol=5e-3)
    fast = mixed_b["by_phase"].get("fast", 0)
    check(mixed_b["f32_state"], "headline batch: the default mixed solve on "
          "the card did not take the float32-state fast phase")
    check(mixed_b["pair"] >= 2 * fast and fast > 0,
          f"headline batch: {mixed_b['pair']} K3 launches < 2 x {fast} "
          f"float32-state steps")
    check(mixed_b["launches"] >= 2 * mixed_b["steps"],
          f"headline batch: {mixed_b['launches']} K2 launches < 2 x "
          f"{mixed_b['steps']} steps")
    mixed64_b = solve_batch(head, batch,
                            Settings(linsys="direct", chunk_iters=250,
                                     fast_f32=False),
                            "headline batch mixed float64 state")
    check(mixed64_b["launches"] >= 4 * mixed64_b["steps"]
          and mixed64_b["pair"] == 0,
          f"headline batch, float64 state: {mixed64_b['launches']} K2 "
          f"launches < 4 x {mixed64_b['steps']} steps, or K3 launched")
    pure_b = solve_batch(head, batch,
                         Settings(linsys="direct", chunk_iters=250,
                                  mixed_precision=False),
                         "headline batch pure f64")
    for label, run, tol in (("mixed", mixed_b, 5e-3),
                            ("mixed float64 state", mixed64_b, 1e-3)):
        check(bool(np.array_equal(pure_b["status"], run["status"])),
              f"headline batch: pure and {label} statuses differ")
        agree = np.abs(run["pobj"] - pure_b["pobj"]) / (
            1 + np.abs(pure_b["pobj"]))
        check(bool(np.all(agree <= tol)),
              f"headline batch: {label} vs pure pobj differ by "
              f"{agree.max():.2e}, above {tol:.0e}")
    print(f"{card}, peak device memory of the last batch "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 6. warm re-solves of a batch in BatchWorkspace's default mode
    # (float32 state), then 64 lanes below the fast floor: every lane
    # polishes, the polish phase on K2 (four a step). The warm batch takes
    # the 64 lanes whose float32-state solve in phase 5 was shortest: with
    # float32 state a few lanes of this family need tens of thousands of
    # iterations (PERF.md: one of the first 64 took 25775 cold, 146 s),
    # and phase 5 times those. The eps 1e-7 batch runs its fast phase with
    # float64 state on the first 64 lanes (one lane of the first 256
    # polishes for 83k iterations, 310 s; the first 64 need at most ~4k);
    # tests/test_torch_cuda.py takes a small batch through the
    # float32-state phase and the polish.
    easy = np.sort(np.argsort(mixed_b["iters"], kind="stable")[:64])
    lanes = torch.as_tensor(easy, device="cuda")
    print(f"BatchWorkspace lanes: the 64 with the fewest float32-state "
          f"iterations in phase 5 (at most {mixed_b['iters'][easy].max()}): "
          f"seeds {(1000 + easy).tolist()}")
    warm_batch(head, tuple(t[lanes] for t in batch[:3]) + (batch[3][easy],))
    tight = solve_batch(head, tuple(t[:64] for t in batch),
                        Settings(linsys="direct", chunk_iters=250,
                                 eps_abs=1e-7, eps_rel=1e-7, fast_f32=False),
                        "headline batch B=64 mixed float64 state eps 1e-7",
                        tol=1e-5)
    pol = tight["by_phase"].get("polish", 0)
    fast = tight["by_phase"].get("fast", 0)
    check(tight["polished"] == 64 and pol > 0,
          f"eps 1e-7 batch: {tight['polished']} lanes polished in {pol} "
          f"steps, not all 64")
    check(tight["launches"] >= 4 * (pol + fast) and tight["pair"] == 0,
          f"eps 1e-7 batch: K2 {tight['launches']}, K3 {tight['pair']} "
          f"launches for {fast} fast and {pol} polish steps")

    # 7. the indirect backend, the default linsys: the large SOCP mixed
    # and pure (K1 counted around each), then the headline batch in the
    # default mode (mixed, float32 state; K2 counted around it). Its
    # objective gate is the float32-state direct batch's (5e-3).
    solve_indirect(big_p, spec, "large SOCP", big["pobj64"])
    ind_b = solve_batch(head, batch, Settings(chunk_iters=250),
                        "headline batch indirect (default: mixed, float32 "
                        "state)", tol=5e-3)
    check(ind_b["f32_state"], "headline batch indirect: the default mixed "
          "solve did not take the float32-state fast phase")
    check(ind_b["launches"] >= 2 * ind_b["steps"] and ind_b["pair"] == 0,
          f"headline batch indirect: {ind_b['launches']} K2 launches < 2 x "
          f"{ind_b['steps']} steps, or K3 launched")
    check(ind_b["cg"] > 0, "headline batch indirect: no CG iteration")
    ind64_b = solve_batch(head, batch, Settings(chunk_iters=250,
                                                fast_f32=False),
                          "headline batch indirect mixed float64 state")
    check(ind64_b["launches"] >= 2 * ind64_b["steps"],
          f"headline batch indirect, float64 state: {ind64_b['launches']} "
          f"K2 launches < 2 x {ind64_b['steps']} steps")

    # 8. the roofline probe, K5's path (K5 counted around it: the
    # warm-up's launches and each graph replay's), and K4's entry point at
    # the tests' shape
    roofline.launches = 0
    t0 = time.perf_counter()
    roof = roofline.measure(n=4096, iters=400, reps=3)
    k5_launches = roofline.launches
    print(f"roofline.measure(n=4096, iters=400, reps=3) in "
          f"{time.perf_counter() - t0:.1f} s, K5 launches {k5_launches}: "
          + ", ".join(f"{k} {v!r}" for k, v in roof.items()))
    check(k5_launches > 0, "roofline.measure did not launch K5")
    check(roof["frac"] is not None and 0 < roof["frac"] <= 1,
          f"roofline frac {roof['frac']!r}")
    check(roof["frac_spec"] is not None and roof["read_peak_gbps"] > 0,
          "roofline: no data-sheet peak for this card, or no read rate")
    gen = torch.Generator(device="cuda").manual_seed(42)
    A4 = torch.randn(2, 37, 53, generator=gen, dtype=torch.float64,
                     device="cuda")
    B4 = torch.randn(2, 53, 29, generator=gen, dtype=torch.float64,
                     device="cuda")
    dsmatmul.launches = 0
    C4 = dsmatmul.ds_matmul(A4, B4)
    torch.cuda.synchronize()
    k4_launches = dsmatmul.launches
    rel = float((C4 - A4 @ B4).abs().max() / (A4 @ B4).abs().max())
    print(f"ds_matmul (2, 37, 53) x (2, 53, 29): K4 launches {k4_launches}, "
          f"max |C - A @ B| / max |A @ B| = {rel:.3e}")
    check(k4_launches == 1 and rel <= 1e-13,
          f"ds_matmul: {k4_launches} launches, relative error {rel:.3e}")

    # 9. where the time of an iteration goes, mixed and pure, on the large
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
    profile_iterations(big_p, spec, True, 100, "large SOCP indirect mixed",
                       linsys="indirect")
    profile_batched(head, batch, 50)
    anderson_qr_times(1024, 501 + 10, 10)

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
    }, {
        "name": "ds_matvec_batched", "route": "cuda",
        "source": "scs_tpu_torch/csrc/dsmatvec.cu",
        "replaces": "scs_tpu/ops/dsmatvec.py:226",
        "launches": mixed_b["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in bcases),
        "ms": bcases[0]["ms"], "plain_ms": bcases[0]["plain_ms"],
        "bound_ms": bcases[0]["bound_ms"],
        "bound_by": bcases[0]["bound_by"],
        "library_ms": bcases[0]["library_ms"],
    }, {
        "name": "ds_matvec_pair_batched", "route": "cuda",
        "source": "scs_tpu_torch/csrc/dsmatvec.cu",
        "replaces": "scs_tpu/ops/dsmatvec.py:471",
        "launches": mixed_b["pair"],
        "max_abs_err": max(c["max_abs_err"] for c in pcases),
        "ms": pcases[0]["ms"], "plain_ms": pcases[0]["plain_ms"],
        "bound_ms": pcases[0]["bound_ms"],
        "bound_by": pcases[0]["bound_by"],
        "library_ms": pcases[0]["library_ms"],
    }, {
        "name": "ds_matmul", "route": "cuda",
        "source": "scs_tpu_torch/csrc/dsmatmul.cu",
        "replaces": "scs_tpu/ops/dsmatmul.py:35",
        "launches": k4_launches,
        "max_abs_err": max(c["max_abs_err"] for c in mcases),
        "ms": mcases[1]["ms"], "plain_ms": mcases[1]["plain_ms"],
        "bound_ms": mcases[1]["bound_ms"],
        "bound_by": mcases[1]["bound_by"],
        "library_ms": mcases[1]["library_ms"],
    }, {
        "name": "read_rowsum", "route": "cuda",
        "source": "scs_tpu_torch/csrc/readpeak.cu",
        "replaces": "scs_tpu/ops/roofline.py:78",
        "launches": k5_launches,
        "max_abs_err": max(c["max_abs_err"] for c in rcases),
        "ms": rcases[0]["ms"], "plain_ms": rcases[0]["plain_ms"],
        "bound_ms": rcases[0]["bound_ms"],
        "bound_by": rcases[0]["bound_by"],
        "library_ms": None,
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
