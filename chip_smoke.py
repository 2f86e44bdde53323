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
     then the first 8 lanes of the headline batch in the default mode
     (mixed, float32 state) and mixed with float64 state, every lane held
     to SCS's termination test;
  8. the roofline probe `roofline.measure(n=4096, iters=400, reps=3)`,
     the path of kernel K5, and K4's entry point `ds_matmul`;
 10. repeatability: the large SOCP through the indirect backend in pure
     float64 solved twice here (the first time in phase 7) and once in a
     fresh process (this script with `--repeat-child`, run beside the
     second), bitwise equal; the 64 easiest lanes of
     phase 5 solved twice in the default mode, lane counts equal;
 11. the mixed-cone configurations (`models/mixed_cones.py`): each of the
     box, exp and power projections as a CUDA graph against its eager run
     (float64 and float32, at both configurations' shapes, with times),
     one mixed-cone projection under set_sync_debug_mode("error"), the
     cost of the fixed-order segment sums against index_add_; the large
     mixed-cone program (n=2048, m=8192) direct mixed (K1 counted),
     direct pure float64, indirect mixed and direct mixed with float32 exp
     projections (exp_f32=True) against its planted optimum; the
     mixed-cone headline batch at B=1024 mixed with float32 state, with
     float64 state and in pure float64, every lane held to SCS's
     termination test and to the pure float64 run; and BatchWorkspace
     cold and warm on its 64 easiest lanes;
 12. the PSD configurations (`models/psd_cones.py`): each PSD and
     complex-PSD block size projected by the card's eigh in float64 and
     float32 against float64 numpy (`PSD_TOL`), with host ms and host
     syncs per projection; the large PSD program (n=2048, m=8192: one
     block of 90, eight of 16, a complex block of 24) direct mixed (K1
     counted, the forced float64 polish entered), direct pure float64
     and indirect mixed against its planted optimum and SCS's
     termination test; the PSD headline batch at B=1024 mixed with
     float32 state (K2 and K3 counted), with float64 state and in pure
     float64, every mixed lane through the forced polish, every lane
     held to SCS's termination test and to the pure float64 run; and
     BatchWorkspace cold and warm on its 64 easiest lanes;
 13. the spectral configurations (`models/spectral_cones.py`): the
     logdet cones' cascade kernel (`ops/logdet.py`, K6: Newton, SCS's KKT
     gate, the IPM) and the sum-of-k-largest loop kernel
     (`ops/sumlargest.py`, K7) against their plain versions on the CPU at
     the projections' shapes, with times (K6 also on its Newton-only and
     its IPM cones, and twice for the same bits), beside an empty kernel's
     launch; both kernels at the orders where their layouts change (K6
     with a cone that runs the IPM); each spectral run (logdet, nuclear,
     ell1, sum-largest) projected on the card with its eigh or SVD in
     float64 and in float32 against the CPU's run of the same function
     (`SPECTRAL_TOL`, `LOGDET_TOL`), with host ms and host syncs per
     projection; the
     large spectral program (n=2048, m=8192: logdet blocks of 60 and
     4 x 16, a nuclear block 40 x 30, two ell1 cones of 400, a
     sum-of-4-largest block of 40) direct mixed (K1, K6, K7 counted, the
     forced float64 polish entered), direct pure float64 and indirect
     mixed against its planted optimum and SCS's termination test; the
     spectral headline batch at B=1024 mixed with float64 state and in
     pure float64, and mixed with float32 state (K2 and K3 counted) on
     its first SPECTRAL_F32_LANES lanes, every mixed lane through the
     forced polish, every lane held to SCS's termination test and to the
     pure float64 run;
 14. the sparse problems (`demo_sparse`, blocked-ELL operands,
     `ops/sparse.py`): kernel K2s (`csrc/ellmatvec.cu`) in its three
     kinds on the full instance's A (12500 block-rows of 8 x 256) and A'
     (8000 of 8 x 768, re-tiled at its chosen width) and, with K1 on the
     dense tails, on the tails fixture at 4000 x 3000: the (hi, lo) pair
     on the double-single split, float32 on the float32 shadow, float64 on
     the operand's own tiles, each apply one K2s launch and no gather of
     x, each against its plain version on the card and a float64 scipy
     product within 1e-13 (1 + max |A||x|) (float32: 1e-5), with times of
     K2s, the plain version, the whole apply and torch.mv on a CSR tensor
     of the kind's dtype beside K2s's bound (the nonzeros, x and y read or
     written once); the pair on a band of 75000 block-rows (beyond K2's
     grid of 65535: one launch); the full instance (K = 500 stages: 100000
     x 64000, 25.57M nonzeros, seed 0, eps 1e-4) through the indirect
     backend mixed (K2s pair and float32 counted) and pure float64 (K2s
     float64 counted), no gather of x, each held to its planted optimum
     and SCS's termination test; the cut instance (SPARSE_CUT_STAGES
     stages, n = 8192, the widths unchanged) through the direct backend
     pure and mixed, sparse against dense, and through the indirect
     backend in pure float64 twice, bit for bit;
 15. the entry points (`entry_phase`): the tracked-rank PSD projection
     (`Settings.psd_rank`) on the planted low-rank SDP of
     `models.planted_lowrank_sdp` (one PSD block of 400, rank 4, n = 200,
     m = 80204) direct in pure float64 and mixed at eps 1e-6, psd_rank 0
     and 8, each within 1e-4 (1 + |opt|) of its planted optimum with the
     share of certificates passed; phase 12's large PSD program direct
     mixed with psd_rank 0 and 8; 64 lanes of the PSD batch mixed with
     float64 state, psd_rank 0 and 2, the same statuses; the headline
     and large SOCPs written by `io.write_scs_data` and by the Python
     writer (the same bytes), read back by the native and the Python
     reader (the arrays equal), each solved by
     `compat.SCS` (K1 counted) with the bits of `Workspace` on the same
     arrays, `python -m scs_tpu_torch.run_from_file` in a process of its
     own on the headline file (rc 0, the same objective), the 64-stage
     `demo_sparse` file read in sparse storage; the large SOCP direct
     mixed, and indirect mixed capped at 500 iterations, with a
     checkpoint every 50 iterations resumed from the middle one, bit for
     bit; and with the CSV trace, profile_phases, both, and verbose
     against the plain solve (the same bits; ms per iteration and host syncs per
     iteration; the CSV's rows and last row against Info, the timers
     against the solve time);
 16. differentiation and the multi-process runtime (`diff_phase`): 64
     planted strictly complementary problems at the headline widths
     (`models.planted_complementary`), an SOCP batch and a QP batch,
     through `make_diff_solver` (the forward solve mixed, K2 counted):
     the gradient of w'x against a central finite difference along a
     random unit direction per lane (two pure float64 solves at eps
     1e-12, warm-started), against the CPU's gradient on two lanes, and
     forward mode's directional derivative against it (the adjoint
     identity), with the forward and backward times, GMRES steps and VJP
     evaluations; then the five examples of `scs_tpu_torch.examples`
     (`EXAMPLE_COUNTS`), each with its asserts and wall time; these two
     parts in a process of their own (`--batch-child diff`) started
     after phase 10 and run beside phases 11-14; here, the box, exp and
     power instances of tests/test_diff.py, card gradients against the
     CPU's, and `graphs.run` raising under autograd; a one-rank NCCL
     group: `make_sharded_batch_solver` on the first 64 lanes of the
     headline batch against `make_batch_solver`;
 17. row (model-axis) sharding (`ops/rowshard.py`,
     `parallel/collectives.py`): K1 at the shard shapes (4096 x 2048 and
     2048 x 4096), K2 and K3 at the sharded batch's, against their plain
     versions (before phase 16 (b), the card alone); then two processes
     (`--batch-child rowshard R PORT LANES`, started there, beside phase
     16 (b, c)) join a gloo group and solve on the one card on a (1, 2)
     mesh, half the rows of A each, and this process runs the same solves
     unsharded: (a) the large SOCP through make_pure_solver direct mixed
     (float64 state: K1 on each rank's rows) and direct pure, each held to
     status solved, SCS's termination test, the planted optimum and the
     unsharded solve (1e-3 (1 + |opt|)), and indirect mixed capped at
     ROWSHARD_INDIRECT_CAP iterations (timed: its CG takes a collective
     a CG iteration), and tests/test_parallel.py:83's one problem (m =
     80, 40 rows a rank) indirect mixed to the end with every gate; (b)
     the first 64 lanes of the headline batch through make_batch_solver
     mixed with float64 state (K2), statuses equal to the unsharded
     solve's, objectives within 1e-3; (c) A' z with
     float32 z from each rank's K3 pairs summed in float64 against the
     float64 product, and 8 lanes mixed with float32 state (K2, K3), every
     lane the unsharded solve solves solved within 5e-3. The ranks return
     the same bits; each rank's launches are counted around its solves;
     ms per iteration and collectives per iteration beside the unsharded
     solve's;
  9. last, a profile of 25 iterations of the large SOCP, mixed, of 25
     batched steps of the headline batch's float32-state phase and of 25
     iterations of phase 14's full sparse instance, mixed
     (launches, device busy share, the kernels that take the most device
     time, the operators that take the most host time), and the batched
     Anderson QR against torch.linalg.qr.
Phase 2 also holds K2 and K3 against their plain versions at the batched
shapes, and K4 and K5 against theirs.
The float32-state batches of phases 11, 12 and 13 each run in a
process of their own (this script with `--batch-child NAME`), started
after phase 2 and run beside phases 3-10 on the same card; phase 15's
psd_rank batch runs the same way, started after phase 10 and run beside
phases 11-14. Each phase waits for its batch's result where it holds it
to the other runs. Their times, and those of phases 3-14, are taken with
the card and the host shared.
Phases 3-6 run the direct backend (`Settings(linsys="direct")`).
Each phase ends with a line `phase N done at T s` (seconds since the
start). The whole run, the build included, has to end inside 1200 s on
one H100: that is the time a caller of this script gives it.
The second-to-last line is a JSON object with one entry per kernel (K1-K7),
per kind of K2s and the sparse direct use of K1 (phase 14) and per
row-sharded use of K1-K3 (phase 17), the last line {"ok": true,
"device": {...}}.
"""

import atexit
import csv
import dataclasses
import functools
import hashlib
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import warnings

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from scs_tpu_torch import Settings, Workspace, accel, compat, config, \
    demo_sparse, io
from scs_tpu_torch.cones import box as box_cone
from scs_tpu_torch.cones import exp as exp_cone
from scs_tpu_torch.cones import graphs, project, psd, segments, soc, spectral
from scs_tpu_torch.cones import power as power_cone
from scs_tpu_torch.demo_socp import make_spec
from scs_tpu_torch.diff import make_diff_solver
from scs_tpu_torch.linsys import direct, indirect
from scs_tpu_torch.models import gen_planted
from scs_tpu_torch.models import mixed_cones, psd_cones, spectral_cones
from scs_tpu_torch.models import diff_instances, planted_complementary
from scs_tpu_torch.models import planted_lowrank_sdp
from scs_tpu_torch.types import ConeData
from scs_tpu_torch.ops import (_build, dsmatmul, dsmatvec, ellmatvec,
                               logdet, ozaki, roofline, sparse, sumlargest)
from scs_tpu_torch.parallel import (BatchWorkspace,
                                    make_chunked_batch_solver,
                                    make_solver_parts)
from scs_tpu_torch.parallel import batch as batch_mod
from scs_tpu_torch.parallel import multihost
from scs_tpu_torch.solver_batched import BatchedIteration
from scs_tpu_torch.types import ConeSpec
from scs_tpu_torch.utils import native

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


def headline_batch(spec, B: int, seed0: int, bounds: bool = False):
    """B planted problems of the headline family, stacked on the card;
    `bounds`: the mixed-cone family (`mixed_cones.gen_mixed`), whose box
    bounds are appended as (bu, bl) (B, bsize - 1)."""
    if bounds:
        probs = [mixed_cones.gen_mixed(spec, 100, seed0 + i, 0.1)
                 for i in range(B)]
    else:
        probs = [gen_planted(spec, n=100, seed=seed0 + i, density=0.1)
                 for i in range(B)]
    A, b, c = (torch.stack([getattr(p.problem, k) for p in probs]).cuda()
               for k in ("A", "b", "c"))
    out = (A, b, c, np.asarray([p.opt for p in probs]))
    if bounds:
        out += tuple(torch.stack([getattr(p.cone_data, k) for p in probs])
                     .cuda() for k in ("bu", "bl"))
    return out


def lanes_of(batch, idx):
    """The lanes `idx` (a numpy index) of a batch from headline_batch."""
    rows = torch.as_tensor(idx, device="cuda")
    return tuple(t[rows] if torch.is_tensor(t) else t[idx] for t in batch)


def termination_failures(batch, res, stg) -> dict:
    """SCS's termination test for every lane, recomputed in float64 from
    the original A, b, c and the returned x, y, s (the reference test
    suite's verify_solution_correct, test/problem_utils.h:107-249):
    primal and dual residuals and the gap within eps_abs + eps_rel times
    their scale, with 1 % slack for the round-off between this recomputation
    and the solver's own check. Returns {test: numpy mask of the lanes
    that fail it}."""
    A, b, c = batch[:3]
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
    return {name: (~(val <= 1.01 * (stg.eps_abs + stg.eps_rel * scl)))
            .cpu().numpy() for name, (val, scl) in tests.items()}


def verify_termination(batch, res, stg, label) -> None:
    """Every lane passes SCS's termination test (termination_failures)."""
    for name, bad in termination_failures(batch, res, stg).items():
        check(not bad.any(), f"{label}: {int(bad.sum())} lanes fail SCS's "
              f"{name} test recomputed from the original data")


def solve_batch(spec, batch, stg, label, tol=1e-3):
    """The batch through make_chunked_batch_solver on the card, with the
    K2 and K3 launch counts read around the solve. Returns the numbers."""
    A, b, c, opts = batch[:4]
    B = A.shape[0]
    bnd = torch.zeros(B, 0, dtype=torch.float64, device="cuda")
    bu, bl = batch[4:] if len(batch) > 4 else (bnd, bnd)
    solver = make_chunked_batch_solver(spec, stg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dsmatvec.launches = 0
    dsmatvec.batched_launches = 0
    dsmatvec.pair_launches = 0
    indirect.host_reads = 0
    indirect.refine_passes = 0
    graphs.replays = 0
    t0 = time.perf_counter()
    res = solver(A, b, c, bu, bl)
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
          f"launches {pair}, cone graph replays {graphs.replays}, max pobj "
          f"rel err {err.max():.2e}, max res_pri "
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


def warm_batch(spec, batch, label: str = ""):
    """BatchWorkspace on the card in its default mode (mixed, fast phase
    with float32 state): cold solve, b shifted by 1 %, warm solve (the
    examples/mpc_warm_batch.py pattern), the K3 launches of the
    float32-state phase counted around the two solves."""
    A, b, c = batch[:3]
    ws = BatchWorkspace(spec, Settings(linsys="direct", chunk_iters=250),
                        A, None, b, c, *batch[4:])
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
    print(f"BatchWorkspace B={A.shape[0]}{label}, float32 state: cold "
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


def solve_indirect(p, spec, label, direct_pobj: float,
                   modes=("mixed", "pure f64")):
    """The planted problem through the indirect backend on the card, mixed
    (the default there) and pure float64, each with its counts set to 0
    just before: status, ADMM and CG iterations, ms per iteration, K1
    launches and the CG loops' host reads, and the objective against the
    planted optimum and the direct solve. The direct runs' gates."""
    out = {}
    for mode, stg in (("mixed", Settings()),
                      ("pure f64", Settings(mixed_precision=False))):
        if mode not in modes:
            continue
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
                     "reads": reads, "mixed": ws._mixed,
                     "status": info.status,
                     "digest": _digest(sol.x, sol.y, sol.s)}
    check(out["mixed"]["mixed"] and out["mixed"]["launches"] >= 2 *
          out["mixed"]["iter"], f"{label} indirect: the default solve on the "
          f"card is not mixed or launched K1 {out['mixed']['launches']} "
          f"times in {out['mixed']['iter']} iterations")
    check(out.get("pure f64", {"launches": 0})["launches"] == 0,
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


def profile_batched(spec, batch, steps: int, label: str = "") -> None:
    """`profile_iterations` for `steps` lockstep steps of the batched
    solver's fast phase as the default mixed solve runs it on the card:
    float32 state, floored targets."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    A, b, c = batch[:3]
    stg = Settings(linsys="direct")
    init_fn, _, _ = make_solver_parts(spec, stg)
    data, st = init_fn(A, None, b, c, *batch[4:])
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
    label = f"batch{label} B={A.shape[0]} mixed float32-state profile"
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


# ---- the box, exp and power cones (graphs, host reads, repeatability) ----

def _wall_ms(fn, reps: int) -> float:
    """Host wall time of one call of fn, the card synchronized around
    `reps` calls (what a solver's iteration waits for)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def cone_inputs(spec, lead: tuple, dtype, seed: int):
    """Random arguments of the box, exp and power projections of `spec`
    with leading shape `lead` (() for one problem, (B,) for a batch), on
    the card: {family: (function, args)}."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, lo=None):
        t = torch.randn((*lead, *shape), generator=gen, dtype=torch.float64,
                        device="cuda")
        return (t if lo is None else lo + t.abs()).to(dtype)

    nb = spec.bsize - 1
    bl = -(0.5 + rnd(nb).abs())
    bu = 0.5 + rnd(nb).abs()
    bu[..., ::10] = math.inf
    n_exp = spec.ep + spec.ed
    mask = torch.arange(n_exp, device="cuda") < spec.ep
    a = torch.as_tensor(spec.p, dtype=dtype, device="cuda")
    return {
        "box": (box_cone.proj_box_cone,
                (2.0 * rnd(spec.bsize), bl, bu, rnd(lo=0.5),
                 rnd(spec.bsize, lo=0.01))),
        "exp": (exp_cone.proj_exp_batch, (2.0 * rnd(n_exp, 3), mask)),
        "power": (power_cone.proj_power_batch, (2.0 * rnd(spec.psize, 3), a)),
    }


def cone_graph_rows(spec, lead: tuple, label: str) -> list:
    """Each cone family of `spec` as a CUDA graph (`graphs.run`) against
    its eager run on the same card tensors, in float64 and float32: the
    outputs agree to 1e-15 relative in float64 and 1e-6 in float32 (the
    graph replays the same kernels; anything but bitwise equality is a
    fault). Times: host wall ms per call of each, the card synchronized
    (the eager run launches every step of every loop)."""
    rows = []
    for dtype, tol in ((torch.float64, 1e-15), (torch.float32, 1e-6)):
        for fam, (fn, args) in cone_inputs(spec, lead, dtype, 60).items():
            eager = fn(*args)
            graph = graphs.run(fn, args)
            eager = eager if torch.is_tensor(eager) else eager[0]
            graph = graph if torch.is_tensor(graph) else graph[0]
            diff = float((graph - eager).abs().max()
                         / eager.abs().max().clamp_min(1.0))
            row = {"family": fam, "shape": list(args[0].shape),
                   "dtype": str(dtype).split(".")[-1], "rel_diff": diff,
                   "graph_ms": _wall_ms(lambda: graphs.run(fn, args), 50),
                   "eager_ms": _wall_ms(lambda: fn(*args), 3)}
            print(f"cone graph {label} {fam} {row['shape']} {row['dtype']}: "
                  f"graph {row['graph_ms']:.4f} ms, eager "
                  f"{row['eager_ms']:.3f} ms per call (host wall), "
                  f"max |graph - eager| / max(1, |eager|) {diff:.1e}")
            check(math.isfinite(diff) and diff <= tol,
                  f"cone graph {label} {fam} {row['dtype']}: graph and eager "
                  f"differ by {diff:.1e} > {tol:.0e}")
            rows.append(row)
    return rows


def sync_free_projection(spec, batch) -> None:
    """One proj_dual_cone_batched on the mixed-cone layout (B lanes, float32
    exp/power as on the fast phase) under set_sync_debug_mode("error"):
    any host read of the card in the projection raises. A first call
    captures the graphs and caches the layouts."""
    A, b = batch[0], batch[1]
    B, m = b.shape
    gen = torch.Generator(device="cuda").manual_seed(61)
    x = torch.randn(B, m, generator=gen, dtype=torch.float64, device="cuda")
    r = 0.1 + torch.rand(B, m, generator=gen, dtype=torch.float64,
                         device="cuda")
    cd = ConeData(bu=batch[4], bl=batch[5])
    tw = torch.ones(B, dtype=torch.float64, device="cuda")
    ref, _ = project.proj_dual_cone_batched(x, spec, cd, tw, r, exp_f32=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, t_new = project.proj_dual_cone_batched(x, spec, cd, tw, r,
                                                    exp_f32=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    same = bool(torch.equal(out, ref))
    print(f"proj_dual_cone_batched ({B}, {m}) mixed cones under "
          f"set_sync_debug_mode('error'): no host read, output equal to the "
          f"first call's: {same}")
    check(same and bool(torch.isfinite(out).all()),
          "sync-free projection differs from the first call or is not finite")


def segment_sum_cost(spec_big, head) -> dict:
    """Device time of the SOC tail norms' segment sum in a fixed order
    (segments.segment_sum, the port's) against the scatter-add it
    replaced (index_add_, atomics in no fixed order), at the large SOCP's
    cone list (one problem) and the headline batch's (B = 1024), with
    how often an iteration or a step runs it: the determinism fix's
    cost."""
    out = {}
    for label, sizes, lead in (("large SOCP", spec_big.q, ()),
                               ("headline batch", head.q, (1024,))):
        sizes = tuple(sz for sz in sizes if sz > 0)
        x = torch.randn((*lead, sum(sizes)), dtype=torch.float64,
                        device="cuda")
        seg = torch.as_tensor(soc._soc_layout_np(sizes)[0], device="cuda")
        dim = len(lead)

        def scatter():
            return torch.zeros(*lead, len(sizes), dtype=x.dtype,
                               device="cuda").index_add_(dim, seg, x)

        fixed = median_ms(lambda: segments.segment_sum(x, sizes))
        old = median_ms(scatter)
        err = float((segments.segment_sum(x, sizes) - scatter()).abs().max())
        print(f"segment sum, {label} cones ({len(sizes)} cones, "
              f"{sum(sizes)} rows{', B = 1024' if lead else ''}): fixed "
              f"order {fixed:.4f} ms, index_add_ {old:.4f} ms (device time; "
              f"one a projection), max difference {err:.1e}")
        out[label] = (fixed, old)
    return out


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _repeat_solve():
    """The large SOCP through the indirect backend in pure float64:
    (iterations, CG iterations, digest of x, y, s)."""
    spec = make_spec(2048, 0.1, np.random.RandomState(7))
    p = gen_planted(spec, n=2048, seed=7, density=0.3)
    ws = Workspace(p.problem, spec, p.cone_data,
                   Settings(mixed_precision=False))
    sol, info = ws.solve()
    return {"iter": info.iter, "cg": ws.tot_cg_its,
            "digest": _digest(sol.x, sol.y, sol.s), "status": info.status}


def repeat_check(spec, batch_easy, first: dict) -> dict:
    """Run-to-run repeatability on the card (ROADMAP section 3 A): the
    large SOCP, indirect, pure float64, solved twice in this process (the
    first time in phase 7: `first`, solve_indirect's record) and once in
    a fresh one, started first and run beside the second, must give equal
    iteration and CG counts and bitwise-equal x, y and s; the 64-lane
    headline batch in its default mode (mixed, float32 state) solved
    twice must give every lane the same iteration count."""
    here = os.path.dirname(os.path.abspath(__file__))
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--repeat-child"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=here)
    runs = [{k: first[k] for k in ("iter", "cg", "digest", "status")},
            _repeat_solve()]
    try:
        out, err = child.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        child.kill()
        out, err = child.communicate()
    check(child.returncode == 0,
          f"repeat check: the fresh process failed: {err[-2000:]}")
    runs.append(json.loads(out.strip().splitlines()[-1]))
    for i, r in enumerate(runs):
        print(f"repeat check, large SOCP indirect pure f64, "
              f"{'fresh process' if i == 2 else f'run {i + 1}'}: "
              f"{r['status']}, {r['iter']} iterations, {r['cg']} CG "
              f"iterations, x/y/s sha256 {r['digest'][:16]}")
    check(all(r == runs[0] for r in runs[1:]),
          "repeat check: the large SOCP's solves differ run to run")
    stg = Settings(linsys="direct", chunk_iters=250)
    bnd = torch.zeros(batch_easy[0].shape[0], 0, dtype=torch.float64,
                      device="cuda")
    lanes = [make_chunked_batch_solver(spec, stg)(
        *batch_easy[:3], bnd, bnd).iters.cpu().numpy() for _ in range(2)]
    print(f"repeat check, headline batch B={len(lanes[0])} mixed float32 "
          f"state: lane-iterations {int(lanes[0].sum())} and "
          f"{int(lanes[1].sum())}, lanes with equal counts "
          f"{int((lanes[0] == lanes[1]).sum())}")
    check(bool(np.array_equal(lanes[0], lanes[1])),
          "repeat check: the batch's per-lane iteration counts differ")
    return {"large": runs[0], "batch_lane_iterations": int(lanes[0].sum())}


# ---- the float32-state batches of phases 11-13, each in a process ----
#
# With float32 state a few lanes of each family need tens of thousands of
# iterations (PERF.md section 5: the reference's own stragglers), and the
# lockstep loop then runs ~5-9 ms of host work a step for them, the card
# 5-10 % busy. Run one after another, these three batches took ~550-740 s
# of the script's 1200 s. Each runs instead in a process of its own (this
# script with `--batch-child NAME`, the kernels already built), started
# after phase 2 and run beside phases 3-10; the phase that holds its
# result to the other runs waits for it. Each child sets its own launch
# counts to 0 just before its solve and reads them just after.

F32_CHILDREN = ("mixed-cone", "psd", "spectral")


def _f32_batch_case(name: str):
    """(spec, batch, label) of the float32-state batch `name`."""
    if name == "mixed-cone":
        spec = mixed_cones.headline_mixed_spec()
        return (spec, headline_batch(spec, 1024, 1000, bounds=True),
                "mixed-cone batch mixed")
    if name == "psd":
        spec = psd_cones.headline_psd_spec()
        return spec, headline_batch(spec, 1024, 1000), "PSD batch mixed"
    spec = spectral_cones.headline_spectral_spec()
    return (spec, headline_batch(spec, SPECTRAL_F32_LANES, 1000),
            f"spectral batch mixed B={SPECTRAL_F32_LANES}")


def _as_json(res: dict) -> dict:
    return {k: v.tolist() if isinstance(v, np.ndarray) else v
            for k, v in res.items()}


def f32_batch_child(name: str, *args: str) -> dict:
    """The child's work: the batch `name` in the default mode (mixed,
    float32 state) through solve_batch and its gates (objective within
    5e-3 of the planted optimum, SCS's termination test), with the
    spectral kernels' launches; numpy arrays as lists. "psd-rank" is
    phase 15's batch instead (`psd_rank_batch`), "diff" phase 16 (a)
    (`diff_headline`) and (d) (`examples_on_the_card`), "rowshard" one
    rank of phase 17 (`rowshard_rank`; args: rank, port, lanes)."""
    torch.set_num_threads(1)
    parent = os.getppid()

    def orphaned():
        # stop with the script, however it ended
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=orphaned, daemon=True).start()
    if name == "psd-rank":
        runs = psd_rank_batch()
        return {"runs": {str(k): _as_json(v) for k, v in runs.items()},
                "ended_at": time.time()}
    if name == "rowshard":
        rank, port, lanes = args
        return rowshard_rank(int(rank), int(port),
                             [int(i) for i in lanes.split(",")])
    if name == "diff":
        out = {"socp": diff_headline(False), "qp": diff_headline(True)}
        return dict(out, examples=examples_on_the_card(),
                    ended_at=time.time())
    spec, batch, label = _f32_batch_case(name)
    logdet.launches = 0
    sumlargest.launches = 0
    res = solve_batch(spec, batch, Settings(linsys="direct", chunk_iters=250),
                      f"{label} (a process of its own)", tol=5e-3)
    res["k6"], res["k7"] = logdet.launches, sumlargest.launches
    res["ended_at"] = time.time()
    return _as_json(res)


class BatchChild:
    """`python3 chip_smoke.py --batch-child NAME [ARGS]`, started now;
    `result()` waits for it, prints its output and returns its last line's
    record (a solve_batch record for the float32-state batches)."""

    running: list = []

    def __init__(self, name: str, *args: str, label: str = ""):
        self.name = label or name
        self.log = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--batch-child",
             name, *args], stdout=self.log, stderr=subprocess.STDOUT,
            text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
        self.started_at = time.time()
        BatchChild.running.append(self)

    def result(self) -> dict:
        t_wait = time.perf_counter()
        try:
            rc = self.proc.wait(timeout=1000)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        self.log.seek(0)
        lines = self.log.read().strip().splitlines()
        for line in lines[:-1]:
            print(f"[{self.name} process] {line}")
        check(rc == 0 and lines, f"the {self.name} process failed ({rc}): "
              f"{lines[-1] if lines else ''}")
        res = json.loads(lines[-1])
        print(f"[{self.name} process] its work ended "
              f"{res['ended_at'] - self.started_at:.1f} s after its start; "
              f"waited for here {time.perf_counter() - t_wait:.1f} s")
        for k in ("status", "pobj", "iters"):
            if k in res:
                res[k] = np.asarray(res[k])
        return res

    @staticmethod
    def stop_all() -> None:
        for c in BatchChild.running:
            if c.proc.poll() is None:
                c.proc.kill()
                c.proc.wait()


def mixed_cone_large(p, spec) -> dict:
    """The large mixed-cone program through Workspace: direct mixed (K1
    counted around it), direct pure float64, indirect mixed, and direct
    mixed with the exp cones in float32 on the fast phase (`exp_f32=True`,
    the JAX package's precision there; ROADMAP R4); each held against the
    planted optimum, with its cone graph replays."""
    out = {}
    graphs.replays = 0
    big = solve_planted(p, spec, "large mixed cones")
    out["direct"] = big
    out["replays_direct"] = graphs.replays
    check(big["launches"] > 0, "large mixed cones: no K1 launch")
    ind = solve_indirect(p, spec, "large mixed cones", big["pobj64"],
                         modes=("mixed",))
    out["indirect"] = ind["mixed"]
    ws = Workspace(p.problem, spec, p.cone_data,
                   Settings(linsys="direct", exp_f32=True))
    check(ws._iteration.exp32 and ws._repolish,
          "large mixed cones exp_f32: the fast phase does not project exp "
          "in float32, or no finishing re-projection")
    sol, info = ws.solve()
    err = abs(info.pobj - p.opt) / (1 + abs(p.opt))
    agree = abs(info.pobj - big["pobj64"]) / (1 + abs(big["pobj64"]))
    print(f"large mixed cones mixed, exp float32 (exp_f32=True): "
          f"{info.status}, {info.iter} iterations, solve "
          f"{info.solve_time:.1f} ms, {info.solve_time / max(info.iter, 1):.3f}"
          f" ms/iteration, pobj {info.pobj!r} (planted rel err {err:.2e}; "
          f"pure f64 rel diff {agree:.2e})")
    check(info.status == "solved" and err <= 1e-3 and agree <= 1e-3
          and bool(np.all(np.isfinite(sol.x))),
          f"large mixed cones exp_f32: {info.status}, objective error "
          f"{err:.2e}, against pure f64 {agree:.2e}")
    out["exp_f32"] = {"iter": info.iter, "solve_ms": info.solve_time}
    return out


# ---- the PSD and complex-PSD cones (phase 12) ----

# the card's eigh reconstruction against float64 numpy eigh, relative to
# 1 + max |v| of the blocks: float64 and float32 (eigh and rebuild in
# float32, as on the mixed fast phase)
PSD_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def _psd_blocks(ns: int, count: int, cplx: bool, seed: int) -> np.ndarray:
    """`count` packed blocks Q diag(w) Q^H of dimension ns: half of w
    N(0, 4), the other half within 1e-8 of 0 (a cluster, as the planted
    y's zero eigenvalues make one)."""
    rng = np.random.RandomState(seed)
    G = rng.randn(count, ns, ns)
    if cplx:
        G = G + 1j * rng.randn(count, ns, ns)
    Q, _ = np.linalg.qr(G)
    w = np.where(np.arange(ns) < ns // 2, 2.0, 1e-8) * rng.randn(count, ns)
    M = (Q * w[:, None, :]) @ np.conj(np.swapaxes(Q, 1, 2))
    if not cplx:
        _, _, r, c, scale = psd._tri_indices(ns)
        return M[:, r, c].real * scale
    diag_idx, re_idx, im_idx, lo_r, lo_c = psd._cplx_indices(ns)
    v = np.zeros((count, ns * ns))
    v[:, diag_idx] = np.diagonal(M, axis1=1, axis2=2).real
    v[:, re_idx] = M[:, lo_r, lo_c].real * math.sqrt(2.0)
    v[:, im_idx] = M[:, lo_r, lo_c].imag * math.sqrt(2.0)
    return v


def _psd_numpy(v: np.ndarray, ns: int, cplx: bool) -> np.ndarray:
    """The plain float64 projection: numpy eigh, clip, rebuild, repack."""
    if not cplx:
        idx, uscale, r, c, pscale = psd._tri_indices(ns)
        M = v[:, idx] * uscale
    else:
        diag_idx, re_idx, im_idx, lo_r, lo_c = psd._cplx_indices(ns)
        M = np.zeros((v.shape[0], ns, ns), complex)
        M[:, np.arange(ns), np.arange(ns)] = v[:, diag_idx]
        M[:, lo_r, lo_c] = (v[:, re_idx] + 1j * v[:, im_idx]) / math.sqrt(2)
        M[:, lo_c, lo_r] = np.conj(M[:, lo_r, lo_c])
    w, V = np.linalg.eigh(M)
    Mp = (V * np.maximum(w, 0.0)[:, None, :]) @ np.conj(np.swapaxes(V, 1, 2))
    if not cplx:
        return Mp[:, r, c].real * pscale
    out = np.zeros_like(v)
    out[:, diag_idx] = np.diagonal(Mp, axis1=1, axis2=2).real
    out[:, re_idx] = Mp[:, lo_r, lo_c].real * math.sqrt(2.0)
    out[:, im_idx] = Mp[:, lo_r, lo_c].imag * math.sqrt(2.0)
    return out


def _host_syncs(fn) -> int:
    """Host synchronizations of one call of fn after a first call (which
    fills the layouts' cached index tensors), counted from the warnings of
    set_sync_debug_mode("warn")."""
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message).lower() for w in caught)


def psd_projection_rows(spec, lead: tuple, label: str) -> list:
    """Each PSD and complex-PSD block size of `spec`, its blocks stacked as
    the projection gets them (lead + (blocks of that size,)), projected on
    the card in float64 and in float32 and held to the float64 numpy
    projection of the same blocks (PSD_TOL); host wall ms per projection,
    the card synchronized, and the host syncs of one projection. No CUDA
    tensor goes to a CPU eigh."""
    rows = []
    for cplx, sizes, fn in ((False, spec.s, psd.proj_psd_batch),
                            (True, spec.cs, psd.proj_cpsd_batch)):
        for ns, ct in project._contiguous_runs(sizes):
            shape = lead + (ct,)
            count = int(np.prod(shape))
            v = _psd_blocks(ns, count, cplx, seed=ns + 100 * cplx)
            ref = _psd_numpy(v, ns, cplx)
            x = torch.as_tensor(v.reshape(shape + (-1,)), device="cuda")
            scale = 1.0 + np.abs(v).max()
            row = {"family": "complex PSD" if cplx else "PSD", "ns": ns,
                   "blocks": list(shape)}
            for dtype, key in ((torch.float64, "f64"),
                               (torch.float32, "f32")):
                xd = x.to(dtype)
                out = fn(xd, ns).double().reshape(count, -1).cpu().numpy()
                err = float(np.abs(out - ref).max() / scale)
                row[f"{key}_err"] = err
                row[f"{key}_ms"] = _wall_ms(lambda: fn(xd, ns), 20)
                row[f"{key}_syncs"] = _host_syncs(lambda: fn(xd, ns))
                check(math.isfinite(err) and err <= PSD_TOL[dtype],
                      f"PSD projection {label} {row['family']} {ns} "
                      f"{key}: card eigh against numpy {err:.1e} > "
                      f"{PSD_TOL[dtype]:.0e} (1 + |v|)")
            print(f"PSD projection {label} {row['family']} ns={ns} blocks "
                  f"{row['blocks']}: float64 {row['f64_ms']:.3f} ms "
                  f"({row['f64_syncs']} host syncs), float32 "
                  f"{row['f32_ms']:.3f} ms ({row['f32_syncs']} host syncs) "
                  f"per projection (host wall); against numpy float64 "
                  f"eigh {row['f64_err']:.1e} and {row['f32_err']:.1e} "
                  f"(1 + |v|)")
            rows.append(row)
    return rows


def _lane_result(sol) -> types.SimpleNamespace:
    """One problem's solution as a batch of one for termination_failures."""
    return types.SimpleNamespace(**{
        k: torch.as_tensor(getattr(sol, k), device="cuda")[None]
        for k in ("x", "y", "s")})


def psd_large(p, spec) -> dict:
    """The large PSD program through Workspace: direct mixed (K1 counted,
    the forced float64 polish entered), direct pure float64 and indirect
    mixed, each held against the planted optimum, SCS's termination test
    recomputed in float64 and the pure float64 objective."""
    out = {}
    one = tuple(t.cuda()[None] for t in (p.problem.A, p.problem.b,
                                         p.problem.c))
    for label, stg in (("direct mixed", Settings(linsys="direct")),
                       ("direct pure f64", Settings(linsys="direct",
                                                    mixed_precision=False)),
                       ("indirect mixed", Settings())):
        torch.cuda.synchronize()
        dsmatvec.launches = 0
        ws = Workspace(p.problem, spec, p.cone_data, stg)
        polish = []
        enter = ws._enter_polish_phase

        def spy(st, enter=enter, polish=polish):
            res = enter(st)
            polish.append(res[1] is not None)
            return res

        ws._enter_polish_phase = spy
        sol, info = ws.solve()
        torch.cuda.synchronize()
        launches = dsmatvec.launches
        err = abs(info.pobj - p.opt) / (1 + abs(p.opt))
        fails = {k: int(v.sum()) for k, v in termination_failures(
            one, _lane_result(sol), stg).items() if v.any()}
        it = max(info.iter, 1)
        print(f"large PSD {label}: {info.status}, {info.iter} iterations"
              f"{f', {ws.tot_cg_its} CG iterations' if stg.linsys == 'indirect' else ''}"
              f", setup {info.setup_time:.1f} ms, solve "
              f"{info.solve_time:.1f} ms, {info.solve_time / it:.3f} "
              f"ms/iteration, pobj {info.pobj!r} (planted {p.opt!r}, rel "
              f"err {err:.2e}), K1 launches {launches} "
              f"({launches / it:.2f} per iteration), polish phase entered "
              f"{polish}, SCS's tests failed {fails or 'none'}")
        check(info.status == "solved", f"large PSD {label}: {info.status}")
        check(err <= 1e-3, f"large PSD {label}: objective error {err:.2e}")
        check(not fails and bool(np.all(np.isfinite(sol.x))),
              f"large PSD {label}: SCS's termination test fails {fails}, "
              f"or x not finite")
        if ws._mixed:
            check(polish == [True], f"large PSD {label}: the forced float64 "
                  f"polish was not entered ({polish})")
            check(launches >= 2 * info.iter, f"large PSD {label}: K1 "
                  f"launched {launches} times in {info.iter} iterations")
        else:
            check(launches == 0, f"large PSD {label}: pure f64 launched K1")
        out[label] = {"iter": info.iter, "solve_ms": info.solve_time,
                      "launches": launches, "pobj": info.pobj,
                      "mixed": ws._mixed}
    pure = out["direct pure f64"]["pobj"]
    for label in ("direct mixed", "indirect mixed"):
        agree = abs(out[label]["pobj"] - pure) / (1 + abs(pure))
        check(out[label]["mixed"] and agree <= 1e-3,
              f"large PSD {label}: not mixed, or {agree:.2e} from pure f64")
    return out


def psd_phase(card: str, f32: BatchChild) -> dict:
    """Phase 12 (see the module docstring); `f32` the process that solves
    the PSD batch with float32 state."""
    t0 = time.perf_counter()
    pspec_big = psd_cones.large_psd_spec()
    pspec = psd_cones.headline_psd_spec()
    rows = (psd_projection_rows(pspec_big, (), "large")
            + psd_projection_rows(pspec, (1024,), "batch B=1024"))
    pbatch = headline_batch(pspec, 1024, 1000)
    B, m = pbatch[1].shape
    gen = torch.Generator(device="cuda").manual_seed(62)
    x = torch.randn(B, m, generator=gen, dtype=torch.float64, device="cuda")
    r = 0.1 + torch.rand(B, m, generator=gen, dtype=torch.float64,
                         device="cuda")
    syncs = {f32: _host_syncs(lambda: project.proj_dual_cone_batched(
        x, pspec, None, None, r, psd_f32=f32)) for f32 in (False, True)}
    print(f"proj_dual_cone_batched ({B}, {m}) PSD layout: host syncs per "
          f"projection float64 {syncs[False]}, float32 {syncs[True]}")
    big_p = gen_planted(pspec_big, n=2048, seed=7, density=0.3)
    big = psd_large(big_p, pspec_big)
    # objectives: every lane passes SCS's termination test at eps 1e-4
    # (verify_termination); against the planted optimum the float64 runs'
    # gate is 2e-3 and float32 state's 5e-3, as phase 11's (float64 state
    # lands 1.02e-3 away on an H100, PERF.md)
    runs = {}
    for label, kw, tol in (
            ("mixed float64 state", dict(fast_f32=False), 2e-3),
            ("pure f64", dict(mixed_precision=False), 2e-3)):
        runs[label] = solve_batch(
            pspec, pbatch, Settings(linsys="direct", chunk_iters=250, **kw),
            f"PSD batch {label}", tol=tol)
    runs["mixed"] = f32.result()
    mixed_pb, mixed64_pb = runs["mixed"], runs["mixed float64 state"]
    fast = mixed_pb["by_phase"].get("fast", 0)
    check(mixed_pb["f32_state"] and mixed_pb["pair"] >= 2 * fast > 0,
          f"PSD batch: float32 state {mixed_pb['f32_state']}, "
          f"{mixed_pb['pair']} K3 launches for {fast} fast steps")
    check(mixed_pb["launches"] >= 2 * mixed_pb["steps"],
          f"PSD batch: {mixed_pb['launches']} K2 launches < 2 x "
          f"{mixed_pb['steps']} steps")
    check(mixed64_pb["launches"] >= 4 * mixed64_pb["steps"]
          and mixed64_pb["pair"] == 0,
          f"PSD batch, float64 state: {mixed64_pb['launches']} K2 "
          f"launches < 4 x {mixed64_pb['steps']} steps, or K3 launched")
    for label in ("mixed", "mixed float64 state"):
        run = runs[label]
        check(run["polished"] == B and run["by_phase"].get("polish", 0) > 0,
              f"PSD batch {label}: {run['polished']} of {B} lanes took the "
              f"forced float64 polish")
    pure_pb = runs["pure f64"]
    check(pure_pb["polished"] == 0, "PSD batch pure f64 polished")
    for label, tol in (("mixed", 5e-3), ("mixed float64 state", 1e-3)):
        run = runs[label]
        check(bool(np.array_equal(pure_pb["status"], run["status"])),
              f"PSD batch: pure and {label} statuses differ")
        agree = np.abs(run["pobj"] - pure_pb["pobj"]) / (
            1 + np.abs(pure_pb["pobj"]))
        print(f"PSD batch: {label} against pure f64, pobj rel diff max "
              f"{agree.max():.3e}")
        check(bool(np.all(agree <= tol)), f"PSD batch: {label} vs pure "
              f"pobj differ by {agree.max():.2e}, above {tol:.0e}")
    peasy = np.sort(np.argsort(mixed_pb["iters"], kind="stable")[:64])
    warm_batch(pspec, lanes_of(pbatch, peasy), " PSD")
    print(f"{card}, phase 12 (PSD) {time.perf_counter() - t0:.1f} s, peak "
          f"device memory of the last batch "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"rows": rows, "syncs": syncs, "large": big, "batch": runs}


# phase 13: the spectral configurations. Card against the CPU's plain run
# of the same port function on the same inputs, (1 + |v|): float64 eig
# 1e-8 (the card's eigh and SVD, ~1e-15 from LAPACK's, and the same
# loops), float32 eig 1e-4 (the card's and LAPACK's float32 eigh and SVD
# each ~1e-6 from float64, as PSD_TOL). The logdet cones' Newton stops
# where its directional derivative falls below 2e-12; its Hessian is at
# least the identity, so a stopping point lies within ~2e-6 of the
# projection, and two devices' round-off may stop it anywhere there:
# LOGDET_TOL on the cones whose Newton converged inside its cap. Cones
# where either side's Newton stopped at its 100-iteration cap or the IPM
# ran are held to SCS's KKT gate instead (round-off moves those points
# within the gate's tolerance: 4.7e-7 between the card and the CPU on
# such cones on an H100, PERF.md)
SPECTRAL_TOL = {False: 1e-8, True: 1e-4}
LOGDET_TOL = 1e-6
# the float32-state spectral batch runs on its first SPECTRAL_F32_LANES
# lanes: on an H100 its first 256 took 1164.0 s (lanes 113 and 233 at
# 27200 and 27675 iterations), its first 64 176.1 s (lane 50, seed 1050,
# at 19475), most of it those lanes' forced float64 polish at ~8 ms a
# lockstep step (PERF.md)
SPECTRAL_F32_LANES = 64


def _spectral_inputs(family: str, shape: tuple, width: int,
                     seed: int) -> np.ndarray:
    """Random segments of one spectral run: N(0, 4) entries, t (and v for
    logdet) a third of the time inside the cone's scale."""
    rng = np.random.RandomState(seed)
    v = 2.0 * rng.randn(*shape, width)
    if family in ("ell1", "nuclear", "sum-largest"):
        v[..., 0] *= 1.0 + 3.0 * (rng.rand(*shape) < 0.3)
    return v


def _logdet_vectors(v: np.ndarray, ns: int):
    """(t0, v0, w) of logdet segments v (L, tri + 2), as proj_logdet_batch
    forms them (float64 numpy eigh on the host)."""
    idx, uscale, _, _, _ = psd._tri_indices(ns)
    M = v[:, 2:][:, idx] * uscale * math.sqrt(2.0)
    return (v[:, 0] * math.sqrt(2.0), v[:, 1] * math.sqrt(2.0),
            np.linalg.eigvalsh(M))


def logdet_kernel_inputs(spec, lead: tuple, seed: int) -> list:
    """[(ns, count, [t0, v0, w])] of each logdet run of `spec` at lanes
    `lead`: the CPU float64 inputs of the logdet cascade kernel, as the
    projections give it (phase 13, tools/torch_logdet_chain.py)."""
    out = []
    for family, _, ct, width, _ in project.spectral_runs(spec):
        if family != "logdet":
            continue
        ns = int(round((math.sqrt(8 * (width - 2) + 1) - 1) / 2))
        shape = lead + (ct,)
        count = int(np.prod(shape))
        v = _spectral_inputs(family, shape, width, seed + ns).reshape(
            count, width)
        out.append((ns, count, [torch.as_tensor(a)
                                for a in _logdet_vectors(v, ns)]))
    return out


def logdet_plain_work(args) -> tuple:
    """The plain version's result on `args` (`spectral.logdet_cone_plain`)
    and the work its cones took, summed over them: the Newton iterations
    that took a step and their line searches' trial points (and the most
    one search tried), the IPM iterations that took a step and their merit
    evaluations. Of the IPM's nonmonotone search only the first evaluation
    is counted, so the work is a lower bound (phase 13's bound,
    tools/torch_logdet_chain.py)."""
    work = dict.fromkeys(("newton_its", "newton_trials", "newton_trials_max",
                          "ipm_its", "ipm_merits"), 0)
    firsts = []
    first, newton_step, ipm_step = (spectral._first, spectral._newton_step,
                                    spectral._ipm_step)

    def spy_first(passes):
        firsts.append(first(passes))
        return firsts[-1]

    def counted_newton(v, x, obj, it, ngrad, done, failed, *consts):
        act = (it < spectral._LC_MAX_ITER) & ~done & ~failed
        firsts.clear()
        out = newton_step(v, x, obj, it, ngrad, done, failed, *consts)
        stepped = act & ~out[5] & ~out[6]
        trials = torch.where(stepped, torch.clamp_max(
            firsts[0], spectral._LC_MAX_LS) + 1, 0)
        work["newton_its"] += int(stepped.sum())
        work["newton_trials"] += int(trials.sum())
        work["newton_trials_max"] = max(work["newton_trials_max"],
                                        int(trials.max()))
        return out

    def counted_ipm(mehrotra):
        step = ipm_step(mehrotra)

        def counted(u1, r, z, s, it, done, *rest):
            act = (it < spectral._IPM_MAX_ITER) & ~done
            firsts.clear()
            out = step(u1, r, z, s, it, done, *rest)
            stepped = act & ~out[5]
            # the affine search's evaluations up to the first that passed,
            # and the nonmonotone search's first
            work["ipm_its"] += int(stepped.sum())
            work["ipm_merits"] += int(torch.where(stepped, firsts[0] + 2,
                                                  0).sum())
            return out
        return counted

    spectral._first, spectral._newton_step = spy_first, counted_newton
    spectral._ipm_step = counted_ipm
    try:
        ref = spectral.logdet_cone_plain(*(a.clone() for a in args))
    finally:
        spectral._first, spectral._newton_step = first, newton_step
        spectral._ipm_step = ipm_step
    return ref, work


def logdet_kernel_case(spec, lead: tuple, seed: int) -> dict:
    """The logdet cascade kernel (`ops/logdet.py`) against its plain
    version on the CPU, on the eigenvalues of random logdet segments at
    the shapes the projections give it: cones whose Newton converged
    inside its cap on both sides within LOGDET_TOL (1 + |v|),
    the others (Newton at its cap, or the IPM) through SCS's KKT gate on
    both sides; two launches give the same bits; kernel time (CUDA
    events) on all cones, on the cones Newton settles alone and on the
    cones that run the IPM, the plain version's (a second run on the CPU,
    the only device it runs on; host clock), and the bound from this
    work the plain version counted on this run's cones."""
    out = []
    for ns, count, args in logdet_kernel_inputs(spec, lead, seed):
        ref, work = logdet_plain_work(args)
        t_plain = time.perf_counter()
        spectral.logdet_cone_plain(*(a.clone() for a in args))
        plain_ms = (time.perf_counter() - t_plain) * 1e3
        dev = [a.cuda() for a in args]
        first = logdet.logdet_cone(*dev)
        again = logdet.logdet_cone(*dev)
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        got = [a.cpu() for a in first]
        ipm = (ref[3] >= 100) | (got[3] >= 100)
        scale = 1.0 + float(np.abs(np.concatenate(
            [a.reshape(count, -1).numpy() for a in args], 1)).max())
        err = max(float((g - r)[~ipm].abs().max()) if (~ipm).any() else 0.0
                  for g, r in zip(got[:3], ref[:3])) / scale
        gate = [bool(spectral._logdet_gate(*res[:3], *args)[ipm].all())
                for res in (got, ref)]
        ms = median_ms(lambda: logdet.logdet_cone(*dev))
        # step 0's split: the cones Newton settles alone, the IPM cones
        split = {}
        for name, mask in (("newton", got[3] < 1000), ("ipm", got[3] >= 1000)):
            idx = torch.nonzero(mask).squeeze(-1).cuda()
            sub = [a[idx] for a in dev]
            split[f"{name}_ms"] = (median_ms(lambda: logdet.logdet_cone(*sub))
                                   if idx.numel() else None)
        its = got[3] % 1000
        # operations: ~30 (n + 1) a Newton step and ~8 (n + 1) a trial
        # point of its line search (n logs); ~6 x 40 (n + 3) an IPM
        # iteration (two KKT solves of three refinement passes) and ~12
        # (n + 3) a merit evaluation; the steps, trial points and
        # evaluations the plain version took on these cones
        ops = float((30 * work["newton_its"] + 8 * work["newton_trials"])
                    * (ns + 1) + (240 * work["ipm_its"]
                                  + 12 * work["ipm_merits"]) * (ns + 3))
        nbytes = count * (2 * (ns + 2) * 8 + 4)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / FP64_FLOPS) * 1e3
        lay = logdet.launch_config(ns)
        case = {"ns": ns, "cones": count, "gated_cones": int(ipm.sum()),
                "ipm_cones": int(((ref[3] >= 1000) | (got[3] >= 1000)).sum()),
                "newton_its_max": int(its.max()), "plain_work": work,
                "max_abs_err": err,
                "gate_ok": gate, "repeats": same, "ms": ms, **split,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": ("operations" if ops / FP64_FLOPS
                             > nbytes / HBM_BYTES_PER_S else "bytes"),
                "library_ms": None, "layout": lay._asdict()}
        print(f"logdet_cone ns={ns} cones={count}: max_abs_err "
              f"{err:.3e} (1 + |v|) on the {count - case['gated_cones']} "
              f"cones whose Newton converged, {case['gated_cones']} held "
              f"to the KKT gate ({case['ipm_cones']} through the IPM; gate "
              f"passed: card {gate[0]}, plain {gate[1]}), Newton "
              f"iterations at most {case['newton_its_max']}, two launches "
              f"bit for bit equal {same}, kernel {ms:.4f} ms (the Newton-only "
              f"cones {split['newton_ms'] or 0:.4f}, the IPM cones "
              f"{split['ipm_ms'] or 0:.4f}), plain version on the CPU "
              f"{plain_ms:.1f} ms, bound {bound_ms:.6f} ms "
              f"({case['bound_by']}; the plain version's work {work}); "
              f"layout {tuple(lay)}")
        check(err <= LOGDET_TOL and all(gate) and same,
              f"logdet_cone ns={ns}: {err:.2e} from the plain version, an "
              f"IPM cone fails the gate ({gate}), or two launches differ "
              f"({same})")
        out.append(case)
    return out


# orders crossing every layout of the logdet kernel (lanes a group 4, 8,
# 16, 32; one and two entries a lane in registers; shared memory with a
# block of four warps a cone, with three at n = 400; the global scratch at
# n = 1300) and the sum-of-k-largest kernel's layouts (rows read in place
# below n = 14; staged, 128 cones a block, 96 at n = 300, 231 KB)
LOGDET_EDGE_NS = (1, 2, 5, 6, 13, 29, 30, 60, 120, 400, 1300)
SUM_LARGEST_EDGE_NS = (2, 6, 13, 14, 40, 300)


def _logdet_ipm_blocks(ns: int, count: int, seed: int) -> list:
    """[t0, v0, w] of `count` random logdet blocks of order ns on the CPU,
    the first of them one that runs the IPM, found among draws of 128: its
    Newton result fails SCS's KKT gate by at least twice a tolerance, with
    v off its floor, so that another device's round-off in Newton does not
    let it pass (the largest such failure). Draws of fewer blocks where
    one block is large (4 of order 1300)."""
    rng = np.random.RandomState(seed)
    width = ns * (ns + 1) // 2 + 2
    for _ in range(32):
        v = 2.0 * rng.randn(max(count, min(128, (1 << 22) // width)), width)
        args = [torch.as_tensor(a) for a in _logdet_vectors(v, ns)]
        tp, vp, xp, _ = spectral._newton(*args)
        res = torch.stack(spectral.check_logdet_opt(tp, vp, xp, *args))
        res = res.abs().amax(0) / 1e-2
        ok = (~spectral._logdet_gate(tp, vp, xp, *args) & (res >= 2.0)
              & (vp > 1e-12))
        if ok.any():
            b = int(torch.where(ok, res, -1.0).argmax())
            rows = torch.cat([torch.tensor([b]), torch.arange(count - 1)
                              + (torch.arange(count - 1) >= b)])
            return [a[rows] for a in args]
    raise RuntimeError(f"no logdet block of order {ns} runs the IPM")


def spectral_kernel_edges(seed: int) -> dict:
    """Both spectral kernels at the orders where their layouts change,
    against their plain versions on the CPU: the logdet kernel on 64 cones
    an order (4 from n = 400), the first running the IPM, held as in
    logdet_kernel_case
    (and a cone whose Newton stopped at v's floor of 1e-14, unconverged,
    to the gate); the sum-of-k-largest kernel on 300 cones for k = 1,
    n / 2, n - 1 within SPECTRAL_TOL[False] (1 + |v|)."""
    worst = {"logdet": 0.0, "sum_largest": 0.0}
    for ns in LOGDET_EDGE_NS:
        args = _logdet_ipm_blocks(ns, 64 if ns <= 120 else 4, seed + ns)
        ref = spectral.logdet_cone_plain(*(a.clone() for a in args))
        got = [a.cpu() for a in logdet.logdet_cone(*(a.cuda()
                                                     for a in args))]
        keep = (got[3] < 100) & (ref[3] < 100) & (got[1] > 1e-14) & (
            ref[1] > 1e-14)
        scale = 1.0 + float(max(a.abs().max() for a in args))
        err = max(float((g - r)[keep].abs().max()) if keep.any() else 0.0
                  for g, r in zip(got[:3], ref[:3])) / scale
        gate = [bool(spectral._logdet_gate(*res[:3], *args)[~keep].all())
                for res in (got, ref)]
        worst["logdet"] = max(worst["logdet"], err)
        print(f"logdet_cone edge ns={ns} ({tuple(logdet.launch_config(ns))})"
              f": max_abs_err {err:.3e} on {int(keep.sum())} cones, "
              f"{int((~keep).sum())} held to the gate (card {gate[0]}, "
              f"plain {gate[1]}), the first cone's info card "
              f"{int(got[3][0])}, plain {int(ref[3][0])}")
        check(err <= LOGDET_TOL and all(gate) and int(ref[3][0]) >= 1000
              and bool(all(torch.isfinite(g).all() for g in got[:3])),
              f"logdet_cone edge ns={ns}: {err:.2e}, gate {gate}, or its "
              f"first cone ran no IPM")
    rng = np.random.RandomState(seed)
    for ns in SUM_LARGEST_EDGE_NS:
        x = -torch.sort(-torch.as_tensor(rng.randn(300, ns) * 2.0)).values
        t0 = torch.as_tensor(rng.randn(300) * 2.0)
        scale = 1.0 + float(max(x.abs().max(), t0.abs().max()))
        for k in sorted({1, ns // 2, ns - 1}):
            got = [a.cpu() for a in sumlargest.sum_largest_sorted(
                t0.cuda(), x.cuda(), k)]
            ref = spectral._sum_largest_sorted_plain(t0, x, k)
            err = max(float((g - r).abs().max())
                      for g, r in zip(got, ref)) / scale
            worst["sum_largest"] = max(worst["sum_largest"], err)
            check(err <= SPECTRAL_TOL[False], f"sum_largest_sorted edge "
                  f"n={ns} k={k}: {err:.2e} from the plain version")
        print(f"sum_largest_sorted edge n={ns} "
              f"({tuple(sumlargest.launch_config(ns))}): k = 1, n / 2, "
              f"n - 1 within {worst['sum_largest']:.3e} so far")
    return worst


def sum_largest_kernel_inputs(spec, lead: tuple, seed: int) -> list:
    """[(ns, k, count, (t0, x))] of each sum-largest run of `spec` at lanes
    `lead`: the CPU float64 inputs of the path-following kernel, as the
    projections give it (phase 13, tools/torch_sum_largest_rows.py)."""
    out = []
    for family, _, ct, width, fn in project.spectral_runs(spec):
        if family != "sum-largest":
            continue
        ns, k = fn.keywords["ns"], fn.keywords["k"]
        shape = lead + (ct,)
        count = int(np.prod(shape))
        v = _spectral_inputs(family, shape, width, seed + ns).reshape(
            count, width)
        idx, uscale, _, _, _ = psd._tri_indices(ns)
        w = np.linalg.eigvalsh(v[:, 1:][:, idx] * uscale * math.sqrt(2.0))
        out.append((ns, k, count, (
            torch.as_tensor(v[:, 0] * math.sqrt(2.0)),
            torch.as_tensor(np.ascontiguousarray(w[:, ::-1])))))
    return out


def sum_largest_kernel_case(spec, lead: tuple, seed: int) -> list:
    """The path-following kernel (`ops/sumlargest.py`) against its plain
    version on the CPU, on the sorted eigenvalues of random sum-largest
    segments at the shapes the projections give it, within
    SPECTRAL_TOL[False] (1 + |v|); kernel time (CUDA events), the plain
    version's (a second run on the CPU; host clock), and the bound from
    this run's pass counts."""
    out = []
    for ns, k, count, args in sum_largest_kernel_inputs(spec, lead, seed):
        t_ref, x_ref, passes = spectral._sum_largest_sorted_plain(
            *args, k, passes=True)
        t_plain = time.perf_counter()
        spectral._sum_largest_sorted_plain(*args, k)
        plain_ms = (time.perf_counter() - t_plain) * 1e3
        dev = [a.cuda() for a in args]
        t_got, x_got = (a.cpu() for a in sumlargest.sum_largest_sorted(
            *dev, k))
        scale = 1.0 + float(max(a.abs().max() for a in args))
        err = max(float((t_got - t_ref).abs().max()),
                  float((x_got - x_ref).abs().max())) / scale
        ms = median_ms(lambda: sumlargest.sum_largest_sorted(*dev, k))
        # ~15 operations a pass, then n for the assembly
        ops = float(passes.sum()) * 15 + count * ns
        nbytes = count * 2 * (ns + 1) * 8
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / FP64_FLOPS) * 1e3
        case = {"ns": ns, "k": k, "cones": count, "max_abs_err": err,
                "passes_max": int(passes.max()), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": ("operations" if ops / FP64_FLOPS
                             > nbytes / HBM_BYTES_PER_S else "bytes"),
                "library_ms": None}
        print(f"sum_largest_sorted n={ns} k={k} cones={count}: max_abs_err "
              f"{err:.3e} (1 + |v|), passes at most {case['passes_max']}, "
              f"kernel {ms:.4f} ms, plain version on the CPU "
              f"{plain_ms:.1f} ms, bound {bound_ms:.6f} ms "
              f"({case['bound_by']})")
        check(err <= SPECTRAL_TOL[False], f"sum_largest_sorted n={ns}: "
              f"{err:.2e} from the plain version")
        out.append(case)
    return out


def spectral_projection_rows(spec, lead: tuple, label: str) -> list:
    """Each spectral run of `spec`, its cones stacked as the projection
    gets them (lead + (cones of the run,)), projected on the card with the
    eigh and SVD in float64 and in float32 and held to the CPU's run of
    the same function on the same inputs (SPECTRAL_TOL); host wall ms and
    host syncs per projection, and for logdet the Newton iterations and
    the cones through the IPM."""
    rows = []
    for i, (family, _, ct, width, _) in enumerate(
            project.spectral_runs(spec)):
        shape = lead + (ct,)
        count = int(np.prod(shape))
        v = _spectral_inputs(family, shape, width, seed=130 + i)
        x = torch.as_tensor(v, device="cuda")
        row = {"family": family, "width": width, "cones": list(shape)}
        for f32 in (False, True):
            fn = project.spectral_runs(spec, f32)[i][4]
            key = "f32" if f32 else "f64"
            keep = np.ones(count, bool)
            if family == "logdet":
                with_info = functools.partial(
                    spectral.proj_logdet_batch_info, **fn.keywords)
                (ref, ref_info), (out, info) = (with_info(torch.as_tensor(v)),
                                                with_info(x))
                info = info.reshape(-1).cpu()
                keep = ((info < 100) & (ref_info.reshape(-1) < 100)).numpy()
                row[f"{key}_gated_cones"] = int(count - keep.sum())
                row[f"{key}_ipm_cones"] = int((info >= 1000).sum())
                row[f"{key}_newton_its_max"] = int((info % 1000).max())
            else:
                ref, out = fn(torch.as_tensor(v)), fn(x)
            ref = ref.reshape(count, -1).numpy()
            out = out.reshape(count, -1).cpu().numpy()
            err = float(np.abs(out - ref)[keep].max() / (1 + np.abs(v).max())
                        if keep.any() else 0.0)
            row[f"{key}_err"] = err
            row[f"{key}_ms"] = _wall_ms(lambda: fn(x), 3)
            row[f"{key}_syncs"] = _host_syncs(lambda: fn(x))
            tol = SPECTRAL_TOL[f32]
            if family == "logdet":
                tol = max(tol, LOGDET_TOL)
            check(math.isfinite(err) and err <= tol
                  and np.isfinite(out).all(),
                  f"spectral projection {label} {family} {key}: card against "
                  f"the CPU {err:.1e} > {tol:.0e} (1 + |v|)")
        extra = (f"; cones at Newton's cap or through the IPM (not held "
                 f"to the tolerance) float64 {row['f64_gated_cones']}, "
                 f"float32 eig {row['f32_gated_cones']} of {count}; through "
                 f"the IPM on the card float64 {row['f64_ipm_cones']} "
                 f"({100 * row['f64_ipm_cones'] / count:.1f} %), float32 "
                 f"eig {row['f32_ipm_cones']} "
                 f"({100 * row['f32_ipm_cones'] / count:.1f} %); Newton "
                 f"iterations at most {row['f64_newton_its_max']} "
                 f"(float32 eig {row['f32_newton_its_max']})"
                 if family == "logdet" else "")
        print(f"spectral projection {label} {family} width {width} cones "
              f"{row['cones']}: float64 {row['f64_ms']:.3f} ms "
              f"({row['f64_syncs']} host syncs), float32 eig "
              f"{row['f32_ms']:.3f} ms ({row['f32_syncs']} host syncs) per "
              f"projection (host wall); card against the CPU "
              f"{row['f64_err']:.1e} and {row['f32_err']:.1e} "
              f"(1 + |v|){extra}")
        rows.append(row)
    return rows


def spectral_large(p, spec) -> dict:
    """The large spectral program through Workspace: direct mixed (K1 and
    the logdet kernel counted, the forced float64 polish entered), direct
    pure float64 and indirect mixed, each held against the planted
    optimum, SCS's termination test recomputed in float64 and the pure
    float64 objective."""
    out = {}
    one = tuple(t.cuda()[None] for t in (p.problem.A, p.problem.b,
                                         p.problem.c))
    for label, stg in (("direct mixed", Settings(linsys="direct")),
                       ("direct pure f64", Settings(linsys="direct",
                                                    mixed_precision=False)),
                       ("indirect mixed", Settings())):
        torch.cuda.synchronize()
        dsmatvec.launches = 0
        logdet.launches = 0
        sumlargest.launches = 0
        ws = Workspace(p.problem, spec, p.cone_data, stg)
        polish = []
        enter = ws._enter_polish_phase

        def spy(st, enter=enter, polish=polish):
            res = enter(st)
            polish.append(res[1] is not None)
            return res

        ws._enter_polish_phase = spy
        sol, info = ws.solve()
        torch.cuda.synchronize()
        launches, k6, k7 = (dsmatvec.launches, logdet.launches,
                            sumlargest.launches)
        err = abs(info.pobj - p.opt) / (1 + abs(p.opt))
        fails = {k: int(v.sum()) for k, v in termination_failures(
            one, _lane_result(sol), stg).items() if v.any()}
        it = max(info.iter, 1)
        print(f"large spectral {label}: {info.status}, {info.iter} "
              f"iterations"
              f"{f', {ws.tot_cg_its} CG iterations' if stg.linsys == 'indirect' else ''}"
              f", setup {info.setup_time:.1f} ms, solve "
              f"{info.solve_time:.1f} ms, {info.solve_time / it:.3f} "
              f"ms/iteration, pobj {info.pobj!r} (planted {p.opt!r}, rel "
              f"err {err:.2e}), K1 launches {launches} "
              f"({launches / it:.2f} per iteration), logdet_cone launches "
              f"{k6}, sum_largest_sorted launches {k7}, "
              f"polish phase entered {polish}, "
              f"SCS's tests failed {fails or 'none'}")
        check(info.status == "solved", f"large spectral {label}: "
              f"{info.status}")
        check(err <= 1e-3, f"large spectral {label}: objective error "
              f"{err:.2e}")
        check(not fails and bool(np.all(np.isfinite(sol.x))),
              f"large spectral {label}: SCS's termination test fails "
              f"{fails}, or x not finite")
        check(min(k6, k7) >= info.iter, f"large spectral {label}: {k6} "
              f"logdet_cone and {k7} sum_largest_sorted launches in "
              f"{info.iter} iterations")
        if ws._mixed:
            check(polish == [True], f"large spectral {label}: the forced "
                  f"float64 polish was not entered ({polish})")
            check(launches >= 2 * info.iter, f"large spectral {label}: K1 "
                  f"launched {launches} times in {info.iter} iterations")
        else:
            check(launches == 0, f"large spectral {label}: pure f64 "
                  f"launched K1")
        out[label] = {"iter": info.iter, "solve_ms": info.solve_time,
                      "launches": launches, "k6": k6, "k7": k7,
                      "pobj": info.pobj, "mixed": ws._mixed}
    pure = out["direct pure f64"]["pobj"]
    for label in ("direct mixed", "indirect mixed"):
        agree = abs(out[label]["pobj"] - pure) / (1 + abs(pure))
        check(out[label]["mixed"] and agree <= 1e-3,
              f"large spectral {label}: not mixed, or {agree:.2e} from pure "
              f"f64")
    return out


def ozaki_product() -> float:
    """`ops/ozaki.py` on the card, which no solver path calls
    (`supported()` is False on the H100): one product whose contraction of
    3000 takes three chunks of 1024, its bf16 slice products accumulated
    in float32 on the tensor cores, against numpy's float64 product, within
    1e-14 of A's row scale x B's column scale x k."""
    rng = np.random.RandomState(64)
    A, B = rng.randn(64, 3000), rng.randn(3000, 48)
    t0 = time.perf_counter()
    C = ozaki.ozaki_matmul(torch.as_tensor(A, device="cuda"),
                           torch.as_tensor(B, device="cuda")).cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3
    scale = (np.abs(A).max(1, keepdims=True) * np.abs(B).max(0, keepdims=True)
             * A.shape[1])
    err = float(np.max(np.abs(C - A @ B) / scale))
    print(f"ozaki_matmul (64, 3000) x (3000, 48) on the card: {err:.2e} of "
          f"the operand scales x k from numpy's float64 product (bound "
          f"1e-14), {ms:.1f} ms (first call, host clock)")
    check(bool(np.all(np.isfinite(C))) and err < 1e-14,
          f"ozaki_matmul on the card: {err:.2e} from numpy's float64 product")
    return err


def spectral_phase(card: str, f32: BatchChild) -> dict:
    """Phase 13 (see the module docstring); `f32` the process that solves
    the first SPECTRAL_F32_LANES lanes with float32 state."""
    t0 = time.perf_counter()
    sspec_big = spectral_cones.large_spectral_spec()
    sspec = spectral_cones.headline_spectral_spec()
    floor_ms = median_ms(sumlargest.empty_launch)
    print(f"empty kernel launch {floor_ms:.4f} ms (the floor beside the "
          f"logdet and sum_largest_sorted kernels' times)")
    kcases = (logdet_kernel_case(sspec, (1024,), 300)
              + logdet_kernel_case(sspec_big, (), 310))
    scases = (sum_largest_kernel_case(sspec, (1024,), 320)
              + sum_largest_kernel_case(sspec_big, (), 330))
    edges = spectral_kernel_edges(340)
    ozaki_err = ozaki_product()
    rows = (spectral_projection_rows(sspec_big, (), "large")
            + spectral_projection_rows(sspec, (1024,), "batch B=1024"))
    sbatch = headline_batch(sspec, 1024, 1000)
    B, m = sbatch[1].shape
    gen = torch.Generator(device="cuda").manual_seed(63)
    x = torch.randn(B, m, generator=gen, dtype=torch.float64, device="cuda")
    r = 0.1 + torch.rand(B, m, generator=gen, dtype=torch.float64,
                         device="cuda")
    syncs = {f32: _host_syncs(lambda: project.proj_dual_cone_batched(
        x, sspec, None, None, r, psd_f32=f32)) for f32 in (False, True)}
    print(f"proj_dual_cone_batched ({B}, {m}) spectral layout: host syncs "
          f"per projection float64 {syncs[False]}, float32 eig "
          f"{syncs[True]}")
    print(f"phase 13 projections done at {time.perf_counter() - t0:.1f} s")
    big_p = gen_planted(sspec_big, n=2048, seed=7, density=0.3)
    big = spectral_large(big_p, sspec_big)
    print(f"phase 13 large program done at {time.perf_counter() - t0:.1f} s")
    # objectives: every lane passes SCS's termination test at eps 1e-4
    # (verify_termination); against the planted optimum and pure f64 the
    # PSD batch's bounds (2e-3 and 1e-3 with float64 state, 5e-3 with
    # float32 state)
    runs = {}
    for label, kw in (("mixed float64 state", dict(fast_f32=False)),
                      ("pure f64", dict(mixed_precision=False))):
        logdet.launches = 0
        sumlargest.launches = 0
        runs[label] = solve_batch(
            sspec, sbatch, Settings(linsys="direct", chunk_iters=250, **kw),
            f"spectral batch {label}", tol=2e-3)
        runs[label]["k6"] = logdet.launches
        runs[label]["k7"] = sumlargest.launches
    runs[f"mixed B={SPECTRAL_F32_LANES}"] = f32.result()
    for label, run in runs.items():
        print(f"spectral batch {label}: logdet_cone launches {run['k6']}, "
              f"sum_largest_sorted launches {run['k7']}")
        check(min(run["k6"], run["k7"]) >= run["steps"], f"spectral batch "
              f"{label}: the spectral kernels launched fewer times than the "
              f"batch stepped")
    mixed64 = runs["mixed float64 state"]
    mixed32 = runs[f"mixed B={SPECTRAL_F32_LANES}"]
    pure = runs["pure f64"]
    fast = mixed32["by_phase"].get("fast", 0)
    check(mixed32["f32_state"] and mixed32["pair"] >= 2 * fast > 0,
          f"spectral batch: float32 state {mixed32['f32_state']}, "
          f"{mixed32['pair']} K3 launches for {fast} fast steps")
    check(mixed32["launches"] >= 2 * mixed32["steps"],
          f"spectral batch: {mixed32['launches']} K2 launches < 2 x "
          f"{mixed32['steps']} steps")
    check(mixed64["launches"] >= 4 * mixed64["steps"]
          and mixed64["pair"] == 0,
          f"spectral batch, float64 state: {mixed64['launches']} K2 "
          f"launches < 4 x {mixed64['steps']} steps, or K3 launched")
    for label, run in (("mixed float64 state", mixed64),
                       (f"mixed B={SPECTRAL_F32_LANES}", mixed32)):
        lanes = len(run["status"])
        check(run["polished"] == lanes
              and run["by_phase"].get("polish", 0) > 0,
              f"spectral batch {label}: {run['polished']} of {lanes} lanes "
              f"took the forced float64 polish")
    check(pure["polished"] == 0, "spectral batch pure f64 polished")
    for label, run, tol in (("mixed float64 state", mixed64, 1e-3),
                            (f"mixed B={SPECTRAL_F32_LANES}", mixed32, 5e-3)):
        lanes = len(run["status"])
        check(bool(np.array_equal(pure["status"][:lanes], run["status"])),
              f"spectral batch: pure and {label} statuses differ")
        agree = np.abs(run["pobj"] - pure["pobj"][:lanes]) / (
            1 + np.abs(pure["pobj"][:lanes]))
        print(f"spectral batch: {label} against pure f64, pobj rel diff max "
              f"{agree.max():.3e}")
        check(bool(np.all(agree <= tol)), f"spectral batch: {label} vs pure "
              f"pobj differ by {agree.max():.2e}, above {tol:.0e}")
    print(f"{card}, phase 13 (spectral) {time.perf_counter() - t0:.1f} s, "
          f"peak device memory of the last batch "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"kernel": kcases, "sl_kernel": scases, "edges": edges,
            "floor_ms": floor_ms, "rows": rows, "ozaki_err": ozaki_err,
            "syncs": syncs, "large": big, "batch": runs}


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


# ---- phase 14: sparse (blocked-ELL) problems, `demo_sparse` ----

# stages of the cut instance of the direct leg and the repeat check: n =
# 64 x 128 = 8192, the widths unchanged. The direct backend's dense Gram
# at the full n = 64000 would take 33 GB, its split and factor 66 GB more.
SPARSE_CUT_STAGES = 64
# the operand beyond K2's grid limit (gridDim.z, 65535), which K2s's
# gridDim.x takes in one launch: 75000 block-rows of 8 (600000 rows), two
# tiles of 128 each, a band
BAND_BLOCK_ROWS = 75000


def _scipy_csc(A):
    """A SparseA (any device) as a float64 scipy CSC matrix on the host."""
    import scipy.sparse as sp
    colptr, rows, vals = sparse.sparse_to_csc(A)
    return sp.csc_matrix((vals, rows, colptr), shape=A.shape)


def _csr_on_card(M, dtype=torch.float64):
    """A scipy matrix as a torch CSR tensor of `dtype` on the card (the
    library call's operand, timed only)."""
    M = M.tocsr()
    return torch.sparse_csr_tensor(
        torch.as_tensor(M.indptr, device="cuda"),
        torch.as_tensor(M.indices, device="cuda"),
        torch.as_tensor(M.data, dtype=dtype, device="cuda"), M.shape,
        check_invariants=True)


def _k2s_bound(nnz: int, m: int, n: int, kind: str) -> tuple:
    """K2s's least time for these inputs: each nonzero read once (8 bytes
    for the pair and float64, 4 for float32) and x read and y written
    once (8 or 4 bytes an entry) at 3.35 TB/s, or its operations (3
    float64 a nonzero for the pair: hi + lo, then an FMA; 2 for float64;
    2 at the float32 rate for float32); (ms, "bytes" or "operations").
    The layout's index bytes are not in it (each row lists them)."""
    elem = 4 if kind == "f32" else 8
    t_b = elem * (nnz + m + n) / HBM_BYTES_PER_S
    t_f = ((3 if kind == "pair" else 2) * nnz
           / (FP32_FLOPS if kind == "f32" else FP64_FLOPS))
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


class _GatherSpy:
    """Counts the calls of `sparse._gather_x` (the blocked-ELL gather of x
    that the plain versions make and K2s does not) while it is entered."""

    def __enter__(self):
        self.calls, self._orig = 0, sparse._gather_x

        def spy(*args):
            self.calls += 1
            return self._orig(*args)
        sparse._gather_x = spy
        return self

    def __exit__(self, *exc):
        sparse._gather_x = self._orig


def _k2s_counts() -> tuple:
    return (ellmatvec.pair_launches, ellmatvec.f32_launches,
            ellmatvec.f64_launches, dsmatvec.launches,
            dsmatvec.batched_launches)


def _k2s_form(label: str, kind: str, apply, kernel, plain, ell, M, x,
              nnz: int, n_tails: int) -> dict:
    """One kind of K2s on one direction: the whole apply (K2s on the tiles
    and the tails) launches K2s once (and the tails' K1 once each in the
    pair) and gathers no x, within tol of scipy's float64 product; K2s
    alone within tol of its plain version on the card; times of K2s, its
    plain version, the whole apply, and torch.mv on a CSR tensor of the
    kind's dtype (float64 for the pair), beside the bound. tol is 1e-13
    (1 + max |A||x|), 1e-5 (1 + max |A||x|) for float32."""
    xh = x.double().cpu().numpy()
    tol = (1e-5 if kind == "f32" else 1e-13) * (
        1.0 + float((abs(M) @ np.abs(xh)).max()))
    before = _k2s_counts()
    with _GatherSpy() as spy:
        y = apply()
        torch.cuda.synchronize()
    got = [a - b for a, b in zip(_k2s_counts(), before)]
    want = [int(kind == "pair"), int(kind == "f32"), int(kind == "f64"),
            n_tails if kind == "pair" else 0, 0]
    check(got == want and spy.calls == 0, f"{label} {kind}: launches (K2s "
          f"pair, f32, f64, K1, K2) {got}, want {want}; {spy.calls} "
          f"gathers of x")
    err = float((kernel().double() - plain().double()).abs().max())
    err_scipy = float(np.abs(y.double().cpu().numpy() - M @ xh).max())
    check(math.isfinite(err) and err <= tol, f"{label} {kind}: max|kernel -"
          f" plain| = {err:.3e} > {tol:.3e}")
    check(err_scipy <= tol, f"{label} {kind}: max|apply - scipy| = "
          f"{err_scipy:.3e} > {tol:.3e}")
    m, n = M.shape
    bound, by = _k2s_bound(nnz, m, n, kind)
    tiles = int(ell.count.sum())
    out = {"kind": kind, "bn": ell.bn, "kmax": ell.kmax, "tiles": tiles,
           "stored": tiles * ell.bm * ell.bn, "nnz": nnz,
           "index_bytes": 4 * (tiles + ell.idx.shape[0]),
           "max_abs_err": max(err, err_scipy), "tol": tol,
           "ms": median_ms(kernel), "plain_ms": median_ms(plain),
           "apply_ms": median_ms(apply), "bound_ms": bound, "bound_by": by}
    try:
        csr = _csr_on_card(M, x.dtype)
        out["library_ms"] = median_ms(lambda: torch.mv(csr, x))
    except RuntimeError as e:          # no CSR product in this build
        out["library_ms"] = None
        print(f"{label}: torch.mv on a {x.dtype} CSR tensor failed: {e}")
    print(f"sparse K2s {kind} {label} ({m} x {n}, {nnz} nonzeros in the "
          f"tiles; bn {ell.bn}, kmax {ell.kmax}, {tiles} tiles, "
          f"{out['stored']} elements read, {out['index_bytes']} index "
          f"bytes): max|kernel - plain| {err:.3e}, max|apply - scipy| "
          f"{err_scipy:.3e} (tol {tol:.3e}); K2s {out['ms']:.4f} ms, bound "
          f"{bound:.4f} ms ({by}), {100 * bound / out['ms']:.0f}% of bound, "
          f"plain {out['plain_ms']:.4f} ms, whole apply "
          f"{out['apply_ms']:.4f} ms, torch.mv ({x.dtype} CSR) "
          f"{out['library_ms']} ms")
    return out


def sparse_kernel_case(label: str, S, M, seed: int) -> dict:
    """K2s on one direction of a sparse operand (S's forward direction; M
    the same matrix in float64 scipy CSC/CSR on the host), each kind
    (`_k2s_form`): the pair on the double-single split (re-tiled at its
    chosen width) with the tails' K1, float32 on the float32 shadow
    (`SparseA.retiled`), float64 on the operand's own tiles (the pure
    path); and the dense tails' K1 alone against torch.mv."""
    ds = sparse.ds_split_sparse(S)
    sh = S.retiled(torch.float32)
    m, n = S.shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=gen, dtype=torch.float64, device="cuda")
    x32 = x.float()
    nnz = int((S.fwd.data != 0).sum())
    n_tails = int(ds.rows_split is not None) + int(ds.cols_split is not None)
    out = {"label": label, "mn": [m, n],
           "own_tiles": list(S.fwd.data.shape),
           "split_elements": ds.ell.hi.numel(),
           "padded_split_elements": S.fwd.data.numel()}
    out["pair"] = _k2s_form(
        label, "pair", lambda: sparse.ds_sparse_matvec(ds, x),
        lambda: sparse.ds_ell_matvec(ds.ell, x),
        lambda: sparse.ds_ell_matvec(ds.ell, x, plain=True), ds.ell, M, x,
        nnz, n_tails)
    out["f32"] = _k2s_form(
        label, "f32", lambda: sh @ x32,
        lambda: sparse.ell_matvec(sh.fwd, x32),
        lambda: sparse.ell_matvec_plain(sh.fwd, x32), sh.fwd, M, x32, nnz,
        n_tails)
    out["f64"] = _k2s_form(
        label, "f64", lambda: S @ x, lambda: sparse.ell_matvec(S.fwd, x),
        lambda: sparse.ell_matvec_plain(S.fwd, x), S.fwd, M, x, nnz,
        n_tails)
    out["tails_ms"] = []
    for tail in (ds.rows_split, ds.cols_split):
        if tail is not None:
            v = x if tail is ds.rows_split else x.index_select(
                0, ds.cols_index)
            # the same function in one library call: torch.mv on the
            # float64 tail (hi + lo); bound: the pair read once (8 bytes an
            # element), x read and y written once (8 bytes each)
            T = tail.hi.double() + tail.lo.double()
            rows, cols = tail.hi.shape
            out["tails_ms"].append(
                [list(tail.hi.shape),
                 median_ms(lambda: dsmatvec.ds_matvec(tail, v)),
                 median_ms(lambda: dsmatvec.ds_matvec_plain(tail, v)),
                 median_ms(lambda: torch.mv(T, v)),
                 8 * (rows * cols + rows + cols) / HBM_BYTES_PER_S * 1e3])
    print(f"sparse {label}: own tiles {out['own_tiles']}, the pair's split "
          f"{out['split_elements']} elements (the padded split of the own "
          f"tiles: {out['padded_split_elements']}); tails K1 [shape, ms, "
          f"plain ms, torch.mv ms, bound ms (bytes)] {out['tails_ms']}")
    return out


def k2_beyond_grid_case(seed: int) -> dict:
    """K2s (the pair) on a banded operand of BAND_BLOCK_ROWS block-rows
    (more than the 65535 that gridDim.z allowed K2: one launch now, the
    block-rows on gridDim.x) against its plain version, within 1e-13 (1 +
    max |A||x|)."""
    nbr, bm, bn, kmax = BAND_BLOCK_ROWS, 8, 128, 2
    m = n = nbr * bm
    ncb = -(-n // bn)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    data = torch.randn(nbr, bm, kmax * bn, generator=gen,
                       dtype=torch.float64, device="cuda")
    c = torch.clamp(torch.arange(nbr, device="cuda") * ncb // nbr,
                    max=ncb - 2)
    idx = torch.stack([c, c + 1], 1).to(torch.int32)
    ds = sparse.ds_split_ell(sparse.BlockedEll(data, idx, m, n, bm, bn,
                                               kmax))
    del data
    x = torch.randn(n, generator=gen, dtype=torch.float64, device="cuda")
    before = ellmatvec.pair_launches
    with _GatherSpy() as spy:
        y = sparse.ds_ell_matvec(ds, x)
        torch.cuda.synchronize()
    launches = ellmatvec.pair_launches - before
    ref = sparse.ds_ell_matvec(ds, x, plain=True)
    A64 = ds.hi.double() + ds.lo.double()
    absax = float(torch.bmm(A64.abs(), sparse._gather_x(
        ds, x.abs()).unsqueeze(-1)).max())
    del A64
    err = float((y - ref).abs().max())
    tol = 1e-13 * (1.0 + absax)
    print(f"sparse K2s band beyond K2's grid ({m} rows, {nbr} block-rows, "
          f"bn {ds.bn}, {ds.hi.numel() * 8 / 1e9:.2f} GB of split): "
          f"{launches} launch, {spy.calls} gathers of x, max|kernel - "
          f"plain| {err:.3e} (tol {tol:.3e})")
    check(launches == 1 and spy.calls == 0, f"band beyond K2's grid: "
          f"{launches} K2s launches, {spy.calls} gathers, not one launch")
    check(math.isfinite(err) and err <= tol, f"band beyond K2's grid: "
          f"max|kernel - plain| = {err:.3e} > {tol:.3e}")
    return {"max_abs_err": err, "launches": launches}


def tails_operand(m: int, n: int, seed: int):
    """The tails fixture of tests/test_sparse.py at a mid size: random
    sparse entries and two dense rows and two dense columns, extracted as
    tails; (SparseA on the card, scipy CSC)."""
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    A = sp.random(m, n, density=0.01, random_state=rng,
                  data_rvs=rng.randn).tolil()
    for r in (3, 41):
        A[r, :] = rng.randn(n)
    for c in (0, 17):
        A[:, c] = rng.randn(m, 1)
    A = A.tocsc()
    return sparse.sparse_from_scipy(A, dense_rows=(3, 41),
                                    dense_cols=(0, 17), device="cuda"), A


def sparse_termination_failures(A, b, c, sol, stg) -> list:
    """SCS's termination test (as `termination_failures`) recomputed in
    float64 from the original sparse A, b, c and the returned x, y, s;
    the names of the tests that fail."""
    x, y, s = (torch.as_tensor(v, device="cuda") for v in (sol.x, sol.y,
                                                          sol.s))
    ax, aty = A @ x, A.T @ y
    ctx, bty = float(c @ x), float(b @ y)

    def inf(t):
        return float(t.abs().max())

    tests = {"res_pri": (inf(ax + s - b), max(inf(b), inf(s), inf(ax))),
             "res_dual": (inf(aty + c), max(inf(c), inf(aty))),
             "gap": (abs(ctx + bty), max(abs(ctx), abs(bty)))}
    return [k for k, (v, scl) in tests.items()
            if not v <= 1.01 * (stg.eps_abs + stg.eps_rel * scl)]


def sparse_solve(prob, spec, opt: float, label: str, stg) -> dict:
    """One sparse problem through Workspace on the card, the counts set to
    0 just before: status, iterations, CG iterations, setup and solve ms,
    K2s launches of each kind (eager; `ellmatvec.captured` counts those
    captured into the CG's graphs, each replay then runs them again), K1
    and K2 launches, gathers of x, host reads; gated on status `solved`,
    SCS's termination test recomputed in float64 and the planted optimum
    within 1e-3 (1 + |opt|)."""
    torch.cuda.synchronize()
    dsmatvec.launches = dsmatvec.batched_launches = 0
    ellmatvec.pair_launches = ellmatvec.f32_launches = 0
    ellmatvec.f64_launches = ellmatvec.captured = 0
    indirect.host_reads = 0
    indirect.refine_passes = 0
    with _GatherSpy() as spy:
        ws = Workspace(prob, spec, None, stg)
        sol, info = ws.solve()
        torch.cuda.synchronize()
    out = {"iter": info.iter, "cg": ws.tot_cg_its, "mixed": ws._mixed,
           "setup_ms": info.setup_time, "solve_ms": info.solve_time,
           "k2": dsmatvec.batched_launches, "k1": dsmatvec.launches,
           "pair": ellmatvec.pair_launches, "f32": ellmatvec.f32_launches,
           "f64": ellmatvec.f64_launches, "captured": ellmatvec.captured,
           "gathers": spy.calls,
           "reads": indirect.host_reads, "passes": indirect.refine_passes,
           "status": info.status, "pobj": info.pobj,
           "digest": _digest(sol.x, sol.y, sol.s)}
    it = max(info.iter, 1)
    err = abs(info.pobj - opt) / (1 + abs(opt))
    print(f"{label}: {info.status}, {info.iter} iterations, {ws.tot_cg_its} "
          f"CG iterations ({ws.tot_cg_its / it:.1f} per iteration), setup "
          f"{info.setup_time:.1f} ms, solve {info.solve_time:.1f} ms, "
          f"{info.solve_time / it:.3f} ms/iteration, K2s launches pair "
          f"{out['pair']} ({out['pair'] / it:.2f} per iteration), float32 "
          f"{out['f32']}, float64 {out['f64']} (captured into CUDA graphs "
          f"{out['captured']}), K1 launches {out['k1']}, K2 {out['k2']}, "
          f"gathers of x {out['gathers']}, host reads {out['reads']} "
          f"({out['reads'] / it:.2f} per iteration), refinement passes "
          f"{out['passes']}, pobj {info.pobj!r} (planted {opt!r}, rel err "
          f"{err:.2e}), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(info.status == "solved", f"{label}: status {info.status}")
    check(err <= 1e-3, f"{label}: objective error {err:.2e}")
    check(out["k2"] == 0 and out["gathers"] == 0, f"{label}: {out['k2']} "
          f"K2 launches, {out['gathers']} gathers of x on a sparse operand")
    A = prob.A.to("cuda")
    fails = sparse_termination_failures(A, prob.b.cuda(), prob.c.cuda(),
                                        sol, stg)
    check(not fails, f"{label}: fails SCS's {fails} test recomputed from "
          f"the original data")
    return out


def _on_card(prob):
    return dataclasses.replace(prob, A=prob.A.to("cuda"), b=prob.b.cuda(),
                               c=prob.c.cuda())


def sparse_phase(card: str, stages: int = 500) -> dict:
    """Phase 14 (see the module docstring); `stages` of the full instance
    (tools/torch_sparse_phase.py may take fewer)."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    prob, spec, opt, meta = demo_sparse.build_problem(K=stages)
    print(f"demo_sparse full size: A {meta['m']} x {meta['n']}, nnz "
          f"{meta['nnz']}, stored {meta['stored_bytes'] / 1e9:.3f} GB (dense "
          f"{meta['dense_bytes'] / 1e9:.1f} GB), tiles A "
          f"{tuple(prob.A.fwd.data.shape)} A' "
          f"{tuple(prob.A.bwd.data.shape)}, host build "
          f"{time.perf_counter() - t0:.1f} s (tiles {meta['build_s']:.1f} s)")
    prob = _on_card(prob)
    M = _scipy_csc(prob.A)
    rows = [sparse_kernel_case("demo A", prob.A, M, 400),
            sparse_kernel_case("demo A'", prob.A.T, M.T, 401)]
    tails, Mt = tails_operand(4000, 3000, 402)
    rows.append(sparse_kernel_case("tails fixture", tails, Mt, 403))
    band = k2_beyond_grid_case(404)
    del M, Mt, tails
    print(f"phase 14 kernel rows done at {time.perf_counter() - t0:.1f} s")

    stg = demo_sparse.SETTINGS
    full = {"mixed": sparse_solve(prob, spec, opt, "demo_sparse full size "
                                  "indirect mixed", stg),
            "pure f64": sparse_solve(prob, spec, opt, "demo_sparse full "
                                     "size indirect pure f64",
                                     dataclasses.replace(
                                         stg, mixed_precision=False))}
    mx, pu = full["mixed"], full["pure f64"]
    check(mx["mixed"] and mx["pair"] >= 2 * mx["iter"] and mx["f32"] > 0,
          f"demo_sparse mixed: not mixed, or {mx['pair']} K2s pair launches"
          f" < 2 x {mx['iter']}, or {mx['f32']} float32 ones")
    check(pu["f64"] > 0 and pu["pair"] == pu["f32"] == pu["k1"] == 0,
          f"demo_sparse pure f64: K2s float64 {pu['f64']} launches, pair "
          f"{pu['pair']}, float32 {pu['f32']}, K1 {pu['k1']}")
    print(f"phase 14 full-size solves done at {time.perf_counter() - t0:.1f}"
          f" s")

    # the cut instance: the direct backend sparse against dense, and the
    # indirect pure solve twice
    cprob, cspec, copt, cmeta = demo_sparse.build_problem(
        K=SPARSE_CUT_STAGES)
    cprob = _on_card(cprob)
    dense = dataclasses.replace(cprob, A=cprob.A.todense())
    cut = {}
    for mode, mixed in (("pure f64", False), ("mixed", True)):
        dstg = Settings(linsys="direct", mixed_precision=mixed,
                        eps_abs=1e-4, eps_rel=1e-4, max_iters=20_000)
        sp_run = sparse_solve(cprob, cspec, copt, f"demo_sparse K="
                              f"{SPARSE_CUT_STAGES} sparse direct {mode}",
                              dstg)
        de_run = sparse_solve(dense, cspec, copt, f"demo_sparse K="
                              f"{SPARSE_CUT_STAGES} dense direct {mode}",
                              dstg)
        agree = abs(sp_run["pobj"] - de_run["pobj"]) / (
            1 + abs(de_run["pobj"]))
        print(f"demo_sparse K={SPARSE_CUT_STAGES} direct {mode}: sparse "
              f"{sp_run['iter']} against dense {de_run['iter']} iterations, "
              f"pobj rel diff {agree:.3e}")
        check(agree <= 1e-5, f"direct {mode}: sparse and dense pobj differ "
              f"by {agree:.2e}")
        if mixed:
            check(sp_run["pair"] > 0 and sp_run["k1"] > 0,
                  f"sparse direct mixed: K2s pair {sp_run['pair']}, K1 "
                  f"{sp_run['k1']} launches")
        else:
            check(sp_run["f64"] > 0 and sp_run["k1"] == 0,
                  f"sparse direct pure f64: K2s float64 {sp_run['f64']}, "
                  f"K1 {sp_run['k1']} launches")
        cut[mode] = sp_run
    del dense
    kcut = ds_matvec_case(cprob.A.shape[1], cprob.A.shape[1], seed=405)
    print(f"ds_matvec {kcut['shape'][0]}x{kcut['shape'][1]} (the cut "
          f"instance's K): max_abs_err {kcut['max_abs_err']:.3e} (tol "
          f"{kcut['tol']:.3e}), kernel {kcut['ms']:.4f} ms, bound "
          f"{kcut['bound_ms']:.4f} ms ({kcut['bound_by']}), {share(kcut)}, "
          f"plain {kcut['plain_ms']:.4f} ms, torch.mv {kcut['library_ms']:.4f}"
          f" ms")
    reps = [sparse_solve(cprob, cspec, copt, f"demo_sparse K="
                         f"{SPARSE_CUT_STAGES} indirect pure f64, run {i}",
                         dataclasses.replace(demo_sparse.SETTINGS,
                                             mixed_precision=False))
            for i in (1, 2)]
    same = (reps[0]["iter"] == reps[1]["iter"]
            and reps[0]["digest"] == reps[1]["digest"])
    print(f"demo_sparse K={SPARSE_CUT_STAGES} indirect pure f64 twice: "
          f"iterations {reps[0]['iter']}, {reps[1]['iter']}; x, y, s "
          f"bitwise equal {reps[0]['digest'] == reps[1]['digest']}")
    check(same, "sparse indirect pure f64: two solves differ")
    print(f"{card}, phase 14 (sparse) {time.perf_counter() - t0:.1f} s, peak"
          f" device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB")
    return {"rows": rows, "band": band, "full": full, "cut": cut,
            "k1_cut": kcut, "prob": prob, "spec": spec}



# phase 15: the entry points of ROADMAP items 13 and 14 (tracked-rank PSD,
# files, compat, the CLI, checkpoint/resume, the trace and the timers)
LOWRANK_NS, LOWRANK_R, LOWRANK_N = 400, 4, 200


def _syncs_of(fn):
    """(fn's result, the host synchronizations it made, counted from the
    warnings of set_sync_debug_mode("warn"); explicit
    torch.cuda.synchronize calls are not among them)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message).lower() for w in caught)


def tracked_solve(p, spec, stg, label: str, tol: float) -> dict:
    """One Workspace solve on the card with the K1 and gate counts set to
    0 just before: status, distance to the planted optimum (gate `tol`
    (1 + |opt|)), SCS's termination test, iterations, ms/it, the share of
    the tracked-rank projections whose certificate passed."""
    torch.cuda.synchronize()
    dsmatvec.launches = 0
    psd.gate_checks = psd.gate_passes = 0
    ws = Workspace(p.problem, spec, p.cone_data, stg)
    sol, info = ws.solve()
    torch.cuda.synchronize()
    k1, checks, passes = dsmatvec.launches, psd.gate_checks, psd.gate_passes
    one = tuple(torch.as_tensor(t).cuda()[None] for t in (
        p.problem.A, p.problem.b, p.problem.c))
    fails = {k: int(v.sum()) for k, v in termination_failures(
        one, _lane_result(sol), stg).items() if v.any()}
    err = abs(info.pobj - p.opt) / (1 + abs(p.opt))
    it = max(info.iter, 1)
    share_ok = passes / checks if checks else float("nan")
    print(f"{label}: {info.status}, {info.iter} iterations, setup "
          f"{info.setup_time:.1f} ms, solve {info.solve_time:.1f} ms, "
          f"{info.solve_time / it:.3f} ms/iteration, pobj {info.pobj!r} "
          f"(planted {p.opt!r}, rel err {err:.2e}), K1 launches {k1}, gate "
          f"passed {passes} of {checks} ({share_ok:.3f}), SCS's tests "
          f"failed {fails or 'none'}")
    check(info.status == "solved", f"{label}: {info.status}")
    check(err <= tol, f"{label}: {err:.2e} from the planted optimum, above "
          f"{tol:.0e}")
    check(not fails and bool(np.all(np.isfinite(sol.x))),
          f"{label}: SCS's termination test fails {fails}, or x not finite")
    if ws._mixed:
        check(k1 >= 2 * info.iter, f"{label}: K1 launched {k1} times in "
              f"{info.iter} iterations")
    if stg.psd_rank:
        check(checks > 0, f"{label}: the tracked-rank path did not run")
    return {"iter": info.iter, "ms_per_it": info.solve_time / it,
            "solve_ms": info.solve_time, "err": err, "k1": k1,
            "gate": (passes, checks), "status": info.status}


def psd_rank_batch() -> dict:
    """Phase 15's batch (run in a process of its own): 64 lanes of the PSD
    headline batch mixed with float64 state, psd_rank 0 and 2 (the
    largest below half of its blocks of 6 and 8), each with its gate
    counts; solve_batch's gates on each."""
    pspec = psd_cones.headline_psd_spec()
    pbatch = headline_batch(pspec, 64, 1000)
    runs = {}
    for rank in (0, 2):
        psd.gate_checks = psd.gate_passes = 0
        runs[rank] = solve_batch(
            pspec, pbatch, Settings(linsys="direct", chunk_iters=250,
                                    fast_f32=False, psd_rank=rank),
            f"PSD batch B=64 mixed float64 state psd_rank {rank}", tol=2e-3)
        runs[rank]["gate"] = [psd.gate_passes, psd.gate_checks]
        print(f"PSD batch B=64 psd_rank {rank}: gate passed "
              f"{psd.gate_passes} of {psd.gate_checks} lane decisions")
    return runs


def tracked_rank_phase(child: "BatchChild", large_exact=None) -> dict:
    """Phase 15 (a): the planted low-rank SDP (one PSD block of 400, rank
    4, n = 200, m = 80204) direct, pure float64 and mixed, at eps 1e-6,
    with psd_rank 0 and 8; phase 12's large PSD program direct mixed with
    psd_rank 8 against phase 12's run without (`large_exact`; solved here
    where None); the child's 64 lanes of the PSD batch with psd_rank 0 and
    2: the same statuses lane by lane, K2 launched."""
    out = {}
    t0 = time.perf_counter()
    p = planted_lowrank_sdp(LOWRANK_NS, LOWRANK_R, LOWRANK_N, seed=0)
    print(f"planted low-rank SDP: ns {LOWRANK_NS}, rank {LOWRANK_R}, n "
          f"{p.problem.A.shape[1]}, m {p.problem.A.shape[0]}, A "
          f"{p.problem.A.numel() * 8 / 2**20:.0f} MiB, host build "
          f"{time.perf_counter() - t0:.1f} s")
    for mode, mixed in (("pure f64", False), ("mixed", True)):
        for rank in (0, 8):
            out[("lowrank", mode, rank)] = tracked_solve(
                p, p.spec, Settings(linsys="direct", mixed_precision=mixed,
                                    eps_abs=1e-6, eps_rel=1e-6,
                                    psd_rank=rank),
                f"low-rank SDP direct {mode} psd_rank {rank}", 1e-4)
        exact, tracked = (out[("lowrank", mode, r)] for r in (0, 8))
        print(f"low-rank SDP direct {mode}: psd_rank 8 against exact eigh "
              f"{tracked['ms_per_it']:.3f} / {exact['ms_per_it']:.3f} "
              f"ms/iteration ({tracked['ms_per_it'] / exact['ms_per_it']:.3f}"
              f"x), iterations {tracked['iter']} / {exact['iter']}")

    pspec_big = psd_cones.large_psd_spec()
    big = gen_planted(pspec_big, n=2048, seed=7, density=0.3)
    if large_exact is None:
        large_exact = tracked_solve(big, pspec_big, Settings(linsys="direct"),
                                    "large PSD direct mixed psd_rank 0",
                                    1e-3)
    tracked = tracked_solve(big, pspec_big,
                            Settings(linsys="direct", psd_rank=8),
                            "large PSD direct mixed psd_rank 8", 1e-3)
    exact_ms = large_exact["solve_ms"] / max(large_exact["iter"], 1)
    print(f"large PSD direct mixed: psd_rank 8 against exact eigh "
          f"{tracked['ms_per_it']:.3f} / {exact_ms:.3f} ms/iteration, "
          f"iterations {tracked['iter']} / {large_exact['iter']}")
    out["large PSD"] = tracked

    runs = {int(k): v for k, v in child.result()["runs"].items()}
    for rank, run in runs.items():
        check(run["launches"] > 0, f"PSD batch psd_rank {rank}: no K2 "
              f"launch")
    check(runs[2]["gate"][1] > 0, "PSD batch psd_rank 2: the tracked-rank "
          "path did not run")
    check(runs[0]["status"] == runs[2]["status"],
          "PSD batch: psd_rank 2 and exact statuses differ")
    print(f"PSD batch B=64 (its own process): psd_rank 2 against exact "
          f"wall {runs[2]['wall']:.3f} / {runs[0]['wall']:.3f} s, the same "
          f"statuses, gate passed {runs[2]['gate'][0]} of "
          f"{runs[2]['gate'][1]}")
    out["batch"] = runs
    return out


def _csc_equal(S, T) -> bool:
    return all(np.array_equal(a, b) for a, b in zip(
        sparse.sparse_to_csc(S), sparse.sparse_to_csc(T)))


def entry_files_phase(head_p, big_p, spec_big, tmp: str) -> dict:
    """Phase 15 (b): the headline and large SOCPs written by the port's
    writer (the native codec's build timed first) and by its Python
    writer (the same bytes, each timed), read back by the native and the
    Python reader (the arrays equal); each solved by
    compat.SCS on the card against Workspace on the same arrays (the same
    iterations and bits; K1 counted around the compat solve; the large
    SOCP's Workspace solve under the sync count: phase 15 (c, d)'s plain
    reference); the CLI in a process of its own on the headline file,
    beside the solves; the 64-stage demo_sparse file read in sparse
    storage."""
    out = {}
    t0 = time.perf_counter()
    built = native.load() is not None
    print(f"native codec (g++) built and loaded in "
          f"{time.perf_counter() - t0:.1f} s: {built}")
    check(built, "the native codec did not build")
    cli = None
    for label, p, spec in (("headline", head_p, HEADLINE),
                           ("large SOCP", big_p, spec_big)):
        f = os.path.join(tmp, label.replace(" ", "_") + ".bin")
        t0 = time.perf_counter()
        io.write_scs_data(f, p.problem, spec, p.cone_data, Settings())
        t_nw = time.perf_counter()
        io._write_scs_data_py(f + ".py", p.problem, spec, p.cone_data,
                              Settings())
        t1 = time.perf_counter()
        with open(f, "rb") as fa, open(f + ".py", "rb") as fb:
            same_bytes = fa.read() == fb.read()
        os.remove(f + ".py")
        check(same_bytes, f"{label} file: the native and the Python "
              f"writers' bytes differ")
        nat = io.read_scs_data(f)
        t2 = time.perf_counter()
        py = io._assemble(io._read_scs_data_py(f), torch.float64, "dense",
                          torch.device("cuda"))
        t3 = time.perf_counter()
        for name in ("A", "b", "c"):
            ref = getattr(p.problem, name).cuda()
            check(torch.equal(getattr(nat[0], name), ref)
                  and torch.equal(getattr(py[0], name), ref),
                  f"{label} file: {name} read back differs")
        check(nat[1] == py[1] == spec, f"{label} file: cone spec differs")
        print(f"{label} file: {os.path.getsize(f)} bytes, native write "
              f"{(t_nw - t0) * 1e3:.1f} ms, Python write "
              f"{(t1 - t_nw) * 1e3:.1f} ms (the same bytes), native read "
              f"{(t2 - t1) * 1e3:.1f} ms, Python read {(t3 - t2) * 1e3:.1f}"
              f" ms, arrays equal")
        out[label + " io_ms"] = {
            "native write": (t_nw - t0) * 1e3, "python write":
            (t1 - t_nw) * 1e3, "native read": (t2 - t1) * 1e3,
            "python read": (t3 - t2) * 1e3}
        if cli is None:
            # the CLI on the headline file, beside the solves below
            t_cli = time.perf_counter()
            cli = subprocess.Popen(
                [sys.executable, "-m", "scs_tpu_torch.run_from_file", f,
                 "linsys", "direct", "verbose", "0"],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__)))
        data = {k: getattr(p.problem, k).numpy() for k in ("A", "b", "c")}
        cone = {"z": spec.z, "l": spec.l, "q": list(spec.q)}
        torch.cuda.synchronize()
        dsmatvec.launches = 0
        csol = compat.SCS(data, cone, verbose=False, use_indirect=False,
                          device="cuda").solve()
        torch.cuda.synchronize()
        k1 = dsmatvec.launches
        (wsol, winfo), syncs = _syncs_of(lambda: Workspace(
            p.problem, spec, p.cone_data, Settings(linsys="direct")).solve())
        ci = csol["info"]
        same = (ci["iter"] == winfo.iter
                and all(np.array_equal(csol[k], getattr(wsol, k))
                        for k in ("x", "y", "s")))
        print(f"{label} compat.SCS on the card: {ci['status']}, "
              f"{ci['iter']} iterations, solve {ci['solve_time']:.1f} ms, "
              f"pobj {ci['pobj']!r}, K1 launches {k1}; Workspace on the "
              f"same arrays {winfo.iter} iterations, "
              f"{winfo.solve_time / max(winfo.iter, 1):.3f} ms/iteration, "
              f"host syncs {syncs}, the same bits {same}")
        check(ci["status"] == "solved" and same and k1 >= 2 * ci["iter"],
              f"{label} compat: {ci['status']}, same as Workspace {same}, "
              f"K1 launches {k1}")
        out[label] = {"pobj": ci["pobj"], "k1": k1, "iter": ci["iter"],
                      "plain": (wsol, winfo, syncs)}

    stdout, stderr = cli.communicate(timeout=300)
    obj = stdout.split("objective = ")[-1].split()[:1]
    want = f"{out['headline']['pobj']:.6f}"
    print(f"python -m scs_tpu_torch.run_from_file on the headline file: rc "
          f"{cli.returncode} after {time.perf_counter() - t_cli:.1f} s, "
          f"objective {obj} (compat {want})")
    check(cli.returncode == 0 and obj == [want],
          f"run_from_file: rc {cli.returncode}, objective {obj} != {want}: "
          f"{stderr[-500:]}")

    t0 = time.perf_counter()
    sprob, sspec, _, _ = demo_sparse.build_problem(K=SPARSE_CUT_STAGES)
    f = os.path.join(tmp, "demo_sparse.bin")
    t1 = time.perf_counter()
    io.write_scs_data(f, sprob, sspec)
    t2 = time.perf_counter()
    rprob, rspec, _, _ = io.read_scs_data(f, storage="sparse")
    t3 = time.perf_counter()
    ok = (rspec == sspec and sparse.is_sparse(rprob.A)
          and _csc_equal(rprob.A, sprob.A)
          and torch.equal(rprob.b.cpu(), sprob.b))
    print(f"demo_sparse K={SPARSE_CUT_STAGES} file: A {sprob.A.shape}, "
          f"{os.path.getsize(f)} bytes, host build {t1 - t0:.1f} s, write "
          f"{(t2 - t1) * 1e3:.1f} ms, sparse read onto the card "
          f"{(t3 - t2) * 1e3:.1f} ms, the same CSC triplets {ok}")
    check(ok, "demo_sparse file: the sparse read differs from the written "
          "operand")
    return out


def checkpoint_solve(big_p, spec_big, tmp: str, stg, label: str):
    """The large SOCP under `stg` with a checkpoint every 50 iterations
    (each kept), resumed from the middle one taken while running: the
    same iteration count, linear-solver iterations and bits as the
    uninterrupted solve. Returns (solution, info, checkpoint record)."""
    kept = []
    save = io.save_state

    def keep(filename, state, phase=0):
        save(filename, state, phase)
        path = os.path.join(tmp, f"ck{len(kept)}.npz")
        os.replace(filename, path)
        kept.append((path, phase, state.status, state.iter))

    io.save_state = keep
    try:
        ws = Workspace(big_p.problem, spec_big, big_p.cone_data, stg)
        sol, info = ws.solve(checkpoint_file=os.path.join(tmp, "ck.npz"),
                             checkpoint_every=50)
    finally:
        io.save_state = save
    running = [k for k in kept if k[2] == config.UNFINISHED]
    check(bool(running), f"{label} checkpoints: none taken while running "
          f"({kept})")
    path, phase, _, at = running[len(running) // 2]
    rws = Workspace(big_p.problem, spec_big, big_p.cone_data, stg)
    rsol, rinfo = rws.solve(resume_from=path)
    same = all(np.array_equal(getattr(rsol, k), getattr(sol, k))
               for k in ("x", "y", "s"))
    print(f"{label} with a checkpoint every 50 iterations: {info.status}, "
          f"{info.iter} iterations, {ws.tot_cg_its} linear-solver "
          f"iterations, solve {info.solve_time:.1f} ms ({len(kept)} "
          f"checkpoints of {os.path.getsize(kept[0][0])} bytes); resumed "
          f"from iteration {at} (phase {phase}): {rinfo.status}, "
          f"{rinfo.iter} iterations, {rws.tot_cg_its} linear-solver "
          f"iterations, solve {rinfo.solve_time:.1f} ms, the same bits "
          f"{same}")
    check(rinfo.iter == info.iter and rws.tot_cg_its == ws.tot_cg_its
          and same, f"{label} checkpoint/resume: iterations {rinfo.iter} / "
          f"{info.iter}, linear-solver iterations {rws.tot_cg_its} / "
          f"{ws.tot_cg_its}, same bits {same}")
    for k in kept:
        os.remove(k[0])
    return sol, info, {"iter": info.iter, "resumed_at": at, "same": same}


def checkpoint_phase(big_p, spec_big, tmp: str, plain) -> dict:
    """Phase 15 (c): checkpoint/resume (`checkpoint_solve`) on the large
    SOCP direct mixed, held also to `plain` (a solve without
    checkpoints), and indirect mixed capped at TRACE_ITERS iterations
    (the uninterrupted indirect solve takes ~1600 iterations of ~40 CG
    iterations each)."""
    sol, info, out = checkpoint_solve(big_p, spec_big, tmp,
                                      Settings(linsys="direct"),
                                      "large SOCP direct mixed")
    psol, pinfo = plain[:2]
    plain_same = all(np.array_equal(getattr(psol, k), getattr(sol, k))
                     for k in ("x", "y", "s"))
    print(f"large SOCP direct mixed without checkpoints: "
          f"{pinfo.iter} iterations, solve {pinfo.solve_time:.1f} ms, the "
          f"same bits as with them {plain_same}")
    check(pinfo.iter == info.iter and plain_same,
          f"checkpoints change the direct solve: iterations {info.iter} / "
          f"{pinfo.iter}, same bits {plain_same}")
    res = {"direct mixed": out}
    res["indirect mixed"] = checkpoint_solve(
        big_p, spec_big, tmp, Settings(max_iters=TRACE_ITERS),
        f"large SOCP indirect mixed, {TRACE_ITERS} iterations")[2]
    return res


# phase 15 (c)'s indirect solve and (d)'s solves stop here: the large
# SOCP takes 1400 iterations direct
TRACE_ITERS = 500


def trace_timer_phase(big_p, spec_big, tmp: str) -> dict:
    """Phase 15 (d): the large SOCP direct mixed capped at TRACE_ITERS
    iterations, plain, with the CSV trace, with profile_phases, with both
    and with verbose, each under the sync count: ms/it, host
    synchronizations an iteration, the plain run's bits; the CSV's rows and last row against
    Info, the timers against the solve time."""
    out = {}
    f = os.path.join(tmp, "trace.csv")
    modes = {"plain": {}, "csv": dict(log_csv_filename=f),
             "profile_phases": dict(profile_phases=True),
             "csv and profile_phases": dict(log_csv_filename=f,
                                            profile_phases=True),
             "verbose": dict(verbose=True)}
    ref = None
    for mode, kw in modes.items():
        stg = Settings(linsys="direct", max_iters=TRACE_ITERS, **kw)
        (sol, info), syncs = _syncs_of(lambda: Workspace(
            big_p.problem, spec_big, big_p.cone_data, stg).solve())
        it = max(info.iter, 1)
        if ref is None:
            ref = (sol, info)
        same = info.iter == ref[1].iter and np.array_equal(sol.x, ref[0].x)
        line = (f"large SOCP direct mixed, {TRACE_ITERS} iterations, {mode}:"
                f" {info.status}, {info.solve_time / it:.3f} ms/iteration, "
                f"host syncs {syncs} ({syncs / it:.3f} per iteration), the "
                f"plain run's bits {same}")
        if "log_csv_filename" in kw:
            with open(f) as fh:
                rows = list(csv.reader(fh))
            head, last = rows[0], rows[-1]
            vals = {k: float(last[head.index(k)])
                    for k in ("res_pri", "res_dual", "gap")}
            line += (f", {len(rows) - 1} rows, last row {vals}")
            check(len(rows) - 1 == info.iter and all(
                vals[k] == getattr(info, k) for k in vals),
                f"CSV trace: {len(rows) - 1} rows for {info.iter} "
                f"iterations, last row {vals}")
        if kw.get("profile_phases"):
            timers = (info.lin_sys_time, info.cone_time, info.accel_time)
            line += (f", lin_sys {timers[0]:.1f} ms, cone {timers[1]:.1f} "
                     f"ms, accel {timers[2]:.1f} ms of {info.solve_time:.1f}"
                     f" ms")
            check(all(math.isfinite(t) and t >= 0 for t in timers)
                  and sum(timers) <= info.solve_time,
                  f"profile_phases: timers {timers}, solve "
                  f"{info.solve_time}")
        print(line)
        check(same, f"{mode}: not the plain run's iterations and bits")
        out[mode] = {"ms_per_it": info.solve_time / it,
                     "syncs_per_it": syncs / it}
    return out


def entry_phase(head_p, big_p, spec_big, child: "BatchChild",
                large_exact=None) -> dict:
    """Phase 15 (see the module docstring); `child` the process that
    solves its psd_rank batch, `large_exact` phase 12's large PSD direct
    mixed run (None: solved here)."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="scs_entry_")
    atexit.register(shutil.rmtree, tmp, True)
    res = {"tracked": tracked_rank_phase(child, large_exact)}
    print(f"phase 15 (a) done at {time.perf_counter() - t0:.1f} s")
    res["files"] = entry_files_phase(head_p, big_p, spec_big, tmp)
    print(f"phase 15 (b) done at {time.perf_counter() - t0:.1f} s")
    res["checkpoint"] = checkpoint_phase(
        big_p, spec_big, tmp, res["files"]["large SOCP"]["plain"])
    res["trace"] = trace_timer_phase(big_p, spec_big, tmp)
    print(f"phase 15 (c, d) done at {time.perf_counter() - t0:.1f} s")
    return res


# ---- phase 16: differentiation and the multi-process runtime ----

DIFF_LANES = 64
# the forward solves of the gradients: eps 1e-9 (make_diff_solver's
# default tolerance), direct, mixed (the card's default) with float64
# state: with float32 state (the batched solvers' default fast phase) the
# 64 lanes took 100045 lockstep steps and 671.5 s (measured on one H100),
# the float32-state stragglers of PERF.md section 5
DIFF_STG = Settings(linsys="direct", eps_abs=1e-9, eps_rel=1e-9,
                    fast_f32=False)
# the finite differences' solves: pure float64 at eps 1e-12, warm-started
# from the gradient's solution, and a step of 1e-4. On a CPU run of the
# headline family (a lane of condition ~400, |fd| 20) the error was
# 2.2e-4, 3.0e-5 and 1.9e-4 at steps 1e-3, 1e-4 and 1e-5 (curvature, then
# the solves' error over the step); at eps 1e-11 and a step of 3e-5 two
# of 64 lanes on the card missed the gate by up to 2.9x (measured on one
# H100), the solves' error over the step
DIFF_FD_STG = Settings(linsys="direct", mixed_precision=False,
                       eps_abs=1e-12, eps_rel=1e-12, max_iters=20000)
DIFF_FD_STEP = 1e-4
# the card's gradients against the CPU's on the same lanes, both from eps
# 1e-9 forward solves (mixed on the card, pure float64 on the CPU): within
# 1e-3 (1 + max |g|), the FD gate's scale
DIFF_CPU_LANES = 2
DIFF_CPU_TOL = 1e-3
# the card's gradients through box, exp and power against the CPU's, both
# solved to eps 1e-11: within 1e-6 (1 + max |g|)
DIFF_CONE_TOL = 1e-6


# the planted lanes' active systems have condition numbers at most this
# (`planted_complementary`): the unbounded draws spread to ~24000, and
# lanes above ~2000 moved off their face under the finite difference's
# step (measured on one H100: 3 of 64 lanes, the worst |fd| 3082)
DIFF_MAX_COND = 500


def diff_batch(spec, B: int, seed0: int, with_P: bool):
    """(A, b, c[, P]) of B planted strictly complementary problems of the
    headline family (`models.planted_complementary`), on the card."""
    probs = [planted_complementary(spec, 100, seed0 + i, with_P,
                                   DIFF_MAX_COND) for i in range(B)]
    keys = ("A", "b", "c") + (("P",) if with_P else ())
    return [torch.stack([getattr(p, k) for p in probs]).cuda() for k in keys]


def _unit_directions(args, seed: int, with_P: bool):
    """One random direction per lane over every argument, of unit norm
    per lane (P's part symmetric)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d = [torch.randn(a.shape, generator=gen, dtype=a.dtype, device="cuda")
         for a in args]
    if with_P:
        d[3] = 0.5 * (d[3] + d[3].transpose(1, 2))
    nrm = torch.sqrt(sum((t * t).flatten(1).sum(1) for t in d))
    return [t / nrm.view((-1,) + (1,) * (t.dim() - 1)) for t in d]


def _fd_solve(args, with_P: bool, start):
    """x of the batch `args` solved with DIFF_FD_STG through
    BatchWorkspace, warm-started from `start` (x, y, s); every lane must
    solve."""
    A, b, c = args[:3]
    ws = BatchWorkspace(HEADLINE, DIFF_FD_STG, A, args[3] if with_P else None,
                        b, c)
    res = ws.solve(warm_start=True, sol=start)
    torch.cuda.synchronize()
    check(bool((res.status == 1).all()), "diff: a finite-difference solve "
          f"left {int((res.status != 1).sum())} lanes unsolved")
    return res.x


def diff_headline(with_P: bool) -> dict:
    """Reverse and forward mode through DIFF_LANES planted problems at the
    headline widths (phase 16 a): the gradient of sum over lanes of w'x,
    held per lane to a central finite difference along a random unit
    direction, to the CPU's gradient on DIFF_CPU_LANES lanes, and to the
    forward mode's directional derivative (the adjoint identity)."""
    label = "QP" if with_P else "SOCP"
    head = HEADLINE
    l = 100 + head.dims() + 1
    args = diff_batch(head, DIFF_LANES, 0, with_P)
    w = torch.as_tensor(np.random.RandomState(5).randn(100), device="cuda")
    solve = make_diff_solver(head, DIFF_STG, has_P=with_P,
                             gmres_restart=l)
    ts = [a.clone().requires_grad_() for a in args]
    torch.cuda.synchronize()
    dsmatvec.batched_launches = 0
    dsmatvec.pair_launches = 0
    t0 = time.perf_counter()
    x, y, s = solve(*ts)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    k2, k3 = dsmatvec.batched_launches, dsmatvec.pair_launches
    (x @ w).sum().backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    steps = solve.core.last_gmres_steps.numpy()
    evals = solve.core.last_evals
    grads = [t.grad for t in ts]
    print(f"diff {label} B={DIFF_LANES} (n=100, m={head.dims()}, l={l}): "
          f"forward solve {1e3 * (t1 - t0):.1f} ms (mixed, K2 launches {k2},"
          f" K3 {k3}), backward {1e3 * (t2 - t1):.1f} ms, GMRES steps per "
          f"lane min {steps.min()} median {int(np.median(steps))} max "
          f"{steps.max()}, VJP evaluations {evals}")
    check(k2 > 0, f"diff {label}: the forward solve launched no K2")
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          f"diff {label}: non-finite gradient")
    check(bool(torch.isfinite(x).all()), f"diff {label}: non-finite x")

    # per lane: central finite difference along a unit direction
    d = _unit_directions(args, 9, with_P)
    an = sum((g * t).flatten(1).sum(1) for g, t in zip(grads, d))
    start = types.SimpleNamespace(x=x.detach(), y=y.detach(), s=s.detach())
    t3 = time.perf_counter()
    xp, xm = (_fd_solve([a + sign * DIFF_FD_STEP * t
                         for a, t in zip(args, d)], with_P, start)
              for sign in (1.0, -1.0))
    fd = ((xp - xm) @ w) / (2 * DIFF_FD_STEP)
    err = (an - fd).abs()
    gate = 5e-5 + 5e-4 * fd.abs().clamp_min(1.0)
    worst = int(torch.argmax(err / gate))
    print(f"diff {label}: finite differences (two pure-f64 eps 1e-12 solves"
          f" warm from the solution, {time.perf_counter() - t3:.1f} s): "
          f"per-lane |<g, d> - fd| max "
          f"{float(err.max()):.3e}, worst share of its gate "
          f"{float((err / gate)[worst]):.3f} (lane {worst}, fd "
          f"{float(fd[worst]):.4f})")
    check(bool((err <= gate).all()),
          f"diff {label}: {int((err > gate).sum())} lanes fail the finite "
          f"difference gate 5e-5 + 5e-4 max(|fd|, 1)")

    # the CPU's gradients on the first lanes
    cpu = make_diff_solver(head, DIFF_STG, has_P=with_P, gmres_restart=l,
                           device="cpu")
    tc = [a[:DIFF_CPU_LANES].cpu().clone().requires_grad_() for a in args]
    t4 = time.perf_counter()
    (cpu(*tc)[0] @ w.cpu()).sum().backward()
    cpu_s = time.perf_counter() - t4
    rel = max(float((g[:DIFF_CPU_LANES].cpu() - t.grad).abs().max())
              / (1 + float(t.grad.abs().max())) for g, t in zip(grads, tc))
    print(f"diff {label}: card against CPU gradients on {DIFF_CPU_LANES} "
          f"lanes, max |diff| / (1 + max |g|) {rel:.3e} (gate "
          f"{DIFF_CPU_TOL:.0e}; CPU {cpu_s:.1f} s)")
    check(rel <= DIFF_CPU_TOL, f"diff {label}: card and CPU gradients "
          f"differ by {rel:.2e}")

    # forward mode: <w, J d> against <J^T w, d>, lane by lane
    t5 = time.perf_counter()
    with fwAD.dual_level():
        out = solve(*[fwAD.make_dual(a, t) for a, t in zip(args, d)],
                    mode="jvp")
        dx = fwAD.unpack_dual(out[0]).tangent
    torch.cuda.synchronize()
    jvp_ms = 1e3 * (time.perf_counter() - t5)
    jsteps = solve.core.last_gmres_steps.numpy()
    fwd = dx @ w
    adj = (fwd - an).abs() / (1 + fwd.abs())
    print(f"diff {label}: forward mode (solve + GMRES) {jvp_ms:.1f} ms, "
          f"GMRES steps per lane median {int(np.median(jsteps))} max "
          f"{jsteps.max()}, JVP evaluations {solve.core.last_evals}; "
          f"adjoint |<w, J d> - <J'w, d>| / (1 + |<w, J d>|) max "
          f"{float(adj.max()):.3e}")
    check(bool((adj <= 1e-8).all()), f"diff {label}: adjoint identity off "
          f"by {float(adj.max()):.2e} > 1e-8")
    return {"forward_ms": 1e3 * (t1 - t0), "backward_ms": 1e3 * (t2 - t1),
            "gmres_median": int(np.median(steps)),
            "gmres_max": int(steps.max()), "evals": evals, "k2": k2,
            "fd_err": float(err.max()), "cpu_rel": rel, "jvp_ms": jvp_ms,
            "adjoint": float(adj.max())}


def diff_small_cones() -> dict:
    """Phase 16 b: tests/test_diff.py's box, exp and power instances,
    gradients on the card against the CPU's (the projections run eagerly
    under autograd, cones.graphs.eager); graphs.run raises where autograd
    would record through a replay."""
    stg = Settings(linsys="direct", eps_abs=1e-11, eps_rel=1e-11)
    cases = {}
    for name, inst in (("exp", diff_instances.exp_instance()),
                       ("power", diff_instances.power_instance()),
                       ("box", diff_instances.box_instance())):
        spec, prob = inst[:2]
        raw = [prob.A, prob.b, prob.c] + list(inst[2:])
        w = torch.as_tensor(np.random.RandomState(5).randn(prob.A.shape[1]))
        grads = {}
        for dev in ("cpu", "cuda"):
            solve = make_diff_solver(spec, stg, device=dev)
            ts = [t.to(dev).clone().requires_grad_() for t in raw]
            graphs.replays = 0
            (solve(*ts)[0] @ w.to(dev)).backward()
            grads[dev] = [t.grad.cpu() for t in ts]
        rel = max(float((g - c).abs().max()) / (1 + float(c.abs().max()))
                  for g, c in zip(grads["cuda"], grads["cpu"]))
        print(f"diff {name}: card against CPU gradients max |diff| / "
              f"(1 + max |g|) {rel:.3e} (gate {DIFF_CONE_TOL:.0e}), "
              f"|d/db| max {float(grads['cpu'][1].abs().max()):.3e}")
        check(rel <= DIFF_CONE_TOL, f"diff {name}: card and CPU gradients "
              f"differ by {rel:.2e}")
        cases[name] = rel
    seg = torch.randn(4, 2, 3, dtype=torch.float64, device="cuda",
                      requires_grad=True)
    mask = torch.tensor([True, False], device="cuda")
    try:
        graphs.run(exp_cone.proj_exp_batch, (seg, mask))
        raised = False
    except RuntimeError:
        raised = True
    check(raised, "graphs.run did not raise under autograd")
    with torch.no_grad():
        graphs.run(exp_cone.proj_exp_batch, (seg, mask))
    print("graphs.run under autograd with an input that requires grad: "
          "raises; under no_grad: replays")
    return cases


def nccl_one_rank(lanes) -> dict:
    """Phase 16 c: a one-rank NCCL group on the card, the global mesh and
    make_sharded_batch_solver on 64 lanes of the headline batch, against
    make_batch_solver on the same lanes."""
    import torch.distributed as dist
    A, b, c = lanes[:3]
    B = A.shape[0]
    bu = bl = torch.zeros(B, 0, dtype=A.dtype, device="cuda")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    # float64 state: with float32 state a few of the first 64 lanes take
    # tens of thousands of iterations (phase 6's note)
    stg = Settings(linsys="direct", chunk_iters=250, fast_f32=False)
    try:
        multihost.init_distributed(f"127.0.0.1:{port}", 1, 0,
                                   backend="nccl")
        check(dist.get_backend() == "nccl", "the process group is not NCCL")
        mesh = multihost.make_global_mesh()
        t0 = time.perf_counter()
        sharded = multihost.make_sharded_batch_solver(HEADLINE, stg, mesh)(
            A, b, c, bu, bl)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    ref = batch_mod.make_batch_solver(HEADLINE, stg)(A, b, c, bu, bl)
    same_status = bool(torch.equal(sharded.status, ref.status))
    diff = float(((sharded.pobj - ref.pobj).abs()
                  / (1 + ref.pobj.abs())).max())
    print(f"NCCL one-rank group: make_sharded_batch_solver on {B} lanes in "
          f"{1e3 * (t1 - t0):.1f} ms, statuses equal {same_status}, pobj "
          f"max rel diff {diff:.3e} against make_batch_solver, device "
          f"{sharded.pobj.device}")
    check(same_status and diff <= 1e-12 and sharded.pobj.is_cuda,
          f"NCCL sharded batch: statuses equal {same_status}, pobj rel diff "
          f"{diff:.2e}")
    return {"ms": 1e3 * (t1 - t0), "pobj_diff": diff}


# the examples' counts in phase 16 (their widths are the examples' own).
# learned_risk_budget runs 10 of its 200 steps: 40 took 107.8 s on an H100
# (a solve at eps 1e-10 and its backward a step), 20 took 169.8 s beside
# phases 11-14; its loss meets the
# example's gate (below 1e-2 of the initial 9.94e-2) from step 8 on, 4.11e-4
# at step 10 (on the CPU), 3.94e-4 at steps 20 and 40
EXAMPLE_COUNTS = {"learned_risk_budget": {"steps": 10},
                  "mpc_warm_start": {"steps": 10},
                  "mpc_warm_batch": {"B": 256, "steps": 5},
                  "portfolio_batch": {"B": 64},
                  "robust_pca": {}}


def examples_on_the_card() -> dict:
    """Phase 16 d: the five examples on the card, each with its asserts."""
    from scs_tpu_torch import examples
    import importlib
    walls = {}
    for name, kw in EXAMPLE_COUNTS.items():
        mod = importlib.import_module(f"{examples.__name__}.{name}")
        t0 = time.perf_counter()
        mod.main(**kw, device="cuda")
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        print(f"example {name} {kw}: {walls[name]:.1f} s")
    return walls


def diff_phase(lanes, child: "BatchChild") -> dict:
    """Phase 16: (a) reverse and forward mode at the headline widths,
    SOCP and QP, then (d) the five examples, in a process of its own
    beside phases 11-14 (`child`); (b) box, exp and power against the CPU
    and (c) a one-rank NCCL group, here."""
    t0 = time.perf_counter()
    out = child.result()
    print(f"phase 16 (a) and (d) done at {time.perf_counter() - t0:.1f} s")
    out["cones"] = diff_small_cones()
    print(f"phase 16 (b) done at {time.perf_counter() - t0:.1f} s")
    out["nccl"] = nccl_one_rank(lanes)
    print(f"phase 16 (c) done at {time.perf_counter() - t0:.1f} s")
    return out


# ---- phase 17: row (model-axis) sharding, two gloo ranks on the card ----
#
# Two processes (`--batch-child rowshard R PORT LANES`) join a gloo group
# on a loopback port and solve on the one card on a (1, 2) mesh, each
# holding half the rows of A (NCCL refuses two ranks on one device; gloo
# stages CUDA tensors through host memory). They start before phase 16
# (b) and run beside it; this process runs the unsharded references in
# phase 17, then holds the ranks' results to them. The one-problem
# solves run mixed with float64 state, so that their products on the
# shards are K1 (float32 state runs K2 and K3, (c)). The indirect
# backend's CG takes one collective a CG iteration, 43-49 an ADMM
# iteration on the large SOCP and on the headline problem, ~2.4-2.9 ms
# each with the card shared (PERF.md): the large SOCP's indirect leg ran
# 179 ms an iteration and the headline problem's 186, so solved to the
# end they would take ~6 min and 65 s. The indirect leg runs
# ROWSHARD_INDIRECT_CAP iterations of the large SOCP, timed and held rank
# to rank, and solves the JAX tests' row-sharded instance
# (tests/test_parallel.py:83, ROWSHARD_SMALL) to the end.

ROWSHARD_INDIRECT_CAP = 20
ROWSHARD_INDIRECT = dict(linsys="indirect", fast_f32=False)
# tests/test_parallel.py:83's one problem, 40 rows a rank, shard edges
# inside its SOC blocks
ROWSHARD_SMALL = (ConeSpec(z=16, l=40, q=(8, 16)), 30, 7, 0.4)
# (label, Settings keywords, iteration cap) of phase 17 (a)'s large SOCP
ROWSHARD_LARGE = (
    ("direct mixed", dict(linsys="direct", fast_f32=False), None),
    ("direct pure", dict(linsys="direct", mixed_precision=False), None),
    ("indirect mixed", ROWSHARD_INDIRECT, ROWSHARD_INDIRECT_CAP),
)
ROWSHARD_BATCH = dict(linsys="direct", chunk_iters=250, fast_f32=False)
ROWSHARD_F32 = dict(linsys="direct", chunk_iters=250)
# (c)'s float32-state lanes: 8 of the headline batch's first 64 whose
# float32-state solve took 250-325 iterations on an H100, unsharded and
# sharded alike (tools/torch_rowshard_phase.py, PERF.md); with float32
# state a few lanes of this family take thousands (phase 6's note)
ROWSHARD_F32_LANES = (14, 15, 24, 35, 36, 42, 58, 60)


def _reset_counts() -> None:
    from scs_tpu_torch.parallel import collectives
    dsmatvec.launches = dsmatvec.batched_launches = 0
    dsmatvec.pair_launches = 0
    collectives.calls, collectives.seconds = 0, 0.0


def _counts(wall: float, iters: int) -> dict:
    from scs_tpu_torch.parallel import collectives
    return {"k1": dsmatvec.launches, "k2": dsmatvec.batched_launches,
            "k3": dsmatvec.pair_launches, "collectives": collectives.calls,
            "collective_s": collectives.seconds, "wall_s": wall,
            "ms_per_it": 1e3 * wall / max(iters, 1)}


def rowshard_one(p, spec, kw: dict, cap, group=None) -> dict:
    """One problem through make_pure_solver on the card, A this rank's
    rows over `group` (None: unsharded), with the kernel launches and the
    collectives counted around the solve; with `group`, SCS's termination
    test on the (gathered, whole) solution."""
    from scs_tpu_torch.ops import rowshard
    from scs_tpu_torch.parallel import make_pure_solver
    A, b, c = (getattr(p.problem, k).cuda() for k in ("A", "b", "c"))
    op = A if group is None else rowshard.shard_rows(A, group)
    e = torch.zeros(0, dtype=torch.float64, device="cuda")
    stg = Settings(**kw)
    solve = make_pure_solver(spec, stg, max_iters=cap)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = solve(op, None, b, c, e, e)
    status = int(res.status)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters = int(res.iters)
    rec = {"status": status, "iters": iters, "pobj": float(res.pobj),
           "opt": float(p.opt), "finite": bool(torch.isfinite(res.x).all()),
           "digest": _digest(*(t.cpu().numpy()
                              for t in (res.x, res.y, res.s, res.pobj))),
           **_counts(wall, iters)}
    if group is not None and cap is None:
        sol = types.SimpleNamespace(x=res.x[None], y=res.y[None],
                                    s=res.s[None])
        rec["term_fail"] = {k: v.tolist() for k, v in termination_failures(
            (A[None], b[None], c[None]), sol, stg).items()}
    return rec


def rowshard_batch(batch, kw: dict, mesh=None) -> dict:
    """Lanes of the headline batch through make_batch_solver on the card,
    A each rank's rows over `mesh`'s "model" dimension (None:
    unsharded), the launches and collectives counted around the solve;
    with `mesh`, SCS's termination test on every lane."""
    from scs_tpu_torch.parallel import make_batch_solver, shard_problem_batch
    A, b, c = batch[:3]
    e = torch.zeros(A.shape[0], 0, dtype=torch.float64, device="cuda")
    args = (A, b, c, e, e)
    if mesh is not None:
        A_l, _, b_l, c_l, bu, bl = shard_problem_batch(
            mesh, A, None, b, c, e, e, shard_rows=True)
        args = (A_l, b_l, c_l, bu, bl)
    stg = Settings(**kw)
    solver = make_batch_solver(HEADLINE, stg)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = solver(*args)
    status = res.status.cpu().numpy()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = sum(lv[3] for lv in solver.levels)
    rec = {"status": status.tolist(), "iters": res.iters.tolist(),
           "pobj": res.pobj.tolist(), "steps": steps,
           "f32_state": solver.machinery.f32_state,
           "digest": _digest(*(t.cpu().numpy()
                              for t in (res.x, res.y, res.s, res.pobj))),
           **_counts(wall, steps)}
    if mesh is not None:
        rec["term_fail"] = {k: v.tolist() for k, v in termination_failures(
            batch, res, stg).items()}
    return rec


def rowshard_pair(batch, group) -> dict:
    """Phase 17 (c)'s product: A' z of the 64 lanes with float32 z as the
    float32-state phase takes it, each rank's K3 pair composed in float64
    and summed over the ranks (`RowShardedSplit.sum64`), against the
    float64 product of the split's exact hi + lo of the whole A', each
    lane held to 1e-12 max(|A'||z|) (phase 2's K3 limit); wall ms of 20
    calls (the two ranks call together), and of the unsharded K3."""
    from scs_tpu_torch.ops import rowshard
    A = batch[0]
    gen = torch.Generator(device="cuda").manual_seed(17)
    z = torch.randn(A.shape[0], A.shape[1], generator=gen,
                    dtype=torch.float64, device="cuda").to(torch.float32)
    _, bwd = rowshard.shard_rows(A, group).split()
    got = bwd.sum64(z)
    full = dsmatvec.split_operand(A.transpose(1, 2))
    exact = full.hi.double() + full.lo.double()
    z64 = z.double().unsqueeze(-1)
    ref = torch.matmul(exact, z64).squeeze(-1)
    err = (got - ref).abs().amax(1)
    tol = 1e-12 * torch.matmul(exact.abs(), z64.abs()).squeeze(-1).amax(1)

    def wall_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    return {"max_abs_err": float(err.max()), "tol": float(tol.min()),
            "ok": bool((err <= tol).all()),
            "sharded_ms": wall_ms(lambda: bwd.sum64(z)),
            "unsharded_k3_ms": wall_ms(
                lambda: dsmatvec.ds_matvec_pair_batched(full, z))}


def _rowshard_small():
    spec, n, seed, density = ROWSHARD_SMALL
    return gen_planted(spec, n=n, seed=seed, density=density)


def rowshard_rank(rank: int, port: int, easy: list) -> dict:
    """One rank of phase 17: a gloo group of two on a loopback port, a
    (1, 2) mesh on the card; (a) the large SOCP one problem
    (`ROWSHARD_LARGE`) and the JAX tests' instance indirect mixed
    (`ROWSHARD_SMALL`); (b) the first 64 lanes of the headline batch
    mixed with float64 state; (c) the K3 pair sum, and the lanes `easy`
    mixed with float32 state."""
    import torch.distributed as dist
    from scs_tpu_torch.parallel import make_mesh
    multihost.init_distributed(f"127.0.0.1:{port}", 2, rank,
                               backend="gloo")
    try:
        mesh = make_mesh(data=1, model=2, device="cuda")
        group = mesh.get_group("model")
        spec = make_spec(2048, 0.1, np.random.RandomState(7))
        big_p = gen_planted(spec, n=2048, seed=7, density=0.3)
        out = {"rank": rank, "large": {}}
        for label, kw, cap in ROWSHARD_LARGE:
            out["large"][label] = rowshard_one(big_p, spec, kw, cap, group)
            print(f"rank {rank}: large SOCP {label}: "
                  f"{out['large'][label]}", flush=True)
        out["small"] = rowshard_one(_rowshard_small(), ROWSHARD_SMALL[0],
                                    ROWSHARD_INDIRECT, None, group)
        batch = headline_batch(HEADLINE, 64, 1000)
        out["batch"] = rowshard_batch(batch, ROWSHARD_BATCH, mesh)
        out["pair"] = rowshard_pair(batch, group)
        out["f32"] = rowshard_batch(lanes_of(batch, np.asarray(easy)),
                                    ROWSHARD_F32, mesh)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    out["ended_at"] = time.time()
    return out


def rowshard_rows() -> dict:
    """Phase 17's kernel rows, with the card alone: K1 at the shard shapes
    of the large SOCP, K2 and K3 at the sharded batch's."""
    rows = {"k1 A_r": ds_matvec_case(4096, 2048, seed=70),
            "k1 A_r'": ds_matvec_case(2048, 4096, seed=71),
            "k2 A_r": ds_matvec_batched_case(64, 200, 100, seed=72),
            "k3 A_r'": ds_matvec_batched_case(64, 100, 200, seed=73,
                                              x32=True, pair=True)}
    for name, c in rows.items():
        print(f"phase 17 row {name} {'x'.join(map(str, c['shape']))}: "
              f"max_abs_err {c['max_abs_err']:.3e} (tol {c['tol']:.3e}), "
              f"kernel {c['ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']}), {share(c)}, plain {c['plain_ms']:.4f} "
              f"ms, library {c['library_ms']:.4f} ms")
    return rows


def rowshard_start(easy=ROWSHARD_F32_LANES) -> list:
    """Phase 17's two ranks (`rowshard_rank`), started now, each in a
    process of its own, on a free loopback port; `easy`: (c)'s lanes."""
    torch.cuda.empty_cache()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    lanes = ",".join(str(int(i)) for i in easy)
    return [BatchChild("rowshard", str(r), str(port), lanes,
                       label=f"rowshard rank {r}") for r in range(2)]


def rowshard_phase(ranks: list, rows: dict,
                   easy=ROWSHARD_F32_LANES) -> dict:
    """Phase 17: the unsharded references here, then the ranks' results
    (`rowshard_start`) held to them; every gate of phase 17."""
    t0 = time.perf_counter()
    spec = make_spec(2048, 0.1, np.random.RandomState(7))
    big_p = gen_planted(spec, n=2048, seed=7, density=0.3)
    ref = {label: rowshard_one(big_p, spec, kw, cap)
           for label, kw, cap in ROWSHARD_LARGE}
    ref_small = rowshard_one(_rowshard_small(), ROWSHARD_SMALL[0],
                             ROWSHARD_INDIRECT, None)
    batch = headline_batch(HEADLINE, 64, 1000)
    ref_batch = rowshard_batch(batch, ROWSHARD_BATCH)
    ref_f32 = rowshard_batch(lanes_of(batch, np.asarray(easy)),
                             ROWSHARD_F32)
    got = [c.result() for c in ranks]

    def same_bits(key, label=None):
        d = [g[key] if label is None else g[key][label] for g in got]
        check(d[0]["digest"] == d[1]["digest"],
              f"phase 17 {key} {label or ''}: the ranks' results differ")

    def failing(g, lanes=None):
        """{test: lanes failing SCS's termination test} among `lanes`."""
        out = {}
        for k, v in g["term_fail"].items():
            v = np.asarray(v)
            bad = int(v[lanes].sum() if lanes is not None else v.sum())
            if bad:
                out[k] = bad
        return out

    def gate_one(name, g, g1, r, full: bool):
        err_opt = abs(g["pobj"] - g["opt"]) / (1 + abs(g["opt"]))
        err_ref = abs(g["pobj"] - r["pobj"]) / (1 + abs(r["pobj"]))
        print(f"phase 17 {name}: rank 0 status {g['status']}, {g['iters']} "
              f"iterations, {g['ms_per_it']:.3f} ms/it (unsharded "
              f"{r['ms_per_it']:.3f} ms/it, {r['iters']} iterations), "
              f"{g['collectives'] / max(g['iters'], 1):.2f} collectives/it "
              f"({1e3 * g['collective_s'] / max(g['collectives'], 1):.3f} ms "
              f"each on the host), K1 {g['k1']} (rank 1 {g1['k1']}), pobj "
              f"{g['pobj']!r} (planted {g['opt']!r}, rel {err_opt:.2e}; "
              f"unsharded {r['pobj']!r}, rel {err_ref:.2e})"
              + (f", termination failures {failing(g)}" if full else ""))
        check(g["finite"], f"phase 17 {name}: x not finite")
        if not full:
            # the capped leg's iterate tracks the unsharded one's (6.9e-7
            # apart after 20 iterations on an H100, PERF.md)
            check(err_ref <= 1e-3, f"phase 17 {name}: pobj {err_ref:.2e} "
                  f"from the unsharded solve's at the same cap")
        if full:
            check(g["status"] == 1 and r["status"] == 1,
                  f"phase 17 {name}: statuses {g['status']}, {r['status']}")
            check(not failing(g), f"phase 17 {name}: SCS's termination "
                  f"test fails {failing(g)}")
            check(err_opt <= 1e-3 and err_ref <= 1e-3,
                  f"phase 17 {name}: pobj {err_opt:.2e} from the planted "
                  f"optimum, {err_ref:.2e} from the unsharded solve")

    for label, kw, cap in ROWSHARD_LARGE:
        same_bits("large", label)
        gate_one(f"large SOCP {label}", got[0]["large"][label],
                 got[1]["large"][label], ref[label], cap is None)
        if kw.get("mixed_precision", True):
            check(all(x["large"][label]["k1"] > 0 for x in got),
                  f"phase 17 large SOCP {label}: a rank launched no K1")
    same_bits("small")
    gate_one("test_parallel.py:83's problem indirect mixed", got[0]["small"],
             got[1]["small"], ref_small, True)
    check(all(x["small"]["k1"] > 0 for x in got),
          "phase 17 test_parallel.py:83's problem: a rank launched no K1")

    for key, r, tol in (("batch", ref_batch, 1e-3), ("f32", ref_f32, 5e-3)):
        same_bits(key)
        g = got[0][key]
        st, st_ref = np.asarray(g["status"]), np.asarray(r["status"])
        opts = batch[3] if key == "batch" else batch[3][np.asarray(easy)]
        err = np.abs(np.asarray(g["pobj"]) - opts) / (1 + np.abs(opts))
        print(f"phase 17 {key}: B={st.size}, float32 state "
              f"{g['f32_state']}, {g['steps']} steps in {g['wall_s']:.3f} s "
              f"({g['ms_per_it']:.3f} ms/step; unsharded {r['steps']} steps, "
              f"{r['ms_per_it']:.3f} ms/step), "
              f"{g['collectives'] / max(g['steps'], 1):.2f} collectives a "
              f"step, K2 {g['k2']}, K3 {g['k3']} (rank 1: K2 "
              f"{got[1][key]['k2']}, K3 {got[1][key]['k3']}), statuses "
              f"{np.unique(st, return_counts=True)}, max pobj rel err "
              f"{err[st == 1].max() if (st == 1).any() else float('nan'):.2e}"
              f", termination failures {failing(g)}")
        check(all(x[key]["k2"] > 0 for x in got),
              f"phase 17 {key}: a rank launched no K2")
        if key == "batch":
            check(bool(np.array_equal(st, st_ref)),
                  f"phase 17 batch: statuses {st} against unsharded {st_ref}")
            check(bool(np.all(err <= tol)),
                  f"phase 17 batch: pobj {err.max():.2e} from the planted "
                  f"optima")
            check(not failing(g), f"phase 17 batch: SCS's termination test "
                  f"fails {failing(g)}")
        else:
            check(g["f32_state"] and all(x[key]["k3"] > 0 for x in got),
                  "phase 17 (c): no float32-state step, or a rank launched "
                  "no K3")
            solved = st_ref == 1
            check(bool(np.all(st[solved] == 1)),
                  f"phase 17 (c): lanes the unsharded solve solves end "
                  f"{st[solved]}")
            check(bool(np.all(err[solved] <= tol)),
                  f"phase 17 (c): pobj {err[solved].max():.2e} from the "
                  f"planted optima")
            check(not failing(g, solved), f"phase 17 (c): SCS's "
                  f"termination test fails {failing(g, solved)}")
    pr = got[0]["pair"]
    print(f"phase 17 (c) A' z, float32 z, K3 pairs summed over the ranks in "
          f"float64: max_abs_err {pr['max_abs_err']:.3e} (tol >= "
          f"{pr['tol']:.3e} per lane), {pr['sharded_ms']:.3f} ms a call "
          f"with its collective (unsharded K3 {pr['unsharded_k3_ms']:.3f} "
          f"ms)")
    check(pr["ok"] and got[1]["pair"]["ok"],
          f"phase 17 (c): the sharded K3 sum is {pr['max_abs_err']:.2e} "
          f"from the float64 product")
    print(f"phase 17 took {time.perf_counter() - t0:.1f} s here, the "
          f"ranks {got[0]['ended_at'] - ranks[0].started_at:.1f} s from "
          f"their start")
    return {"rows": rows, "got": got, "ref": ref, "ref_batch": ref_batch}


def rowshard_kernel_rows(rs17: dict) -> list:
    """The `kernels` entries of phase 17: K1, K2 and K3 on the row shards,
    each with rank 0's launches in the phase's solve that runs it."""
    rows, got = rs17["rows"], rs17["got"][0]
    out = []
    for name, key, replaces, launches, errs in (
            ("ds_matvec_row_shard", "k1 A_r", "scs_tpu/ops/dsmatvec.py:91",
             got["large"]["direct mixed"]["k1"],
             [rows["k1 A_r"]["max_abs_err"], rows["k1 A_r'"]["max_abs_err"]]),
            ("ds_matvec_batched_row_shard", "k2 A_r",
             "scs_tpu/ops/dsmatvec.py:226", got["batch"]["k2"],
             [rows["k2 A_r"]["max_abs_err"]]),
            ("ds_matvec_pair_batched_row_shard", "k3 A_r'",
             "scs_tpu/ops/dsmatvec.py:471", got["f32"]["k3"],
             [rows["k3 A_r'"]["max_abs_err"], got["pair"]["max_abs_err"]])):
        c = rows[key]
        out.append({
            "name": name, "route": "cuda",
            "source": "scs_tpu_torch/csrc/dsmatvec.cu", "replaces": replaces,
            "launches": launches, "max_abs_err": max(errs), "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    return out


def k2s_entry(sp14: dict, kind: str, replaces: str, launches: int) -> dict:
    """The `kernels` entry of one kind of K2s: its times on the full
    demo_sparse's A' (the row the redesign aimed at), the largest error
    over every phase-14 row (and the band, for the pair)."""
    row = sp14["rows"][1][kind]
    errs = [r[kind]["max_abs_err"] for r in sp14["rows"]]
    if kind == "pair":
        errs.append(sp14["band"]["max_abs_err"])
    return {"name": f"ell_matvec_{kind}", "route": "cuda",
            "source": "scs_tpu_torch/csrc/ellmatvec.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(errs), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}


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
    if sys.argv[1:] == ["--repeat-child"]:
        # the repeat check's fresh process (phase 10)
        print(json.dumps(_repeat_solve()))
        return 0
    if sys.argv[1:2] == ["--batch-child"]:
        # a float32-state batch of phases 11-13, or another process of
        # phases 15-17 (BatchChild)
        print(json.dumps(f32_batch_child(*sys.argv[2:]),
                         default=lambda v: v.item()))
        return 0
    t_start = time.perf_counter()

    def done(phase: int) -> None:
        print(f"phase {phase} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

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

    done(1)

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

    done(2)

    # the float32-state batches of phases 11-13, each in a process of its
    # own beside phases 3-10 (BatchChild); stopped at exit, however it comes
    atexit.register(BatchChild.stop_all)
    children = {name: BatchChild(name) for name in F32_CHILDREN}
    print(f"started the float32-state batches of phases 11-13 "
          f"({', '.join(F32_CHILDREN)}), each in a process of its own")

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

    done(3)

    # 4. the headline problem
    head = HEADLINE
    solve_planted(gen_planted(head, n=100, seed=1000, density=0.1), head,
                  "headline")

    done(4)

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

    done(5)

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

    done(6)

    # 7. the indirect backend, the default linsys: the large SOCP mixed
    # and pure (K1 counted around each), then the first 8 lanes of the
    # headline batch in the default mode (mixed, float32 state; K2 counted
    # around it) and mixed with float64 state. The float32-state run's
    # objective gate is the float32-state direct batch's (5e-3). Eight
    # lanes keep the script inside its limit: with float32 state the 128
    # first lanes took ~110 s, ~95 s of it one lane (seed 1014, 8000
    # iterations; PERF.md); tools/torch_batch_trees.py runs the full batch.
    big_ind = solve_indirect(big_p, spec, "large SOCP", big["pobj64"])
    head8 = tuple(t[:8] for t in batch)
    ind_b = solve_batch(head, head8, Settings(chunk_iters=250),
                        "headline batch B=8 indirect (default: mixed, "
                        "float32 state)", tol=5e-3)
    check(ind_b["f32_state"], "headline batch indirect: the default mixed "
          "solve did not take the float32-state fast phase")
    check(ind_b["launches"] >= 2 * ind_b["steps"] and ind_b["pair"] == 0,
          f"headline batch indirect: {ind_b['launches']} K2 launches < 2 x "
          f"{ind_b['steps']} steps, or K3 launched")
    check(ind_b["cg"] > 0, "headline batch indirect: no CG iteration")
    ind64_b = solve_batch(head, head8,
                          Settings(chunk_iters=250, fast_f32=False),
                          "headline batch B=8 indirect mixed float64 "
                          "state")
    check(not ind64_b["f32_state"] and ind64_b["cg"] > 0,
          "headline batch indirect, float64 state: float32 state, or no CG "
          "iteration")
    check(ind64_b["launches"] >= 2 * ind64_b["steps"],
          f"headline batch indirect, float64 state: {ind64_b['launches']} "
          f"K2 launches < 2 x {ind64_b['steps']} steps")

    done(7)

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

    done(8)

    # 10. repeatability (ROADMAP section 3 A): the indirect pure float64
    # large SOCP twice here (phase 7's solve the first) and once in a
    # fresh process, bitwise; the 64
    # easiest lanes of phase 5 twice in the default mode, lane by lane
    repeat = repeat_check(head, lanes_of(batch, easy), big_ind["pure f64"])

    done(10)

    # phase 15's psd_rank batch, and phase 16's differentiation (a) and
    # examples (d) one after the other, each in a process of its own,
    # beside phases 11-14 (the main path's timed phases 3-10 run without
    # them). One process for (a) and (d): with each in its own, phases
    # 11-14 took 141.6 s longer than with no phase 16 beside them (every
    # process a context the card time-slices; measured on one H100)
    for name in ("psd-rank", "diff"):
        children[name] = BatchChild(name)
    print("started phase 15's psd_rank batch and phase 16's "
          "differentiation and examples, each in a process of its own")

    # 11. the mixed-cone configurations: box, exp and power cones beside
    # zero, nonnegative and SOC rows. First each cone family as a CUDA
    # graph against its eager run at both configurations' shapes, one
    # mixed-cone projection with no host read, and the determinism fix's
    # cost; then the large program (direct mixed with K1 counted, direct
    # pure float64, indirect mixed, direct mixed with exp_f32=True) and
    # the batch of 1024 (mixed with float32 state, float64 state, pure
    # float64), BatchWorkspace on 64 lanes
    mspec_big = mixed_cones.large_mixed_spec()
    mspec = mixed_cones.headline_mixed_spec()
    cone_rows = (cone_graph_rows(mspec_big, (), "large")
                 + cone_graph_rows(mspec, (1024,), "batch B=1024"))
    mbatch = headline_batch(mspec, 1024, 1000, bounds=True)
    sync_free_projection(mspec, mbatch)
    seg_cost = segment_sum_cost(spec, head)
    mbig_p = mixed_cones.gen_mixed(mspec_big, 2048, 7, 0.3)
    mbig = mixed_cone_large(mbig_p, mspec_big)
    mixed_mb = children["mixed-cone"].result()
    fast = mixed_mb["by_phase"].get("fast", 0)
    check(mixed_mb["f32_state"] and mixed_mb["pair"] >= 2 * fast > 0,
          f"mixed-cone batch: float32 state {mixed_mb['f32_state']}, "
          f"{mixed_mb['pair']} K3 launches for {fast} fast steps")
    check(mixed_mb["launches"] >= 2 * mixed_mb["steps"],
          f"mixed-cone batch: {mixed_mb['launches']} K2 launches < 2 x "
          f"{mixed_mb['steps']} steps")
    # objectives: every lane passes SCS's termination test at eps 1e-4
    # (verify_termination). The pure float64 solve itself lands 1.54e-3
    # (1 + |opt|) from the planted optimum on seed 1973 (6025 iterations)
    # on an H100: the distance SCS's eps leaves on this family's lanes, so
    # the float64 runs' gate is 2e-3 (float32 state: 5e-3, its lanes up
    # to 1.73e-3 away, as phase 5). Against the pure float64 run, float64
    # state agrees to 1.2e-7 with every lane's iteration count equal,
    # float32 exp projections (exp_f32=True) differ by 1.9e-4 and leave 5
    # lanes failing the gap test (tools/torch_mixed_cone_gates.py,
    # PERF.md), so that gate is 1e-5; float32 state keeps phase 5's 5e-3
    mixed64_mb = solve_batch(mspec, mbatch,
                             Settings(linsys="direct", chunk_iters=250,
                                      fast_f32=False),
                             "mixed-cone batch mixed float64 state",
                             tol=2e-3)
    check(mixed64_mb["launches"] >= 4 * mixed64_mb["steps"]
          and mixed64_mb["pair"] == 0,
          f"mixed-cone batch, float64 state: {mixed64_mb['launches']} K2 "
          f"launches < 4 x {mixed64_mb['steps']} steps, or K3 launched")
    pure_mb = solve_batch(mspec, mbatch,
                          Settings(linsys="direct", chunk_iters=250,
                                   mixed_precision=False),
                          "mixed-cone batch pure f64", tol=2e-3)
    for label, run, tol in (("mixed", mixed_mb, 5e-3),
                            ("mixed float64 state", mixed64_mb, 1e-5)):
        check(bool(np.array_equal(pure_mb["status"], run["status"])),
              f"mixed-cone batch: pure and {label} statuses differ")
        agree = np.abs(run["pobj"] - pure_mb["pobj"]) / (
            1 + np.abs(pure_mb["pobj"]))
        print(f"mixed-cone batch: {label} against pure f64, pobj rel diff "
              f"max {agree.max():.3e}, lanes with equal iterations "
              f"{int((run['iters'] == pure_mb['iters']).sum())}")
        check(bool(np.all(agree <= tol)),
              f"mixed-cone batch: {label} vs pure pobj differ by "
              f"{agree.max():.2e}, above {tol:.0e}")
    measy = np.sort(np.argsort(mixed_mb["iters"], kind="stable")[:64])
    warm_batch(mspec, lanes_of(mbatch, measy), " mixed cones")
    print(f"{card}, peak device memory of the last batch "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    done(11)

    # 12. the PSD configurations (`models/psd_cones.py`): each PSD and
    # complex-PSD block size's card eigh against float64 numpy, with its
    # host syncs and times; the large PSD program (direct mixed with K1
    # counted, direct pure float64, indirect mixed) and the PSD batch of
    # 1024 (float32 state with K2 and K3 counted, float64 state, pure
    # float64), every mixed lane through the forced float64 polish, and
    # BatchWorkspace on 64 lanes
    psd12 = psd_phase(card, children["psd"])

    done(12)

    # 13. the spectral configurations (`models/spectral_cones.py`): the
    # logdet kernel against its plain version, each spectral run's card
    # projection against the CPU's; the large spectral program (direct
    # mixed with K1 and the logdet kernel counted, direct pure float64,
    # indirect mixed) and the spectral batch of 1024 (float64 state, pure
    # float64, and float32 state on its first SPECTRAL_F32_LANES lanes),
    # every mixed lane through the forced float64 polish
    spec13 = spectral_phase(card, children["spectral"])

    done(13)

    # 14. sparse problems (`demo_sparse`, blocked-ELL): K2s (pair, float32,
    # float64) on the full instance's A and A' and on a tails operand (with
    # K1 on its tails), the pair on a band beyond K2's 65535 block-rows,
    # against their plain versions and scipy; the full instance (100000 x
    # 64000, 25.57M nonzeros) through the indirect backend mixed and pure
    # float64 (K2s counted); the cut
    # instance through the direct backend, sparse against dense, and
    # through the indirect backend twice, bit for bit
    sparse14 = sparse_phase(card)

    done(14)

    # 15. the entry points: the tracked-rank PSD projection (psd_rank) on a
    # planted low-rank SDP, phase 12's large PSD program and 64 lanes of
    # its batch; files written and read (native and Python), compat.SCS
    # against Workspace, the CLI, a sparse file; checkpoint/resume; the
    # CSV trace, the phase timers and verbose on the large SOCP
    entry_phase(gen_planted(head, n=100, seed=1000, density=0.1), big_p,
                spec, children["psd-rank"], psd12["large"]["direct mixed"])

    done(15)

    # phase 17's kernel rows with the card alone, then its two ranks,
    # started now to run beside phase 16 (b, c)
    rows17 = rowshard_rows()
    ranks17 = rowshard_start()

    # 16. differentiation through the solve (reverse and forward mode at
    # the headline widths, SOCP and QP; box, exp and power against the
    # CPU), a one-rank NCCL group over the first 64 lanes of the headline
    # batch, and the five examples
    diff_phase(tuple(t[:64] for t in batch), children["diff"])

    done(16)

    # 17. row (model-axis) sharding: two gloo ranks on the card, a (1, 2)
    # mesh, half the rows of A each; the large SOCP one problem, 64 lanes
    # of the headline batch with float64 state, the K3 pair sum, and 8
    # lanes with float32 state, against the unsharded solves
    rs17 = rowshard_phase(ranks17, rows17)

    done(17)

    # 9. where the time of an iteration goes, mixed and pure, on the large
    # SOCP (100 iterations each unprofiled, in turns, then 25 under the
    # profiler: with 100 this phase took 192 s on an H100, most of it
    # outside the profiled solves, in the profiler's own processing).
    # Last: the profiler's tracing may slow launches after it stops, so
    # nothing timed above runs after it.
    turns = {True: [], False: []}
    for mixed in (True, False, False, True):
        turns[mixed].append(warm_workspace(big_p, spec, mixed, 100)[1])
    print(f"large SOCP, 100 iterations, warm, in turns mixed, pure, pure, "
          f"mixed: mixed {turns[True][0]:.3f}, {turns[True][1]:.3f} "
          f"ms/iteration; pure f64 {turns[False][0]:.3f}, "
          f"{turns[False][1]:.3f} ms/iteration")
    profile_iterations(big_p, spec, True, 25, "large SOCP mixed")
    profile_batched(head, batch, 25)
    # phase 14's profile: 25 iterations of the full sparse instance, mixed
    profile_iterations(types.SimpleNamespace(problem=sparse14["prob"],
                                             cone_data=None),
                       sparse14["spec"], True, 25,
                       "demo_sparse full size indirect mixed",
                       linsys="indirect")
    anderson_qr_times(1024, 501 + 10, 10)

    done(9)

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
    }, {
        "name": "logdet_cone", "route": "cuda",
        "source": "scs_tpu_torch/csrc/logdet.cu",
        "replaces": "scs_tpu/cones/spectral.py:193",
        "launches": spec13["large"]["direct mixed"]["k6"],
        "max_abs_err": max([c["max_abs_err"] for c in spec13["kernel"]]
                           + [spec13["edges"]["logdet"]]),
        "ms": spec13["kernel"][0]["ms"],
        "plain_ms": spec13["kernel"][0]["plain_ms"],
        "bound_ms": spec13["kernel"][0]["bound_ms"],
        "bound_by": spec13["kernel"][0]["bound_by"],
        "library_ms": None,
    }, {
        "name": "sum_largest_sorted", "route": "cuda",
        "source": "scs_tpu_torch/csrc/sumlargest.cu",
        "replaces": "scs_tpu/cones/spectral.py:99",
        "launches": spec13["large"]["direct mixed"]["k7"],
        "max_abs_err": max([c["max_abs_err"] for c in spec13["sl_kernel"]]
                           + [spec13["edges"]["sum_largest"]]),
        "ms": spec13["sl_kernel"][0]["ms"],
        "plain_ms": spec13["sl_kernel"][0]["plain_ms"],
        "bound_ms": spec13["sl_kernel"][0]["bound_ms"],
        "bound_by": spec13["sl_kernel"][0]["bound_by"],
        "library_ms": None,
    }, k2s_entry(sparse14, "pair", "scs_tpu/ops/dsmatvec.py:226",
                 sparse14["full"]["mixed"]["pair"]),
        k2s_entry(sparse14, "f32", "none: the JAX package's float32 "
                  "product is an XLA einsum, scs_tpu/ops/sparse.py:122",
                  sparse14["full"]["mixed"]["f32"]),
        k2s_entry(sparse14, "f64", "none: the JAX package's float64 "
                  "product is an XLA einsum, scs_tpu/ops/sparse.py:122",
                  sparse14["full"]["pure f64"]["f64"]),
        *rowshard_kernel_rows(rs17), {
        "name": "ds_matvec_sparse_direct", "route": "cuda",
        "source": "scs_tpu_torch/csrc/dsmatvec.cu",
        "replaces": "scs_tpu/ops/dsmatvec.py:91",
        "launches": sparse14["cut"]["mixed"]["k1"],
        "max_abs_err": sparse14["k1_cut"]["max_abs_err"],
        "ms": sparse14["k1_cut"]["ms"],
        "plain_ms": sparse14["k1_cut"]["plain_ms"],
        "bound_ms": sparse14["k1_cut"]["bound_ms"],
        "bound_by": sparse14["k1_cut"]["bound_by"],
        "library_ms": sparse14["k1_cut"]["library_ms"],
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
