"""Achieved device-memory bandwidth of the solver's hot matvecs, and the
pure-read rowsum (kernel K5) that witnesses the card's read ceiling.

Counterpart of `scs_tpu/ops/roofline.py`. The indirect backend's CG
matvec (A x, then A' z, inside the Schur apply of `linsys/indirect.py`)
streams its operand from device memory once per apply, so at solver sizes
it is bound by bandwidth, not by arithmetic. `measure` times, on one
square (n, n) matrix:

  * `ds_gbps`: the double-single matvec (K1, `ops/dsmatvec.py`), the mixed
    path's accurate matvec: 8 bytes (hi and lo) per element per apply;
  * `read_peak_gbps`: the pure-read rowsum of the same (hi, lo) pair
    (K5, `read_rowsum`, `csrc/readpeak.cu`): the same bytes, no work
    beyond one add and a sum, so the streaming-read rate a kernel of this
    repository reaches;
  * `f32_gbps`: `torch.mv` in float32 (the mixed CG's inner matvec), 4
    bytes per element;
  * `torch_rowsum_gbps`: PyTorch's own rowsum of the float32 matrix, 4
    bytes per element (the JAX probe's `xla_rowsum_gbps`, renamed: it is
    PyTorch's reduction kernel, not XLA's fused add-and-reduce; PyTorch
    runs eagerly and fuses nothing, so the chain's dependency enters as
    a separate add on the (n,) result rather than inside the reduction);
  * `torch_copy_total_gbps`: a chain of in-place `M += 1e-30` passes over
    the float32 matrix, read plus write traffic per pass (the JAX probe's
    `xla_copy_total_gbps`, renamed for the same reason);
  * `f64_gbps`: `torch.mv` in float64, the pure path's matvec.

Method: `iters` dependent applies, each result rescaled by its largest
magnitude before it feeds the next (the rescale that keeps a compiled
chain from being hoisted in the JAX probe; it also keeps values finite),
timed best of `reps`. The JAX probe runs the chain in one jitted
`fori_loop`, one dispatch. On the card the host would take longer to
launch an apply (4-7 launches of ~5 us) than the card takes to run it
(40 us for K1 at n = 4096), so the chain is captured once as a CUDA graph
and replayed: one launch from the host, the counterpart of that single
dispatch, timed with CUDA events. Rates are in GB/s (1e9 bytes/s).

Ceiling convention (the JAX probe's): the measured ceiling is the larger
of the pure-read witness and the best read-dominated kernel (the ds
matvec) of the same run, so `frac` = achieved / ceiling <= 1 by
construction; `frac_spec` is achieved over the data-sheet peak of the
card (`PEAK_HBM_GBPS`, looked up by `torch.cuda.get_device_name()`).

On the CPU (`device="cpu"`, the tests) every kernel wrapper runs its plain
version and the chain runs eagerly: the numbers are CPU rates, not the
card's.

    python -m scs_tpu_torch.ops.roofline [--n 4096] [--iters 400]
"""

from __future__ import annotations

import ctypes
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import _build, dsmatvec

# Peak device-memory bandwidth by card, GB/s, from NVIDIA's data sheets.
# Keys are matched in order against the lowercased device name.
PEAK_HBM_GBPS = {
    # H100 NVL product brief: 94 GB HBM3 at 3.9 TB/s
    "h100 nvl": 3900.0,
    # H100 PCIe data sheet: 80 GB HBM2e at 2.0 TB/s
    "h100 pcie": 2000.0,
    # H100 SXM5 data sheet ("NVIDIA H100 80GB HBM3"): 80 GB HBM3 at
    # 3.35 TB/s
    "h100": 3350.0,
}

# launches of the K5 kernel since the count was last set to 0; a call made
# while a CUDA graph is captured launches nothing and counts in `captured`
# instead, and each replay of that graph adds its captured calls here
launches = 0
captured = 0


def device_peak_gbps(name: Optional[str] = None) -> Optional[float]:
    """The data-sheet bandwidth of the card called `name` (default: CUDA
    device 0), or None for a card not in PEAK_HBM_GBPS."""
    if name is None:
        name = torch.cuda.get_device_name()
    kind = name.lower()
    for key, gbps in PEAK_HBM_GBPS.items():
        if key in kind:
            return gbps
    return None


# ---- K5: the pure-read rowsum ----

def read_rowsum_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (m, 1) float32 rowsums of
    a + b."""
    return (a + b).sum(dim=1, keepdim=True)


def read_rowsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """o (m, 1) float32 with o[i] = sum_j (a[i, j] + b[i, j]) for float32
    a and b (m, n) (kernel K5).

    CUDA tensors go to the CUDA kernel, CPU tensors to the plain version.
    The kernel takes unit column stride and equal strides for a and b,
    launches on the current stream and is not waited for."""
    global launches, captured
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"a and b must be matrices of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"a and b must be float32, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, "
                         f"{b.device}")
    dev = a.device
    if dev.type == "cpu":
        return read_rowsum_plain(a, b)
    if dev.type != "cuda":
        raise ValueError(f"read_rowsum runs on CUDA or CPU tensors, not "
                         f"{dev}")
    if a.stride() != b.stride() or a.stride(1) != 1:
        raise ValueError("read_rowsum's kernel takes a and b of equal "
                         "strides with unit column stride")
    m, n = a.shape
    o = torch.empty(m, 1, dtype=torch.float32, device=dev)
    if m == 0:
        return o
    lib = _lib()
    lda = a.stride(0)
    vec = int(n % 4 == 0 and lda % 4 == 0 and a.data_ptr() % 16 == 0
              and b.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.scs_read_rowsum(a.data_ptr(), b.data_ptr(), o.data_ptr(),
                                  m, n, lda, vec, stream)
    if err != 0:
        msg = lib.scs_readpeak_error_string(err).decode()
        raise RuntimeError(f"read_rowsum kernel launch failed: {msg} "
                           f"({err})")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return o


def _lib():
    lib = _build.load("readpeak")
    if lib.scs_read_rowsum.argtypes is None:
        lib.scs_read_rowsum.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        lib.scs_read_rowsum.restype = ctypes.c_int
        lib.scs_readpeak_error_string.argtypes = [ctypes.c_int]
        lib.scs_readpeak_error_string.restype = ctypes.c_char_p
    return lib


# ---- timing ----

def _chain(apply_fn: Callable, x: torch.Tensor, iters: int) -> torch.Tensor:
    for _ in range(iters):
        y = apply_fn(x)
        x = y / torch.clamp_min(torch.linalg.vector_norm(y, math.inf),
                                1e-30)
    return x


def _best_seconds(run: Callable[[], object], reps: int,
                  device: torch.device) -> float:
    """Best-of-reps seconds of run(). CUDA: run() captured once as a CUDA
    graph (after one uncaptured warm-up, which builds kernels and library
    handles) and each replay timed with CUDA events; every replay adds the
    K1 and K5 calls it captured to their launch counts. CPU: wall time."""
    best = math.inf
    if device.type == "cpu":
        run()
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        return best
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    k1, k5 = dsmatvec.captured, captured
    with torch.cuda.graph(graph):
        run()
    k1, k5 = dsmatvec.captured - k1, captured - k5

    def replay():
        global launches
        graph.replay()
        dsmatvec.launches += k1
        launches += k5

    replay()
    torch.cuda.synchronize(device)
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def _time_chained(apply_fn: Callable, x0: torch.Tensor, iters: int,
                  reps: int) -> float:
    """Best-of-reps seconds of `iters` dependent applies."""
    return _best_seconds(lambda: _chain(apply_fn, x0, iters), reps,
                         x0.device)


def measure(n: int = 4096, iters: int = 400, reps: int = 3, *,
            device="cuda") -> dict:
    """Achieved GB/s of the square (n, n) matvecs and probes (see the
    module docstring), the card's data-sheet peak, and `frac` = the ds
    matvec's rate over the measured read ceiling (`frac_spec`: over the
    data-sheet peak).

    At n = 4096 one ds apply streams 134 MB, 0.040 ms at 3.35 TB/s: 400
    applies take ~20 ms of device time, far above the graph launch."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; roofline.measure "
                           "runs on the card unless device='cpu' is passed")
    rng = np.random.RandomState(0)
    A64 = torch.tensor(rng.randn(n, n), device=dev)
    x0 = torch.tensor(rng.randn(n), device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out: dict = {"device": name, "n": n, "iters": iters}

    # the double-single matvec (K1), and the pure read of its operands (K5)
    split = dsmatvec.split_operand(A64)
    bytes_ds = 2 * n * n * 4
    t = _time_chained(lambda x: dsmatvec.ds_matvec(split, x), x0, iters,
                      reps)
    out["ds_gbps"] = iters * bytes_ds / t / 1e9
    t = _time_chained(lambda x: read_rowsum(split.hi, split.lo)[:, 0], x0,
                      iters, reps)
    out["read_peak_gbps"] = iters * bytes_ds / t / 1e9

    # float32 matvec, one float32 image per apply
    A32 = A64.to(torch.float32)
    x32 = x0.to(torch.float32)
    t = _time_chained(lambda x: torch.mv(A32, x), x32, iters, reps)
    out["f32_gbps"] = iters * (n * n * 4) / t / 1e9
    # PyTorch's rowsum, the dependency added on the (n,) result
    t = _time_chained(lambda x: torch.add(A32.sum(dim=1), x[:1],
                                          alpha=1e-30), x32, iters, reps)
    out["torch_rowsum_gbps"] = iters * (n * n * 4) / t / 1e9
    # in-place copy chain: read + write of the matrix per pass, one
    # reduction at the end (an extra read of 1/it_copy of the traffic)
    it_copy = max(iters // 2, 8)
    M = A32.clone()

    def copy_chain():
        for _ in range(it_copy):
            M.add_(1e-30)
        return M.sum()

    t = _best_seconds(copy_chain, reps, dev)
    out["torch_copy_total_gbps"] = it_copy * (2 * n * n * 4) / t / 1e9

    # float64 matvec (the pure path)
    f64_iters = max(iters // 16, 8)
    t = _time_chained(lambda x: torch.mv(A64, x), x0, f64_iters,
                      max(2, reps // 2))
    out["f64_gbps"] = f64_iters * (n * n * 8) / t / 1e9

    peak = device_peak_gbps(name) if dev.type == "cuda" else None
    out["peak_gbps"] = peak
    ach = out["ds_gbps"]
    ceiling = max(out["read_peak_gbps"], ach)
    out["read_ceiling_gbps"] = ceiling
    out["frac"] = ach / ceiling
    out["frac_spec"] = ach / peak if peak else None
    out["frac_achievable"] = out["frac"]
    return out


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    print(json.dumps(measure(a.n, a.iters, a.reps, device=a.device),
                     indent=2))
