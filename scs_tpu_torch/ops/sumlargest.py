"""The sum-of-k-largest cone's path-following loop on the card:
`csrc/sumlargest.cu`, one thread per cone, a block's rows staged in shared
memory from n = 14 on, read in place below (`launch_config`).
`empty_launch` launches a kernel that does nothing, the floor against
which a launch's time is read.

Replaces no Pallas kernel. The JAX package leaves the loop of
`scs_tpu/cones/spectral.py` (proj_sum_largest_sorted, :99-145) to XLA;
its PyTorch form (`cones/spectral._sum_largest_sorted_plain`, the plain
version here) launches ~40 kernels a pass, for up to 2n + 4 passes.

CUDA tensors go to the kernel, CPU tensors to the plain version. Both
take float64 t0 (L,) and x (L, n) on one device, each row of x sorted
descending, 0 < k < n (the spectral cones project in float64 whatever
the state's dtype, ROADMAP R5); the kernel launches on the current stream
and is not waited for. `launches` counts the
kernel's launches since it was last set to 0.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

launches = 0

_lib_cache = None

# shared memory a block may take on an H100 (227 KB), and cones a block
# where their rows fit
SHARED_MAX = 232448
_CONES = 128
# the least n whose rows are staged: below it a thread's few passes cost
# less than the block's loads, barrier and stores (1024 cones on an H100,
# tools/torch_sum_largest_rows.py --sweep: n = 12 0.0111 ms in place,
# 0.0117 staged; n = 14 0.0131 and 0.0125; PERF.md)
STAGE_MIN_N = 14


class Layout(NamedTuple):
    """Cones (one a thread) and threads a block, the rows' stride in
    doubles (odd, or 0 where even one row does not fit and the passes read
    it in device memory) and the dynamic shared memory a block."""

    cones_per_block: int
    threads: int
    stride: int
    shared_bytes: int


def launch_config(n: int) -> Layout:
    """The layout for rows of n: in place below STAGE_MIN_N; staged at an
    odd stride of n or n + 1 doubles, 128 cones a block while their rows
    fit in 227 KB, fewer beyond; in place where one row does not fit."""
    stride = n | 1
    cones = min(_CONES, SHARED_MAX // (8 * stride))
    if n < STAGE_MIN_N or cones == 0:
        return Layout(_CONES, _CONES, 0, 0)
    return Layout(cones, 32 * -(-cones // 32), stride, 8 * stride * cones)


def _lib() -> ctypes.CDLL:
    global _lib_cache
    if _lib_cache is None:
        lib = _build.load("sumlargest")
        vp = ctypes.c_void_p
        lib.scs_sum_largest.argtypes = [vp] * 4 + [ctypes.c_longlong] + [
            ctypes.c_int] * 6 + [vp]
        lib.scs_sum_largest.restype = ctypes.c_int
        lib.scs_empty_launch.argtypes = [vp]
        lib.scs_empty_launch.restype = ctypes.c_int
        lib.scs_sumlargest_error_string.argtypes = [ctypes.c_int]
        lib.scs_sumlargest_error_string.restype = ctypes.c_char_p
        _lib_cache = lib
    return _lib_cache


def sum_largest_sorted(t0: torch.Tensor, x: torch.Tensor, k: int):
    """Project each (t0[i], x[i]), x[i] sorted descending, onto {(t, x):
    sum of the k largest of x <= t}. Returns (t, x)."""
    global launches
    if t0.dim() != 1 or x.dim() != 2 or x.shape[0] != t0.shape[0]:
        raise ValueError(f"sum_largest_sorted takes t0 (L,) and x (L, n), "
                         f"got {tuple(t0.shape)}, {tuple(x.shape)}")
    n = x.shape[1]
    if not 0 < k < n:
        raise ValueError(f"sum_largest_sorted needs 0 < k < n, got k={k}, "
                         f"n={n}")
    if not (t0.dtype == x.dtype == torch.float64):
        raise TypeError(f"sum_largest_sorted takes float64 operands, got "
                        f"{t0.dtype}, {x.dtype}")
    if t0.device != x.device:
        raise ValueError("sum_largest_sorted's operands lie on different "
                         "devices")
    dev = x.device
    if dev.type == "cpu":
        from ..cones.spectral import _sum_largest_sorted_plain
        return _sum_largest_sorted_plain(t0, x, k)
    if dev.type != "cuda":
        raise ValueError(f"sum_largest_sorted runs on CUDA or CPU tensors, "
                         f"not {dev}")
    t0, x = t0.contiguous(), x.contiguous()
    t, xo = torch.empty_like(t0), torch.empty_like(x)
    L = x.shape[0]
    if L == 0:
        return t, xo
    lib = _lib()
    lay = launch_config(n)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.scs_sum_largest(t0.data_ptr(), x.data_ptr(), t.data_ptr(),
                                  xo.data_ptr(), L, n, k, *lay, stream)
    if err != 0:
        msg = lib.scs_sumlargest_error_string(err).decode()
        raise RuntimeError(f"sum_largest_sorted kernel launch failed: {msg} "
                           f"({err})")
    launches += 1
    return t, xo


def empty_launch() -> None:
    """Launch, on the current stream of the current card, a kernel of one
    warp that does nothing."""
    lib = _lib()
    err = lib.scs_empty_launch(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.scs_sumlargest_error_string(err).decode()
        raise RuntimeError(f"empty kernel launch failed: {msg} ({err})")
