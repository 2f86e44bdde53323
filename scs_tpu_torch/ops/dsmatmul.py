"""C = A B for float64 stacks, with the operands held as double-single
(hi, lo) float32 pairs (kernel K4).

Counterpart of `scs_tpu/ops/dsmatmul.py` (`ds_matmul`, its Pallas kernel
`_kernel` launched by `_ds_matmul_padded`). The JAX package superseded it
on its hot paths (`ops/ozaki.py`); nothing in the solver calls it, and its
entry point is `ds_matmul` itself.

On a CUDA tensor `ds_matmul_pairs` launches the hand-written kernel in
`csrc/dsmatmul.cu` (built with nvcc for sm_90a at first use, see
`_build.py`): a tiled product on the float64 tensor cores, one block per
128 x 64 tile of C and `blockIdx.z` per product of the stack, fed by a
`cp.async` pipeline. On a CPU tensor it runs the plain version,
`(Ah + Al) @ (Bh + Bl)` in float64, which the tests hold against numpy and
the JAX kernel and which the chip smoke test holds against the kernel.
Any other device raises. The pairs are not padded: the kernel masks its
own ragged edges, with 16-byte copies where k (for A) or n (for B) is a
multiple of 4 and 4-byte copies otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dsmatvec import DsSplit, split_operand

# launches of the CUDA kernel since the count was last set to 0
launches = 0

# gridDim.z (the product index) and gridDim.y (row tiles of the kernel's
# 128-row tile, `scs_ds_matmul_tile`) are at most 65535
MAX_BATCH = 65535
_TILE_M = 128


def ds_matmul_plain(a: DsSplit, b: DsSplit) -> torch.Tensor:
    """Plain PyTorch version of the kernel: each element formed exactly in
    float64 as hi + lo, then a float64 batched product."""
    f64 = torch.float64
    return torch.matmul(a.hi.to(f64) + a.lo.to(f64),
                        b.hi.to(f64) + b.lo.to(f64))


def _check(a: DsSplit, b: DsSplit) -> tuple[int, int, int, int]:
    for name, s in (("A", a), ("B", b)):
        if s.hi.dim() != 3 or s.hi.shape != s.lo.shape:
            raise ValueError(f"{name}'s hi and lo must be (batch, ., .) "
                             f"stacks of one shape, got "
                             f"{tuple(s.hi.shape)} and {tuple(s.lo.shape)}")
        if s.hi.dtype != torch.float32 or s.lo.dtype != torch.float32:
            raise TypeError(f"{name}'s hi and lo must be float32, got "
                            f"{s.hi.dtype}, {s.lo.dtype}")
    nb, m, k = a.hi.shape
    if b.hi.shape[0] != nb or b.hi.shape[1] != k:
        raise ValueError(f"shapes {tuple(a.hi.shape)} and "
                         f"{tuple(b.hi.shape)} do not multiply")
    devs = {t.device for t in (*a, *b)}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {devs}")
    return nb, m, b.hi.shape[2], k


def ds_matmul_pairs(a: DsSplit, b: DsSplit) -> torch.Tensor:
    """C (batch, m, n) float64 = (Ah + Al) @ (Bh + Bl) for (batch, m, k)
    and (batch, k, n) float32 pairs (kernel K4).

    CUDA tensors go to the CUDA kernel, CPU tensors to the plain version.
    The kernel takes contiguous pairs, launches on the current stream and
    is not waited for."""
    global launches
    nb, m, n, k = _check(a, b)
    dev = a.hi.device
    if dev.type == "cpu":
        return ds_matmul_plain(a, b)
    if dev.type != "cuda":
        raise ValueError(f"ds_matmul runs on CUDA or CPU tensors, not {dev}")
    if not all(t.is_contiguous() for t in (*a, *b)):
        raise ValueError("ds_matmul's kernel takes contiguous pairs")
    if nb > MAX_BATCH or -(-m // _TILE_M) > MAX_BATCH:
        raise ValueError(f"ds_matmul launches one grid slice per product "
                         f"and per {_TILE_M} rows, at most {MAX_BATCH} of "
                         f"each; got {nb} products of {m} rows")
    c = torch.empty(nb, m, n, dtype=torch.float64, device=dev)
    if nb == 0 or m == 0 or n == 0:
        return c
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.scs_ds_matmul(a.hi.data_ptr(), a.lo.data_ptr(),
                                b.hi.data_ptr(), b.lo.data_ptr(),
                                c.data_ptr(), nb, m, n, k, stream)
    if err != 0:
        msg = lib.scs_dsmatmul_error_string(err).decode()
        raise RuntimeError(f"ds_matmul kernel launch failed: {msg} ({err})")
    launches += 1
    return c


def _lib():
    lib = _build.load("dsmatmul")
    if lib.scs_ds_matmul.argtypes is None:
        lib.scs_ds_matmul.argtypes = ([ctypes.c_void_p] * 5
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_void_p])
        lib.scs_ds_matmul.restype = ctypes.c_int
        lib.scs_dsmatmul_error_string.argtypes = [ctypes.c_int]
        lib.scs_dsmatmul_error_string.restype = ctypes.c_char_p
    return lib


def ds_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """C = A @ B for float64 A (..., m, k) and B (..., k, n) with equal
    leading dimensions, f64 in and out (the JAX `ds_matmul`): both
    operands split into (hi, lo) pairs, multiplied by `ds_matmul_pairs`."""
    if A.dtype != torch.float64 or B.dtype != torch.float64:
        raise TypeError(f"ds_matmul takes float64 operands, got {A.dtype}, "
                        f"{B.dtype}")
    if A.dim() < 2 or B.dim() < 2 or A.shape[:-2] != B.shape[:-2]:
        raise ValueError(f"ds_matmul takes (..., m, k) and (..., k, n) with "
                         f"equal leading dimensions, got {tuple(A.shape)} "
                         f"and {tuple(B.shape)}")
    lead = A.shape[:-2]
    m, k = A.shape[-2:]
    n = B.shape[-1]
    a = split_operand(A.reshape(-1, m, k))
    b = split_operand(B.reshape(-1, B.shape[-2], n))
    return ds_matmul_pairs(a, b).reshape(*lead, m, n)
