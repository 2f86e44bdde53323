"""y = A x with A held as a double-single (hi, lo) float32 pair (kernel K1).

Counterpart of `scs_tpu/ops/dsmatvec.py` (`split_operand`, `ds_matvec`,
`DsOperator`). The mixed-precision direct solve and its residual checks
need A x, A' z and K x accurate to far below the solver's ~1e-6 noise
line, while the operator is stored as two float32 words per element
(hi + lo carries ~48 bits of the float64 value).

On a CUDA tensor `ds_matvec` launches the hand-written kernel in
`csrc/dsmatvec.cu` (built with nvcc for sm_90a at first use, see
`_build.py`); on a CPU tensor it runs the plain version
`ds_matvec_plain`, which the tests compare against the JAX kernel and
which the chip smoke test compares against the CUDA kernel. Any other
device raises.

Unlike the TPU split, the pair is not padded: the kernel masks its own
ragged edges.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

# launches of the CUDA kernel since the count was last set to 0
launches = 0


class DsSplit(NamedTuple):
    """(hi, lo) float32 pair of an (m, n) float64 matrix, hi + lo ~= A."""

    hi: torch.Tensor
    lo: torch.Tensor


def split_operand(A: torch.Tensor) -> DsSplit:
    """Split a float64 matrix into its contiguous (hi, lo) float32 pair:
    hi = f32(A), lo = f32(A - hi)."""
    if A.dtype != torch.float64 or A.dim() != 2:
        raise ValueError(f"split_operand takes a float64 matrix, got "
                         f"{A.dtype} of shape {tuple(A.shape)}")
    hi = A.to(torch.float32).contiguous()
    lo = (A - hi.to(torch.float64)).to(torch.float32).contiguous()
    return DsSplit(hi, lo)


def ds_matvec_plain(split: DsSplit, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: each element formed exactly in
    float64 as hi + lo, then a float64 matrix-vector product."""
    return (split.hi.to(torch.float64) + split.lo.to(torch.float64)) @ x


def _check(split: DsSplit, x: torch.Tensor) -> tuple[int, int]:
    hi, lo = split
    if hi.dim() != 2 or hi.shape != lo.shape:
        raise ValueError(f"hi and lo must be matrices of one shape, got "
                         f"{tuple(hi.shape)} and {tuple(lo.shape)}")
    if hi.dtype != torch.float32 or lo.dtype != torch.float32:
        raise TypeError(f"hi and lo must be float32, got {hi.dtype}, "
                        f"{lo.dtype}")
    if x.dtype != torch.float64:
        raise TypeError(f"x must be float64, got {x.dtype}")
    m, n = hi.shape
    if x.shape != (n,):
        raise ValueError(f"x must have shape ({n},), got {tuple(x.shape)}")
    if not (hi.device == lo.device == x.device):
        raise ValueError(f"operands on different devices: {hi.device}, "
                         f"{lo.device}, {x.device}")
    return m, n


def ds_matvec(split: DsSplit, x: torch.Tensor) -> torch.Tensor:
    """y (m,) float64 = (hi + lo) @ x.

    CUDA tensors go to the CUDA kernel, CPU tensors to the plain version.
    The kernel launches on the current stream and is not waited for."""
    m, n = _check(split, x)
    dev = x.device
    if dev.type == "cpu":
        return ds_matvec_plain(split, x)
    if dev.type != "cuda":
        raise ValueError(f"ds_matvec runs on CUDA or CPU tensors, not {dev}")
    return _launch(split, x, m, n)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]


def _lib():
    lib = _build.load("dsmatvec")
    if lib.scs_ds_matvec.argtypes is None:
        lib.scs_ds_matvec.argtypes = _ARGTYPES
        lib.scs_ds_matvec.restype = ctypes.c_int
        lib.scs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.scs_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(split: DsSplit, x: torch.Tensor, m: int, n: int) -> torch.Tensor:
    global launches
    hi, lo = split
    if not (hi.is_contiguous() and lo.is_contiguous() and x.is_contiguous()):
        raise ValueError("ds_matvec's kernel takes contiguous operands")
    y = torch.empty(m, dtype=torch.float64, device=x.device)
    if m == 0:
        return y
    lib = _lib()
    # 16-byte loads need 16-byte aligned rows of hi/lo and pairs of x
    ptrs = (hi.data_ptr(), lo.data_ptr(), x.data_ptr())
    vec = int(n % 4 == 0 and all(p % 16 == 0 for p in ptrs))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.scs_ds_matvec(hi.data_ptr(), lo.data_ptr(), x.data_ptr(),
                                y.data_ptr(), m, n, n, 1, 0, 0, 0, vec,
                                stream)
    if err != 0:
        msg = lib.scs_cuda_error_string(err).decode()
        raise RuntimeError(f"ds_matvec kernel launch failed: {msg} ({err})")
    launches += 1
    return y


class DsOperator:
    """Loop-invariant double-single operator for A and A' applies."""

    def __init__(self, A: torch.Tensor):
        self.m, self.n = A.shape
        self.fwd = split_operand(A)
        self.bwd = split_operand(A.T)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return ds_matvec(self.fwd, x)

    def rmatvec(self, z: torch.Tensor) -> torch.Tensor:
        return ds_matvec(self.bwd, z)
