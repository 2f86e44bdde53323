"""y = A x with A held as a double-single (hi, lo) float32 pair: one
problem (kernel K1), a batch of problems (kernel K2), or a batch with the
float32 pair of each sum returned unsummed (kernel K3).

Counterpart of `scs_tpu/ops/dsmatvec.py` (`split_operand`, `ds_matvec`,
its batched rule `_ds_matvec_batched`, `ds_matvec_pair`,
`ds_compose_gram`, `DsOperator`). The mixed-precision direct solve and its
residual checks need A x, A' z and K x accurate to far below the solver's
~1e-6 noise line, while the operator is stored as two float32 words per
element (hi + lo carries ~48 bits of the float64 value).

On a CUDA tensor `ds_matvec`, `ds_matvec_batched` and
`ds_matvec_pair_batched` launch the hand-written kernel in
`csrc/dsmatvec.cu` (built with nvcc for sm_90a at first use, see
`_build.py`); the batched wrappers launch it with one `blockIdx.z` per
problem. On a CPU tensor they run the plain versions (`*_plain`), which
the tests compare against the JAX kernels and which the chip smoke test
compares against the CUDA kernel. Any other device raises.

Unlike the TPU split, the pair is not padded: the kernel masks its own
ragged edges. `launch_config` picks the kernel's variant on the host from
the shape, the strides and the pointers: threads per row from n, the
block size from m, and 16-byte loads for A and for x each where its own
alignment allows (a column slice of the iterate as x keeps A's).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

# launches of the CUDA kernel since the counts were last set to 0: one
# problem (K1), batched (K2) and batched with the pair output (K3). A K1
# call made while a CUDA graph is captured launches nothing and counts in
# `captured` instead (the graph's owner counts its replays)
launches = 0
batched_launches = 0
pair_launches = 0
captured = 0

# gridDim.z, the batch index of a launch, is at most 65535: a larger
# batch launches in chunks of at most this many problems (`batch_chunks`)
MAX_BATCH = 65535


class DsSplit(NamedTuple):
    """(hi, lo) float32 pair of an (m, n) float64 matrix, or of a (B, m, n)
    stack of them, hi + lo ~= A."""

    hi: torch.Tensor
    lo: torch.Tensor


def split_operand(A: torch.Tensor) -> DsSplit:
    """Split a float64 matrix (m, n), or a stack of them (B, m, n), into
    its contiguous (hi, lo) float32 pair: hi = f32(A), lo = f32(A - hi)."""
    if A.dtype != torch.float64 or A.dim() not in (2, 3):
        raise ValueError(f"split_operand takes a float64 matrix or a stack "
                         f"of them, got {A.dtype} of shape {tuple(A.shape)}")
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


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_longlong,
                                     ctypes.c_longlong] + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]

# threads per row the kernel is built for, and block sizes
_TPRS = (8, 16, 32, 64, 128, 256)
_BLOCKS = (256, 128, 64)


class LaunchConfig(NamedTuple):
    """The kernel variant for one launch: threads per row, threads per
    block, and whether A (hi and lo) and x take 16-byte loads."""

    tpr: int
    threads: int
    vec_a: bool
    vec_x: bool


# an H100 holds 132 x 2048 threads at once: rows at which one warp per row
# fills it, and loads at which one load per thread does
_MANY_ROWS = 132 * 64
_ONE_WAVE = 132 * 2048
_UNROLL = 4     # chunks a thread has in flight (kUnroll in the kernel)


def launch_config(batch: int, m: int, n: int, lda: int, a_bstride: int,
                  x_bstride: int, ptrs: tuple[int, int, int],
                  x_itemsize: int) -> LaunchConfig:
    """Choose the kernel's variant for y[b] = (hi[b] + lo[b]) x[b], b <
    batch, with m rows of n columns, A's row stride lda and batch stride
    a_bstride (floats), x's batch stride x_bstride (elements of x_itemsize
    bytes) and the data pointers (hi, lo, x). Strides of a batch of one
    are not read.

    A takes float4 loads when every problem's rows of hi and lo start on
    16-byte boundaries; x takes 16-byte loads when, in addition, every
    problem's x does. Threads per row (8 to 256): as many as give each
    thread kUnroll loads of a row where the loads outnumber the threads
    the card holds, else one load each (a small product is bound by
    latency: the shorter a thread's chain, the sooner it ends); at most
    32 where a warp per row would fill the card, so that a row's sum
    stays within a warp. Block: 256, 128 or 64 threads, whichever leaves
    the fewest rows of a problem idle in its last block (the largest on
    a tie)."""
    hi_p, lo_p, x_p = ptrs
    if batch == 1:
        a_bstride = x_bstride = 0
    vec_a = (hi_p % 16 == 0 and lo_p % 16 == 0 and lda % 4 == 0
             and a_bstride % 4 == 0)
    vec_x = (vec_a and x_p % 16 == 0
             and (x_bstride * x_itemsize) % 16 == 0)
    loads = -(-n // 4) if vec_a else n      # loads a row takes
    rows = batch * m
    want = -(-loads // _UNROLL) if rows * loads > _ONE_WAVE else loads
    cap = 32 if rows >= _MANY_ROWS else _TPRS[-1]
    tpr = next((t for t in _TPRS if t >= min(want, cap)), _TPRS[-1])
    threads = min((b for b in _BLOCKS if b >= tpr),
                  key=lambda b: -(-m // (b // tpr)) * (b // tpr) - m)
    return LaunchConfig(tpr, threads, vec_a, vec_x)


def _lib():
    lib = _build.load("dsmatvec")
    if lib.scs_ds_matvec.argtypes is None:
        lib.scs_ds_matvec.argtypes = _ARGTYPES
        lib.scs_ds_matvec.restype = ctypes.c_int
        lib.scs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.scs_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(split: DsSplit, x: torch.Tensor, m: int, n: int) -> torch.Tensor:
    global launches, captured
    hi, lo = split
    if not (hi.is_contiguous() and lo.is_contiguous() and x.is_contiguous()):
        raise ValueError("ds_matvec's kernel takes contiguous operands")
    y = torch.empty(m, dtype=torch.float64, device=x.device)
    if m == 0:
        return y
    lib = _lib()
    cfg = launch_config(1, m, n, n, 0, 0, (hi.data_ptr(), lo.data_ptr(),
                                           x.data_ptr()), 8)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.scs_ds_matvec(hi.data_ptr(), lo.data_ptr(), x.data_ptr(),
                                y.data_ptr(), None, m, n, n, 1, 0, 0, 0,
                                cfg.tpr, cfg.threads, int(cfg.vec_a),
                                int(cfg.vec_x), 0, stream)
    if err != 0:
        msg = lib.scs_cuda_error_string(err).decode()
        raise RuntimeError(f"ds_matvec kernel launch failed: {msg} ({err})")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return y


def ds_matvec_batched_plain(split: DsSplit, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the batched kernel: y[b] = (hi[b] + lo[b])
    @ x[b], each element formed exactly in float64, y in x's type."""
    return _sum_plain(split, x).to(x.dtype)


def _sum_plain(split: DsSplit, x: torch.Tensor) -> torch.Tensor:
    A = split.hi.to(torch.float64) + split.lo.to(torch.float64)
    return torch.matmul(A, x.to(torch.float64).unsqueeze(-1)).squeeze(-1)


def _check_batched(split: DsSplit, x: torch.Tensor) -> tuple[int, int, int]:
    hi, lo = split
    if hi.dim() != 3 or hi.shape != lo.shape:
        raise ValueError(f"hi and lo must be (B, m, n) stacks of one shape, "
                         f"got {tuple(hi.shape)} and {tuple(lo.shape)}")
    if hi.dtype != torch.float32 or lo.dtype != torch.float32:
        raise TypeError(f"hi and lo must be float32, got {hi.dtype}, "
                        f"{lo.dtype}")
    if x.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"x must be float64 or float32, got {x.dtype}")
    B, m, n = hi.shape
    if x.shape != (B, n):
        raise ValueError(f"x must have shape ({B}, {n}), got "
                         f"{tuple(x.shape)}")
    if not (hi.device == lo.device == x.device):
        raise ValueError(f"operands on different devices: {hi.device}, "
                         f"{lo.device}, {x.device}")
    return B, m, n


def _batched_device(name: str, x: torch.Tensor) -> str:
    dev = x.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not "
                         f"{x.device}")
    return dev


def ds_matvec_batched(split: DsSplit, x: torch.Tensor) -> torch.Tensor:
    """y (B, m) with y[b] = (hi[b] + lo[b]) @ x[b] (kernel K2), in x's type
    (float64, or float32 in the float32-state fast phase).

    CUDA tensors go to the CUDA kernel, CPU tensors to the plain version.
    The kernel reads the operands where they lie: hi and lo need unit
    column stride and equal strides, x unit stride along n; the batch and
    row strides are passed to the kernel (x is often a column slice of
    the (B, l) iterate, whose batch stride is l)."""
    global batched_launches
    B, m, n = _check_batched(split, x)
    if _batched_device("ds_matvec_batched", x) == "cpu":
        return ds_matvec_batched_plain(split, x)
    y = torch.empty(B, m, dtype=x.dtype, device=x.device)
    batched_launches += _launch_batched("ds_matvec_batched", split, x, y,
                                        None, B, m, n)
    return y


def ds_matvec_pair_batched_plain(split: DsSplit,
                                 x: torch.Tensor) -> DsSplit:
    """Plain PyTorch version of K3: the float64 product of
    `ds_matvec_batched_plain`, returned as its float32 pair (hi, lo =
    f32(y - hi))."""
    y = _sum_plain(split, x)
    hi = y.to(torch.float32)
    return DsSplit(hi, (y - hi.to(torch.float64)).to(torch.float32))


def ds_matvec_pair_batched(split: DsSplit, x: torch.Tensor) -> DsSplit:
    """For float32 x (B, n): (hi, lo) float32 (B, m) with hi + lo =
    (A_hi + A_lo) x per lane to
    ~2^-48 relative (kernel K3; `ds_matvec_pair` under the JAX package's
    vmap). The float32-state refinement residual r = (b - hi) - lo cancels
    exactly, which a single float32 product would not.

    CUDA tensors go to the CUDA kernel, CPU tensors to the plain version;
    the operands as for `ds_matvec_batched`."""
    global pair_launches
    B, m, n = _check_batched(split, x)
    if x.dtype != torch.float32:
        raise TypeError(f"ds_matvec_pair_batched takes float32 x (the "
                        f"float32-state regime), got {x.dtype}")
    if _batched_device("ds_matvec_pair_batched", x) == "cpu":
        return ds_matvec_pair_batched_plain(split, x)
    hi = torch.empty(B, m, dtype=torch.float32, device=x.device)
    lo = torch.empty_like(hi)
    pair_launches += _launch_batched("ds_matvec_pair_batched", split, x, hi,
                                     lo, B, m, n)
    return DsSplit(hi, lo)


def batch_chunks(B: int) -> list[tuple[int, int]]:
    """The (start, stop) problem ranges of a batch's launches: at most
    MAX_BATCH problems each, the grid's z extent."""
    return [(s, min(s + MAX_BATCH, B)) for s in range(0, B, MAX_BATCH)]


def _launch_batched(name: str, split: DsSplit, x: torch.Tensor,
                    y: torch.Tensor, ylo, B: int, m: int, n: int) -> int:
    """Launch the kernel for a batch into y (and ylo, the pair's low
    words), one launch per chunk of `batch_chunks(B)`. Returns the number
    of launches (none for an empty batch)."""
    hi, lo = split
    if hi.stride() != lo.stride() or hi.stride(2) != 1 or x.stride(1) != 1:
        raise ValueError(f"{name}'s kernel takes hi and lo of equal strides "
                         f"with unit column stride, and x with unit stride "
                         f"along n")
    if m == 0 or B == 0:
        return 0
    lib = _lib()
    lda, a_bs, x_bs = hi.stride(1), hi.stride(0), x.stride(0)
    x_f32 = x.dtype == torch.float32
    stream = torch.cuda.current_stream(x.device).cuda_stream
    chunks = batch_chunks(B)
    for s, e in chunks:
        h, l, xs, ys = hi[s:e], lo[s:e], x[s:e], y[s:e]
        cfg = launch_config(e - s, m, n, lda, a_bs, x_bs,
                            (h.data_ptr(), l.data_ptr(), xs.data_ptr()),
                            x.element_size())
        with torch.cuda.device(x.device):
            err = lib.scs_ds_matvec(
                h.data_ptr(), l.data_ptr(), xs.data_ptr(), ys.data_ptr(),
                None if ylo is None else ylo[s:e].data_ptr(),
                m, n, lda, e - s, a_bs, x_bs, m, cfg.tpr, cfg.threads,
                int(cfg.vec_a), int(cfg.vec_x), int(x_f32), stream)
        if err != 0:
            msg = lib.scs_cuda_error_string(err).decode()
            raise RuntimeError(f"{name} kernel launch failed: {msg} "
                               f"({err})")
    return len(chunks)


def ds_compose_gram_batched(ds_K: DsSplit, scale: torch.Tensor,
                            diag: torch.Tensor,
                            P=None) -> DsSplit:
    """The (hi, lo) split of G[b] = scale[b] K[b] + diag(diag[b]) [+ P[b]]
    from K's split, for the float32-state phase, whose view of the problem
    holds no float64 K (`ds_compose_gram`, dsmatvec.py:497-514). The JAX
    package composes the pair with error-free float32 arithmetic for want
    of float64; here G is formed in float64 from the exact hi + lo and
    split again, which is at least as accurate. A few elementwise passes
    over (B, n, n), once per factor."""
    K = ds_K.hi.to(torch.float64) + ds_K.lo.to(torch.float64)
    G = (scale.to(torch.float64)[:, None, None] * K
         + torch.diag_embed(diag.to(torch.float64)))
    if P is not None:
        G = G + P.to(torch.float64)
    return split_operand(G)


class DsOperator:
    """Loop-invariant double-single operator for A and A' applies, of one
    matrix (m, n) or of a stack of them (B, m, n)."""

    def __init__(self, A: torch.Tensor):
        self.batched = A.dim() == 3
        self.m, self.n = A.shape[-2:]
        self.fwd = split_operand(A)
        self.bwd = split_operand(A.transpose(-2, -1))

    def _apply(self, split: DsSplit, x: torch.Tensor) -> torch.Tensor:
        if self.batched:
            return ds_matvec_batched(split, x)
        return ds_matvec(split, x)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply(self.fwd, x)

    def rmatvec(self, z: torch.Tensor) -> torch.Tensor:
        return self._apply(self.bwd, z)
