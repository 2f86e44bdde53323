"""The launch of kernel K2s, y = A x for one direction of a blocked-ELL
operand (`csrc/ellmatvec.cu`), in three kinds: the (hi, lo) float32 pair
with float64 x and y (the mixed path's products, `sparse.ds_ell_matvec`),
float32 (the indirect CG's shadow) and float64 (the pure path), the last
two through `sparse.ell_matvec`.

The wrappers in `ops/sparse.py` pick by device: a CUDA tensor comes here,
a CPU tensor goes to their plain versions there, any other device raises.
`launch` checks what it is given and raises on what the kernel does not
take; it launches on the current stream and does not wait.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build

# launches of each kind since the counts were last set to 0; a call made
# while a CUDA graph is captured launches nothing and counts in `captured`
# instead (the indirect CG's blocks replay one)
pair_launches = 0
f32_launches = 0
f64_launches = 0
captured = 0

KINDS = {"pair": 0, "f32": 1, "f64": 2}
# the fast path's tile shapes (csrc/ellmatvec.cu); others take the
# generic path, one thread a row
FAST_BM = 8
FAST_BN = (16, 32, 64, 128)


# warps the card holds at half occupancy (132 SMs x 32): where the
# block-rows are fewer, several warps share one (`launch_config`)
_FILL_WARPS = 132 * 32
_MAX_WPR = 8


class LaunchConfig(NamedTuple):
    """The kernel's variant: the fast path (warps a block-row, 16-byte
    loads of the tiles) and 16-byte loads of x."""

    fast: bool
    wpr: int
    vec_x: bool


def launch_config(nbr: int, bm: int, bn: int, kmax: int, tile_ptrs: tuple,
                  x_ptr: int) -> LaunchConfig:
    """The fast path where the tiles are bm = 8 rows by bn = 16, 32, 64 or
    128 columns and every tile array starts on a 16-byte boundary (each
    row's stride kmax * bn elements then keeps it); 16-byte loads of x
    where x starts on one too. Warps a block-row (wpr): 1 where nbr
    block-rows fill half the card's warps, else the least power of two
    that does, at most 8 and at most kmax (a warp takes a contiguous share
    of its block-row's tiles)."""
    fast = (bm == FAST_BM and bn in FAST_BN
            and all(p % 16 == 0 for p in tile_ptrs))
    wpr = 1
    while (wpr < _MAX_WPR and 2 * wpr <= kmax
           and nbr * wpr < _FILL_WARPS):
        wpr *= 2
    return LaunchConfig(fast, wpr, x_ptr % 16 == 0)


def _lib():
    lib = _build.load("ellmatvec")
    if lib.scs_ell_matvec.argtypes is None:
        lib.scs_ell_matvec.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
            + [ctypes.c_void_p])
        lib.scs_ell_matvec.restype = ctypes.c_int
        lib.scs_ell_error_string.argtypes = [ctypes.c_int]
        lib.scs_ell_error_string.restype = ctypes.c_char_p
    return lib


def launch(kind: str, a: torch.Tensor, alo: Optional[torch.Tensor],
           idx: torch.Tensor, count: torch.Tensor, x: torch.Tensor, m: int,
           n: int, bm: int, bn: int, kmax: int) -> torch.Tensor:
    """y (m,) in x's type = A x on CUDA tensors: `a` (and `alo`, the pair's
    low words) the (nbr, bm, kmax * bn) tiles, `idx` (nbr, kmax) and
    `count` (nbr,) int32, x (n,) with unit stride."""
    global pair_launches, f32_launches, f64_launches, captured
    want = {"pair": (torch.float32, torch.float64),
            "f32": (torch.float32, torch.float32),
            "f64": (torch.float64, torch.float64)}[kind]
    if (a.dtype, x.dtype) != want or (alo is None) != (kind != "pair"):
        raise TypeError(f"K2s {kind}: tiles {a.dtype} and x {x.dtype}, "
                        f"want {want}")
    nbr = idx.shape[0]
    tiles = [a] if alo is None else [a, alo]
    if any(t.shape != (nbr, bm, kmax * bn) or not t.is_contiguous()
           for t in tiles):
        raise ValueError(f"K2s takes contiguous ({nbr}, {bm}, {kmax * bn}) "
                         f"tiles, got {[tuple(t.shape) for t in tiles]}")
    if (idx.dtype != torch.int32 or count.dtype != torch.int32
            or idx.shape != (nbr, kmax) or count.shape != (nbr,)
            or not (idx.is_contiguous() and count.is_contiguous())):
        raise ValueError("K2s takes contiguous int32 idx (nbr, kmax) and "
                         "count (nbr,)")
    if x.shape != (n,) or x.stride(0) != 1:
        raise ValueError(f"K2s takes x ({n},) with unit stride, got "
                         f"{tuple(x.shape)}")
    if nbr != -(-max(m, 1) // bm):
        raise ValueError(f"K2s: {nbr} block-rows of {bm} for {m} rows")
    if len({t.device for t in (*tiles, idx, count, x)}) != 1:
        raise ValueError("K2s: operands on different devices")
    y = torch.empty(m, dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    cfg = launch_config(nbr, bm, bn, kmax,
                        tuple(t.data_ptr() for t in tiles), x.data_ptr())
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.scs_ell_matvec(
            KINDS[kind], a.data_ptr(), None if alo is None else alo.data_ptr(),
            idx.data_ptr(), count.data_ptr(), x.data_ptr(), y.data_ptr(), m,
            n, bm, bn, kmax, int(cfg.fast), cfg.wpr, int(cfg.vec_x),
            stream)
    if err != 0:
        msg = lib.scs_ell_error_string(err).decode()
        raise RuntimeError(f"K2s {kind} launch failed: {msg} ({err})")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    elif kind == "pair":
        pair_launches += 1
    elif kind == "f32":
        f32_launches += 1
    else:
        f64_launches += 1
    return y
