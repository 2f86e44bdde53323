"""The logarithmic-cone cascade of the log-determinant cone projection on
the card: `csrc/logdet.cu`, a group of lanes per copy of a cone, several
copies a cone, the IPM in a launch of its own (`launch_config`).

Replaces no Pallas kernel. The JAX package leaves Newton, the KKT gate
and the IPM of `scs_tpu/cones/spectral.py` (:193-766) to XLA, which
compiles each loop into one program; their PyTorch form
(`cones/spectral.logdet_cone_plain`, the plain version here) launches
~220 kernels per Newton iteration and ~1200 per IPM iteration, and the
IPM often runs its full 100 iterations on the cones that need it.

CUDA tensors go to the kernel, CPU tensors to the plain version. Both
take float64 t0, v0 (L,) and x0 (L, n) on one device (the spectral cones
project in float64 whatever the state's dtype, ROADMAP R5; Newton's
tolerance of 1e-12 is below float32's resolution); the kernel launches on
the current stream and is not waited for. `launches` counts the kernel's
launches since it was last set to 0: two a call, the Newton + gate pass
and the IPM pass (launched also where no cone is listed).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

launches = 0

_lib_cache = None

# kArrays in csrc/logdet.cu: the (n + 3)-vectors a warp keeps in memory
_ARRAYS = 23
# shared memory a block may take on an H100 (227 KB), and the kernel's
# static share of it (the line searches' exchange, 2 x 32 x 4 doubles)
SHARED_MAX = 232448
SHARED_STATIC = 2048
# warps a cone where a block takes one
_CONE_WARPS = 4


class Layout(NamedTuple):
    """How the kernel holds one cone of order n (m = n + 3 entries a
    vector): a group of `lanes` lanes (the least power of two >= m, at most
    32) holds a copy of the cone, lane l entries l, l + lanes, ...;
    `entries` of them a lane in registers (1 or 2), or 0 where the vectors
    lie in `storage` "shared" (dynamic shared memory, `shared_bytes` a
    block) or "global" (a scratch of the wrapper's). `warps` warps a cone
    and `cones_per_block` cones a block in the Newton + gate launch,
    `ipm_warps` warps a cone in the IPM launch; every group of a cone's
    warps is a copy, and the copies evaluate consecutive trial points of a
    line search at once."""

    entries: int
    lanes: int
    warps: int
    cones_per_block: int
    storage: str
    shared_bytes: int
    ipm_warps: int

    @property
    def groups(self) -> int:
        """Copies of a cone in the Newton + gate launch."""
        return self.warps * 32 // self.lanes

    @property
    def threads(self) -> int:
        return 32 * self.warps * self.cones_per_block


def launch_config(n: int) -> Layout:
    """The kernel's layout for cones of order n (see `Layout`): registers
    where m = n + 3 <= 64 (one warp a cone, 32 / lanes copies and four
    cones a block where m <= 32; a block of four warps a cone beyond),
    shared memory where the four warps' copies (or fewer) fit in 227 KB,
    a global scratch beyond."""
    m = n + 3
    lanes = min(32, 1 << (m - 1).bit_length())
    if m <= 32:
        return Layout(1, lanes, 1, 4, "registers", 0, _CONE_WARPS)
    if m <= 64:
        return Layout(2, 32, _CONE_WARPS, 1, "registers", 0, _CONE_WARPS)
    warp_bytes = _ARRAYS * -(-m // 32) * 32 * 8
    warps = min(_CONE_WARPS, (SHARED_MAX - SHARED_STATIC) // warp_bytes)
    if warps:
        return Layout(0, 32, warps, 1, "shared", warps * warp_bytes, warps)
    return Layout(0, 32, _CONE_WARPS, 1, "global", 0, _CONE_WARPS)


def _lib() -> ctypes.CDLL:
    global _lib_cache
    if _lib_cache is None:
        lib = _build.load("logdet")
        vp = ctypes.c_void_p
        lib.scs_logdet_cone.argtypes = [vp] * 9 + [ctypes.c_longlong] + [
            ctypes.c_int] * 7 + [vp]
        lib.scs_logdet_cone.restype = ctypes.c_int
        lib.scs_logdet_scratch_len.argtypes = [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_int]
        lib.scs_logdet_scratch_len.restype = ctypes.c_longlong
        lib.scs_logdet_error_string.argtypes = [ctypes.c_int]
        lib.scs_logdet_error_string.restype = ctypes.c_char_p
        _lib_cache = lib
    return _lib_cache


def logdet_cone(t0: torch.Tensor, v0: torch.Tensor, x0: torch.Tensor):
    """Project each (t0[i], v0[i], x0[i]) onto the logarithmic cone
    cl{(t, v, x): -v (sum log x - n log v) <= t, v > 0, x > 0} as SCS's
    logdet wrapper does: damped Newton, the KKT gate, then the IPM
    (variant 0, then 1) where the gate fails. Returns (t, v, x, info),
    info (L,) int32 = Newton iterations + 1000 x IPM variants run."""
    global launches
    if t0.dim() != 1 or v0.shape != t0.shape or x0.dim() != 2 \
            or x0.shape[0] != t0.shape[0]:
        raise ValueError(f"logdet_cone takes t0, v0 (L,) and x0 (L, n), got "
                         f"{tuple(t0.shape)}, {tuple(v0.shape)}, "
                         f"{tuple(x0.shape)}")
    if not (t0.dtype == v0.dtype == x0.dtype == torch.float64):
        raise TypeError(f"logdet_cone takes float64 operands, got "
                        f"{t0.dtype}, {v0.dtype}, {x0.dtype}")
    if not (t0.device == v0.device == x0.device):
        raise ValueError("logdet_cone's operands lie on different devices")
    dev = t0.device
    if dev.type == "cpu":
        from ..cones.spectral import logdet_cone_plain
        return logdet_cone_plain(t0, v0, x0)
    if dev.type != "cuda":
        raise ValueError(f"logdet_cone runs on CUDA or CPU tensors, not {dev}")
    t0, v0, x0 = t0.contiguous(), v0.contiguous(), x0.contiguous()
    L, n = x0.shape
    t, v, x = torch.empty_like(t0), torch.empty_like(v0), torch.empty_like(x0)
    info = torch.empty(L, dtype=torch.int32, device=dev)
    if L == 0:
        return t, v, x, info
    lib = _lib()
    lay = launch_config(n)
    scratch = (torch.empty(lib.scs_logdet_scratch_len(L, n, lay.warps),
                           dtype=torch.float64, device=dev)
               if lay.storage == "global" else None)
    # the count of cones that fail the gate, then those cones
    listed = torch.zeros(L + 1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.scs_logdet_cone(
            t0.data_ptr(), v0.data_ptr(), x0.data_ptr(), t.data_ptr(),
            v.data_ptr(), x.data_ptr(), info.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            listed.data_ptr(), L, n,
            lay.entries, lay.lanes, lay.warps, lay.cones_per_block,
            lay.shared_bytes, lay.ipm_warps, stream)
    if err != 0:
        msg = lib.scs_logdet_error_string(err).decode()
        raise RuntimeError(f"logdet_cone kernel launch failed: {msg} ({err})")
    launches += 2
    return t, v, x, info
