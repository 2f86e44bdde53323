"""Core data types: problem data, cones, settings, solution, info.

Counterpart of `scs_tpu/types.py` (SCS's include/scs.h:44-244). Problem
data are dense tensors; the cone layout is a static, hashable spec; the
per-cone numeric data (box bounds) ride along as tensors. Every field and
default of `Settings` equals the JAX package's, except that `dtype` is a
`torch.dtype`. The device is not a setting: the entry points take it as a
keyword (see `api.Workspace`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from . import config


@dataclasses.dataclass(frozen=True)
class Problem:
    """Quadratic cone program data:  min (1/2)x'Px + c'x  s.t. Ax + s = b, s in K.

    ``A`` is (m, n); ``P`` is (n, n) full symmetric, or None for LPs/SOCPs.
    Either may be a sparse operand (`ops.sparse.SparseA`). The tensors may
    live on any device; the workspace moves them to its own.
    """

    A: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    P: Optional[torch.Tensor] = None

    @property
    def m(self) -> int:
        return self.A.shape[0]

    @property
    def n(self) -> int:
        return self.A.shape[1]


def problem_from_csc(A_csc, b, c, P_upper_csc=None,
                     dtype=torch.float64) -> Problem:
    """A dense Problem from scipy CSC inputs, the reference's data format
    (`scs_tpu/types.py:46-60`): P_upper_csc holds the upper triangle
    (include/scs.h:111-114) and is symmetrized here. For a problem kept
    sparse, pass `ops.sparse.sparse_from_scipy(A_csc)` as A instead."""
    A = torch.as_tensor(np.asarray(A_csc.todense()), dtype=dtype)
    P = None
    if P_upper_csc is not None:
        Pu = np.asarray(P_upper_csc.todense())
        P = torch.as_tensor(Pu + Pu.T - np.diag(np.diag(Pu)), dtype=dtype)
    return Problem(A=A, b=torch.as_tensor(np.asarray(b), dtype=dtype),
                   c=torch.as_tensor(np.asarray(c), dtype=dtype), P=P)


@dataclasses.dataclass(frozen=True)
class ConeSpec:
    """Static cone layout, SCS's ScsCone (include/scs.h:121-172).

    Rows of A follow this order: zero, nonnegative, box, SOC blocks, PSD
    blocks, complex-PSD blocks, primal exp triples, dual exp triples, power
    triples, then the spectral cones (logdet, nuclear, ell1, sum-largest).
    Every field converts from the JAX package's spec and every cone
    projects (`cones.project`). The mixed fast phase runs the eigh and SVD
    of the PSD and spectral cones in float32 and polishes in float64
    after, as the JAX package does; it
    leaves the JAX package's float32 fast phase for the exp and power
    cones, which project in float64 (exp in float32 only with
    `Settings.exp_f32=True`, and never in the polish; ROADMAP section 3,
    R4).
    """

    z: int = 0                      # zero cone (equalities)
    l: int = 0                      # nonnegative orthant
    bsize: int = 0                  # box cone total length (incl. scale t); 0 = absent
    q: tuple[int, ...] = ()         # second-order cone sizes
    s: tuple[int, ...] = ()         # PSD cone matrix dims (packed size n(n+1)/2)
    cs: tuple[int, ...] = ()        # complex PSD dims (packed size n^2 reals)
    ep: int = 0                     # primal exponential cone triples
    ed: int = 0                     # dual exponential cone triples
    p: tuple[float, ...] = ()       # power cone exponents (sign: primal/dual)
    d: tuple[int, ...] = ()         # logdet cone matrix dims
    nuc_m: tuple[int, ...] = ()     # nuclear cone row dims
    nuc_n: tuple[int, ...] = ()     # nuclear cone col dims
    ell1: tuple[int, ...] = ()      # ell1 cone sizes
    sl_n: tuple[int, ...] = ()      # sum-largest-evals matrix dims
    sl_k: tuple[int, ...] = ()      # sum-largest-evals k values

    @property
    def psize(self) -> int:
        return len(self.p)

    @property
    def f32_polish_cones(self) -> bool:
        """True when terminated lanes must take at least one float64
        polish leg even at loose eps targets: the PSD/spectral family
        only. A float32 eigh's error on a clustered spectrum can reach
        ~1e-3 scale, above the usual 1e-4 targets, so the float64 phase
        re-projects to restore exact complementarity (s'y = 0 up to
        float64 round-off)."""
        return bool(self.s or self.cs or self.d or self.nuc_m
                    or self.sl_n)

    def dims(self) -> int:
        """Total number of rows m implied by the cone layout."""
        dd = self.z + self.l + self.bsize
        dd += sum(self.q)
        dd += sum(si * (si + 1) // 2 for si in self.s)
        dd += sum(ci * ci for ci in self.cs)
        dd += 3 * (self.ep + self.ed + self.psize)
        dd += sum(di * (di + 1) // 2 + 2 for di in self.d)
        dd += sum(mi * ni + 1 for mi, ni in zip(self.nuc_m, self.nuc_n))
        dd += sum(ei + 1 for ei in self.ell1)
        dd += sum(si * (si + 1) // 2 + 1 for si in self.sl_n)
        return dd

    def num_cones(self) -> int:
        return (len(self.q) + len(self.s) + len(self.cs) + self.ep + self.ed
                + self.psize + len(self.d) + len(self.nuc_m) + len(self.ell1)
                + len(self.sl_n))


@dataclasses.dataclass(frozen=True)
class ConeData:
    """Per-cone numeric data (tensors). Empty tensors when absent."""

    bu: torch.Tensor  # (max(bsize-1, 0),) upper box bounds
    bl: torch.Tensor  # (max(bsize-1, 0),) lower box bounds

    @staticmethod
    def make(spec: ConeSpec, bu=None, bl=None,
             dtype=torch.float64) -> "ConeData":
        nb = max(spec.bsize - 1, 0)
        if nb:
            if bu is None or bl is None:
                raise ValueError("box cone requires bu and bl of length bsize-1")
            bu = torch.as_tensor(bu, dtype=dtype)
            bl = torch.as_tensor(bl, dtype=dtype)
            if bu.shape != (nb,) or bl.shape != (nb,):
                raise ValueError(f"bu/bl must have shape ({nb},)")
        else:
            bu = torch.zeros((0,), dtype=dtype)
            bl = torch.zeros((0,), dtype=dtype)
        return ConeData(bu=bu, bl=bl)


@dataclasses.dataclass(frozen=True)
class Settings:
    """Solver settings with SCS's defaults (include/scs.h:60-101,
    glbopts.h:35-52), field for field those of the JAX package."""

    normalize: bool = config.NORMALIZE
    scale: float = config.SCALE
    adaptive_scale: bool = config.ADAPTIVE_SCALE
    rho_x: float = config.RHO_X
    max_iters: int = config.MAX_ITERS
    eps_abs: float = config.EPS_ABS
    eps_rel: float = config.EPS_REL
    eps_infeas: float = config.EPS_INFEAS
    alpha: float = config.ALPHA
    time_limit_secs: float = config.TIME_LIMIT_SECS
    verbose: bool = False
    warm_start: bool = False
    acceleration_lookback: int = config.ACCELERATION_LOOKBACK
    acceleration_interval: int = config.ACCELERATION_INTERVAL
    acceleration_type_1: bool = config.ACCELERATION_TYPE_1
    acceleration_regularization: float = config.AA_REGULARIZATION
    acceleration_relaxation: float = config.AA_RELAXATION
    write_data_filename: Optional[str] = None
    log_csv_filename: Optional[str] = None
    # "indirect" (CG) or "direct" (dense Schur-complement Cholesky)
    linsys: str = "indirect"
    dtype: Any = torch.float64
    # f32 inverse-apply + f64 refinement with double-single matvecs.
    # None = auto: on for f64 off the CPU (linsys.resolve_mixed).
    mixed_precision: Optional[bool] = None
    # iterations run between host-side checks of the time limit
    chunk_iters: int = 2500
    # tracked-rank PSD projection (0 = off)
    psd_rank: int = 0
    # measured per-phase timing
    profile_phases: bool = False
    # f32 cone projections / exp-power transcendentals (None = follow the
    # resolved mixed flag); they act on the PSD, spectral, exp and power
    # cones only
    cone_f32: Optional[bool] = None
    exp_f32: Optional[bool] = None
    # f32-state fast phase of the batched solvers (None = follow the
    # resolved mixed flag where the ds splits exist;
    # linsys.resolve_fast_f32)
    fast_f32: Optional[bool] = None
    # batched-loop body selection of the JAX package (None = auto); no
    # effect here, where the batched loop is Python (solver_batched)
    macro_schedule: Optional[bool] = None


@dataclasses.dataclass
class Solution:
    """Primal/dual solution or certificate (include/scs.h:174-187)."""

    x: Any = None
    y: Any = None
    s: Any = None


@dataclasses.dataclass
class Info:
    """Solve diagnostics (subset of ScsInfo, include/scs.h:189-244)."""

    iter: int = 0
    status: str = "unfinished"
    status_val: int = config.UNFINISHED
    scale_updates: int = 0
    pobj: float = float("nan")
    dobj: float = float("nan")
    res_pri: float = float("nan")
    res_dual: float = float("nan")
    gap: float = float("nan")
    res_infeas: float = float("nan")
    res_unbdd_a: float = float("nan")
    res_unbdd_p: float = float("nan")
    setup_time: float = 0.0   # milliseconds
    solve_time: float = 0.0   # milliseconds
    lin_sys_time: float = float("nan")
    cone_time: float = float("nan")
    accel_time: float = float("nan")
    ave_time_matrix_cone_proj: float = float("nan")
    ave_time_vector_cone_proj: float = float("nan")
    scale: float = 0.0
    comp_slack: float = float("nan")
    rejected_accel_steps: int = 0
    accepted_accel_steps: int = 0
    lin_sys_solver: str = ""
