"""Ruiz + L2 equilibration of (A, P) and b/c normalization.

Counterpart of `scs_tpu/equilibrate.py` (SCS: linsys/scs_matrix.c:226-496,
25 Ruiz passes + 1 L2 pass respecting cone boundaries, and
src/normalize.c:33-90). Row and column norms are reductions over the
dense A and P; the per-cone aggregation is a scatter-reduce over a
segment-id map derived from the cone layout.

The `*_batched` functions equilibrate and normalize a stack of B problems
of one shape (leading batch axis); each problem's D and E are those of
`equilibrate` applied to it alone. The Scaling of a batch holds D (B, m),
E (B, n) and sigmas of shape (B,).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config
from .cones.project import cone_boundaries
from .types import ConeSpec


@dataclasses.dataclass(frozen=True)
class Scaling:
    """Equilibration state (SCS's ScsScaling). The sigmas are 0-d tensors."""

    D: torch.Tensor              # (m,) row scaling
    E: torch.Tensor              # (n,) col scaling
    primal_scale: torch.Tensor   # sigma
    dual_scale: torch.Tensor     # sigma


def _segment_ids(spec: ConeSpec) -> tuple[np.ndarray, int]:
    """Per-row segment ids for cone-boundary aggregation: rows of the first
    boundary block (z + l + box) are one segment each, every later cone is
    one segment."""
    b = cone_boundaries(spec)
    ids = list(range(b[0]))
    seg = b[0]
    for blen in b[1:]:
        ids.extend([seg] * blen)
        seg += 1
    return np.asarray(ids, dtype=np.int64), seg


def _apply_limit(x: torch.Tensor) -> torch.Tensor:
    x = torch.where(x < config.MIN_NORMALIZATION_FACTOR,
                    torch.ones_like(x), x)
    return torch.clamp_max(x, config.MAX_NORMALIZATION_FACTOR)


def _segment_reduce(vals, ids, nseg, reduce: str):
    out = torch.zeros(nseg, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(0, ids, vals, reduce, include_self=False)


def equilibrate(A: torch.Tensor, P, spec: ConeSpec):
    """Rescale A -> DAE, P -> EPE in the Ruiz/L2 sense. Returns (A, P, Scaling).

    Each pass makes new tensors; the caller's A and P are left as they were.
    """
    ids_np, nseg = _segment_ids(spec)
    ids = torch.as_tensor(ids_np, device=A.device)
    D = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
    E = torch.ones(A.shape[1], dtype=A.dtype, device=A.device)

    for _ in range(config.NUM_RUIZ_PASSES):
        # D: inf-norm of rows of A, aggregated (inf-norm) within each cone
        Dt = torch.amax(torch.abs(A), dim=1)
        Dt = _segment_reduce(Dt, ids, nseg, "amax")[ids]
        Dt = 1.0 / torch.sqrt(_apply_limit(Dt))
        # E: inf-norm of cols of [P; A]
        Et = torch.amax(torch.abs(A), dim=0)
        if P is not None:
            Et = torch.maximum(Et, torch.amax(torch.abs(P), dim=0))
        Et = 1.0 / torch.sqrt(_apply_limit(Et))
        A = Dt[:, None] * A * Et[None, :]
        if P is not None:
            P = Et[:, None] * P * Et[None, :]
        D = D * Dt
        E = E * Et

    for _ in range(config.NUM_L2_PASSES):
        Dt = torch.sqrt(torch.sum(A * A, dim=1))
        seg_sum = _segment_reduce(Dt, ids, nseg, "sum")
        seg_cnt = _segment_reduce(torch.ones_like(Dt), ids, nseg, "sum")
        Dt = (seg_sum / torch.clamp_min(seg_cnt, 1.0))[ids]  # cone-wise mean
        Dt = 1.0 / torch.sqrt(_apply_limit(Dt))
        Et = torch.sum(A * A, dim=0)
        if P is not None:
            Et = Et + torch.sum(P * P, dim=0)
        Et = 1.0 / torch.sqrt(_apply_limit(torch.sqrt(Et)))
        A = Dt[:, None] * A * Et[None, :]
        if P is not None:
            P = Et[:, None] * P * Et[None, :]
        D = D * Dt
        E = E * Et

    one = torch.ones((), dtype=A.dtype, device=A.device)
    return A, P, Scaling(D=D, E=E, primal_scale=one, dual_scale=one)


def normalize_b_c(scal: Scaling, b: torch.Tensor, c: torch.Tensor):
    """Scale b/c by D/E then by sigma; returns (b, c, new Scaling)
    (src/normalize.c:33-61)."""
    c = c * scal.E
    b = b * scal.D
    sigma = torch.maximum(torch.amax(torch.abs(c)), torch.amax(torch.abs(b)))
    one = torch.ones_like(sigma)
    sigma = torch.where(sigma < config.MIN_NORMALIZATION_FACTOR, one, sigma)
    sigma = torch.clamp_max(sigma, config.MAX_NORMALIZATION_FACTOR)
    sigma = torch.where(sigma < config.DIV_EPS_TOL,
                        one / config.DIV_EPS_TOL, 1.0 / sigma)
    return b * sigma, c * sigma, Scaling(
        D=scal.D, E=scal.E, primal_scale=sigma, dual_scale=sigma)


def normalize_xys(scal: Scaling, x, y, s):
    """Map an original-space (x, y, s) into the normalized space (warm starts)."""
    x = x / (scal.E / scal.dual_scale)
    y = y / (scal.D / scal.primal_scale)
    s = s * (scal.D * scal.dual_scale)
    return x, y, s


def unnormalize_xys(scal: Scaling, x, y, s):
    """Recover original-space (x, y, s) from normalized iterates."""
    x = x * (scal.E / scal.dual_scale)
    y = y * (scal.D / scal.primal_scale)
    s = s / (scal.D * scal.dual_scale)
    return x, y, s


def identity_scaling(m: int, n: int, dtype, device) -> Scaling:
    one = torch.ones((), dtype=dtype, device=device)
    return Scaling(D=torch.ones(m, dtype=dtype, device=device),
                   E=torch.ones(n, dtype=dtype, device=device),
                   primal_scale=one, dual_scale=one)


# ---- a batch of problems (leading batch axis) ----


def _segment_reduce_batched(vals, ids, nseg, reduce: str):
    out = torch.zeros(vals.shape[0], nseg, dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_reduce(1, ids.expand_as(vals), vals, reduce,
                              include_self=False)


def equilibrate_batched(A: torch.Tensor, P, spec: ConeSpec):
    """`equilibrate` for a (B, m, n) stack (and P (B, n, n) or None):
    the same passes, each problem scaled by its own row and column norms.
    Returns (A, P, Scaling)."""
    ids_np, nseg = _segment_ids(spec)
    ids = torch.as_tensor(ids_np, device=A.device)
    B, m, n = A.shape
    D = torch.ones(B, m, dtype=A.dtype, device=A.device)
    E = torch.ones(B, n, dtype=A.dtype, device=A.device)

    for _ in range(config.NUM_RUIZ_PASSES):
        Dt = torch.amax(torch.abs(A), dim=2)
        Dt = _segment_reduce_batched(Dt, ids, nseg, "amax")[:, ids]
        Dt = 1.0 / torch.sqrt(_apply_limit(Dt))
        Et = torch.amax(torch.abs(A), dim=1)
        if P is not None:
            Et = torch.maximum(Et, torch.amax(torch.abs(P), dim=1))
        Et = 1.0 / torch.sqrt(_apply_limit(Et))
        A = Dt[:, :, None] * A * Et[:, None, :]
        if P is not None:
            P = Et[:, :, None] * P * Et[:, None, :]
        D = D * Dt
        E = E * Et

    for _ in range(config.NUM_L2_PASSES):
        Dt = torch.sqrt(torch.sum(A * A, dim=2))
        seg_sum = _segment_reduce_batched(Dt, ids, nseg, "sum")
        seg_cnt = _segment_reduce_batched(torch.ones_like(Dt), ids, nseg,
                                          "sum")
        Dt = (seg_sum / torch.clamp_min(seg_cnt, 1.0))[:, ids]
        Dt = 1.0 / torch.sqrt(_apply_limit(Dt))
        Et = torch.sum(A * A, dim=1)
        if P is not None:
            Et = Et + torch.sum(P * P, dim=1)
        Et = 1.0 / torch.sqrt(_apply_limit(torch.sqrt(Et)))
        A = Dt[:, :, None] * A * Et[:, None, :]
        if P is not None:
            P = Et[:, :, None] * P * Et[:, None, :]
        D = D * Dt
        E = E * Et

    one = torch.ones(B, dtype=A.dtype, device=A.device)
    return A, P, Scaling(D=D, E=E, primal_scale=one, dual_scale=one)


def normalize_b_c_batched(scal: Scaling, b: torch.Tensor, c: torch.Tensor):
    """`normalize_b_c` for b (B, m), c (B, n): one sigma per problem."""
    c = c * scal.E
    b = b * scal.D
    sigma = torch.maximum(torch.amax(torch.abs(c), dim=1),
                          torch.amax(torch.abs(b), dim=1))
    one = torch.ones_like(sigma)
    sigma = torch.where(sigma < config.MIN_NORMALIZATION_FACTOR, one, sigma)
    sigma = torch.clamp_max(sigma, config.MAX_NORMALIZATION_FACTOR)
    sigma = torch.where(sigma < config.DIV_EPS_TOL,
                        one / config.DIV_EPS_TOL, 1.0 / sigma)
    return b * sigma[:, None], c * sigma[:, None], Scaling(
        D=scal.D, E=scal.E, primal_scale=sigma, dual_scale=sigma)


def normalize_xys_batched(scal: Scaling, x, y, s):
    """`normalize_xys` for rows of x (B, n), y and s (B, m)."""
    ps, ds = scal.primal_scale[:, None], scal.dual_scale[:, None]
    return x / (scal.E / ds), y / (scal.D / ps), s * (scal.D * ds)


def unnormalize_xys_batched(scal: Scaling, x, y, s):
    """`unnormalize_xys` for rows of x (B, n), y and s (B, m)."""
    ps, ds = scal.primal_scale[:, None], scal.dual_scale[:, None]
    return x * (scal.E / ds), y * (scal.D / ps), s / (scal.D * ds)


def identity_scaling_batched(B: int, m: int, n: int, dtype,
                             device) -> Scaling:
    one = torch.ones(B, dtype=dtype, device=device)
    return Scaling(D=torch.ones(B, m, dtype=dtype, device=device),
                   E=torch.ones(B, n, dtype=dtype, device=device),
                   primal_scale=one, dual_scale=one)
