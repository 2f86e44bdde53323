"""Ruiz + L2 equilibration of (A, P) and b/c normalization.

Counterpart of `scs_tpu/equilibrate.py` (SCS: linsys/scs_matrix.c:226-496,
25 Ruiz passes + 1 L2 pass respecting cone boundaries, and
src/normalize.c:33-90). Row and column norms are reductions over the
dense A and P; the per-cone aggregation is a scatter-reduce (amax, exact
in any order) over a segment-id map derived from the cone layout, and,
for the sums of the L2 pass, segment sums in a fixed order
(`cones.segments.segment_sum`), so that D repeats bit for bit from run to
run on the card.

A and P may each be a sparse operand (`ops.sparse.SparseA`): its row and
column norms and its scaling use the structure-aware operations, never
the dense matrix (scs_tpu/equilibrate.py:61-140), and each pass makes a
new operand. In `equilibrate_batched` A may be row-sharded
(`ops.rowshard.RowShardedA`): its row statistics are gathered over the
model group and its column statistics reduced (max, or a sum), so that
the segment aggregation over cone blocks and D and E run on whole
vectors on every rank, and each rank scales its own rows.

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
from .cones.segments import segment_sum
from .ops.rowshard import is_row_sharded
from .ops.sparse import is_sparse
from .types import ConeSpec


@dataclasses.dataclass(frozen=True)
class Scaling:
    """Equilibration state (SCS's ScsScaling). The sigmas are 0-d tensors."""

    D: torch.Tensor              # (m,) row scaling
    E: torch.Tensor              # (n,) col scaling
    primal_scale: torch.Tensor   # sigma
    dual_scale: torch.Tensor     # sigma


def _segment_sizes(spec: ConeSpec) -> tuple[int, ...]:
    """Row counts of the cone-boundary segments: rows of the first
    boundary block (z + l + box) are one segment each, every later cone is
    one segment."""
    b = cone_boundaries(spec)
    return (1,) * b[0] + tuple(b[1:])


def _segment_ids(spec: ConeSpec) -> tuple[np.ndarray, int]:
    """Per-row segment ids of `_segment_sizes`, and the segment count."""
    sizes = _segment_sizes(spec)
    ids = np.repeat(np.arange(len(sizes)), sizes)
    return ids.astype(np.int64), len(sizes)


def _segment_mean(vals, spec: ConeSpec, ids):
    """Per-row mean of vals (..., m) over the row's segment (ids: the
    rows' segment ids on vals' device)."""
    sizes = _segment_sizes(spec)
    cnt = torch.as_tensor(np.maximum(np.asarray(sizes, np.float64), 1.0),
                          dtype=vals.dtype, device=vals.device)
    return (segment_sum(vals, sizes) / cnt)[..., ids]


def _apply_limit(x: torch.Tensor) -> torch.Tensor:
    x = torch.where(x < config.MIN_NORMALIZATION_FACTOR,
                    torch.ones_like(x), x)
    return torch.clamp_max(x, config.MAX_NORMALIZATION_FACTOR)


def _segment_amax(vals, ids, nseg):
    out = torch.zeros(nseg, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(0, ids, vals, "amax", include_self=False)


# dense operands reduce over the full tensor, a SparseA over its stored
# parts


def _row_abs_max(M):
    return M.row_abs_max() if is_sparse(M) else torch.amax(torch.abs(M), 1)


def _col_abs_max(M):
    return M.col_abs_max() if is_sparse(M) else torch.amax(torch.abs(M), 0)


def _row_sumsq(M):
    return M.row_sumsq() if is_sparse(M) else torch.sum(M * M, dim=1)


def _col_sumsq(M):
    return M.col_sumsq() if is_sparse(M) else torch.sum(M * M, dim=0)


def _scale(M, D, E):
    return M.scale(D, E) if is_sparse(M) else D[:, None] * M * E[None, :]


def equilibrate(A, P, spec: ConeSpec):
    """Rescale A -> DAE, P -> EPE in the Ruiz/L2 sense. Returns (A, P, Scaling).

    Each pass makes new tensors; the caller's A and P are left as they were.
    """
    ids_np, nseg = _segment_ids(spec)
    ids = torch.as_tensor(ids_np, device=A.device)
    D = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
    E = torch.ones(A.shape[1], dtype=A.dtype, device=A.device)

    for _ in range(config.NUM_RUIZ_PASSES):
        # D: inf-norm of rows of A, aggregated (inf-norm) within each cone
        Dt = _row_abs_max(A)
        Dt = _segment_amax(Dt, ids, nseg)[ids]
        Dt = 1.0 / torch.sqrt(_apply_limit(Dt))
        # E: inf-norm of cols of [P; A]
        Et = _col_abs_max(A)
        if P is not None:
            Et = torch.maximum(Et, _col_abs_max(P))
        Et = 1.0 / torch.sqrt(_apply_limit(Et))
        A = _scale(A, Dt, Et)
        if P is not None:
            P = _scale(P, Et, Et)
        D = D * Dt
        E = E * Et

    for _ in range(config.NUM_L2_PASSES):
        Dt = torch.sqrt(_row_sumsq(A))
        Dt = _segment_mean(Dt, spec, ids)       # cone-wise mean
        Dt = 1.0 / torch.sqrt(_apply_limit(Dt))
        Et = _col_sumsq(A)
        if P is not None:
            Et = Et + _col_sumsq(P)
        Et = 1.0 / torch.sqrt(_apply_limit(torch.sqrt(Et)))
        A = _scale(A, Dt, Et)
        if P is not None:
            P = _scale(P, Et, Et)
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


def _segment_amax_batched(vals, ids, nseg):
    out = torch.zeros(vals.shape[0], nseg, dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_reduce(1, ids.expand_as(vals), vals, "amax",
                              include_self=False)


def equilibrate_batched(A: torch.Tensor, P, spec: ConeSpec):
    """`equilibrate` for a (B, m, n) stack (and P (B, n, n) or None), or
    a batched RowShardedA: the same passes, each problem scaled by its own
    row and column norms. Returns (A, P, Scaling)."""
    ids_np, nseg = _segment_ids(spec)
    ids = torch.as_tensor(ids_np, device=A.device)
    B, m, n = A.shape
    D = torch.ones(B, m, dtype=A.dtype, device=A.device)
    E = torch.ones(B, n, dtype=A.dtype, device=A.device)
    sharded = is_row_sharded(A)

    def scale_a(A, Dt, Et):
        if sharded:
            return A.scale(Dt, Et)
        return Dt[:, :, None] * A * Et[:, None, :]

    for _ in range(config.NUM_RUIZ_PASSES):
        Dt = A.row_abs_max() if sharded else torch.amax(torch.abs(A), dim=2)
        Dt = _segment_amax_batched(Dt, ids, nseg)[:, ids]
        Dt = 1.0 / torch.sqrt(_apply_limit(Dt))
        Et = A.col_abs_max() if sharded else torch.amax(torch.abs(A), dim=1)
        if P is not None:
            Et = torch.maximum(Et, torch.amax(torch.abs(P), dim=1))
        Et = 1.0 / torch.sqrt(_apply_limit(Et))
        A = scale_a(A, Dt, Et)
        if P is not None:
            P = Et[:, :, None] * P * Et[:, None, :]
        D = D * Dt
        E = E * Et

    for _ in range(config.NUM_L2_PASSES):
        Dt = torch.sqrt(A.row_sumsq() if sharded
                        else torch.sum(A * A, dim=2))
        Dt = _segment_mean(Dt, spec, ids)
        Dt = 1.0 / torch.sqrt(_apply_limit(Dt))
        Et = A.col_sumsq() if sharded else torch.sum(A * A, dim=1)
        if P is not None:
            Et = Et + torch.sum(P * P, dim=1)
        Et = 1.0 / torch.sqrt(_apply_limit(torch.sqrt(Et)))
        A = scale_a(A, Dt, Et)
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
