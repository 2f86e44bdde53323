"""Direct KKT solver via dense Schur-complement Cholesky.

Counterpart of `scs_tpu/linsys/direct.py` (SCS's dense backend,
linsys/cpu/dense/private.c:64-220):

    G = R_x + P + A' R_y^{-1} A = R_x + P + scale * K   (n x n, SPD)

with K = A'A + 999 A_z'A_z formed once, factored on every diag-R update
and applied every iteration.

Mixed precision: `derive(mixed=True)` returns the explicit float32 inverse
of G (from the float32 Cholesky factor), so a solve is one float32
matrix-vector product plus REFINE_PASSES float64 refinement passes. The
refinement's K x and the surrounding A' z and A x run on the double-single
kernel (`ops.dsmatvec`, K1) when the cache holds the operand splits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import dsmatvec
from ..ops.dsmatvec import DsSplit

METHOD_NAME = "dense-direct-schur-cholesky"

# Two correction passes reach float64 round-off for a moderately
# conditioned G (each gains ~7 decades over the float32 inverse).
REFINE_PASSES = 2


class DirectCache(NamedTuple):
    """Loop-invariant operand cache."""

    K: torch.Tensor               # scale-free Gram, float64
    ds_fwd: Optional[DsSplit]     # (hi, lo) split of A
    ds_bwd: Optional[DsSplit]     # (hi, lo) split of A'
    ds_K: Optional[DsSplit]       # (hi, lo) split of K


def precompute(A, P, n_zero: int, ds: bool = False) -> DirectCache:
    """K = A'A + 999 A_z'A_z, plus the double-single splits of A, A' and K
    when `ds` is set (the mixed path on the card; a test may set it on the
    CPU to drive the solver through the kernel's plain version)."""
    del P
    K = A.T @ A
    if n_zero:
        Az = A[:n_zero]
        K = K + 999.0 * (Az.T @ Az)
    if not ds:
        return DirectCache(K, None, None, None)
    return DirectCache(K, dsmatvec.split_operand(A),
                       dsmatvec.split_operand(A.T),
                       dsmatvec.split_operand(K))


def _gram(mats, diag_r, scale):
    n = mats.A.shape[1]
    G = scale * mats.cache.K + torch.diag(diag_r[:n])
    if mats.P is not None:
        G = G + mats.P
    return G


def _gram_matvec(mats, diag_r, scale, x):
    """G x via the invariant K."""
    n = mats.A.shape[1]
    cache = mats.cache
    Kx = (dsmatvec.ds_matvec(cache.ds_K, x) if cache.ds_K is not None
          else cache.K @ x)
    y = scale * Kx + diag_r[:n] * x
    if mats.P is not None:
        y = y + mats.P @ x
    return y


def _A_matvec(mats, x):
    if mats.cache.ds_fwd is not None:
        return dsmatvec.ds_matvec(mats.cache.ds_fwd, x)
    return mats.A @ x


def _At_matvec(mats, z):
    if mats.cache.ds_bwd is not None:
        return dsmatvec.ds_matvec(mats.cache.ds_bwd, z)
    return mats.A.T @ z


def _cholesky(G):
    """Lower Cholesky factor; NaN where G is not positive definite (as the
    JAX package's factor is), so that a failure surfaces without a sync."""
    L, info = torch.linalg.cholesky_ex(G)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def derive(mats, diag_r, scale, mixed: bool = False):
    """Factor the Schur complement: the float64 Cholesky factor (pure) or
    (float32 inverse, scale) (mixed)."""
    G = _gram(mats, diag_r, scale)
    if not mixed:
        return _cholesky(G)
    L32 = _cholesky(G.to(torch.float32))
    eye = torch.eye(G.shape[0], dtype=torch.float32, device=G.device)
    return (torch.cholesky_solve(eye, L32), scale)


def solve(mats, diag_r, derived, rhs, warm_start=None, tol=None):
    """Solve the full (n+m) KKT system; returns (sol, refine_passes).

    warm_start and tol belong to the iterative backend's protocol; a direct
    solve does not read them."""
    del warm_start, tol
    m, n = mats.A.shape
    r_y = diag_r[n:n + m]
    rx = rhs[:n]
    ry = rhs[n:]

    if not isinstance(derived, tuple):  # pure path: float64 Cholesky
        b = rx + mats.A.T @ (ry / r_y)
        x = torch.cholesky_solve(b[:, None], derived)[:, 0]
        its = 0
        y = ((mats.A @ x) - ry) / r_y
    else:  # mixed: float32 inverse-apply + float64 refinement over K
        Ginv32, scale = derived
        f32, dtype = torch.float32, rhs.dtype
        b = rx + _At_matvec(mats, ry / r_y)
        x = (Ginv32 @ b.to(f32)).to(dtype)
        for _ in range(REFINE_PASSES):
            r = b - _gram_matvec(mats, diag_r, scale, x)
            x = x + (Ginv32 @ r.to(f32)).to(dtype)
        its = REFINE_PASSES
        y = (_A_matvec(mats, x) - ry) / r_y
    return torch.cat([x, y]), its
