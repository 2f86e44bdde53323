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

A sparse A (`ops.sparse.SparseA`, one problem) forms K from its tiles
(`ops.sparse.sparse_gram`, a fixed-order sum; the n x n factor is dense
whatever A's storage); a sparse P is densified once for G; the mixed
path's A x and A' z run K2s on the tiles and K1 on the dense tails
(`ops.sparse.ds_sparse_matvec`), K x K1 on K's split.

A row-sharded A (`ops.rowshard.RowShardedA`, a batch: the batched
solvers take one problem as a batch of one) forms K as the sum over the
model group of each rank's A_r'A_r + 999 A_{z,r}'A_{z,r} (a rank's
zero-cone rows are those whose global index is below z), so that K, its
split and the factor are whole on every rank; A_r and A_r' are split
locally, and A x and A' z go through `matvec` (the local product, then
the group's collective).

The `*_batched` functions do the same for a stack of B problems of one
shape, with a leading batch axis on every operand (the JAX package's
vmapped precompute/derive/solve): batched products, batched Cholesky
factors, and the batched double-single kernel (K2). They are separate from
the one-problem functions so that the one-problem path keeps its own
rounding.

The float32-state regime (the batched solvers' `fast_f32` phase, whose
view of the problem holds A, K and the state in float32 and the splits as
they are): the factor carries a third member, the double-single split of
G itself, and the refinement residual r = b - G x is read from it as a
float32 pair (kernel K3), so that it cancels at ulp(r), not ulp(G x). The
derived factor has one structure per regime, (Ginv32, scale) with float64
state and (Ginv32, scale, ds_G) with float32 state; `enter_f32_state` and
`leave_f32_state` convert between them at the phase's ends (the JAX
package mixes the two inside one loop, ROADMAP queue 3, R1).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import dsmatvec, rowshard, sparse
from ..ops.dsmatvec import DsSplit
from .matvec import bmv, ds_mv, mT, mv

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
    P_dense: Optional[torch.Tensor] = None   # a sparse P, densified


def precompute(A, P, n_zero: int, ds: bool = False) -> DirectCache:
    """K = A'A + 999 A_z'A_z, plus the double-single splits of A, A' and K
    when `ds` is set (the mixed path on the card; a test may set it on the
    CPU to drive the solver through the kernel's plain version). A
    SparseA's K is A' W A from its tiles, W = 1000 on the zero-cone rows
    (scs_tpu/linsys/direct.py:64-92); a sparse P is densified here."""
    sparse.require_operand(A)
    P_dense = P.todense() if sparse.is_sparse(P) else None
    if sparse.is_sparse(A):
        w = None
        if n_zero:
            rows = torch.arange(A.shape[0], device=A.device)
            w = torch.where(rows < n_zero, 1000.0, 1.0).to(A.dtype)
        K = sparse.sparse_gram(A, w)
        if not ds:
            return DirectCache(K, None, None, None, P_dense)
        return DirectCache(K, sparse.ds_split_sparse(A),
                           sparse.ds_split_sparse(A.T),
                           dsmatvec.split_operand(K), P_dense)
    K = A.T @ A
    if n_zero:
        Az = A[:n_zero]
        K = K + 999.0 * (Az.T @ Az)
    if not ds:
        return DirectCache(K, None, None, None)
    return DirectCache(K, dsmatvec.split_operand(A),
                       dsmatvec.split_operand(A.T),
                       dsmatvec.split_operand(K))


def _precompute_row_sharded(A, n_zero: int, ds: bool) -> DirectCache:
    """The cache of a batched RowShardedA: K summed over the model group,
    the local splits of A_r and A_r' (their products gather or sum over
    the group), K's split whole."""
    K = A.gram(n_zero)
    if not ds:
        return DirectCache(K, None, None, None)
    fwd, bwd = A.split()
    return DirectCache(K, fwd, bwd, dsmatvec.split_operand(K))


def _gram(mats, diag_r, scale):
    n = mats.A.shape[1]
    G = scale * mats.cache.K + torch.diag(diag_r[:n])
    P = mats.P if mats.cache.P_dense is None else mats.cache.P_dense
    if P is not None:
        G = G + P
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
        return ds_mv(mats.cache.ds_fwd, x)
    return mv(mats.A, x)


def _At_matvec(mats, z):
    if mats.cache.ds_bwd is not None:
        return ds_mv(mats.cache.ds_bwd, z)
    return mv(mT(mats.A), z)


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
        b = rx + mv(mT(mats.A), ry / r_y)
        x = torch.cholesky_solve(b[:, None], derived)[:, 0]
        its = 0
        y = (mv(mats.A, x) - ry) / r_y
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


# ---- a batch of problems: every operand has a leading batch axis ----


def precompute_batched(A, P, n_zero: int, ds: bool = False) -> DirectCache:
    """`precompute` for a (B, m, n) stack: K[b] = A[b]'A[b] + 999
    A_z[b]'A_z[b] by batched products, and the splits of A, A' and K as
    (B, ., .) stacks when `ds` is set."""
    del P
    if rowshard.is_row_sharded(A):
        return _precompute_row_sharded(A, n_zero, ds)
    At = A.transpose(1, 2)
    K = torch.matmul(At, A)
    if n_zero:
        Az = A[:, :n_zero]
        K = K + 999.0 * torch.matmul(Az.transpose(1, 2), Az)
    if not ds:
        return DirectCache(K, None, None, None)
    return DirectCache(K, dsmatvec.split_operand(A),
                       dsmatvec.split_operand(At),
                       dsmatvec.split_operand(K))


def _cholesky_batched(G):
    """Lower Cholesky factors of a (B, n, n) stack; NaN in the lanes whose
    G is not positive definite, so one failed lane leaves the others as
    they are."""
    L, info = torch.linalg.cholesky_ex(G)
    ok = (info == 0).view(-1, 1, 1)
    return torch.where(ok, L, torch.full_like(L, float("nan")))


def derive_batched(mats, diag_r, scale, mixed: bool = False):
    """`derive` for a batch: diag_r (B, l), scale (B,). Returns the float64
    factors (B, n, n) (pure) or (float32 inverses (B, n, n), scale)
    (mixed), and with float32 operands (the float32-state regime) also the
    split of G (see the module docstring)."""
    n = mats.A.shape[2]
    G = scale[:, None, None] * mats.cache.K + torch.diag_embed(diag_r[:, :n])
    if mats.P is not None:
        G = G + mats.P
    if not mixed:
        return _cholesky_batched(G)
    L32 = _cholesky_batched(G.to(torch.float32))
    eye = torch.eye(n, dtype=torch.float32, device=G.device)
    Ginv32 = torch.cholesky_solve(eye.expand_as(L32), L32)
    if mats.A.dtype == torch.float32:
        return (Ginv32, scale, _ds_gram(mats, diag_r, scale))
    return (Ginv32, scale)


def _ds_gram(mats, diag_r, scale) -> DsSplit:
    if mats.cache.ds_K is None:
        raise ValueError("the float32-state regime needs the double-single "
                         "split of K")
    n = mats.A.shape[2]
    return dsmatvec.ds_compose_gram_batched(mats.cache.ds_K, scale,
                                            diag_r[:, :n], mats.P)


def enter_f32_state(mats, diag_r, derived):
    """The mixed factor of the float64-state regime as the float32-state
    regime holds it: `mats`, `diag_r` and `derived` already cast to
    float32, the split of G added."""
    Ginv32, scale = derived
    return (Ginv32, scale, _ds_gram(mats, diag_r, scale))


def leave_f32_state(derived):
    """The float32-state regime's factor in the float64-state regime's
    structure: the split of G dropped, scale back in float64."""
    return (derived[0], derived[1].to(torch.float64))


def _gram_matvec_batched(mats, diag_r, scale, x):
    n = mats.A.shape[2]
    cache = mats.cache
    Kx = (dsmatvec.ds_matvec_batched(cache.ds_K, x)
          if cache.ds_K is not None else bmv(cache.K, x))
    y = scale[:, None] * Kx + diag_r[:, :n] * x
    if mats.P is not None:
        y = y + bmv(mats.P, x)
    return y


def solve_batched(mats, diag_r, derived, rhs, warm_start=None, tol=None,
                  active=None):
    """`solve` for a batch: rhs (B, n + m) -> (sol (B, n + m),
    refine_passes). On the mixed path the float32 inverse-apply is one
    batched float32 product and the refinement's K x, A' z and A x run on
    the batched double-single kernel where the cache holds the splits.
    warm_start, tol and active belong to the iterative backend's protocol
    and are not read."""
    del warm_start, tol, active
    m, n = mats.A.shape[1:]
    r_y = diag_r[:, n:n + m]
    rx = rhs[:, :n]
    ry = rhs[:, n:]
    cache = mats.cache
    if not isinstance(derived, tuple):  # pure path: float64 Cholesky
        b = rx + mv(mT(mats.A), ry / r_y)
        x = torch.cholesky_solve(b.unsqueeze(-1), derived).squeeze(-1)
        its = 0
        y = (mv(mats.A, x) - ry) / r_y
    else:  # mixed: float32 inverse-apply + float64 refinement over K
        Ginv32, scale = derived[:2]
        ds_G = derived[2] if len(derived) > 2 else None
        f32, dtype = torch.float32, rhs.dtype
        z = ry / r_y
        b = rx + (ds_mv(cache.ds_bwd, z) if cache.ds_bwd is not None
                  else mv(mT(mats.A), z))
        x = bmv(Ginv32, b.to(f32)).to(dtype)
        for _ in range(REFINE_PASSES):
            if ds_G is not None:
                # float32 state: (b - hi) is exact, - lo rounds at ulp(r)
                Gh, Gl = dsmatvec.ds_matvec_pair_batched(ds_G, x)
                r = (b - Gh) - Gl
            else:
                r = b - _gram_matvec_batched(mats, diag_r, scale, x)
            x = x + bmv(Ginv32, r.to(f32)).to(dtype)
        its = REFINE_PASSES
        ax = (ds_mv(cache.ds_fwd, x) if cache.ds_fwd is not None
              else mv(mats.A, x))
        y = (ax - ry) / r_y
    return torch.cat([x, y], dim=1), its
