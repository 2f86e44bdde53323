"""Refined symmetric eigendecomposition: float32 eigh, then
Ogita-Aishima correction sweeps with float64-grade products.

Counterpart of `scs_tpu/ops/eigh_ds.py` (Ogita & Aishima, SIAM J. Matrix
Anal. 2018). The JAX package refines its TPU's approximate float32 eigh
this way because the TPU's float64 eigh is emulated and no more accurate.
Per sweep, with the products from `ozaki.ozaki_matmul`:

    R = I - X'X,  S = X'AX
    lam_i = S_ii / (1 - R_ii)
    E_ij  = (S_ij + lam_j R_ij) / (lam_j - lam_i)   (separated pairs)
    E_ij  = R_ij / 2                                 (clustered pairs)
    X <- X + X E

which converges quadratically for separated eigenvalues; clustered
directions get only the orthogonality correction. After the sweeps a
quality gate (max |X'X - I| below 1e-8) decides on one extra sweep: the
JAX package's scalar cond, here one host read.

`supported()` is `ozaki.supported()`: False on the CPU and on the H100,
whose float64 eigh is native, so no solver path calls this module.
"""

from __future__ import annotations

import torch

from . import ozaki

_mm = ozaki.ozaki_matmul

# relative eigenvalue-gap thresholds per sweep (the JAX package's)
_SEP_TOLS = (1e-3, 1e-7, 1e-7)
_QA_TOL = 1e-8


def _sweep(A: torch.Tensor, X: torch.Tensor, sep_tol: float):
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    R = eye - _mm(X.transpose(-1, -2), X)
    S = _mm(X.transpose(-1, -2), _mm(A, X))
    rdiag = torch.diagonal(R, dim1=-2, dim2=-1)
    lam = torch.diagonal(S, dim1=-2, dim2=-1) / (1.0 - rdiag)
    nrm = lam.abs().amax(-1, keepdim=True).unsqueeze(-1)
    delta = lam.unsqueeze(-2) - lam.unsqueeze(-1)          # lam_j - lam_i
    sep = delta.abs() > sep_tol * torch.clamp_min(nrm, 1e-300)
    E_sep = (S + lam.unsqueeze(-2) * R) / torch.where(sep, delta, 1.0)
    E = torch.where(sep, E_sep, R / 2.0)
    return lam, X + _mm(X, E), R


def eigh_refined(A: torch.Tensor, sweeps: int = 2):
    """Batched (..., n, n) symmetric eigh with refined accuracy: (w, V) in
    A's dtype (float64), w ascending as `torch.linalg.eigh` gives it."""
    w32, V32 = torch.linalg.eigh(A.to(torch.float32))
    X = V32.to(A.dtype)
    lam = w32.to(A.dtype)
    for tol in _SEP_TOLS[:sweeps]:
        lam, X, _ = _sweep(A, X, tol)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    orth = (_mm(X.transpose(-1, -2), X) - eye).abs().max()
    if not bool(orth < _QA_TOL):
        lam, X, _ = _sweep(A, X, _SEP_TOLS[-1])
    order = torch.argsort(lam, dim=-1)
    w_s = torch.gather(lam, -1, order)
    V_s = torch.gather(X, -1, order.unsqueeze(-2).expand(X.shape))
    return w_s, V_s


def supported() -> bool:
    return ozaki.supported()
