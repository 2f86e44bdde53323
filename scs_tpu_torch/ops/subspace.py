"""Warm-started subspace PSD projection (`Settings.psd_rank`).

Counterpart of `scs_tpu/ops/subspace.py` (`psd_project_warm`). Where the
solution of an SDP has low rank r, the positive eigenspace of the PSD
projection's input moves little from one ADMM iteration to the next, so it
can be tracked instead of recomputed by a full eigendecomposition:

  1. a range-finder on the previous iteration's projection (exactly of
     rank <= k, already in the loop state) gives a k-dimensional basis V0;
  2. the Krylov enrichment span{V0, M V0} holds the first-order
     correction of the tracked eigenspace under the iterate's drift;
  3. Rayleigh-Ritz on that 2k-dimensional space gives the positive part
     U+ diag(th+) U+' in O(n^2 k) products instead of an O(n^3) eigh.

The answer is gated by a certificate, and the caller falls back to the
exact eigh wherever it fails (`cones/psd._tracked_or_exact`):

  (a) every positive Ritz pair's residual ||M u - th u|| <= tol;
  (b) lambda_max of the deflated operator M - U+ Th+ U+' <= tol, estimated
      by 16 Lanczos steps from two starts (a fixed Gaussian probe and the
      Ritz residual of largest norm). Lanczos Ritz values are tight lower
      bounds of lambda_max, not upper bounds: the check is sharp in
      practice, not a proof, as in the JAX package;
  (c) headroom: fewer than k positive Ritz values.

Every function takes any leading axes (blocks, lanes): M (..., n, n). The
probe is the JAX package's, numpy's RandomState(7), made once per (n, k,
dtype, device) and copied to the device once, so that both packages'
gates decide alike. QR and eigh may choose other signs than LAPACK's; the
projection and the certificate depend only on the spans.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

LANCZOS_STEPS = 16


@functools.lru_cache(maxsize=32)
def _probe_const(n: int, k: int, dtype: torch.dtype, device: torch.device):
    """(omega (n, k), probe (n,)): the JAX package's deterministic Gaussian
    probe, on `device`."""
    rng = np.random.RandomState(7)
    omega, probe = rng.randn(n, k), rng.randn(n)
    return (torch.as_tensor(omega, dtype=dtype, device=device),
            torch.as_tensor(probe, dtype=dtype, device=device))


def _lanczos_lmax(dapply, q0: torch.Tensor) -> torch.Tensor:
    """Largest Ritz value of LANCZOS_STEPS Lanczos steps of the symmetric
    operator `dapply` from each start column of q0 (..., n, s): (..., s)."""
    q = q0 / torch.linalg.vector_norm(q0, dim=-2, keepdim=True)
    q_prev = torch.zeros_like(q)
    beta = torch.zeros(q.shape[:-2] + q.shape[-1:], dtype=q.dtype,
                       device=q.device)
    alphas, betas = [], []
    for _ in range(LANCZOS_STEPS):
        w = dapply(q) - beta.unsqueeze(-2) * q_prev
        alpha = (q * w).sum(-2)
        w = w - alpha.unsqueeze(-2) * q
        beta_n = torch.linalg.vector_norm(w, dim=-2)
        q_prev, q = q, w / torch.where(beta_n > 0, beta_n,
                                       1.0).unsqueeze(-2)
        beta = beta_n
        alphas.append(alpha)
        betas.append(beta_n)
    a = torch.stack(alphas, -1)                      # (..., s, steps)
    b = torch.stack(betas[:-1], -1)
    T = torch.diag_embed(a) + torch.diag_embed(b, 1) + torch.diag_embed(b, -1)
    return torch.linalg.eigvalsh(T).amax(-1)


def psd_project_warm(M: torch.Tensor, P_prev: torch.Tensor, rank: int,
                     tol):
    """Approximate PSD projection of the symmetric M (..., n, n) from a
    warm range.

    P_prev (..., n, n): the previous iteration's projection (only its
    range is used). rank: the tracked dimension k (at most n). tol: the
    gate's absolute tolerance, a float or a tensor of M's leading shape.
    Returns (proj (..., n, n), ok (...,) bool): proj = U+ diag(th+) U+',
    ok the certificate of the module docstring."""
    n = M.shape[-1]
    k = min(rank, n)
    omega, probe = _probe_const(n, k, M.dtype, M.device)

    # randomized range finder on the (exactly low-rank) previous
    # projection, plus a touch of the probe so that a zero P_prev still
    # gives an orthonormal basis
    V0, _ = torch.linalg.qr(P_prev @ omega + 1e-30 * omega)
    V, _ = torch.linalg.qr(torch.cat([V0, M @ V0], dim=-1))

    # Rayleigh-Ritz
    C = V.transpose(-1, -2) @ (M @ V)
    C = 0.5 * (C + C.transpose(-1, -2))
    th, W = torch.linalg.eigh(C)                     # ascending
    U = V @ W                                        # (..., n, 2k)
    pos = th > 0.0

    # (a) residuals of the positive Ritz pairs
    R = M @ U - U * th.unsqueeze(-2)
    res = torch.linalg.vector_norm(R, dim=-2)
    tol = torch.as_tensor(tol, dtype=M.dtype, device=M.device)
    res_ok = (torch.where(pos, res, 0.0) <= tol.unsqueeze(-1)).all(-1)

    th_pos = torch.where(pos, th, 0.0)
    proj = (U * th_pos.unsqueeze(-2)) @ U.transpose(-1, -2)
    proj = 0.5 * (proj + proj.transpose(-1, -2))

    # (b) nothing positive missed: lambda_max of the deflated operator, by
    # Lanczos (power iteration would find the most negative end of this
    # indefinite operator) from the probe and from the leading Ritz
    # residual, the direction where the tracked subspace is most wrong
    Ut = U.transpose(-1, -2)

    def dapply(X):
        return M @ X - U @ (th_pos.unsqueeze(-1) * (Ut @ X))

    lead = torch.argmax(res, dim=-1, keepdim=True)    # first of the ties
    r_lead = torch.take_along_dim(
        R, lead.unsqueeze(-2).expand(R.shape[:-1] + (1,)), dim=-1)
    starts = torch.cat([probe.expand(R.shape[:-1]).unsqueeze(-1),
                        r_lead + 1e-30 * probe.unsqueeze(-1)], dim=-1)
    lam = _lanczos_lmax(dapply, starts).amax(-1)
    defl_ok = lam <= tol

    # (c) headroom: the positive count fits strictly inside the tracked k
    head_ok = pos.sum(-1) < k
    return proj, res_ok & defl_ok & head_ok
