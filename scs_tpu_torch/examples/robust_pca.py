"""Robust PCA via the nuclear-norm spectral cone.

Decompose an observed matrix M = L0 + S0 into low-rank L and sparse S:

    min ||L||_* + lam * ||vec(S)||_1   s.t.  L + S = M

with the nuclear-norm cone (t >= ||L||_*) and the ell1 cone
(u >= ||s||_1): the reference's spectral_cones_problems/robust_pca.h
formulation on synthetic data (the JAX package's examples/robust_pca.py
step for step).

Run:  python -m scs_tpu_torch.examples.robust_pca [--device cpu]
"""

import numpy as np

from ..api import solve
from ..convert import problem_from_numpy
from ..types import ConeSpec, Settings


def main(p: int = 12, q: int = 8, r: int = 2, device="cuda") -> dict:
    lam = 1.0 / np.sqrt(max(p, q))      # classical robust-PCA weight
    rng = np.random.RandomState(3)
    L0 = rng.randn(p, r) @ rng.randn(r, q)
    S0 = np.zeros((p, q))
    mask = rng.rand(p, q) < 0.08
    S0[mask] = 5.0 * rng.randn(int(mask.sum()))
    M = L0 + S0

    pq = p * q
    # variables z = [t, vec(L) (pq), u, vec(S) (pq)]
    n = 1 + pq + 1 + pq
    it, iL, iu, iS = 0, 1, 1 + pq, 2 + pq

    # zero cone: L + S = M  (pq rows)
    A_eq = np.zeros((pq, n))
    A_eq[:, iL:iL + pq] = np.eye(pq)
    A_eq[:, iS:iS + pq] = np.eye(pq)
    b_eq = M.reshape(-1, order="F")   # cone convention: column-major vec

    # nuclear cone slot layout: (t, vec(L)) with L stored p x q, p >= q
    A_nuc = np.zeros((1 + pq, n))
    A_nuc[0, it] = -1.0
    A_nuc[1:, iL:iL + pq] = -np.eye(pq)

    # ell1 cone slot layout: (u, vec(S))
    A_l1 = np.zeros((1 + pq, n))
    A_l1[0, iu] = -1.0
    A_l1[1:, iS:iS + pq] = -np.eye(pq)

    A = np.concatenate([A_eq, A_nuc, A_l1])
    b = np.concatenate([b_eq, np.zeros(1 + pq), np.zeros(1 + pq)])
    c = np.zeros(n)
    c[it] = 1.0
    c[iu] = lam

    spec = ConeSpec(z=pq, nuc_m=(p,), nuc_n=(q,), ell1=(pq,))
    stg = Settings(eps_abs=1e-5, eps_rel=1e-5)
    sol, info = solve(problem_from_numpy(A, b, c), spec, settings=stg,
                      device=device)
    assert "solved" in info.status, info.status

    x = np.asarray(sol.x)
    L = x[iL:iL + pq].reshape(p, q, order="F")
    S = x[iS:iS + pq].reshape(p, q, order="F")
    sv = np.linalg.svd(L, compute_uv=False)
    rank = int((sv > 1e-2 * sv[0]).sum())
    agree = int(((np.abs(S) > 1e-2) == mask).sum())
    resid = float(np.abs(L + S - M).max())
    print(f"status: {info.status} in {info.iter} iters, obj {info.pobj:.4f}")
    print(f"recovered rank(L) ~ {rank} (true {r}); "
          f"singular values: {sv.round(3)}")
    print(f"sparse support recovered: {agree}/{pq} entries agree")
    print(f"||L + S - M||_inf = {resid:.2e}")
    assert resid < 1e-3, resid
    return {"iters": info.iter, "pobj": info.pobj, "rank": rank,
            "support_agree": agree, "resid": resid}


if __name__ == "__main__":
    from ._cli import parse
    a = parse(__doc__)
    main(device=a.device)
