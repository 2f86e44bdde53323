"""Block-banded sparse SOCP at O(nnz) storage (counterpart of
`scs_tpu/demo_sparse.py`, the JAX package's BASELINE config 5 shape).

    python -m scs_tpu_torch.demo_sparse                 # full size, card
    python -m scs_tpu_torch.demo_sparse --small         # CI size
    python -m scs_tpu_torch.demo_sparse --small --device cpu

A multi-stage (MPC-style) SOCP of K stages, the rows of stage i coupling
the variable blocks of stages i-1 and i:

    rows(stage i) = [ 0 ... C_{i,i-1}  C_{i,i} ... 0 ]

each stage with mb_l nonnegative rows, two SOC cones of `soc` rows and nb
variables. At the default size (K = 500, 72, 64, 128) A is 100000 x 64000
with 25.57M nonzeros: 51 GB dense, ~0.6 GB as blocked-ELL tiles in both
directions (`ops.sparse.SparseA`). The instance, its planted optimum and
b and c come from numpy's RandomState in the JAX package's order, so a
seed gives the JAX package's instance.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .api import solve
from .ops.sparse import SparseA, ell_from_coo
from .types import ConeSpec, Problem, Settings

# the CI size of `--small`
SMALL = dict(K=6, mb_l=8, soc=4, nb=16)


def _proj_soc_batch_np(V: np.ndarray) -> np.ndarray:
    """Numpy SOC projection of each row of V (the planted dual's cones)."""
    t = V[:, 0]
    x = V[:, 1:]
    nx = np.linalg.norm(x, axis=1)
    out = V.copy()
    inside = nx <= t
    zero = nx <= -t
    a = 0.5 * (1.0 + t / np.where(nx > 0, nx, 1.0))
    scale_rows = ~inside & ~zero
    out[scale_rows, 0] = (a * nx)[scale_rows]
    out[scale_rows, 1:] = (a[:, None] * x)[scale_rows]
    out[zero] = 0.0
    return out


def build_problem(K: int = 500, mb_l: int = 72, soc: int = 64,
                  nb: int = 128, seed: int = 0):
    """(Problem with a SparseA A on the CPU, ConeSpec, planted optimum,
    info dict: m, n, nnz, build_s, stored_bytes, dense_bytes)."""
    rng = np.random.RandomState(seed)
    mb = mb_l + 2 * soc                   # rows per stage
    m = K * mb
    n = K * nb
    spec = ConeSpec(l=K * mb_l, q=(soc,) * (2 * K))

    # COO assembly: stage i's nonnegative rows at i*mb_l, its SOC rows
    # after all nonnegative rows, its columns those of stages i-1 and i
    rows, cols, vals = [], [], []
    l_total = K * mb_l
    rr2, cc2 = np.nonzero(np.ones((mb, nb), bool))
    for i in range(K):
        r_l = np.arange(mb_l) + i * mb_l
        r_q = l_total + np.arange(2 * soc) + i * 2 * soc
        r_all = np.concatenate([r_l, r_q])
        for j in ([i - 1, i] if i > 0 else [i]):
            Cij = rng.randn(mb, nb) / np.sqrt(2 * nb)
            rows.append(r_all[rr2])
            cols.append(j * nb + cc2)
            vals.append(Cij[rr2, cc2])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)

    t0 = time.perf_counter()
    A = SparseA(fwd=ell_from_coo(rows, cols, vals, m, n),
                bwd=ell_from_coo(cols, rows, vals, n, m))
    build_s = time.perf_counter() - t0

    # planted primal-dual pair: y in K* (nonnegative and SOC rows are
    # self-dual), s = y - z in K, y's = 0
    x0 = rng.randn(n)
    z = rng.randn(m)
    y0 = np.empty(m)
    y0[:l_total] = np.maximum(z[:l_total], 0.0)
    zq = z[l_total:].reshape(2 * K, soc)
    y0[l_total:] = _proj_soc_batch_np(zq).reshape(-1)
    s0 = y0 - z
    b = (A @ torch.as_tensor(x0)).numpy() + s0
    c = -(A.T @ torch.as_tensor(y0)).numpy()
    opt = float(c @ x0)
    prob = Problem(A=A, b=torch.as_tensor(b), c=torch.as_tensor(c))
    info = {"m": m, "n": n, "nnz": vals.size, "build_s": build_s,
            "stored_bytes": A.nnz_stored() * 8, "dense_bytes": 2 * m * n * 8}
    return prob, spec, opt, info


# the demo's settings (the JAX package's demo_sparse.main)
SETTINGS = Settings(linsys="indirect", chunk_iters=250, eps_abs=1e-4,
                    eps_rel=1e-4, max_iters=20_000)


def solve_demo(small: bool = False, device="cuda"):
    """Build the instance (the CI size where `small`) and solve it at the
    demo's settings on `device`: (Info, planted optimum, build info)."""
    prob, spec, opt, meta = build_problem(**(SMALL if small else {}))
    _, info = solve(prob, spec, settings=SETTINGS, device=device)
    return info, opt, meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="the CI size")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    info, opt, meta = solve_demo(args.small, args.device)
    wall = time.perf_counter() - t0
    rel = abs(info.pobj - opt) / (1 + abs(opt))
    print(f"A: {meta['m']} x {meta['n']}, nnz {meta['nnz'] / 1e6:.2f}M; "
          f"stored {meta['stored_bytes'] / 1e9:.2f} GB vs dense "
          f"{meta['dense_bytes'] / 1e9:.1f} GB (built in "
          f"{meta['build_s']:.1f} s)")
    print(f"{args.device}: status={info.status} iters={info.iter} "
          f"pobj={info.pobj:.6f} planted={opt:.6f} relerr={rel:.2e} "
          f"setup={info.setup_time:.0f} ms solve={info.solve_time:.0f} ms "
          f"wall={wall:.1f} s")
    return 0 if info.status_val in (1, 2) else 1


if __name__ == "__main__":
    raise SystemExit(main())
