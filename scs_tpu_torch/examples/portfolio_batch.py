"""A batch of portfolio-style SOCPs solved together on the card.

The batch axis is the solver's data parallelism, and the chunked batch
solver compacts stragglers so that early convergers stop costing work
(the JAX package's examples/portfolio_batch.py step for step).

Each instance:  min -mu'w + gamma t   s.t.  sum w = 1, w >= 0,
                (t, F'w) in SOC  (risk ||F'w|| <= t)

Run:  python -m scs_tpu_torch.examples.portfolio_batch [B] [--device cpu]
      (default B=64)
"""

import time

import numpy as np
import torch

from ..api import _resolve_device
from ..parallel import make_chunked_batch_solver
from ..types import ConeSpec, Settings


def main(B: int = 64, device="cuda") -> dict:
    dev = _resolve_device(device)
    n_assets, n_factors, gamma = 30, 25, 0.5
    rng = np.random.RandomState(0)

    # variables z = [w (n_assets), t (1)]
    n = n_assets + 1
    m_zero, m_pos, m_soc = 1, n_assets, n_factors + 1
    spec = ConeSpec(z=m_zero, l=m_pos, q=(m_soc,))

    A_list, b_list, c_list = [], [], []
    for _ in range(B):
        mu = 0.02 + 0.05 * rng.rand(n_assets)
        F = rng.randn(n_assets, n_factors) / np.sqrt(n_factors)
        A = np.zeros((m_zero + m_pos + m_soc, n))
        b = np.zeros(m_zero + m_pos + m_soc)
        A[0, :n_assets] = 1.0                     # sum w = 1 (zero cone)
        b[0] = 1.0
        A[1:1 + n_assets, :n_assets] = -np.eye(n_assets)   # w >= 0
        A[1 + n_assets, n_assets] = -1.0          # SOC head: t
        A[2 + n_assets:, :n_assets] = -F.T        # SOC tail: F'w
        c = np.concatenate([-mu, [gamma]])
        A_list.append(A)
        b_list.append(b)
        c_list.append(c)
    A, b, c = (torch.as_tensor(np.stack(a), device=dev)
               for a in (A_list, b_list, c_list))
    bu = torch.zeros((B, 0), dtype=A.dtype, device=dev)
    bl = torch.zeros((B, 0), dtype=A.dtype, device=dev)

    stg = Settings(eps_abs=1e-5, eps_rel=1e-5, chunk_iters=250)
    solver = make_chunked_batch_solver(spec, stg, device=dev)

    res = solver(A, b, c, bu, bl)                 # warm-up
    t0 = time.perf_counter()
    res = solver(A, b, c, bu, bl)
    iters = res.iters.cpu().numpy()
    wall = time.perf_counter() - t0

    solved = int((res.status.cpu().numpy() == 1).sum())
    print(f"B={B}: {solved}/{B} solved, {int(iters.sum())} total iters "
          f"in {wall:.3f}s = {iters.sum() / wall:,.0f} iters/s, "
          f"{wall / B * 1e3:.2f} ms/problem")
    w0 = res.x[0, :n_assets].cpu().numpy()
    print(f"instance 0 weights: max {w0.max():.3f}, "
          f"sum {w0.sum():.6f}, risk t = {float(res.x[0, n_assets]):.4f}")
    assert solved == B, f"{B - solved} lanes not solved"
    assert abs(w0.sum() - 1.0) < 1e-4 and w0.min() > -1e-4
    return {"solved": solved, "iters": int(iters.sum()), "wall_s": wall}


if __name__ == "__main__":
    from ._cli import parse
    a = parse(__doc__, "B", 64)
    main(a.B, a.device)
