"""Random-SOCP demo (counterpart of `scs_tpu/demo_socp.py`; SCS's
test/random_socp_prob.c:20-174):

    python -m scs_tpu_torch.demo_socp [n] [density] [zero_frac] [seed]

Generates a random feasible SOCP with a planted optimum (m = 4n rows:
10% zero cone, 30% nonnegative, the rest SOC blocks of ~sqrt(m) sizes),
solves it on the card at default tolerances with the direct backend, and
reports the objective error.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .api import solve
from .models import gen_planted
from .types import ConeSpec, Settings


def make_spec(n: int, zero_frac: float = 0.1, rng=None) -> ConeSpec:
    """Cone layout of random_socp_prob.c: m = 4n, a zero block, a
    nonnegative block, then random SOC sizes averaging ~sqrt(remaining)."""
    rng = rng or np.random.RandomState(0)
    m = 4 * n
    z = int(zero_frac * m)
    l = int(0.3 * m)
    rem = m - z - l
    q = []
    while rem > 0:
        sz = int(min(rem, max(1, rng.poisson(np.sqrt(rem)))))
        q.append(sz)
        rem -= sz
    return ConeSpec(z=z, l=l, q=tuple(q))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 100
    density = float(argv[1]) if len(argv) > 1 else 0.1
    zero_frac = float(argv[2]) if len(argv) > 2 else 0.1
    seed = int(argv[3]) if len(argv) > 3 else 42

    spec = make_spec(n, zero_frac, np.random.RandomState(seed))
    print(f"random SOCP: n={n}, m={spec.dims()}, cones z={spec.z} "
          f"l={spec.l} q x {len(spec.q)}, density={density}, seed={seed}")
    p = gen_planted(spec, n=n, seed=seed, density=density)
    t0 = time.perf_counter()
    sol, info = solve(p.problem, spec, p.cone_data, Settings(linsys="direct"))
    err = abs(info.pobj - p.opt) / (1 + abs(p.opt))
    print(f"{info.status} in {info.iter} iterations, "
          f"{time.perf_counter() - t0:.2f} s; objective error vs planted "
          f"optimum: {err:.2e}")
    return 0 if info.status_val > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
