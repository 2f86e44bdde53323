"""The mixed-cone configurations: bench.py's two families with part of
their rows moved to box, exponential and power cones.

* `large_mixed_spec`: bench.py's large_socp_leg (n = 2048, m = 8192,
  density 0.3, seed 7) with m shared out as zero 819, nonnegative 2457,
  box 1025 (bsize), 400 primal and 200 dual exp triples, 200 power
  triples with exponents drawn from +-U(0.1, 0.9), and SOC blocks of
  make_spec-style sizes (Poisson around the square root of what is left)
  over the remaining 1491 rows.
* `headline_mixed_spec`: bench.py's headline family (n = 100, m = 400)
  as z = 40, l = 100, bsize = 21, q = (20, 34, 14, 51, 21), ep = 15,
  ed = 8 and 10 power triples.

Box bounds: bl ~ -U(0.5, 2), bu ~ U(0.5, 2), every 10th bound at
-+MAX_BOX_VAL (infinite once equilibrated). Everything is drawn with
numpy's RandomState from the given seeds and built on the CPU.
"""

from __future__ import annotations

import numpy as np

from .. import config
from ..types import ConeData, ConeSpec
from .generators import PlantedProblem, gen_planted


def _soc_sizes(rem: int, rng) -> tuple[int, ...]:
    """make_spec's SOC sizes (demo_socp.make_spec) over `rem` rows."""
    q = []
    while rem > 0:
        sz = int(min(rem, max(1, rng.poisson(np.sqrt(rem)))))
        q.append(sz)
        rem -= sz
    return tuple(q)


def large_mixed_spec(seed: int = 7) -> ConeSpec:
    rng = np.random.RandomState(seed)
    p = rng.uniform(0.1, 0.9, 200) * np.where(rng.rand(200) < 0.5, -1, 1)
    return ConeSpec(z=819, l=2457, bsize=1025, q=_soc_sizes(1491, rng),
                    ep=400, ed=200, p=tuple(float(a) for a in p))


def headline_mixed_spec() -> ConeSpec:
    return ConeSpec(z=40, l=100, bsize=21, q=(20, 34, 14, 51, 21), ep=15,
                    ed=8, p=(0.3, -0.4, 0.5, -0.6, 0.7, -0.2, 0.8, -0.75,
                             0.25, -0.35))


def box_bounds(spec: ConeSpec, seed: int) -> ConeData:
    """Box bounds of the configurations (see the module docstring)."""
    rng = np.random.RandomState(seed)
    nb = spec.bsize - 1
    bl = -rng.uniform(0.5, 2.0, nb)
    bu = rng.uniform(0.5, 2.0, nb)
    bl[::10] = -config.MAX_BOX_VAL
    bu[5::10] = config.MAX_BOX_VAL
    return ConeData.make(spec, bu=bu, bl=bl)


def gen_mixed(spec: ConeSpec, n: int, seed: int,
              density: float) -> PlantedProblem:
    """A planted problem of `spec` with the configurations' box bounds
    (drawn from seed + 1)."""
    return gen_planted(spec, n=n, seed=seed, density=density,
                       cone_data=box_bounds(spec, seed + 1))
