"""A planted low-rank SDP, the workload of the tracked-rank PSD projection
(`Settings.psd_rank`).

The JAX package's test instance (`tests/test_subspace.py:59-80`), draw for
draw: four nonnegative rows (two of them active) and one PSD block of
dimension ns whose planted primal slack S has rank r and whose planted
dual Y has rank ns - r on the complementary eigenspace (strict
complementarity), A Gaussian (m x n), b = A x + s and c = -A'y, so x, y,
s are optimal and the optimum is c'x. Low-rank SDPs of this kind (matrix
completion, phase retrieval, max-cut relaxations) are where tracking the
r positive eigenvalues replaces an O(ns^3) eigendecomposition by O(ns^2 r)
products.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cones.psd import _tri_indices
from ..types import ConeData, ConeSpec, Problem
from .generators import PlantedProblem


def _svec(M: np.ndarray, ns: int) -> np.ndarray:
    _, _, tri_r, tri_c, pack_scale = _tri_indices(ns)
    return M[tri_r, tri_c] * pack_scale


def planted_lowrank_sdp(ns: int = 16, r: int = 3, n: int = 10,
                        seed: int = 0) -> PlantedProblem:
    """The planted SDP with one PSD block of dimension ns, of rank r at
    the optimum, and n variables: m = 4 + ns (ns + 1) / 2 rows."""
    rng = np.random.RandomState(seed)
    tri = ns * (ns + 1) // 2
    l = 4
    m = l + tri
    A = rng.randn(m, n)
    Q, _ = np.linalg.qr(rng.randn(ns, ns))
    S = (Q[:, :r] * (rng.rand(r) + 0.5)) @ Q[:, :r].T
    Y = (Q[:, r:] * (rng.rand(ns - r) + 0.5)) @ Q[:, r:].T
    y = np.zeros(m)
    s = np.zeros(m)
    act = 2
    y[:act] = rng.rand(act) + 0.5
    s[act:l] = rng.rand(l - act) + 0.5
    s[l:] = _svec(S, ns)
    y[l:] = _svec(Y, ns)
    x = rng.randn(n)
    b = A @ x + s
    c = -A.T @ y
    spec = ConeSpec(l=l, s=(ns,))
    t = torch.as_tensor
    return PlantedProblem(
        problem=Problem(A=t(A), b=t(b), c=t(c)), spec=spec,
        cone_data=ConeData.make(spec), x=x, y=y, s=s, opt=float(c @ x))
