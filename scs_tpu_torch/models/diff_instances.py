"""Instances on which the solution map is differentiable (`diff.py`).

`planted_complementary` generalizes tests/test_diff.py's
`_gen_strictly_complementary` to any layout of zero, nonnegative and SOC
rows, size-1 SOC blocks included: a STRICTLY COMPLEMENTARY,
nondegenerate optimum is planted, with exactly as many active constraint
dimensions as the primal has (face dimension 0), so that the implicit
function system (I - dPhi/dv) is nonsingular. Equality rows carry free
duals; SOC blocks of size k >= 2 go on the boundary from both sides (s on
a ray, y on the opposite one, k - 1 dimensions each) as long as the
dimension budget n - z allows, in row order, and the rest are strictly
interior (s inside, y = 0); size-1 blocks are one-sided (s > 0, y = 0);
the remaining budget goes to active nonnegative rows (y > 0, s = 0), the
other nonnegative rows are strictly slack. With `with_P` the objective
gets a strictly convex P = F F' + I and the same active set. `max_cond`
bounds the condition number of the active constraints' system: with
random Gaussian A it spreads from ~80 to ~24000 over 64 headline-width
draws, and the worst lanes move off their face under a finite
difference's step.

`exp_instance`, `power_instance` and `box_instance` are the exp, power
and box instances of tests/test_diff.py (the port's `gen_planted` draws
the JAX generator's numbers).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..types import ConeData, ConeSpec, Problem
from .generators import gen_planted


def _active_jacobian(A, z: int, act: int, boundary) -> np.ndarray:
    """The n x n first-order system that fixes x at the planted optimum:
    the equality rows, the active nonnegative rows, and for each boundary
    SOC block (offset, size, unit s) the rows of U' A_j, U an orthonormal
    basis of s's complement (s may move along its ray only)."""
    rows = [A[:z], A[z:z + act]]
    for off, k, u in boundary:
        Q, _ = np.linalg.qr(np.column_stack([u, np.eye(k)[:, :k - 1]]))
        rows.append(Q[:, 1:].T @ A[off:off + k])
    return np.vstack(rows)


def planted_complementary(spec: ConeSpec, n: int, seed: int = 0,
                          with_P: bool = False,
                          max_cond: Optional[float] = None) -> Problem:
    """A problem of `spec` (z, l and q rows only) with n variables and a
    strictly complementary, nondegenerate planted optimum (module
    docstring). With `max_cond`, A is drawn again (from the same random
    stream) until the condition number of the active constraints' system
    (`_active_jacobian`) is at most max_cond: the solution's sensitivity
    to the data, and so the reach of a finite difference that stays on
    the optimum's face, scales with it."""
    if spec.dims() != spec.z + spec.l + sum(spec.q):
        raise ValueError("planted_complementary takes z, l and q rows only")
    rng = np.random.RandomState(seed)
    z, l = spec.z, spec.l
    m = spec.dims()
    y = np.zeros(m)
    s = np.zeros(m)
    y[:z] = rng.randn(z)
    budget = n - z
    boundary = []
    off = z + l
    for k in spec.q:
        if k == 1:
            s[off] = rng.rand() + 0.5
        elif k - 1 <= budget - 1:
            v = rng.randn(k - 1)
            a = np.linalg.norm(v)
            s[off:off + k] = np.concatenate([[a], v])
            y[off:off + k] = (0.5 + rng.rand()) * np.concatenate([[a], -v])
            boundary.append((off, k, s[off:off + k] / (a * np.sqrt(2.0))))
            budget -= k - 1
        else:
            v = rng.randn(k - 1)
            s[off:off + k] = np.concatenate(
                [[np.linalg.norm(v) * (1.5 + rng.rand())], v])
        off += k
    act = min(budget, l)
    y[z:z + act] = rng.rand(act) + 0.5
    s[z + act:z + l] = rng.rand(l - act) + 0.5
    x = rng.randn(n)
    while True:
        A = rng.randn(m, n)
        if max_cond is None or np.linalg.cond(
                _active_jacobian(A, z, act, boundary)) <= max_cond:
            break
    b = A @ x + s
    P = None
    c = -A.T @ y
    if with_P:
        F = rng.randn(n, n) / np.sqrt(n)
        P = F @ F.T + np.eye(n)
        c = c - P @ x

    def t(a):
        return None if a is None else torch.as_tensor(a, dtype=torch.float64)

    return Problem(A=t(A), b=t(b), c=t(c), P=t(P))


def exp_instance():
    """(spec, Problem): tests/test_diff.py's primal exp-cone case."""
    spec = ConeSpec(z=1, ep=1)
    return spec, gen_planted(spec, n=3, seed=0, density=0.9).problem


def power_instance():
    """(spec, Problem): tests/test_diff.py's power-cone case."""
    spec = ConeSpec(z=1, p=(0.6,))
    return spec, gen_planted(spec, n=3, seed=3, density=0.9).problem


def box_instance():
    """(spec, Problem, bu, bl): tests/test_diff.py's box-cone case (bounds
    slack at the solution)."""
    rng = np.random.RandomState(2)
    nb, n = 2, 4
    spec = ConeSpec(z=1, bsize=nb + 1)
    bu = rng.rand(nb) + 0.5
    bl = -(rng.rand(nb) + 0.5)
    cd = ConeData.make(spec, bu=bu, bl=bl)
    p = gen_planted(spec, n=n, seed=3, density=0.9, cone_data=cd)
    return (spec, p.problem, torch.as_tensor(bu, dtype=torch.float64),
            torch.as_tensor(bl, dtype=torch.float64))
