"""Problem generators: planted-optimum random cone programs and
certificate (infeasible / unbounded) constructions.

Counterpart of `scs_tpu/models/generators.py` for the cones this package
projects. Everything is drawn with numpy's RandomState in the JAX
package's order, so a seed gives bit-identical A, b and c in both
packages wherever the dual projection is the numpy one (zero,
nonnegative and SOC layouts); a layout with box, exp or power cones
projects through this package's `proj_dual_cone` in float64 on the CPU,
as the JAX package projects through its own, so the two agree to the
projections' round-off. The planted pair mirrors SCS's test harness
(test/problem_utils.h:22-81): y in K*, s = y - z in K with y's = 0, a
random x, b = Ax + s and c = -A'y (- Px for QPs).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..cones.project import proj_dual_cone, require_supported
from ..types import ConeData, ConeSpec, Problem


@dataclasses.dataclass
class PlantedProblem:
    problem: Problem
    spec: ConeSpec
    cone_data: ConeData
    x: np.ndarray
    y: np.ndarray
    s: np.ndarray
    opt: float  # optimal objective (1/2 x'Px + c'x)


def _project_dual_np(z: np.ndarray, spec: ConeSpec) -> np.ndarray:
    """Numpy projection onto the dual cone of a zero/nonnegative/SOC
    layout (zero cone: the dual is free)."""
    out = np.asarray(z, np.float64).copy()
    off = spec.z
    out[off:off + spec.l] = np.maximum(out[off:off + spec.l], 0.0)
    off += spec.l
    for q in spec.q:
        v = out[off:off + q]
        if q == 1:
            v[:] = np.maximum(v, 0.0)
        else:
            t, x = v[0], v[1:]
            nx = np.linalg.norm(x)
            if nx <= t:
                pass
            elif nx <= -t:
                v[:] = 0.0
            else:
                a = 0.5 * (1.0 + t / nx)
                v[0] = a * nx
                v[1:] = a * x
        off += q
    return out


def _project_dual(z: np.ndarray, spec: ConeSpec,
                  cone_data: ConeData) -> np.ndarray:
    """Projection onto the dual cone: numpy for zero/nonnegative/SOC
    layouts, else `proj_dual_cone` in float64 on the CPU."""
    require_supported(spec)
    if not (spec.bsize or spec.ep or spec.ed or spec.p):
        return _project_dual_np(z, spec)
    bu = torch.as_tensor(np.asarray(cone_data.bu), dtype=torch.float64)
    bl = torch.as_tensor(np.asarray(cone_data.bl), dtype=torch.float64)
    out, _ = proj_dual_cone(torch.as_tensor(z, dtype=torch.float64), spec,
                            ConeData(bu=bu, bl=bl),
                            torch.ones((), dtype=torch.float64), None)
    return out.numpy()


def _problem(A, b, c, P, dtype) -> Problem:
    def t(a):
        return None if a is None else torch.as_tensor(a, dtype=dtype)
    return Problem(A=t(A), b=t(b), c=t(c), P=t(P))


def gen_planted(spec: ConeSpec, n: int, seed: int = 0, density: float = 0.3,
                with_P: bool = False, cone_data: Optional[ConeData] = None,
                dtype=torch.float64) -> PlantedProblem:
    """Random cone program with a planted primal-dual optimal pair."""
    rng = np.random.RandomState(seed)
    m = spec.dims()
    if cone_data is None:
        cone_data = ConeData.make(spec, dtype=dtype)

    A = rng.uniform(-1, 1, (m, n)) * (rng.rand(m, n) < density)
    # no zero column, so the problem is well-posed
    for j in range(n):
        if not A[:, j].any():
            A[rng.randint(m), j] = rng.uniform(-1, 1)

    z = rng.uniform(-1, 1, m)
    y = _project_dual(z, spec, cone_data)
    s = y - z  # s in K, y in K*, s'y = 0 (Moreau)
    x = rng.uniform(-1, 1, n)

    P = None
    if with_P:
        F = rng.uniform(-1, 1, (n, n)) * (rng.rand(n, n) < density)
        P = F @ F.T + 1e-3 * np.eye(n)

    b = A @ x + s
    c = -A.T @ y
    if P is not None:
        c = c - P @ x

    obj = float(0.5 * x @ P @ x + c @ x) if P is not None else float(c @ x)
    return PlantedProblem(problem=_problem(A, b, c, P, dtype), spec=spec,
                          cone_data=cone_data, x=x, y=y, s=s, opt=obj)


def gen_infeasible(spec: ConeSpec, n: int, seed: int = 0,
                   cone_data: Optional[ConeData] = None,
                   with_P: bool = False, dtype=torch.float64):
    """Primal-infeasible problem with a planted Farkas certificate y0:
    y0 in K*, A'y0 = 0, b'y0 < 0. Returns (problem, cone_data, y0)."""
    rng = np.random.RandomState(seed)
    m = spec.dims()
    if cone_data is None:
        cone_data = ConeData.make(spec, dtype=dtype)
    A = rng.uniform(-1, 1, (m, n))
    z = rng.uniform(0.1, 1, m)
    y0 = _project_dual(z, spec, cone_data)
    if not np.linalg.norm(y0):
        raise ValueError("certificate projection collapsed to zero")
    A = A - np.outer(y0, y0 @ A) / (y0 @ y0)       # A' y0 = 0
    b = rng.uniform(-1, 1, m)
    b = b - y0 * (b @ y0 + 1.0) / (y0 @ y0)         # b' y0 = -1
    c = rng.uniform(-1, 1, n)
    P = None
    if with_P:
        F = rng.uniform(-1, 1, (n, n))
        P = F @ F.T / n + 1e-3 * np.eye(n)
    return _problem(A, b, c, P, dtype), cone_data, y0


def gen_unbounded(spec: ConeSpec, n: int, seed: int = 0,
                  cone_data: Optional[ConeData] = None, dtype=torch.float64):
    """Primal-unbounded problem with a planted ray x0: A x0 = -s0 with s0
    in K, c'x0 = -1 (P absent). Returns (problem, cone_data, x0)."""
    rng = np.random.RandomState(seed)
    m = spec.dims()
    if cone_data is None:
        cone_data = ConeData.make(spec, dtype=dtype)
    A = rng.uniform(-1, 1, (m, n))
    z = rng.uniform(-1, 1, m)
    s0 = z + _project_dual(-z, spec, cone_data)     # s0 = Pi_K(z) (Moreau)
    x0 = rng.uniform(-1, 1, n)
    A = A + np.outer(-s0 - A @ x0, x0) / (x0 @ x0)  # A x0 = -s0
    c = rng.uniform(-1, 1, n)
    c = c - x0 * (c @ x0 + 1.0) / (x0 @ x0)         # c' x0 = -1
    b = rng.uniform(-1, 1, m)
    return _problem(A, b, c, None, dtype), cone_data, x0
