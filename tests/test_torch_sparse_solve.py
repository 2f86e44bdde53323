"""Sparse (blocked-ELL) solves of scs_tpu_torch against the JAX package's
sparse solves on the CPU, on the instances of tests/test_sparse.py
(demo_sparse's CI size: tests/test_torch_sparse.py): both backends, pure float64 and mixed (the port
with ds_split=True, so its double-single products run the plain versions
of K2 and K1), sparse A and sparse P.

Each package gets the same operand (the constructors agree bit for bit,
tests/test_torch_sparse.py). Statuses are equal and objectives agree to
1e-5 (1 + |pobj|). Pure float64 direct: equal iteration counts (the
factor and every product are float64, and the fixed-order Gram differs
from the JAX package's in the last bits only). Elsewhere the count is held
to [0.8, 1.25] of the JAX package's: CG stops on data-dependent tests
(the residual's inf-norm against a tolerance that follows the iterates),
and torch and XLA sum in other orders, so a CG count can differ by one
near the tolerance and the ADMM trajectories part; the mixed paths also
round differently (the JAX package has no double-single kernel on the
CPU and runs float64 products there). The JAX solves are shared across
cases through a module-scope cache."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

import scs_tpu
from scs_tpu.models import gen_planted
from scs_tpu.ops import sparse as jsp
from scs_tpu_torch import Workspace, config, convert
from scs_tpu_torch.linsys import direct, indirect
from scs_tpu_torch.ops import sparse as tsp
from scs_tpu_torch.types import Problem


def t64(a):
    return None if a is None else torch.tensor(np.asarray(a),
                                                dtype=torch.float64)


def _rand_sparse_psd(n, seed, density=0.2):
    """tests/test_sparse.py:_rand_sparse_psd."""
    rng = np.random.RandomState(seed)
    F = sp.random(n, max(n // 4, 2), density=density, random_state=rng,
                  data_rvs=rng.randn).tocsc()
    return ((F @ F.T).tocsc() + 1e-3 * sp.eye(n, format="csc")).tocsc()


def _planted(spec, n, seed, density, with_P=False, P_csc=None):
    """(A csc, b, c, P csc or None, spec) of a planted instance of the JAX
    generators (P: the generator's, or P_csc)."""
    p = gen_planted(spec, n=n, seed=seed, density=density, with_P=with_P)
    P = P_csc
    if with_P:
        P = sp.csc_matrix(np.asarray(p.problem.P))
    return (sp.csc_matrix(np.asarray(p.problem.A)), np.asarray(p.problem.b),
            np.asarray(p.problem.c), P, spec)


def _tails_lp():
    """tests/test_sparse.py:test_tails_end_to_end_solve: an LP with a dense
    budget row, extracted as a row tail."""
    rng = np.random.RandomState(5)
    n, m_ineq = 50, 80
    A_sp = sp.random(m_ineq, n, density=0.1, random_state=rng,
                     data_rvs=rng.randn)
    x0 = 0.01 * rng.rand(n)
    A = sp.vstack([sp.csc_matrix(np.ones((1, n))), A_sp,
                   -sp.eye(n)]).tocsc()
    b = np.r_[x0.sum() + 0.5, A_sp @ x0 + np.abs(rng.randn(m_ineq)),
              10.0 * np.ones(n)]
    return A, b, rng.randn(n), None, scs_tpu.ConeSpec(l=m_ineq + 1 + n)


def _infeasible():
    """tests/test_sparse.py:test_sparse_infeasible_certificate."""
    return (sp.csc_matrix(np.array([[-1.0], [1.0]])), np.array([-1.0, 0.0]),
            np.array([0.0]), None, scs_tpu.ConeSpec(l=2))


SOCP = scs_tpu.ConeSpec(z=20, l=40, q=(12, 8, 20))

# name -> (instance, settings, tail rows of A, pure float64 direct)
CASES = {
    "dense_parity_lp": (lambda: _planted(scs_tpu.ConeSpec(l=90), 30, 11,
                                         0.1),
                        dict(linsys="indirect", eps_abs=1e-6, eps_rel=1e-6),
                        None),
    "dense_parity_socp": (lambda: _planted(SOCP, 40, 13, 0.1),
                          dict(linsys="indirect", eps_abs=1e-6,
                               eps_rel=1e-6), None),
    "indirect_mixed": (lambda: _planted(scs_tpu.ConeSpec(l=60), 20, 17,
                                        0.15),
                       dict(linsys="indirect", mixed_precision=True,
                            eps_abs=1e-7, eps_rel=1e-7), None),
    "direct_pure": (lambda: _planted(SOCP, 40, 13, 0.1),
                    dict(linsys="direct", mixed_precision=False,
                         eps_abs=1e-6, eps_rel=1e-6), None),
    "direct_mixed": (lambda: _planted(SOCP, 40, 13, 0.1),
                     dict(linsys="direct", mixed_precision=True,
                          eps_abs=1e-6, eps_rel=1e-6), None),
    "P_direct": (lambda: _planted(scs_tpu.ConeSpec(l=50), 24, 31, 0.15,
                                  P_csc=_rand_sparse_psd(24, seed=77)),
                 dict(linsys="direct", eps_abs=1e-7, eps_rel=1e-7), None),
    "P_qp_sparse_A": (lambda: _planted(scs_tpu.ConeSpec(z=8, l=40), 24, 31,
                                       0.2, with_P=True),
                      dict(linsys="indirect", eps_abs=1e-7, eps_rel=1e-7),
                      None),
    "P_qp_dense_A": (lambda: _planted(scs_tpu.ConeSpec(z=8, l=40), 24, 31,
                                      0.2, with_P=True),
                     dict(linsys="indirect", eps_abs=1e-7, eps_rel=1e-7),
                     "dense"),
    "infeasible": (_infeasible, dict(linsys="indirect"), None),
    "tails_lp": (_tails_lp, dict(linsys="indirect", eps_abs=1e-8,
                                 eps_rel=1e-8), (0,)),
}


@functools.lru_cache(maxsize=None)
def _jax_solve(case):
    make, kw, rows = CASES[case]
    A, b, c, P, spec = make()
    jA = (jnp.asarray(A.toarray()) if rows == "dense"
          else jsp.sparse_from_scipy(A, dense_rows=rows))
    jP = None if P is None else jsp.sparse_from_scipy(P)
    prob = scs_tpu.Problem(A=jA, b=jnp.asarray(b), c=jnp.asarray(c), P=jP)
    sol, info = scs_tpu.solve(prob, spec, None, scs_tpu.Settings(**kw))
    return np.asarray(sol.x), np.asarray(sol.y), info


def _port_solve(case):
    make, kw, rows = CASES[case]
    A, b, c, P, jspec = make()
    tA = (t64(A.toarray()) if rows == "dense"
          else tsp.sparse_from_scipy(A, dense_rows=rows))
    tP = None if P is None else tsp.sparse_from_scipy(P)
    prob = Problem(A=tA, b=t64(b), c=t64(c), P=tP)
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    stg = convert.settings_from_dict(dataclasses.asdict(
        scs_tpu.Settings(**kw)))
    mixed = bool(kw.get("mixed_precision"))
    w = Workspace(prob, spec, None, stg, device="cpu", ds_split=mixed)
    sol, info = w.solve()
    return w, sol, info


@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_solve_matches_jax(case):
    jx, jy, jinfo = _jax_solve(case)
    w, sol, info = _port_solve(case)
    kw = CASES[case][1]
    assert info.status == jinfo.status
    backend = direct if kw["linsys"] == "direct" else indirect
    assert info.lin_sys_solver == backend.METHOD_NAME
    if case != "P_qp_dense_A":
        assert tsp.is_sparse(w.data.A)
    if kw["linsys"] == "direct" and not kw.get("mixed_precision"):
        assert info.iter == jinfo.iter
    else:
        assert 0.8 <= info.iter / jinfo.iter <= 1.25, (info.iter,
                                                       jinfo.iter)
    if info.status_val == config.INFEASIBLE:
        assert abs(float(np.dot(t64(CASES[case][0]()[1]).numpy(), sol.y))
                   + 1.0) < 1e-9
        assert info.pobj == jinfo.pobj
        return
    assert info.status_val == config.SOLVED
    assert abs(info.pobj - jinfo.pobj) <= 1e-5 * (1 + abs(jinfo.pobj))


def test_mixed_sparse_path_runs_the_double_single_products():
    """The mixed indirect solve's caches hold the sparse operand's
    double-single splits (K2's tiles, K1's tails) and its float32 shadow;
    the pure solve's hold none."""
    w, _, info = _port_solve("indirect_mixed")
    assert isinstance(w.data.lin_cache.ds_fwd, tsp.DsSparse)
    assert isinstance(w.data.lin_cache.ds_bwd, tsp.DsSparse)
    assert tsp.is_sparse(w.data.A32) and w.data.A32.dtype == torch.float32
    w64, _, _ = _port_solve("dense_parity_lp")
    assert w64.data.lin_cache.ds_fwd is None and w64.data.A32 is None
