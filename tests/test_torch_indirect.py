"""The indirect backend (Jacobi-preconditioned CG) of scs_tpu_torch against
the JAX package's on the CPU: the KKT solve alone, one-problem solves and
a batch. Inputs are made with numpy (or the JAX generators) and handed to
both packages.

CG stops on data-dependent tests (the inf-norm of the residual against a
tolerance that itself follows the iterates), and torch and XLA sum in
other orders, so a CG count can differ by one where the residual lands
near the tolerance, and the ADMM trajectories that follow part. Where
both packages then agree on the iteration count the tests say so; where
they do not, the count is held to a ratio in [0.8, 1.25] and the
objective to SCS's own accuracy."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

import scs_tpu
from scs_tpu import models as j_models
from scs_tpu.linsys import Mats as JMats
from scs_tpu.linsys import indirect as j_ind
from scs_tpu.parallel import make_chunked_batch_solver as j_make_chunked
from scs_tpu_torch import Settings, Workspace, config, convert
from scs_tpu_torch import solve as t_solve
from scs_tpu_torch.linsys import Mats, get_backend, indirect
from scs_tpu_torch.ops import dsmatvec
from scs_tpu_torch.parallel import make_chunked_batch_solver
from scs_tpu_torch.validation import ValidationError

from helpers import stack_planted_problems


def t64(a):
    return None if a is None else torch.tensor(np.asarray(a),
                                                dtype=torch.float64)


def _kkt_system(seed, with_P):
    """A well-conditioned KKT system: dense A (m > n), five zero-cone rows,
    the solver's diag_r at `scale`, a random right-hand side and warm
    start."""
    rng = np.random.RandomState(seed)
    m, n, z = 40, 25, 5
    A = rng.randn(m, n)
    P = None
    if with_P:
        Q = rng.randn(n, n)
        P = Q @ Q.T / n
    scale = 0.1 + seed
    r_y = np.where(np.arange(m) < z, 1 / (1000 * scale), 1 / scale)
    dr = np.concatenate([np.full(n, 1e-6), r_y, [10.0]])
    return A, P, z, scale, dr, rng.randn(n + m), rng.randn(n) * 0.1


@pytest.mark.parametrize("seed, with_P", [(0, False), (1, True), (2, False)])
@pytest.mark.parametrize("mixed", [False, True])
def test_kkt_solve_matches_jax(seed, with_P, mixed):
    """One KKT solve with a warm start and a tight tolerance: x and y
    within 1e-10 (pure) or 1e-8 (mixed, the port through the kernels'
    plain versions, ds_split) of the JAX solve relative to their norm. Pure
    CG takes the same number of iterations give or take the last one (at
    this tolerance the final residual test compares numbers that differ
    in their last bits); the mixed solve's count (over all refinement
    passes) is held within 10 %: its float32 inner loops round
    differently in the two packages."""
    A, P, z, scale, dr, rhs, warm = _kkt_system(seed, with_P)
    tol = 1e-11
    jm = JMats(jnp.asarray(A), None if P is None else jnp.asarray(P),
               jnp.asarray(A, jnp.float32) if mixed else None,
               (jnp.asarray(P, jnp.float32)
                if mixed and P is not None else None),
               j_ind.precompute(jnp.asarray(A), None, z))
    jd = j_ind.derive(jm, jnp.asarray(dr), jnp.asarray(scale), mixed=mixed)
    jsol, jits = j_ind.solve(jm, jnp.asarray(dr), jd, jnp.asarray(rhs),
                             jnp.asarray(warm), jnp.asarray(tol))
    tA, tP = t64(A), t64(P)
    tm = Mats(tA, tP, indirect.precompute(tA, tP, z, ds=mixed),
              tA.float() if mixed else None,
              tP.float() if mixed and P is not None else None)
    td = indirect.derive(tm, t64(dr), torch.tensor(scale, dtype=torch.float64),
                         mixed=mixed)
    before = dsmatvec.launches
    sol, its = indirect.solve(tm, t64(dr), td, t64(rhs), t64(warm),
                              torch.tensor(tol, dtype=torch.float64))
    assert dsmatvec.launches == before          # CPU: plain versions
    jsol = np.asarray(jsol)
    err = np.linalg.norm(sol.numpy() - jsol) / np.linalg.norm(jsol)
    assert err <= (1e-8 if mixed else 1e-10), err
    slack = 0.1 * int(jits) if mixed else 1
    assert abs(int(its) - int(jits)) <= slack, (its, jits)


def test_pcg_iterations_and_exits_match_jax():
    """The PCG alone on SPD systems of growing condition: the same
    iteration counts as JAX's `_pcg`, and its two early exits: a warm
    start that already meets the tolerance takes no iteration, and a zero
    right-hand side returns zeros."""
    rng = np.random.RandomState(5)
    n = 30
    for cond in (1e1, 1e3, 1e5):
        Q, _ = np.linalg.qr(rng.randn(n, n))
        A = Q * np.sqrt(np.geomspace(1.0, cond, n))
        dr = np.concatenate([np.full(n, 1e-6), np.ones(n), [1.0]])
        M = 1.0 / (dr[:n] + np.sum(A * A, axis=0))
        b = rng.randn(n)
        for tol in (1e-4, 1e-9):
            jx, jits = j_ind._pcg(jnp.asarray(A), None, jnp.asarray(dr),
                                  jnp.asarray(M), None, jnp.asarray(b),
                                  10 * n, jnp.asarray(tol))
            tA, tdr = t64(A), t64(dr)
            x, its = indirect._pcg(
                (tA, None, tdr), t64(M), None, t64(b), 10 * n,
                torch.tensor(tol, dtype=torch.float64))
            assert int(its) == int(jits), (cond, tol)
            np.testing.assert_allclose(x.numpy(), np.asarray(jx),
                                       rtol=1e-9, atol=1e-12)
            # warm-started at its own answer: nothing left to do
            _, its2 = indirect._pcg(
                (tA, None, tdr), t64(M), x, t64(b), 10 * n,
                torch.tensor(1e-3, dtype=torch.float64))
            assert int(its2) == 0
    tm = Mats(t64(A), None, indirect.precompute(t64(A), None, 0))
    sol, its = indirect.solve(tm, t64(dr), indirect.derive(
        tm, t64(dr), torch.tensor(1.0, dtype=torch.float64)),
        torch.zeros(2 * n, dtype=torch.float64), None, None)
    assert int(its) == 0 and not sol.any()


# ---- one problem: the tests/test_solve.py instances ----

def _planted_socp():
    spec = scs_tpu.ConeSpec(z=5, l=20, q=(5, 5, 5, 10))
    p = j_models.gen_planted(spec, n=30, seed=3, density=0.3)
    return p.problem, spec


def _planted_lp():
    spec = scs_tpu.ConeSpec(l=300)
    p = j_models.gen_planted(spec, n=100, seed=42, density=0.1)
    return p.problem, spec


def _infeasible_socp():
    spec = scs_tpu.ConeSpec(l=10, q=(5, 8))
    return j_models.gen_infeasible(spec, n=10, seed=37)[0], spec


def _unbounded_socp():
    spec = scs_tpu.ConeSpec(l=8, q=(6,))
    return j_models.gen_unbounded(spec, n=10, seed=43)[0], spec


# (instance, its settings, whether pure float64 takes JAX's iteration
# count on this CPU). The SOCP's pure trajectories part at iteration 5,
# where one CG stop lands on the other side of its tolerance (14 and 15
# iterations); both solve it, 200 against JAX's 175 ADMM iterations. The
# LP runs at the default eps 1e-4 (tests/test_solve.py takes it to 1e-5):
# 725 iterations instead of 925 keep the port's CPU loop short.
CASES = {
    "socp": (_planted_socp, {}, False),
    "lp": (_planted_lp, {}, True),
    "infeasible": (_infeasible_socp, {}, True),
    "unbounded": (_unbounded_socp, {}, True),
}


def _port_args(jprob, jspec, jstg):
    P = None if jprob.P is None else np.asarray(jprob.P)
    prob = convert.problem_from_numpy(np.asarray(jprob.A),
                                      np.asarray(jprob.b),
                                      np.asarray(jprob.c), P)
    return (prob, convert.spec_from_dict(dataclasses.asdict(jspec)),
            convert.settings_from_dict(dataclasses.asdict(jstg)))


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_one_problem_matches_jax(case, mixed):
    """Equal statuses. Pure float64: the same ADMM iteration count where
    the case says so, objectives within 1e-8 (1 + |pobj|) then; else (and
    mixed, through the kernels' plain versions) a count within [0.8,
    1.25] of JAX's and objectives within 1e-3 (1 + |pobj|), SCS's eps
    1e-4 being the accuracy either side guarantees."""
    make, kw, exact = CASES[case]
    jprob, jspec = make()
    jstg = scs_tpu.Settings(linsys="indirect", mixed_precision=mixed, **kw)
    _, jinfo = scs_tpu.solve(jprob, jspec, None, jstg)
    prob, spec, stg = _port_args(jprob, jspec, jstg)
    w = Workspace(prob, spec, None, stg, device="cpu", ds_split=mixed)
    _, info = w.solve()
    assert info.status == jinfo.status
    assert info.lin_sys_solver == jinfo.lin_sys_solver == indirect.METHOD_NAME
    assert w.tot_cg_its >= info.iter // 2
    if exact and not mixed:
        assert info.iter == jinfo.iter
        rtol = 1e-8
    else:
        assert 0.8 <= info.iter / jinfo.iter <= 1.25, (info.iter,
                                                       jinfo.iter)
        rtol = 1e-3
    if np.isfinite(jinfo.pobj):
        assert abs(info.pobj - jinfo.pobj) <= rtol * (1 + abs(jinfo.pobj))
    else:
        assert info.pobj == jinfo.pobj


def test_default_settings_solve_through_the_indirect_backend():
    """Settings() solves through the indirect backend; on the CPU the
    default is pure float64 (mixed is auto-on only off the CPU)."""
    from scs_tpu_torch.models import gen_planted

    spec = convert.spec_from_dict(dataclasses.asdict(
        scs_tpu.ConeSpec(z=2, l=10, q=(4,))))
    p = gen_planted(spec, n=8, seed=11)
    assert Settings().linsys == "indirect"
    assert get_backend(Settings().linsys) is indirect
    sol, info = t_solve(p.problem, spec, p.cone_data, device="cpu")
    assert info.status == "solved"
    assert abs(info.pobj - p.opt) <= 1e-3 * (1 + abs(p.opt))


def test_indefinite_P_is_refused_as_in_jax():
    """An indefinite P with a positive diagonal passes the Jacobi test;
    the spectrum probe refuses it in both packages. A PSD but singular P
    passes."""
    rng = np.random.RandomState(3)
    n, m = 6, 10
    A = rng.randn(m, n)
    b, c = rng.rand(m) + 1.0, rng.randn(n)
    P_bad = np.eye(n)
    P_bad[0, 1] = P_bad[1, 0] = 2.0          # eigenvalues 3 and -1
    v = rng.randn(n)
    P_ok = np.outer(v, v)                    # rank one
    jspec = scs_tpu.ConeSpec(l=m)
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    for P, bad in ((P_bad, True), (P_ok, False)):
        jprob = scs_tpu.Problem(A=jnp.asarray(A), b=jnp.asarray(b),
                                c=jnp.asarray(c), P=jnp.asarray(P))
        prob = convert.problem_from_numpy(A, b, c, P)
        if bad:
            with pytest.raises(Exception, match="non-convexity"):
                scs_tpu.Workspace(jprob, jspec, None, scs_tpu.Settings())
            with pytest.raises(ValidationError, match="non-convexity"):
                Workspace(prob, spec, None, Settings(), device="cpu")
        else:
            Workspace(prob, spec, None, Settings(), device="cpu")


def test_sparse_A_raises_naming_its_item():
    """A torch sparse tensor is not an operand of either backend: the
    TypeError names the constructor of the port's sparse operand."""
    A = torch.eye(3, dtype=torch.float64).to_sparse()
    for backend in (indirect, get_backend("direct")):
        with pytest.raises(TypeError, match="sparse_from_scipy"):
            backend.precompute(A, None, 0)


# ---- a batch ----

BSPEC = scs_tpu.ConeSpec(l=20, q=(6,))


@functools.lru_cache(maxsize=None)
def _batch(count=2, n=8):
    A, _, b, c, bu, bl, opts = stack_planted_problems(BSPEC, n=n,
                                                      count=count)
    spec = convert.spec_from_dict(dataclasses.asdict(BSPEC))
    tA, _, tb, tc, tbu, tbl = convert.batch_from_numpy(
        np.asarray(A), np.asarray(b), np.asarray(c))
    return (A, b, c, bu, bl), spec, (tA, tb, tc, tbu, tbl), opts


def test_pure_batch_matches_jax():
    """Pure float64 through the chunked batched solvers: equal statuses and
    equal iteration counts lane by lane; objectives within 1e-4 (1 +
    |pobj|) of JAX's (the inexact CG solves leave the iterates apart at
    SCS's eps even where the counts agree) and 1e-3 of the planted
    optimum."""
    jargs, spec, targs, opts = _batch()
    jstg = scs_tpu.Settings(linsys="indirect", mixed_precision=False,
                            macro_schedule=False)
    jres = j_make_chunked(BSPEC, jstg)(*jargs)
    stg = convert.settings_from_dict(dataclasses.asdict(jstg))
    res = make_chunked_batch_solver(spec, stg, device="cpu")(*targs)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(jres.status))
    assert bool((res.status == config.SOLVED).all())
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(jres.iters))
    assert bool((res.tot_cg_its > 0).all())
    for ref, rtol in ((np.asarray(jres.pobj), 1e-4), (opts, 1e-3)):
        assert np.all(np.abs(res.pobj.numpy() - ref)
                      <= rtol * (1 + np.abs(ref)))


def test_mixed_f32_state_batch_matches_jax():
    """Mixed at eps 1e-5 (the fast floor, so no lane polishes) through the
    kernels' plain versions: the port's fast phase runs float32 state
    (fast_f32 auto-on with the splits), JAX's float64 state (its
    float32-state phase is the reference fault R2 on the CPU). Equal
    statuses, objectives within 1e-4 (1 + |pobj|)."""
    jargs, spec, targs, opts = _batch()
    eps = config.MIXED_FAST_FLOOR
    jstg = scs_tpu.Settings(linsys="indirect", mixed_precision=True,
                            fast_f32=False, macro_schedule=False,
                            eps_abs=eps, eps_rel=eps)
    jres = j_make_chunked(BSPEC, jstg)(*jargs)
    stg = Settings(linsys="indirect", mixed_precision=True, eps_abs=eps,
                   eps_rel=eps)
    solver = make_chunked_batch_solver(spec, stg, device="cpu",
                                       ds_split=True)
    before = dsmatvec.batched_launches
    res = solver(*targs)
    assert dsmatvec.batched_launches == before      # CPU: plain version
    assert solver.machinery.f32_state and solver.machinery.polished == 0
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(jres.status))
    assert bool((res.status == config.SOLVED).all())
    jp = np.asarray(jres.pobj)
    assert np.all(np.abs(res.pobj.numpy() - jp) <= 1e-4 * (1 + np.abs(jp)))
