"""The port's batched solvers on their own, on the CPU: BatchWorkspace on
the cases of tests/test_batch_warm.py, the time limit and SIGINT on the
cases of tests/test_batch_limits.py, the rules of the entry points, and
the batched modules lane by lane against their one-problem versions
(which tests/test_torch_modules.py holds against the JAX package)."""

import dataclasses

import numpy as np
import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

from scs_tpu_torch import ConeSpec, Settings, accel, config
from scs_tpu_torch import equilibrate as eq
from scs_tpu_torch.cones import project
from scs_tpu_torch.linsys import Mats, direct
from scs_tpu_torch.models import gen_planted
from scs_tpu_torch.parallel import (BatchWorkspace, make_batch_solver,
                                    make_chunked_batch_solver,
                                    make_pure_solver, make_restart_fn,
                                    make_solver_parts)
from scs_tpu_torch.parallel import batch as batch_mod
from scs_tpu_torch import solver_batched

STG = Settings(linsys="direct")
_INACCURATE = (config.SOLVED_INACCURATE, config.INFEASIBLE_INACCURATE,
               config.UNBOUNDED_INACCURATE, config.FAILED)


def _stack(spec, n, count, seed0=100, with_P=False):
    probs = [gen_planted(spec, n=n, seed=seed0 + i, density=0.4,
                         with_P=with_P) for i in range(count)]
    A = torch.stack([p.problem.A for p in probs])
    b = torch.stack([p.problem.b for p in probs])
    c = torch.stack([p.problem.c for p in probs])
    P = torch.stack([p.problem.P for p in probs]) if with_P else None
    return A, P, b, c, np.asarray([p.opt for p in probs])


def _setup(count=8, with_P=False, q=()):
    spec = ConeSpec(l=30, q=q)
    return (spec,) + _stack(spec, 12, count, with_P=with_P)


def _solved(res):
    return bool(torch.all(res.status == config.SOLVED))


def test_warm_resolve_same_problem_fewer_iters():
    spec, A, P, b, c, opts = _setup()
    ws = BatchWorkspace(spec, STG, A, None, b, c, device="cpu")
    cold = ws.solve()
    assert _solved(cold)
    warm = ws.solve(warm_start=True)
    assert _solved(warm)
    assert torch.all(warm.iters < cold.iters), (warm.iters, cold.iters)
    np.testing.assert_allclose(warm.pobj.numpy(), opts, atol=1e-3, rtol=1e-3)


def test_update_b_then_warm_matches_fresh_cold():
    spec, A, P, b, c, opts = _setup(q=(8,))
    ws = BatchWorkspace(spec, STG, A, None, b, c, device="cpu")
    assert _solved(ws.solve())
    b_new = b * 1.02
    ws.update(b=b_new)
    warm = ws.solve(warm_start=True)
    assert _solved(warm)
    B = A.shape[0]
    fresh = make_chunked_batch_solver(spec, STG, device="cpu")(
        A, b_new, c, torch.zeros(B, 0), torch.zeros(B, 0))
    assert _solved(fresh)
    np.testing.assert_allclose(warm.pobj.numpy(), fresh.pobj.numpy(),
                               atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(warm.x.numpy(), fresh.x.numpy(), atol=5e-3,
                               rtol=5e-3)
    assert int(warm.iters.sum()) < int(fresh.iters.sum())


def test_update_c_cold_matches_fresh_setup():
    """update(c) + a cold re-solve equals a fresh setup on the new c: the
    g cache is rebuilt after the update, and a cold restart keeps each
    lane's adapted scale, as the JAX package's does."""
    spec, A, P, b, c, opts = _setup(count=4)
    ws = BatchWorkspace(spec, STG, A, None, b, c, device="cpu")
    ws.solve()
    c_new = c * 0.5
    ws.update(c=c_new)
    cold2 = ws.solve(warm_start=False)
    fresh = make_chunked_batch_solver(spec, STG, device="cpu")(
        A, b, c_new, torch.zeros(4, 0), torch.zeros(4, 0))
    assert _solved(cold2)
    np.testing.assert_allclose(cold2.pobj.numpy(), fresh.pobj.numpy(),
                               atol=1e-3, rtol=1e-3)


def test_warm_with_qp_batch():
    spec, A, P, b, c, opts = _setup(count=4, with_P=True)
    ws = BatchWorkspace(spec, STG, A, P, b, c, device="cpu")
    cold = ws.solve()
    warm = ws.solve(warm_start=True)
    assert _solved(cold) and _solved(warm)
    assert torch.all(warm.iters < cold.iters)
    np.testing.assert_allclose(warm.pobj.numpy(), opts, atol=1e-3, rtol=1e-3)


def test_warm_nan_seed_scrubbed():
    spec, A, P, b, c, opts = _setup(count=4)
    ws = BatchWorkspace(spec, STG, A, None, b, c, device="cpu")
    cold = ws.solve()
    x = cold.x.clone()
    y = cold.y.clone()
    x[0] = float("nan")
    y[1] = float("nan")
    warm = ws.solve(warm_start=True,
                    sol=dataclasses.replace(cold, x=x, y=y))
    assert _solved(warm)
    np.testing.assert_allclose(warm.pobj.numpy(), opts, atol=1e-3, rtol=1e-3)


def test_mixed_precision_warm_path():
    """BatchWorkspace under the two-phase mixed strategy, through the
    plain K2 version."""
    spec, A, P, b, c, opts = _setup(count=4)
    stg = Settings(linsys="direct", mixed_precision=True, eps_abs=1e-6,
                   eps_rel=1e-6)
    ws = BatchWorkspace(spec, stg, A, None, b, c, device="cpu",
                        ds_split=True)
    cold = ws.solve()
    assert _solved(cold)
    assert {lv[0] for lv in ws.levels} == {"fast", "polish"}
    warm = ws.solve(warm_start=True)
    assert _solved(warm)
    assert int(warm.iters.sum()) <= int(cold.iters.sum())
    np.testing.assert_allclose(warm.pobj.numpy(), opts, atol=1e-4, rtol=1e-4)


# ---- time limit and SIGINT (tests/test_batch_limits.py) ----

def _limits_setup(count=4):
    spec = ConeSpec(l=20, q=(6,))
    A, _, b, c, opts = _stack(spec, 10, count)
    return spec, A, b, c, torch.zeros(count, 0), opts


@pytest.mark.parametrize("mixed", [False, True])
def test_batched_time_limit_pre_expired(mixed):
    spec, A, b, c, bnd, _ = _limits_setup()
    stg = Settings(linsys="direct", mixed_precision=mixed,
                   time_limit_secs=1e-9, chunk_iters=25)
    res = make_chunked_batch_solver(spec, stg, device="cpu",
                                    ds_split=mixed)(A, b, c, bnd, bnd)
    status = res.status.numpy()
    assert np.all(np.isin(status, _INACCURATE)), status
    assert np.all(res.iters.numpy() == 0)


def test_batch_workspace_time_limit():
    spec, A, b, c, bnd, _ = _limits_setup()
    stg = Settings(linsys="direct", time_limit_secs=1e-9)
    ws = BatchWorkspace(spec, stg, A, None, b, c, device="cpu")
    assert np.all(np.isin(ws.solve().status.numpy(), _INACCURATE))


def test_generous_time_limit_still_solves():
    spec, A, b, c, bnd, opts = _limits_setup()
    stg = Settings(linsys="direct", time_limit_secs=600.0, chunk_iters=25)
    res = make_chunked_batch_solver(spec, stg, device="cpu")(A, b, c, bnd,
                                                             bnd)
    assert _solved(res)
    np.testing.assert_allclose(res.pobj.numpy(), opts, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("mixed", [False, True])
def test_sigint_finalizes_with_status_minus5(monkeypatch, mixed):
    """A KeyboardInterrupt raised in the middle of a step (here: the
    80th linear solve) stops the solve; running lanes finalize as
    interrupted (-5) with NaN solutions, and the steps made before it
    count."""
    spec, A, b, c, bnd, _ = _limits_setup()
    stg = Settings(linsys="direct", mixed_precision=mixed, eps_abs=1e-15,
                   eps_rel=0.0, chunk_iters=25, max_iters=1_000_000)
    solve = make_chunked_batch_solver(spec, stg, device="cpu",
                                      ds_split=mixed)
    calls = [0]
    real = direct.solve_batched

    def interrupted(*args):
        calls[0] += 1
        if calls[0] == 80:
            raise KeyboardInterrupt
        return real(*args)

    monkeypatch.setattr(direct, "solve_batched", interrupted)
    res = solve(A, b, c, bnd, bnd)
    assert calls[0] == 80
    assert torch.all(res.status == config.SIGINT), res.status
    assert torch.all(torch.isnan(res.x))
    assert torch.all(res.iters > 0)


# ---- the rules of the entry points ----

def test_entry_points_refuse_the_cpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, A, P, b, c, _ = _setup(count=2)
    builders = [
        lambda: make_batch_solver(spec, STG),
        lambda: make_chunked_batch_solver(spec, STG),
        lambda: make_pure_solver(spec, STG),
        lambda: make_solver_parts(spec, STG),
        lambda: make_restart_fn(spec, STG, True),
        lambda: batch_mod.make_repair_fn(spec, STG),
        lambda: BatchWorkspace(spec, STG, A, None, b, c),
    ]
    for build in builders:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert _solved(make_batch_solver(spec, STG, device="cpu")(
        A, b, c, torch.zeros(2, 0), torch.zeros(2, 0)))


@pytest.mark.parametrize("kw", [
    dict(linsys="direct", verbose=True),
    dict(linsys="direct", profile_phases=True),
    dict(linsys="direct", psd_rank=2),
])
def test_parts_outside_the_slice_raise(kw):
    """The settings that raised until ROADMAP items 13 and 14 were ported
    are taken, as by the JAX package's batched solvers: verbose and
    profile_phases change nothing there, and psd_rank (no PSD cone here)
    gives the same lanes."""
    spec, A, P, b, c, _ = _setup(count=3)
    bnd = torch.zeros(3, 0)
    ref = make_chunked_batch_solver(spec, STG, device="cpu")(A, b, c, bnd,
                                                             bnd)
    res = make_chunked_batch_solver(spec, Settings(**kw), device="cpu")(
        A, b, c, bnd, bnd)
    assert _solved(res)
    assert torch.equal(res.x, ref.x) and torch.equal(res.iters, ref.iters)


def test_macro_schedule_is_accepted_and_changes_nothing():
    spec, A, P, b, c, _ = _setup(count=3)
    bnd = torch.zeros(3, 0)
    runs = [make_batch_solver(spec, Settings(linsys="direct",
                                             macro_schedule=ms),
                              device="cpu")(A, b, c, bnd, bnd)
            for ms in (None, False, True)]
    for r in runs[1:]:
        assert torch.equal(r.x, runs[0].x)


# ---- the batched modules, lane by lane ----

@pytest.mark.parametrize("with_P", [False, True])
def test_equilibrate_batched_is_per_problem(with_P):
    spec = ConeSpec(z=5, l=20, q=(5, 5, 5, 10))
    A, P, b, c, _ = _stack(spec, 30, 3, with_P=with_P)
    bA, bP, bscal = eq.equilibrate_batched(A, P, spec)
    bb, bc, bscal = eq.normalize_b_c_batched(bscal, b, c)
    for i in range(3):
        tA, tP, scal = eq.equilibrate(A[i], None if P is None else P[i],
                                      spec)
        tb, tc, scal = eq.normalize_b_c(scal, b[i], c[i])
        pairs = [(bA[i], tA), (bscal.D[i], scal.D), (bscal.E[i], scal.E),
                 (bb[i], tb), (bc[i], tc),
                 (bscal.primal_scale[i], scal.primal_scale)]
        if with_P:
            pairs.append((bP[i], tP))
        for got, ref in pairs:
            torch.testing.assert_close(got, ref, rtol=1e-13, atol=0)


def test_proj_dual_cone_batched_is_per_problem():
    spec = ConeSpec(z=3, l=7, q=(1, 4, 4, 2, 9, 1))
    rng = np.random.RandomState(5)
    x = torch.tensor(rng.randn(4, spec.dims()) * 3)
    r = torch.tensor(rng.uniform(0.01, 10.0, (4, spec.dims())))
    got, _ = project.proj_dual_cone_batched(x, spec, None, None, r)
    for i in range(4):
        torch.testing.assert_close(
            got[i], project.proj_dual_cone(x[i], spec, None, None, r[i])[0],
            rtol=1e-13, atol=1e-13)
    uniform = ConeSpec(l=2, q=(3, 3))
    xu = x[:, :uniform.dims()]
    got, _ = project.proj_cone_batched(xu, uniform)
    for i in range(4):
        torch.testing.assert_close(got[i],
                                   project.proj_cone(xu[i], uniform)[0],
                                   rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("mixed, ds", [(False, False), (True, False),
                                       (True, True)])
def test_direct_solve_batched_is_per_problem(mixed, ds):
    spec = ConeSpec(z=5, l=20, q=(5, 5, 5, 10))
    A, P, _, _, _ = _stack(spec, 30, 3, with_P=True)
    B, m, n = A.shape
    scale = torch.tensor([0.1, 3.0, 0.02], dtype=torch.float64)
    dr = solver_batched.set_diag_r_batched(spec, n, m, scale, 1e-6)
    rhs = torch.tensor(np.random.RandomState(1).randn(B, n + m))
    bm = Mats(A, P, direct.precompute_batched(A, P, spec.z, ds=ds))
    got, _ = direct.solve_batched(
        bm, dr, direct.derive_batched(bm, dr, scale, mixed=mixed), rhs)
    for i in range(B):
        tm = Mats(A[i], P[i], direct.precompute(A[i], P[i], spec.z, ds=ds))
        ref, _ = direct.solve(tm, dr[i], direct.derive(tm, dr[i], scale[i],
                                                       mixed=mixed), rhs[i])
        rel = float(torch.linalg.vector_norm(got[i] - ref)
                    / torch.linalg.vector_norm(ref))
        assert rel < 1e-10, (i, rel)


def test_failed_factor_stays_in_its_lane():
    spec = ConeSpec(l=20)
    A, _, _, _, _ = _stack(spec, 8, 3)
    P = torch.zeros(3, 8, 8, dtype=torch.float64)
    P[1] = -torch.eye(8) * 1e3                  # not PSD: lane 1 fails
    scale = torch.full((3,), 0.1, dtype=torch.float64)
    dr = solver_batched.set_diag_r_batched(spec, 8, 20, scale, 1e-6)
    bm = Mats(A, P, direct.precompute_batched(A, P, 0))
    for mixed in (False, True):
        der = direct.derive_batched(bm, dr, scale, mixed=mixed)
        factor = der[0] if mixed else der
        finite = torch.isfinite(factor).flatten(1).all(1)
        assert finite.tolist() == [True, False, True]


@pytest.mark.parametrize("kw", [
    dict(type1=True), dict(type1=False),
    dict(type1=True, max_weight_norm=1.0),
    dict(type1=False, relaxation=0.7),
    dict(type1=True, gamma_f32=True),
])
def test_anderson_batched_is_per_lane(kw):
    """Each lane of the batched accelerator follows the one-problem
    accelerator on its own sequence: the same accept/reject decisions and
    counters, and the same points to 1e-9 in float64. With float32 gammas
    the two QR implementations round differently and the ill-conditioned
    history amplifies that, so the points agree to 1e-1 there; the
    decisions still agree."""
    mem, l, B = 5, 12, 3
    base = dict(mem=mem, regularization=1e-8, relaxation=1.0)
    base.update(kw)
    rtol = 1e-1 if kw.get("gamma_f32") else 1e-9
    seqs = []
    for seed in range(B):
        rng = np.random.RandomState(4 + seed)
        M = rng.randn(l, l)
        M *= 0.95 / np.max(np.abs(np.linalg.eigvals(M)))
        cc = rng.randn(l)
        x = rng.randn(l)
        xs, fs = [], []
        for k in range(36):
            f = M @ x + cc + (0.3 * rng.randn(l) if k % 7 == 3 else 0.0)
            xs.append(x)
            fs.append(f)
            x = f
        seqs.append((xs, fs))
    singles = [accel.aa_init(l, mem, torch.float64, "cpu") for _ in range(B)]
    bat = accel.aa_init_batched(B, l, mem, torch.float64, "cpu")

    def rows(k, which):
        return torch.tensor(np.stack([s[which][k] for s in seqs]))

    for k in range(35):
        F, X = rows(k, 1), rows(k, 0)
        bat, bf, bn = accel.aa_apply_batched(bat, F, X, **base)
        for i in range(B):
            singles[i], tf, tn = accel.aa_apply(singles[i], F[i], X[i],
                                                **base)
            assert (float(tn) > 0) == (float(bn[i]) > 0)
            scale = float(torch.linalg.vector_norm(F[i])) + 1.0
            assert float((tf - bf[i]).abs().max()) <= rtol * scale
        gate = bn > 0
        st, _, _, rej = accel.aa_safeguard_batched(bat, rows(k + 1, 1),
                                                   rows(k + 1, 0))
        bat = accel.select_lanes(gate, st, bat)
        for i in range(B):
            if bool(gate[i]):
                singles[i], _, _, trej = accel.aa_safeguard(
                    singles[i], rows(k + 1, 1)[i], rows(k + 1, 0)[i])
                assert bool(trej) == bool(rej[i])
    for name in ("it", "n_accept", "n_reject", "n_safeguard_reject"):
        assert ([int(getattr(s, name)) for s in singles]
                == getattr(bat, name).tolist()), name
