"""The tracked-rank PSD projection (`Settings.psd_rank`) of scs_tpu_torch
against the JAX package on the CPU.

`psd_project_warm` takes the same seeded numpy M and P_prev through both
packages (`tests/test_subspace.py`'s cases: an exact warm range, a drifted
one, a saturated rank, a garbage warm range at a tight tolerance, and
twelve matrices with a positive eigenvalue hidden outside the warm
range): the certificates are equal and the projections agree within
1e-10 (1 + ||M||_F), every input away from the gate's threshold. QR and
eigh may pick other signs than LAPACK's: the projection depends only on
the spans.

Solves of the planted low-rank SDP (`models.planted_lowrank_sdp`, the JAX
tests' instance draw for draw) with psd_rank against the JAX package's
psd_rank solve: the same status, the objective within 1e-6 (1 + |opt|)
of it, and an iteration count within [0.8, 1.25] (the gate may decide
otherwise near its threshold and move the trajectory). A psd_rank too
small for the solution still solves (nearly every gate fails); a
complex-PSD block; a warm re-solve sequence against the exact path; and a
batch with psd_rank against the batch without, lane by lane, whose gate
is decided per lane: failing lanes take the exact eigh, bit for bit that
of the exact projection."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

import scs_tpu
from scs_tpu.cones import psd as j_psd
from scs_tpu.ops.subspace import psd_project_warm as j_warm
from scs_tpu_torch import Settings, Workspace, config, convert
from scs_tpu_torch.cones import psd
from scs_tpu_torch.models import planted_lowrank_sdp
from scs_tpu_torch.ops.subspace import psd_project_warm
from scs_tpu_torch.parallel import make_chunked_batch_solver


def _rand_indef(n, r, seed=0):
    """Symmetric matrix with exactly r positive eigenvalues."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.randn(n, n))
    lam = np.concatenate([rng.rand(r) + 0.5, -(rng.rand(n - r) + 0.1)])
    M = (Q * lam) @ Q.T
    return 0.5 * (M + M.T), Q, lam


def _warm_cases():
    n, r = 80, 6
    M, Q, lam = _rand_indef(n, r)
    P_exact = (Q * np.maximum(lam, 0)) @ Q.T
    rng = np.random.RandomState(1)
    drift = P_exact + 1e-6 * rng.randn(n, n)
    cases = {
        "exact warm": (M, P_exact, r + 10, 1e-7),
        "drifted warm": (M, 0.5 * (drift + drift.T), r + 10, 1e-4),
        "saturated rank": (M, P_exact, 3, 1e-4),
        "garbage warm": (M, rng.randn(n, n), r + 10, 1e-9),
    }
    # tests/test_subspace.py:200: positive eigenvalues outside the range
    rng = np.random.RandomState(0)
    Q, _ = np.linalg.qr(rng.randn(n, n))
    lam = np.concatenate([rng.rand(r) + 0.5, -(rng.rand(n - r) + 0.1)])
    for trial in range(12):
        theta = 10 ** rng.uniform(-4, -1.5)
        lam2 = lam.copy()
        lam2[r + 1 + trial % (n - r - 2)] = theta
        Mh = (Q * lam2) @ Q.T
        Ph = (Q[:, :r] * np.maximum(lam2[:r], 0)) @ Q[:, :r].T
        cases[f"hidden {trial}"] = (0.5 * (Mh + Mh.T), Ph, r + 10, 1e-7)
    return cases


WARM_CASES = _warm_cases()


@pytest.mark.parametrize("case", list(WARM_CASES))
def test_psd_project_warm_matches_jax(case):
    M, P, k, tol = WARM_CASES[case]
    j_proj, j_ok = j_warm(jnp.asarray(M), jnp.asarray(P), rank=k, tol=tol)
    proj, ok = psd_project_warm(torch.tensor(M), torch.tensor(P), k, tol)
    assert bool(ok) == bool(j_ok)
    err = np.abs(proj.numpy() - np.asarray(j_proj)).max()
    assert err <= 1e-10 * (1 + np.linalg.norm(M)), err
    if case == "exact warm":
        assert bool(ok)


def test_psd_project_warm_batched_equals_one_by_one():
    """A stack of (M, P_prev) pairs with their own tolerances gives each
    pair's own answer."""
    names = ["exact warm", "saturated rank", "garbage warm", "hidden 3"]
    Ms = torch.tensor(np.stack([WARM_CASES[c][0] for c in names]))
    Ps = torch.tensor(np.stack([WARM_CASES[c][1] for c in names]))
    tol = torch.tensor([WARM_CASES[c][3] for c in names],
                       dtype=torch.float64)
    proj, ok = psd_project_warm(Ms, Ps, 16, tol)
    for i, c in enumerate(names):
        p1, ok1 = psd_project_warm(Ms[i], Ps[i], 16, tol[i])
        assert bool(ok[i]) == bool(ok1)
        assert torch.allclose(proj[i], p1, rtol=0, atol=1e-12)


def test_gate_is_decided_lane_by_lane():
    """A batch of PSD blocks (B lanes, one block each): lanes whose warm
    range is exact pass the gate and return the subspace projection; the
    others take the exact eigh, gathered and scattered back, bit for bit
    the plain projection of those lanes."""
    ns, r, B = 20, 3, 5
    rng = np.random.RandomState(2)
    v, warm = [], []
    for i in range(B):
        Mi, Qi, lam = _rand_indef(ns, r, seed=10 + i)
        v.append(psd.mat_to_svec(torch.tensor(Mi), ns))
        Pi = (Qi * np.maximum(lam, 0)) @ Qi.T
        warm.append(psd.mat_to_svec(torch.tensor(
            Pi if i % 2 == 0 else rng.randn(ns, ns)), ns))
    v = torch.stack(v)[:, None]             # (B, 1, tri)
    warm = torch.stack(warm)[:, None]
    psd.gate_checks = psd.gate_passes = 0
    out = psd.proj_psd_batch(v, ns, warm=warm, psd_rank=4)
    assert (psd.gate_checks, psd.gate_passes) == (B, 3)
    exact = psd.proj_psd_batch(v, ns)
    for i in (1, 3):
        assert torch.equal(out[i], exact[i])
    for i in (0, 2, 4):
        assert not torch.equal(out[i], exact[i])
        assert torch.allclose(out[i], exact[i], rtol=0, atol=1e-10)


def _jax_lowrank_sdp(ns=16, r=3, n=10, seed=0):
    """`tests/test_subspace.py:59-80`, with the JAX package's packing."""
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
    y[:2] = rng.rand(2) + 0.5
    s[2:l] = rng.rand(l - 2) + 0.5
    s[l:] = np.asarray(j_psd.mat_to_svec(jnp.asarray(S), ns))
    y[l:] = np.asarray(j_psd.mat_to_svec(jnp.asarray(Y), ns))
    x = rng.randn(n)
    return A, A @ x + s, -A.T @ y, float((-A.T @ y) @ x)


def test_planted_lowrank_sdp_is_the_jax_tests_instance():
    A, b, c, opt = _jax_lowrank_sdp()
    p = planted_lowrank_sdp()
    assert np.array_equal(p.problem.A.numpy(), A)
    assert np.array_equal(p.problem.b.numpy(), b)
    assert np.array_equal(p.problem.c.numpy(), c)
    assert p.opt == opt


SOLVES = {
    "direct pure": dict(linsys="direct", mixed_precision=False),
    "indirect pure": dict(linsys="indirect", mixed_precision=False),
    "direct mixed": dict(linsys="direct", mixed_precision=True),
}


def _jax_solve(p, kw):
    jprob = scs_tpu.Problem(A=jnp.asarray(p.problem.A.numpy()),
                            b=jnp.asarray(p.problem.b.numpy()),
                            c=jnp.asarray(p.problem.c.numpy()))
    jspec = scs_tpu.ConeSpec(**dataclasses.asdict(p.spec))
    return scs_tpu.solve(jprob, jspec, settings=scs_tpu.Settings(**kw))


@pytest.fixture(scope="module")
def jax_tracked():
    """The JAX package's psd_rank solves of the planted SDP, one a mode
    (shared by the cases below)."""
    p = planted_lowrank_sdp()
    return {name: _jax_solve(p, dict(kw, eps_abs=1e-7, eps_rel=1e-7,
                                     psd_rank=6))[1]
            for name, kw in SOLVES.items()}


@pytest.mark.parametrize("mode", list(SOLVES))
def test_tracked_solve_matches_jax(mode, jax_tracked):
    p = planted_lowrank_sdp()
    stg = Settings(eps_abs=1e-7, eps_rel=1e-7, psd_rank=6, **SOLVES[mode])
    psd.gate_checks = psd.gate_passes = 0
    ws = Workspace(p.problem, p.spec, p.cone_data, stg, device="cpu",
                   ds_split=True if "mixed" in mode else None)
    _, info = ws.solve()
    jinfo = jax_tracked[mode]
    assert info.status == jinfo.status == "solved"
    assert abs(info.pobj - jinfo.pobj) <= 1e-6 * (1 + abs(p.opt))
    assert abs(info.pobj - p.opt) <= 1e-5 * (1 + abs(p.opt))
    assert 0.8 <= info.iter / jinfo.iter <= 1.25, (info.iter, jinfo.iter)
    # the tracked path ran and its certificate passed on the tail
    assert psd.gate_checks > 0 and psd.gate_passes > 0


def test_rank_too_small_still_solves():
    """psd_rank 2 against a rank-6 solution: the headroom check fails on
    all but a few early projections (an iterate with fewer than two
    positive eigenvalues), and the solve runs the exact eigh."""
    p = planted_lowrank_sdp(ns=12, r=6)
    psd.gate_checks = psd.gate_passes = 0
    _, info = Workspace(p.problem, p.spec, p.cone_data,
                        Settings(eps_abs=1e-7, eps_rel=1e-7, psd_rank=2),
                        device="cpu").solve()
    assert info.status_val == config.SOLVED
    assert abs(info.pobj - p.opt) < 1e-5 * (1 + abs(p.opt))
    assert psd.gate_checks > 0
    assert psd.gate_passes <= 0.05 * psd.gate_checks


def _cpsd_problem():
    """`tests/test_subspace.py:test_cpsd_tracked_rank_matches_exact`."""
    rng = np.random.RandomState(4)
    ns, r, n, l = 10, 2, 8, 4
    full = ns * ns
    m = l + full
    A = rng.randn(m, n)
    H = rng.randn(ns, ns) + 1j * rng.randn(ns, ns)
    Q, _ = np.linalg.qr(H)
    S = (Q[:, :r] * (rng.rand(r) + 0.5)) @ Q[:, :r].conj().T
    Y = (Q[:, r:] * (rng.rand(ns - r) + 0.5)) @ Q[:, r:].conj().T

    def pack(M):
        diag_idx, re_idx, im_idx, lo_r, lo_c = j_psd._cplx_indices(ns)
        out = np.zeros(full)
        out[diag_idx] = np.diag(M).real
        out[re_idx] = M[lo_r, lo_c].real * np.sqrt(2.0)
        out[im_idx] = M[lo_r, lo_c].imag * np.sqrt(2.0)
        return out

    y = np.zeros(m)
    s = np.zeros(m)
    y[:2] = rng.rand(2) + 0.5
    s[2:l] = rng.rand(2) + 0.5
    s[l:] = pack(S)
    y[l:] = pack(Y)
    x = rng.randn(n)
    return A, A @ x + s, -A.T @ y, float((-A.T @ y) @ x), ns


def test_complex_block_tracked_matches_jax():
    A, b, c, opt, ns = _cpsd_problem()
    jspec = scs_tpu.ConeSpec(l=4, cs=(ns,))
    jstg = scs_tpu.Settings(eps_abs=1e-7, eps_rel=1e-7, psd_rank=4)
    _, jinfo = scs_tpu.solve(scs_tpu.Problem(A=jnp.asarray(A),
                                             b=jnp.asarray(b),
                                             c=jnp.asarray(c)),
                             jspec, settings=jstg)
    prob = convert.problem_from_numpy(A, b, c)
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    psd.gate_checks = psd.gate_passes = 0
    sol, info = Workspace(prob, spec, None,
                          convert.settings_from_dict(
                              dataclasses.asdict(jstg)),
                          device="cpu").solve()
    assert info.status == jinfo.status == "solved"
    assert abs(info.pobj - jinfo.pobj) <= 1e-6 * (1 + abs(opt))
    assert abs(info.pobj - opt) <= 1e-5 * (1 + abs(opt))
    assert 0.8 <= info.iter / jinfo.iter <= 1.25, (info.iter, jinfo.iter)
    assert psd.gate_checks > 0


def test_warm_resolve_sequence_tracks_exact():
    """The JAX tests' MPC-style sequence: b moved inside range(A), a warm
    re-solve with psd_rank beside one without, three times."""
    p = planted_lowrank_sdp()
    w = Workspace(p.problem, p.spec, p.cone_data,
                  Settings(eps_abs=1e-7, eps_rel=1e-7, psd_rank=6),
                  device="cpu")
    w0 = Workspace(p.problem, p.spec, p.cone_data,
                   Settings(eps_abs=1e-7, eps_rel=1e-7), device="cpu")
    sol, _ = w.solve()
    sol0, _ = w0.solve()
    A, b = p.problem.A.numpy(), p.problem.b.numpy()
    rng = np.random.RandomState(3)
    for _ in range(3):
        b = b + A @ (1e-3 * rng.randn(A.shape[1]))
        w.update(b=b)
        w0.update(b=b)
        sol, info = w.solve(warm_start=True, sol=sol)
        sol0, info0 = w0.solve(warm_start=True, sol=sol0)
        assert info.status_val == info0.status_val == config.SOLVED
        assert abs(info.pobj - info0.pobj) < 1e-5 * (1 + abs(info0.pobj))
        np.testing.assert_allclose(sol.x, sol0.x, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("mode", ["pure", "mixed"])
def test_batch_with_tracked_rank_against_without(mode):
    """Four planted SDPs (seeds 0-3) batched, with psd_rank and without:
    the same statuses, every lane within 1e-5 (1 + |opt|) of its planted
    optimum. Mixed: float32 state (the splits' plain versions), the gate
    in float32."""
    ps = [planted_lowrank_sdp(seed=s) for s in range(4)]
    A = torch.stack([p.problem.A for p in ps])
    b = torch.stack([p.problem.b for p in ps])
    c = torch.stack([p.problem.c for p in ps])
    bnd = torch.zeros(4, 0, dtype=torch.float64)
    opt = np.array([p.opt for p in ps])
    kw = (dict(mixed_precision=False) if mode == "pure"
          else dict(mixed_precision=True))
    out = {}
    for rank in (0, 6):
        psd.gate_checks = psd.gate_passes = 0
        res = make_chunked_batch_solver(
            ps[0].spec, Settings(linsys="direct", eps_abs=1e-6, eps_rel=1e-6,
                                 psd_rank=rank, **kw),
            device="cpu", ds_split=mode == "mixed" or None)(A, b, c, bnd,
                                                           bnd)
        out[rank] = res
        if rank:
            assert psd.gate_checks > 0 and psd.gate_passes > 0
    assert torch.equal(out[0].status, out[6].status)
    assert bool((out[6].status == config.SOLVED).all())
    err = np.abs(out[6].pobj.numpy() - opt) / (1 + np.abs(opt))
    assert err.max() <= 1e-5, err
