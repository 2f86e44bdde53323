"""The PSD and complex-PSD cones of scs_tpu_torch against the JAX package on
the CPU.

Cone functions: the same numpy inputs through both packages, for block
sizes ns in {1, 2, 5, 8}, random blocks plus a clustered spectrum and a
rank-deficient block: float64 within 1e-12 (1 + |v|), float32 within
1e-5 (1 + |v|), |v| the block's largest entry. The packing indices equal
the JAX package's element for element; the native complex path agrees
with the 2ns x 2ns real embedding (a numpy plain check here) to 1e-10 in
float64 and 5e-4 in float32 (tests/test_cones.py's bounds).

Solves (`tests/test_solve.py`'s PSD specs): pure float64 direct gives the
same status, the same iteration count and the objective within 1e-8
(1 + |pobj|); mixed with float64 state gives the same status and the
objective within 1e-4 (1 + |pobj|), and both packages take the forced
float64 polish (`ConeSpec.f32_polish_cones`); the indirect backend's
count is within [0.8, 1.25] of the JAX package's; an infeasible PSD
instance returns the certificate through the forced polish in both.
Batched (`make_chunked_batch_solver`, 4 lanes): pure float64 counts
equal; mixed with float64 state counts within [0.8, 1.25], and the port
polishes the lanes the JAX package polishes; mixed with float32 state
(the card's default) the same statuses, objectives within 1e-4
(1 + |pobj|), the same polished lanes and the batch's lane-iterations
within [0.8, 1.25]."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

import scs_tpu
from scs_tpu import api as j_api
from scs_tpu import equilibrate as j_eq
from scs_tpu import models as j_models
from scs_tpu.cones import project as j_project
from scs_tpu.cones import psd as j_psd
from scs_tpu.parallel import make_chunked_batch_solver as j_make_chunked
from scs_tpu_torch import Workspace, api, config, convert, equilibrate
from scs_tpu_torch import models as t_models
from scs_tpu_torch.cones import project, psd, segments
from scs_tpu_torch.models import psd_cones
from scs_tpu_torch.parallel import make_chunked_batch_solver

F64 = jnp.float64
SIZES = [1, 2, 5, 8]


def _blocks(rng, ns, count, cplx=False):
    """`count` packed blocks of dimension ns: random ones, one with a
    clustered spectrum (eigenvalues 1 +- 1e-7 and -1 +- 1e-7) and one of
    rank ns // 2, as (count + 2, width) numpy arrays."""
    width = ns * ns if cplx else ns * (ns + 1) // 2
    out = [rng.randn(count, width) * 2.0]
    for w in (np.where(np.arange(ns) % 2 == 0, 1.0, -1.0)
              + 1e-7 * rng.randn(ns),
              np.where(np.arange(ns) < ns // 2, rng.rand(ns) + 0.5, 0.0)):
        if cplx:
            Q, _ = np.linalg.qr(rng.randn(ns, ns) + 1j * rng.randn(ns, ns))
        else:
            Q, _ = np.linalg.qr(rng.randn(ns, ns))
        M = (Q * w) @ Q.conj().T
        out.append(_pack(M, ns, cplx)[None])
    return np.concatenate(out)


def _pack(M, ns, cplx):
    """numpy packing of a symmetric or Hermitian matrix (the JAX
    package's index arrays)."""
    if not cplx:
        _, _, r, c, scale = j_psd._tri_indices(ns)
        return M[r, c].real * scale
    diag_idx, re_idx, im_idx, lo_r, lo_c = j_psd._cplx_indices(ns)
    v = np.zeros(ns * ns)
    v[diag_idx] = np.diag(M).real
    v[re_idx] = M[lo_r, lo_c].real * np.sqrt(2.0)
    v[im_idx] = M[lo_r, lo_c].imag * np.sqrt(2.0)
    return v


def _close(got, ref, v, rtol):
    scale = 1.0 + np.abs(v).max(axis=-1, keepdims=True)
    err = np.abs(got - ref) / scale
    assert err.max() <= rtol, err.max()


# ---- packing ----

@pytest.mark.parametrize("ns", SIZES)
def test_packing_matches_jax(ns):
    for got, ref in zip(psd._tri_indices(ns), j_psd._tri_indices(ns)):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(psd._cplx_indices(ns), j_psd._cplx_indices(ns)):
        np.testing.assert_array_equal(got, ref)
    rng = np.random.RandomState(ns)
    tri = ns * (ns + 1) // 2
    v = rng.randn(3, tri)
    M = psd.svec_to_mat(torch.as_tensor(v), ns)
    np.testing.assert_array_equal(
        M.numpy(), np.stack([np.asarray(j_psd.svec_to_mat(
            jnp.asarray(vi, F64), ns)) for vi in v]))
    np.testing.assert_array_equal(M.numpy(), M.transpose(1, 2).numpy())
    np.testing.assert_allclose(psd.mat_to_svec(M, ns).numpy(), v,
                               rtol=0, atol=1e-15)
    # svec keeps inner products: <svec(A), svec(B)> = <A, B>_F
    w = rng.randn(3, tri)
    N = psd.svec_to_mat(torch.as_tensor(w), ns)
    np.testing.assert_allclose((v * w).sum(1), (M * N).sum((1, 2)).numpy(),
                               rtol=1e-13, atol=1e-13)


# ---- projections ----

@pytest.mark.parametrize("cplx", [False, True], ids=["psd", "cpsd"])
@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_projection_matches_jax(cplx, f32):
    """Every block size at once, each through both packages; the port's
    blocks with a leading batch axis (2, k, width), as a batch projects."""
    j_fn = j_psd.proj_cpsd_batch if cplx else j_psd.proj_psd_batch
    t_fn = psd.proj_cpsd_batch if cplx else psd.proj_psd_batch
    rng = np.random.RandomState(7 + cplx)
    for ns in SIZES:
        v = _blocks(rng, ns, 6, cplx)
        ref = np.asarray(j_fn(jnp.asarray(v, F64), ns, f32_eig=f32))
        got = t_fn(torch.as_tensor(v).reshape(2, -1, v.shape[1]), ns,
                   f32_eig=f32).reshape(v.shape)
        assert got.dtype == torch.float64
        _close(got.numpy(), ref, v, 1e-5 if f32 else 1e-12)
        if f32:   # float32 in and out, as with float32 state
            got32 = t_fn(torch.as_tensor(v, dtype=torch.float32), ns)
            assert got32.dtype == torch.float32
            _close(got32.double().numpy(), ref, v, 1e-5)


def _embedding_projection(v, ns):
    """numpy plain check: the complex-PSD projection through the real
    embedding E(M) = [Re, -Im; Im, Re] (each eigenvalue of M doubled)."""
    out = []
    for vi in v:
        diag_idx, re_idx, im_idx, lo_r, lo_c = j_psd._cplx_indices(ns)
        M = np.diag(vi[diag_idx]).astype(complex)
        M[lo_r, lo_c] = (vi[re_idx] + 1j * vi[im_idx]) / np.sqrt(2.0)
        M[lo_c, lo_r] = np.conj(M[lo_r, lo_c])
        E = np.block([[M.real, -M.imag], [M.imag, M.real]])
        w, V = np.linalg.eigh(E)
        Ep = (V * np.maximum(w, 0.0)) @ V.T
        Mp = (0.5 * (Ep[:ns, :ns] + Ep[ns:, ns:])
              + 0.5j * (Ep[ns:, :ns] - Ep[:ns, ns:]))
        out.append(_pack(Mp, ns, True))
    return np.stack(out)


def test_cpsd_native_matches_embedding():
    rng = np.random.RandomState(15)
    for ns in (2, 4, 7):
        v = _blocks(rng, ns, 2, cplx=True)
        ref = _embedding_projection(v, ns)
        got = psd.proj_cpsd_batch(torch.as_tensor(v), ns).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
        got32 = psd.proj_cpsd_batch(torch.as_tensor(v), ns,
                                    f32_eig=True).numpy()
        np.testing.assert_allclose(got32, ref, rtol=0, atol=5e-4)


MIXED_SPEC = dict(z=2, l=3, q=(3, 4), s=(3, 3, 2), cs=(2,), ep=1, ed=1,
                  p=(0.3, -0.6))


def test_moreau_identity_and_dual_cone_match_jax():
    """Pi_K(x) + Pi_{K polar}(x) = x with the two parts orthogonal, on a
    layout of every ported family with PSD runs of equal sizes; the
    port's dual projection equals the JAX package's, for one problem and
    for each row of a batch."""
    jspec = scs_tpu.ConeSpec(**MIXED_SPEC)
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    m = spec.dims()
    cd = scs_tpu.ConeData.make(jspec, dtype=F64)
    tcd = convert.cone_data_from_numpy(spec)
    rng = np.random.RandomState(8)
    x = rng.uniform(-2, 2, (3, m))
    j_proj = jax.jit(lambda xi: j_project.proj_dual_cone(
        xi, jspec, cd, jnp.ones(()), None)[0])
    ref = np.stack([np.asarray(j_proj(jnp.asarray(xi, F64))) for xi in x])
    one = project.proj_dual_cone(torch.as_tensor(x[0]), spec, tcd, None,
                                 None)[0].numpy()
    rows = project.proj_dual_cone(torch.as_tensor(x), spec, tcd, None,
                                  None)[0].numpy()
    _close(one[None], ref[:1], x[:1], 1e-12)
    _close(rows, ref, x, 1e-12)
    # Moreau: Pi_K(x) = x + Pi_{K*}(-x); Pi_{K polar}(x) = -Pi_{K*}(-x)
    neg = project.proj_dual_cone(torch.as_tensor(-x), spec, tcd, None,
                                 None)[0].numpy()
    pk = project.proj_cone(torch.as_tensor(x), spec, tcd)[0].numpy()
    np.testing.assert_allclose(pk, x + neg, rtol=0, atol=1e-9)
    assert np.abs((pk * -neg).sum(1)).max() <= 1e-9 * np.abs(x).max()


def test_layout_and_unported_cones():
    """The PSD layout's offsets; each spectral family added to it (the
    specs that raised until the spectral cones came in) lays out with the
    JAX package's offsets and projects as it does, within 1e-10
    (1 + |v|)."""
    jspec = scs_tpu.ConeSpec(**MIXED_SPEC)
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    lay = project.ConeLayout.make(spec)
    assert (lay.q_off, lay.s_off, lay.cs_off, lay.exp_off, lay.pow_off,
            lay.total) == (5, 12, 12 + 6 + 6 + 3, 31, 37, 43)
    assert lay.total == spec.dims()
    rng = np.random.RandomState(12)
    for extra in (dict(d=(3,)), dict(nuc_m=(2,), nuc_n=(2,)),
                  dict(ell1=(3,)), dict(sl_n=(3,), sl_k=(1,))):
        jext = dataclasses.replace(jspec, **extra)
        ext = dataclasses.replace(spec, **extra)
        jl, tl = j_project.ConeLayout.make(jext), project.ConeLayout.make(ext)
        for f in dataclasses.fields(jl):
            if f.name != "spec":
                assert getattr(tl, f.name) == getattr(jl, f.name), f.name
        x = rng.randn(2, ext.dims()) * 2.0
        cd = scs_tpu.ConeData.make(jext, dtype=F64)
        j_proj = jax.jit(lambda xi, jext=jext, cd=cd: j_project.proj_cone(
            xi, jext, cd, jnp.ones(()), None)[0])
        ref = np.stack([np.asarray(j_proj(jnp.asarray(xi, F64))) for xi in x])
        got = project.proj_cone(torch.as_tensor(x), ext,
                                convert.cone_data_from_numpy(ext))[0]
        _close(got.numpy(), ref, x, 1e-10)


@pytest.mark.parametrize("kw", [
    dict(l=3), dict(l=3, q=(3,)), dict(l=2, s=(3,)), dict(cs=(2,)),
    dict(ep=1), dict(p=(0.5,)), dict(d=(3,)), dict(nuc_m=(2,), nuc_n=(2,)),
    dict(sl_n=(3,), sl_k=(1,)), dict(ell1=(2,)), MIXED_SPEC])
def test_spec_plumbing_matches_jax(kw):
    jspec = scs_tpu.ConeSpec(**kw)
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    assert spec.s == jspec.s and spec.cs == jspec.cs
    assert spec.dims() == jspec.dims()
    assert spec.f32_polish_cones == jspec.f32_polish_cones


def test_equilibration_and_segment_classes():
    """The cone-wise means of PSD segments equal the JAX package's; the
    large PSD configuration's one 4095-row segment gets a size class of
    its own instead of padding every segment to 4095."""
    jspec = scs_tpu.ConeSpec(z=2, l=3, s=(3, 2), cs=(2,))
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    rng = np.random.RandomState(3)
    A = rng.uniform(-1, 1, (spec.dims(), 5))
    jA, _, jscal = j_eq.equilibrate(jnp.asarray(A), None, jspec)
    tA, _, tscal = equilibrate.equilibrate(torch.as_tensor(A), None, spec)
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), rtol=1e-12)
    np.testing.assert_allclose(tscal.D.numpy(), np.asarray(jscal.D),
                               rtol=1e-12)
    big = psd_cones.large_psd_spec()
    assert big.dims() == 8192
    assert psd_cones.headline_psd_spec().dims() == 400
    sizes = equilibrate._segment_sizes(big)
    blocks, _ = segments._plan_np(sizes)
    assert sum(b.size for b in blocks) <= 2 * big.dims()
    assert sorted(b.shape[1] for b in blocks)[-1] == 4095


# ---- solves ----

SPECS = {"s": dict(l=5, s=(4, 4)), "cs": dict(l=4, cs=(3,)),
         "s_cs": dict(z=2, l=3, s=(3,), cs=(2, 2))}


def _planted(case):
    jspec = scs_tpu.ConeSpec(**SPECS[case])
    return j_models.gen_planted(jspec, n=6, seed=1), jspec


def _port(problem, jspec, jstg):
    prob = convert.problem_from_numpy(np.asarray(problem.A),
                                      np.asarray(problem.b),
                                      np.asarray(problem.c))
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    return prob, spec, convert.settings_from_dict(dataclasses.asdict(jstg))


PURE = scs_tpu.Settings(linsys="direct", mixed_precision=False)


@pytest.mark.parametrize("case", sorted(SPECS))
def test_pure_f64_solve_matches_jax(case):
    jp, jspec = _planted(case)
    jsol, jinfo = scs_tpu.solve(jp.problem, jspec, None, PURE)
    prob, spec, stg = _port(jp.problem, jspec, PURE)
    sol, info = Workspace(prob, spec, None, stg, device="cpu").solve()
    assert info.status == jinfo.status == "solved"
    assert info.iter == jinfo.iter
    assert abs(info.pobj - jinfo.pobj) <= 1e-8 * (1 + abs(jinfo.pobj))
    assert abs(info.pobj - jp.opt) <= 1e-3 * (1 + abs(jp.opt))
    # the port's generator draws the same instance through its own
    # float64 dual projection
    tp = t_models.gen_planted(spec, n=6, seed=1)
    np.testing.assert_array_equal(tp.problem.A.numpy(),
                                  np.asarray(jp.problem.A))
    for got, ref in ((tp.problem.b, jp.problem.b), (tp.y, jp.y)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=0, atol=1e-12)


def _spy_polish(monkeypatch):
    """Record each package's `_enter_polish_phase` decisions."""
    took = {"jax": [], "port": []}
    j_orig, t_orig = (j_api.Workspace._enter_polish_phase,
                      api.Workspace._enter_polish_phase)

    def j_spy(self, st):
        out = j_orig(self, st)
        took["jax"].append(bool(out[1]))
        return out

    def t_spy(self, st):
        out = t_orig(self, st)
        took["port"].append(out[1] is not None)
        return out

    monkeypatch.setattr(j_api.Workspace, "_enter_polish_phase", j_spy)
    monkeypatch.setattr(api.Workspace, "_enter_polish_phase", t_spy)
    return took


MIXED = scs_tpu.Settings(linsys="direct", mixed_precision=True)


@pytest.mark.parametrize("case", sorted(SPECS))
def test_mixed_solve_takes_the_forced_polish(case, monkeypatch):
    """Mixed with float64 state at the default eps (above the fast
    floor): the float32 PSD projections of the fast phase make both
    packages polish in float64."""
    took = _spy_polish(monkeypatch)
    jp, jspec = _planted(case)
    jsol, jinfo = scs_tpu.solve(jp.problem, jspec, None, MIXED)
    prob, spec, stg = _port(jp.problem, jspec, MIXED)
    ws = Workspace(prob, spec, None, stg, device="cpu")
    assert ws._mixed and ws._iteration.psd32
    assert not ws._polish_iteration.psd32
    sol, info = ws.solve()
    assert info.status == jinfo.status == "solved"
    assert abs(info.pobj - jinfo.pobj) <= 1e-4 * (1 + abs(jinfo.pobj))
    assert took == {"jax": [True], "port": [True]}


def test_exactness_polish_projects_exp_in_f64(monkeypatch):
    """A spec with PSD and exp cones, mixed, `exp_f32=True`, at the
    default eps: the polish only restores the PSD cones' exactness. The
    JAX package runs that polish with float32 exp; the port's one polish
    iteration projects every cone in float64 (ROADMAP R4), and reaches
    the same status and objective. The batched machinery builds the same
    polish iteration."""
    jspec = scs_tpu.ConeSpec(z=1, l=3, s=(3,), ep=1, ed=1)
    jp = j_models.gen_planted(jspec, n=6, seed=2)
    jstg = scs_tpu.Settings(linsys="direct", mixed_precision=True,
                            exp_f32=True)
    jsol, jinfo = scs_tpu.solve(jp.problem, jspec, None, jstg)
    prob, spec, stg = _port(jp.problem, jspec, jstg)
    ws = Workspace(prob, spec, None, stg, device="cpu")
    assert ws._iteration.exp32 and ws._iteration.psd32
    taken = []
    orig = ws._enter_polish_phase

    def spy(st):
        out = orig(st)
        taken.append(out[1])
        return out

    monkeypatch.setattr(ws, "_enter_polish_phase", spy)
    sol, info = ws.solve()
    assert info.status == jinfo.status == "solved"
    assert abs(info.pobj - jinfo.pobj) <= 1e-4 * (1 + abs(jinfo.pobj))
    assert taken == [ws._polish_iteration]
    assert not taken[0].exp32 and not taken[0].psd32
    mach = make_chunked_batch_solver(spec, stg, device="cpu").machinery
    assert not mach.it_polish.exp32 and not mach.it_polish.psd32


def test_indirect_solve_matches_jax():
    jp, jspec = _planted("s_cs")
    jstg = scs_tpu.Settings(mixed_precision=False)
    jsol, jinfo = scs_tpu.solve(jp.problem, jspec, None, jstg)
    prob, spec, stg = _port(jp.problem, jspec, jstg)
    sol, info = Workspace(prob, spec, None, stg, device="cpu").solve()
    assert info.status == jinfo.status == "solved"
    assert 0.8 <= info.iter / jinfo.iter <= 1.25, (info.iter, jinfo.iter)
    assert abs(info.pobj - jinfo.pobj) <= 1e-4 * (1 + abs(jinfo.pobj))


def test_infeasible_psd_certificate_takes_the_forced_polish(monkeypatch):
    took = _spy_polish(monkeypatch)
    jspec = scs_tpu.ConeSpec(l=3, s=(3,), cs=(2,))
    jprob, _, _ = j_models.gen_infeasible(jspec, n=5, seed=4)
    jsol, jinfo = scs_tpu.solve(jprob, jspec, None, MIXED)
    prob, spec, stg = _port(jprob, jspec, MIXED)
    sol, info = Workspace(prob, spec, None, stg, device="cpu").solve()
    assert info.status == jinfo.status == "infeasible"
    assert took == {"jax": [True], "port": [True]}
    # the Farkas certificate: A'y = 0, b'y = -1 (normalized), y in K*
    y = np.asarray(sol.y)
    A, b = (np.asarray(getattr(jprob, k)) for k in ("A", "b"))
    assert abs(b @ y + 1.0) <= 1e-6
    assert np.abs(A.T @ y).max() <= 1e-5


def _batch(jspec, B):
    probs = [j_models.gen_planted(jspec, n=6, seed=40 + i, density=0.5)
             for i in range(B)]
    return (np.stack([np.asarray(getattr(p.problem, k)) for p in probs])
            for k in ("A", "b", "c"))


@pytest.mark.parametrize("mode", ["pure", "mixed", "mixed_f32"])
def test_batch_matches_jax(mode, monkeypatch, capsys):
    """4 lanes of a PSD and complex-PSD spec through both packages'
    chunked batch solvers; the JAX package's polish count read from its
    debug line. `mixed_f32` is the card's default batched mode: the fast
    phase with float32 state (the port through the double-single splits'
    plain versions, the JAX package without them), float32 eigh, then
    the forced float64 polish of every lane."""
    jspec = scs_tpu.ConeSpec(z=1, l=3, s=(3,), cs=(2,))
    A, b, c = _batch(jspec, 4)
    jstg = (scs_tpu.Settings(linsys="direct", mixed_precision=False)
            if mode == "pure" else
            scs_tpu.Settings(linsys="direct", mixed_precision=True,
                             fast_f32=mode == "mixed_f32"))
    monkeypatch.setenv("SCS_TPU_LEVEL_DEBUG", "1")
    jres = j_make_chunked(jspec, jstg)(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
        jnp.zeros((4, 0)), jnp.zeros((4, 0)))
    j_status = np.asarray(jres.status)
    found = re.findall(r"\[polish\] needs=(\d+)", capsys.readouterr().err)
    j_polished = int(found[-1]) if found else 0
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    tA, _, tb, tc, tbu, tbl = convert.batch_from_numpy(A, b, c)
    solver = make_chunked_batch_solver(
        spec, convert.settings_from_dict(dataclasses.asdict(jstg)),
        device="cpu", ds_split=mode == "mixed_f32")
    res = solver(tA, tb, tc, tbu, tbl)
    np.testing.assert_array_equal(res.status.numpy(), j_status)
    assert np.all(j_status == config.SOLVED)
    jpo, po = np.asarray(jres.pobj), res.pobj.numpy()
    iters, j_iters = res.iters.numpy(), np.asarray(jres.iters)
    if mode == "pure":
        np.testing.assert_array_equal(iters, j_iters)
        assert np.all(np.abs(po - jpo) <= 1e-8 * (1 + np.abs(jpo)))
        assert solver.machinery.polished == 0
    elif mode == "mixed":
        ratio = iters / j_iters
        assert np.all((ratio >= 0.8) & (ratio <= 1.25)), ratio
        assert np.all(np.abs(po - jpo) <= 1e-4 * (1 + np.abs(jpo)))
        assert solver.machinery.polished == j_polished == 4
        assert not solver.machinery.f32_state
    else:
        # the port's float32-state phase runs through the double-single
        # splits and the JAX package's on the CPU without them, so single
        # lanes part (one lane here 225 against 325 iterations); the
        # batch's lane-iterations stay in the band
        ratio = iters.sum() / j_iters.sum()
        assert 0.8 <= ratio <= 1.25, (iters, j_iters)
        assert np.all(np.abs(po - jpo) <= 1e-4 * (1 + np.abs(jpo)))
        assert solver.machinery.polished == j_polished == 4
        assert solver.machinery.f32_state
