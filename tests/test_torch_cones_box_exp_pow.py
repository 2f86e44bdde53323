"""The box, exponential and power cones of scs_tpu_torch against the JAX
package on the CPU, and the fixed-order segment sums.

Cone functions: the same numpy inputs through both packages; float64
within 1e-12 relative (scaled by max(1, |reference|)). The float32 path
is within 1e-5 relative of JAX's float32 result on at least 99 % of the
rows; on every row it is within max(1e-5, 1.25 e_jax) of JAX's float64
projection, e_jax being the distance of JAX's own float32 result from
it. (The float32 root-finds steer on exp and log values that XLA and
ATen round differently in the last ulp: on one of the 582 exp points
JAX's float32 result lies 4.3e-4 from the float64 projection and the
port's 9e-9.) The points are those of tests/test_cones.py plus 512
random triples or vectors each.

Solves (direct backend): pure float64 gives the same status and the
objective within 1e-8 (1 + |pobj|); the box-only instance takes the same
iteration count, the exp and power instances a count within [0.8, 1.25]
of JAX's (XLA's and ATen's exp, log and pow may differ in the last ulp,
and the root-finds carry that into the trajectory). Mixed precision
(float32 exp/power on the fast phase, then the float64 Moreau
re-projection at the finish) is held to the same status, the objective
within 1e-4 (1 + |pobj|), and, after the re-projection, s in K, y in K*
and |s'y| within 1e-9 of the iterates' scale.

The JAX functions are jitted once per shape and shared across cases."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

import scs_tpu
from scs_tpu import models as j_models
from scs_tpu.cones import exp as j_exp
from scs_tpu.cones import power as j_power
from scs_tpu.cones import project as j_project
from scs_tpu.cones.box import proj_box_cone as j_box
from scs_tpu.parallel import make_batch_solver as j_batch
from scs_tpu_torch import Workspace, config, convert
from scs_tpu_torch import models as t_models
from scs_tpu_torch.cones import box, exp, graphs, power, project, segments
from scs_tpu_torch.parallel import make_batch_solver
from scs_tpu_torch.types import ConeData

from test_cones import EXP_V0

F64 = jnp.float64


def _close(got, ref, rtol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert np.all(err <= rtol), float(np.max(err))


def _close_f32(got, ref32, ref64):
    """The float32 criterion of the module docstring, per row of (k, 3)
    or (k,) results."""
    got, ref32, ref64 = (np.asarray(a, np.float64).reshape(len(ref64), -1)
                         for a in (got, ref32, ref64))
    scale = np.maximum(1.0, np.abs(ref64))

    def rel(a, b):
        return np.max(np.abs(a - b) / scale, axis=1)

    agree = rel(got, ref32) <= 1e-5
    assert agree.mean() >= 0.99, np.nonzero(~agree)[0]
    e_port, e_jax = rel(got, ref64), rel(ref32, ref64)
    ok = e_port <= np.maximum(1e-5, 1.25 * e_jax)
    assert ok.all(), (np.nonzero(~ok)[0], e_port[~ok], e_jax[~ok])


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ---- segment sums ----

@pytest.mark.parametrize("sizes", [
    (20, 34, 14, 51, 22, 31, 1, 67),       # the headline family's SOCs
    (3, 0, 1, 7, 2, 2, 9),                 # a zero-size segment
    (5000,) + (3,) * 40 + (1,) * 200,      # size classes (padding > 4x)
])
def test_segment_sum_matches_numpy(sizes):
    rng = np.random.RandomState(len(sizes))
    x = rng.randn(4, sum(sizes)) * rng.uniform(0.1, 10.0, (4, 1))
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    ref = np.stack([[row[s:s + n].sum() for s, n in zip(starts, sizes)]
                    for row in x])
    got = segments.segment_sum(t(x), sizes).numpy()
    scale = np.maximum(np.abs(ref), np.stack(
        [[np.abs(row[s:s + n]).sum() for s, n in zip(starts, sizes)]
         for row in x]))
    assert np.all(np.abs(got - ref) <= 1e-14 * np.maximum(scale, 1e-300))
    one = segments.segment_sum(t(x[1]), sizes).numpy()
    np.testing.assert_array_equal(one, got[1])


# ---- cone functions against JAX ----

@functools.lru_cache(maxsize=None)
def _jit(fn):
    return jax.jit(fn)


def _exp_points(rng):
    return np.concatenate([EXP_V0, rng.uniform(-3, 3, (512, 3)),
                           rng.randn(64, 3) * 1e-3])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_proj_exp_batch_matches_jax(dtype):
    v = _exp_points(np.random.RandomState(1))
    mask = np.arange(len(v)) % 3 != 0
    jd, td = (F64, torch.float64) if dtype == "float64" else \
        (jnp.float32, torch.float32)
    jfn = _jit(j_exp.proj_exp_batch)
    ref = jfn(jnp.asarray(v, jd), jnp.asarray(mask))
    got = exp.proj_exp_batch(t(v, td), torch.as_tensor(mask))
    assert got.dtype == td
    if dtype == "float64":
        _close(got, ref, 1e-12)
    else:
        _close_f32(got, ref, jfn(jnp.asarray(v, F64), jnp.asarray(mask)))
    # the reference points of SCS's test_exp_cone.h
    if dtype == "float64":
        from test_cones import EXP_VD, EXP_VP
        n0 = len(EXP_V0)
        prim = exp.proj_exp_batch(t(EXP_V0), torch.ones(n0, dtype=bool))
        dual = exp.proj_exp_batch(t(EXP_V0), torch.zeros(n0, dtype=bool))
        np.testing.assert_allclose(prim.numpy(), EXP_VP, atol=1e-6)
        np.testing.assert_allclose(dual.numpy(), EXP_VD, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_proj_power_batch_matches_jax(dtype):
    rng = np.random.RandomState(6)
    v = np.concatenate([rng.uniform(-2, 2, (30, 3)),
                        rng.uniform(-2, 2, (512, 3))])
    a = rng.uniform(0.1, 0.9, len(v)) * np.where(
        np.arange(len(v)) % 2, 1.0, -1.0)
    jd, td = (F64, torch.float64) if dtype == "float64" else \
        (jnp.float32, torch.float32)
    jfn = _jit(j_power.proj_power_batch)
    ref = jfn(jnp.asarray(v, jd), jnp.asarray(a, jd))
    got = power.proj_power_batch(t(v, td), t(a, td))
    if dtype == "float64":
        _close(got, ref, 1e-12)
    else:
        _close_f32(got, ref, jfn(jnp.asarray(v, F64), jnp.asarray(a, F64)))


def _box_cases(rng):
    """(tx, bl, bu, t_warm, r_box) cases: the points of
    tests/test_cones.py, then 64 boxes of 8 bounds (512 entries) with
    metric weights, warm starts and a few infinite bounds."""
    cases = [
        ([1.0, 5.0, -3.0, 0.0], [-1.0, 0.0, -2.0], [1.0, 2.0, -1.0], 1.0,
         None),
        ([1.0, 0.5, 1.0, -1.5], [-1.0, 0.0, -2.0], [1.0, 2.0, -1.0], 1.0,
         None),
        ([2.0, -7.0, -3.0], [-np.inf, 0.0], [np.inf, np.inf], 1.0, None),
        ([0.0, 3.0, -2.0], [-np.inf, -1.0], [np.inf, 1.0], 0.0, None),
    ]
    for k in range(64):
        bl = -rng.uniform(0.5, 2.0, 8)
        bu = rng.uniform(0.5, 2.0, 8)
        if k % 8 == 0:
            bl[k % 3] = -np.inf
            bu[(k + 1) % 5] = np.inf
        tx = rng.randn(9) * 2.0
        r = rng.uniform(0.01, 10.0, 9) if k % 2 else None
        cases.append((tx, bl, bu, rng.uniform(0.0, 3.0), r))
    return cases


def test_proj_box_cone_matches_jax():
    for tx, bl, bu, tw, r in _box_cases(np.random.RandomState(23)):
        ref, ref_t = _jit(j_box)(jnp.asarray(tx, F64), jnp.asarray(bl, F64),
                                 jnp.asarray(bu, F64), jnp.asarray(tw, F64),
                                 None if r is None else jnp.asarray(r, F64))
        got, got_t = box.proj_box_cone(t(tx), t(bl), t(bu), t(tw),
                                       None if r is None else t(r))
        _close(got, ref, 1e-12)
        _close(got_t, ref_t, 1e-12)


def test_proj_box_cone_batched_is_per_box():
    rng = np.random.RandomState(5)
    cases = [c for c in _box_cases(rng)[4:] if c[4] is not None][:16]
    tx, bl, bu, tw, r = (t(np.stack([c[i] for c in cases]))
                         for i in range(5))
    out, tnew = box.proj_box_cone(tx, bl, bu, tw, r)
    for i in range(len(cases)):
        o, ti = box.proj_box_cone(tx[i], bl[i], bu[i], tw[i], r[i])
        torch.testing.assert_close(out[i], o, rtol=0, atol=0)
        torch.testing.assert_close(tnew[i], ti, rtol=0, atol=0)
    bu_s, bl_s = box.scale_box_bounds(t([1.0, 1e15, 2.0]),
                                      t([-1.0, -3.0, -1e15]),
                                      t([2.0, 4.0, 1.0, 8.0]))
    np.testing.assert_array_equal(bu_s.numpy(), [2.0, np.inf, 8.0])
    np.testing.assert_array_equal(bl_s.numpy(), [-2.0, -1.5, -np.inf])


MIXED = scs_tpu.ConeSpec(z=2, l=3, bsize=5, q=(3, 4, 1), ep=3, ed=2,
                         p=(0.3, -0.6, 0.8))


@pytest.mark.parametrize("exp_f32", [False, True])
def test_proj_dual_cone_matches_jax(exp_f32):
    """The mixed layout's Moreau projection with a metric and a box warm
    start: float64 within 1e-12 of JAX's. With exp_f32 the exp rows are
    held to JAX's float32 projection within 1e-5, the other rows to its
    float64 one within 1e-12: the port projects the power cones in the
    dtype of x whatever exp_f32 says (JAX's float32 power Newton lands on
    the wrong root for some triples, ROADMAP section 3, R4)."""
    spec = convert.spec_from_dict(dataclasses.asdict(MIXED))
    lay = project.ConeLayout.make(spec)
    f32_rows = np.zeros(spec.dims(), bool)
    f32_rows[lay.exp_off:lay.pow_off] = exp_f32
    rng = np.random.RandomState(8)
    bu, bl = rng.uniform(0.5, 2.0, 4), -rng.uniform(0.5, 2.0, 4)
    bu[1] = np.inf
    jcd = scs_tpu.ConeData.make(MIXED, bu=bu, bl=bl)
    tcd = convert.cone_data_from_numpy(spec, bu, bl)
    jfns = {f32: _jit(functools.partial(j_project.proj_dual_cone,
                                        spec=MIXED, psd_f32=f32))
            for f32 in {False, exp_f32}}
    for trial in range(4):
        x = rng.randn(spec.dims()) * (1 + trial)
        r = rng.uniform(0.01, 10.0, spec.dims()) if trial % 2 else None
        tw = rng.uniform(0.5, 2.0)
        refs = {f32: fn(jnp.asarray(x), cone_data=jcd,
                        box_t_warm=jnp.asarray(tw),
                        r_y=None if r is None else jnp.asarray(r))
                for f32, fn in jfns.items()}
        got, got_t = project.proj_dual_cone(
            t(x), spec, tcd, t(tw), None if r is None else t(r),
            exp_f32=exp_f32)
        got = got.numpy()
        _close(got[~f32_rows], np.asarray(refs[False][0])[~f32_rows], 1e-12)
        if exp_f32:
            _close(got[f32_rows], np.asarray(refs[True][0])[f32_rows], 1e-5)
        _close(got_t, refs[False][1], 1e-12)


def test_cpu_runs_eagerly_and_layout():
    """On the CPU `graphs.run` is the plain call (no capture); the layout
    matches the JAX package's offsets; each spectral family added to the
    layout (the specs that raised until the spectral cones came in) lays
    out with the JAX package's offsets and projects as it does, within
    1e-10 relative."""
    spec = convert.spec_from_dict(dataclasses.asdict(MIXED))
    before = (graphs.captures, graphs.replays)
    x = t(np.random.RandomState(2).randn(spec.dims()))
    tcd = ConeData.make(spec, bu=np.ones(4), bl=-np.ones(4))
    a, ta = project.proj_cone(x, spec, tcd)
    assert (graphs.captures, graphs.replays) == before
    assert float(ta) >= 0 and a.shape == x.shape
    jl = j_project.ConeLayout.make(MIXED)
    tl = project.ConeLayout.make(spec)
    for name in ("z_off", "l_off", "box_off", "q_off", "s_off", "cs_off",
                 "exp_off", "pow_off", "total"):
        assert getattr(tl, name) == getattr(jl, name), name
    rng = np.random.RandomState(13)
    for extra in (dict(nuc_m=(2,), nuc_n=(2,)), dict(sl_n=(2,), sl_k=(1,)),
                  dict(d=(2,)), dict(ell1=(3,))):
        jext = dataclasses.replace(MIXED, **extra)
        ext = dataclasses.replace(spec, **extra)
        jl, tl = j_project.ConeLayout.make(jext), project.ConeLayout.make(ext)
        for f in dataclasses.fields(jl):
            if f.name != "spec":
                assert getattr(tl, f.name) == getattr(jl, f.name), f.name
        xe = rng.randn(ext.dims())
        jcd = scs_tpu.ConeData.make(jext, bu=np.ones(4), bl=-np.ones(4))
        ref = jax.jit(lambda xi, jext=jext, jcd=jcd: j_project.proj_cone(
            xi, jext, jcd, jnp.ones(()), None)[0])(jnp.asarray(xe))
        got = project.proj_cone(t(xe), ext, tcd)[0]
        _close(got.numpy(), np.asarray(ref), 1e-10)


def test_convert_carries_box_bounds_and_exponents():
    jspec = scs_tpu.ConeSpec(l=2, bsize=3, p=(np.float64(0.25), -0.5))
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    assert spec.p == (0.25, -0.5) and all(type(a) is float for a in spec.p)
    jcd = scs_tpu.ConeData.make(jspec, bu=[1.0, 2.0], bl=[-1.0, -np.inf])
    cd = convert.cone_data_from_numpy(spec, np.asarray(jcd.bu),
                                      np.asarray(jcd.bl))
    np.testing.assert_array_equal(cd.bu.numpy(), [1.0, 2.0])
    np.testing.assert_array_equal(cd.bl.numpy(), [-1.0, -np.inf])
    assert convert.cone_data_from_numpy(
        convert.spec_from_dict(dataclasses.asdict(scs_tpu.ConeSpec(l=2)))
    ).bu.shape == (0,)


# ---- solves ----

def _box_problem():
    spec = scs_tpu.ConeSpec(z=2, l=5, bsize=6)
    rng = np.random.RandomState(23)
    cd = scs_tpu.ConeData.make(spec, bu=rng.uniform(0.5, 2.0, 5),
                               bl=rng.uniform(-2.0, -0.5, 5))
    return j_models.gen_planted(spec, n=10, seed=23, density=0.5,
                                cone_data=cd), spec, cd


def _exp_problem():
    spec = scs_tpu.ConeSpec(l=6, ep=3, ed=2)
    return j_models.gen_planted(spec, n=12, seed=13, density=0.5), spec, None


def _power_problem():
    spec = scs_tpu.ConeSpec(l=4, p=(0.4, -0.7, 0.25))
    return j_models.gen_planted(spec, n=10, seed=17, density=0.5), spec, None


SOLVES = {
    "box": (_box_problem, True),
    "exp": (_exp_problem, False),
    "power": (_power_problem, False),
}


def _port(jp, jspec, jcd, jstg):
    prob = convert.problem_from_numpy(np.asarray(jp.problem.A),
                                      np.asarray(jp.problem.b),
                                      np.asarray(jp.problem.c))
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    cd = None if jcd is None else convert.cone_data_from_numpy(
        spec, np.asarray(jcd.bu), np.asarray(jcd.bl))
    return prob, spec, cd, convert.settings_from_dict(dataclasses.asdict(jstg))


PURE = scs_tpu.Settings(linsys="direct", mixed_precision=False,
                        eps_abs=1e-6, eps_rel=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_pure(case):
    """(planted problem, spec, cone data, JAX solution, JAX info) of a
    case, solved once by the JAX package in pure float64."""
    jp, jspec, jcd = SOLVES[case][0]()
    jsol, jinfo = scs_tpu.solve(jp.problem, jspec, jcd, PURE)
    return jp, jspec, jcd, jsol, jinfo


def _exact_pair(spec, cd, s, y, tol):
    """s in K, y in K* and |s'y| within tol of the iterates' scale, by the
    port's float64 projections (held to the JAX package's above):
    dist(s, K) = |Pi_{K*}(-s)| and dist(y, K*) = |Pi_{K*}(y) - y|."""
    s, y = t(s), t(y)
    tspec = convert.spec_from_dict(dataclasses.asdict(spec))
    tcd = convert.cone_data_from_numpy(
        tspec, None if cd is None else np.asarray(cd.bu),
        None if cd is None else np.asarray(cd.bl))
    nm = max(float(s.abs().max()), float(y.abs().max()), 1.0)
    assert abs(float(s @ y)) <= tol * nm
    ds = project.proj_dual_cone(-s, tspec, tcd, None, None)[0]
    dy = project.proj_dual_cone(y, tspec, tcd, None, None)[0] - y
    assert float(ds.abs().max()) <= tol * nm
    assert float(dy.abs().max()) <= tol * nm


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_pure_f64_solve_matches_jax(case):
    make, equal_iters = SOLVES[case]
    jp, jspec, jcd, jsol, jinfo = _jax_pure(case)
    prob, spec, cd, stg = _port(jp, jspec, jcd, PURE)
    sol, info = Workspace(prob, spec, cd, stg, device="cpu").solve()
    assert info.status == jinfo.status == "solved"
    assert abs(info.pobj - jinfo.pobj) <= 1e-8 * (1 + abs(jinfo.pobj))
    assert abs(info.pobj - jp.opt) <= 1e-4 * (1 + abs(jp.opt))
    if equal_iters:
        assert info.iter == jinfo.iter
    else:
        assert 0.8 <= info.iter / jinfo.iter <= 1.25, (info.iter, jinfo.iter)
    # the port's generator draws the same instance (its dual projection
    # is the port's own, in float64)
    tp = t_models.gen_planted(spec, n=jp.x.shape[0],
                              seed={"box": 23, "exp": 13, "power": 17}[case],
                              density=0.5, cone_data=cd)
    np.testing.assert_array_equal(tp.problem.A.numpy(),
                                  np.asarray(jp.problem.A))
    for got, ref in ((tp.problem.b, jp.problem.b),
                     (tp.problem.c, jp.problem.c), (tp.y, jp.y)):
        _close(np.asarray(got), np.asarray(ref), 1e-12)
    assert abs(tp.opt - jp.opt) <= 1e-12 * (1 + abs(jp.opt))


@pytest.mark.parametrize("case", ["exp", "power"])
def test_mixed_solve_repolishes(case):
    """Mixed precision with float32 exp projections on the fast phase
    (`exp_f32=True`, the JAX package's default with mixed; the port's
    opt-in), then the float64 Moreau re-projection at the finish; held to
    JAX's pure float64 solve of the instance."""
    jp, jspec, jcd, _, jinfo = _jax_pure(case)
    jstg = scs_tpu.Settings(linsys="direct", mixed_precision=True,
                            exp_f32=True)
    prob, spec, cd, stg = _port(jp, jspec, jcd, jstg)
    ws = Workspace(prob, spec, cd, stg, device="cpu")
    assert ws._mixed and ws._iteration.exp32 and ws._repolish
    sol, info = ws.solve()
    assert info.status == jinfo.status == "solved"
    assert abs(info.pobj - jinfo.pobj) <= 1e-4 * (1 + abs(jinfo.pobj))
    _exact_pair(jspec, jcd, sol.s, sol.y, 1e-9)


def test_mixed_batch_matches_jax():
    """B = 4 problems with box, SOC, exp and power cones, mixed with
    float64 state (the JAX side's float32-state phase would run where no
    double-single kernel exists, ROADMAP R2) and float32 exp projections
    on both sides, through both packages' `make_batch_solver`: equal
    statuses, objectives within 1e-4
    (1 + |pobj|), iteration counts within [0.8, 1.25], and every lane's
    (s, y) exact after the re-projection."""
    jspec = scs_tpu.ConeSpec(z=2, l=4, bsize=3, q=(3,), ep=2, ed=1,
                             p=(0.6, -0.4))
    B = 4
    bu = np.tile([1.5, np.inf], (B, 1))
    bl = np.tile([-1.0, -2.0], (B, 1))
    jcd = scs_tpu.ConeData.make(jspec, bu=bu[0], bl=bl[0])
    probs = [j_models.gen_planted(jspec, n=8, seed=300 + i, density=0.4,
                                  cone_data=jcd) for i in range(B)]
    A, b, c = (jnp.stack([getattr(p.problem, k) for p in probs])
               for k in ("A", "b", "c"))
    jstg = scs_tpu.Settings(linsys="direct", mixed_precision=True,
                            fast_f32=False, exp_f32=True,
                            macro_schedule=False)
    jres = j_batch(jspec, jstg)(A, b, c, jnp.asarray(bu), jnp.asarray(bl))
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    stg = convert.settings_from_dict(dataclasses.asdict(jstg))
    tA, _, tb, tc, tbu, tbl = convert.batch_from_numpy(
        np.asarray(A), np.asarray(b), np.asarray(c), None, bu, bl)
    solver = make_batch_solver(spec, stg, device="cpu")
    assert solver.machinery.it.exp32 and not solver.machinery.f32_state
    res = solver(tA, tb, tc, tbu, tbl)
    jst, st = np.asarray(jres.status), res.status.numpy()
    np.testing.assert_array_equal(st, jst)
    assert np.all(st == config.SOLVED)
    jpo, po = np.asarray(jres.pobj), res.pobj.numpy()
    assert np.all(np.abs(po - jpo) <= 1e-4 * (1 + np.abs(jpo)))
    ratio = res.iters.numpy() / np.asarray(jres.iters)
    assert np.all((ratio >= 0.8) & (ratio <= 1.25)), ratio
    for i in range(B):
        _exact_pair(jspec, jcd, res.s[i].numpy(), res.y[i].numpy(), 1e-9)
