"""The slice as a whole: the JAX package's `solve` against scs_tpu_torch's
on the CPU, with the direct backend. Problems are generated by both
packages from the same seeds (bit-identical, checked below) and settings
carried across through `convert`.

Pure float64 must follow the JAX trajectory: same status, same iteration
count, objective within 1e-8 (1 + |pobj|) and x, y, s within 1e-6 of the
JAX solution relative to their norms. Both sides run the same float64
arithmetic in a different order (LAPACK vs XLA), so iterates agree to
round-off amplified over the run, far inside 1e-6.

The mixed path rounds differently on each side (XLA's float32 inverse vs
PyTorch's), so it is held to the same status, the objective within
1e-4 (1 + |pobj|) and an iteration count within [0.8, 1.25] of JAX's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

import scs_tpu
from scs_tpu import demo_socp as j_demo
from scs_tpu import models as j_models
from scs_tpu_torch import ConeSpec, Settings, Workspace, convert
from scs_tpu_torch import solve as t_solve
from scs_tpu_torch import config
from scs_tpu_torch import demo_socp as t_demo
from scs_tpu_torch import models as t_models
from scs_tpu_torch.ops import dsmatvec

SOCP = scs_tpu.ConeSpec(z=5, l=20, q=(5, 5, 5, 10))


def _planted_socp():
    p = j_models.gen_planted(SOCP, n=30, seed=3, density=0.3)
    return p.problem, SOCP, p.cone_data


def _planted_lp():
    spec = scs_tpu.ConeSpec(l=300)
    p = j_models.gen_planted(spec, n=100, seed=42, density=0.1)
    return p.problem, spec, p.cone_data


def _infeasible_socp():
    spec = scs_tpu.ConeSpec(l=10, q=(5, 8))
    prob, cd, _ = j_models.gen_infeasible(spec, n=10, seed=37)
    return prob, spec, cd


def _unbounded_socp():
    spec = scs_tpu.ConeSpec(l=8, q=(6,))
    prob, cd, _ = j_models.gen_unbounded(spec, n=10, seed=43)
    return prob, spec, cd


PURE_CASES = {
    "socp": (_planted_socp, {}),
    "lp": (_planted_lp, dict(eps_abs=1e-5, eps_rel=1e-5)),
    "infeasible": (_infeasible_socp, {}),
    "unbounded": (_unbounded_socp, {}),
}


def _port_args(jprob, jspec, jstg):
    P = None if jprob.P is None else np.asarray(jprob.P)
    prob = convert.problem_from_numpy(np.asarray(jprob.A), np.asarray(jprob.b),
                                      np.asarray(jprob.c), P)
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    stg = convert.settings_from_dict(dataclasses.asdict(jstg))
    return prob, spec, stg


def _close(got, ref, rtol):
    """Vectors equal within rtol of the reference's norm, NaN where the
    reference is NaN (certificates leave x, s or y NaN)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan)
    if nan.all():
        return
    err = np.linalg.norm(got[~nan] - ref[~nan])
    assert err <= rtol * max(np.linalg.norm(ref[~nan]), 1.0), err


def _same_objective(got, ref, rtol):
    if np.isfinite(ref):
        assert abs(got - ref) <= rtol * (1 + abs(ref)), (got, ref)
    else:
        assert got == ref


@pytest.mark.parametrize("case", sorted(PURE_CASES))
def test_pure_f64_follows_jax(case):
    make, kw = PURE_CASES[case]
    jprob, jspec, jcd = make()
    jstg = scs_tpu.Settings(linsys="direct", mixed_precision=False, **kw)
    jsol, jinfo = scs_tpu.solve(jprob, jspec, jcd, jstg)
    prob, spec, stg = _port_args(jprob, jspec, jstg)
    sol, info = t_solve(prob, spec, None, stg, device="cpu")
    assert info.status == jinfo.status
    assert info.status_val == jinfo.status_val
    assert info.iter == jinfo.iter
    assert info.scale_updates == jinfo.scale_updates
    _same_objective(info.pobj, jinfo.pobj, 1e-8)
    for got, ref in ((sol.x, jsol.x), (sol.y, jsol.y), (sol.s, jsol.s)):
        _close(got, ref, 1e-6)


@pytest.mark.parametrize("eps, ds_split", [
    (1e-4, False),     # as the JAX package's CPU mixed path runs
    (1e-4, True),      # the solver's K1 wiring, through the plain version
    (1e-7, True),      # below MIXED_FAST_FLOOR: the polish phase runs
])
def test_mixed_matches_jax(eps, ds_split):
    jprob, jspec, jcd = _planted_socp()
    jstg = scs_tpu.Settings(linsys="direct", mixed_precision=True,
                            eps_abs=eps, eps_rel=eps)
    _, jinfo = scs_tpu.solve(jprob, jspec, jcd, jstg)
    prob, spec, stg = _port_args(jprob, jspec, jstg)
    before = dsmatvec.launches
    ws = Workspace(prob, spec, None, stg, device="cpu", ds_split=ds_split)
    assert (ws.data.lin_cache.ds_fwd is not None) == ds_split
    _, info = ws.solve()
    assert dsmatvec.launches == before    # CPU tensors: plain version only
    assert info.status == jinfo.status == "solved"
    _same_objective(info.pobj, jinfo.pobj, 1e-4)
    assert 0.8 <= info.iter / jinfo.iter <= 1.25, (info.iter, jinfo.iter)
    if eps < config.MIXED_FAST_FLOOR:
        assert info.res_pri < 1e-5 and info.res_dual < 1e-5


def test_warm_start_after_update_matches_jax():
    jprob, jspec, jcd = _planted_socp()
    jstg = scs_tpu.Settings(linsys="direct", mixed_precision=False)
    b2 = np.asarray(jprob.b) * 1.05 + 0.01
    jw = scs_tpu.Workspace(jprob, jspec, jcd, jstg)
    jsol, _ = jw.solve()
    jw.update(b=jnp.asarray(b2))
    jsol2, jinfo2 = jw.solve(warm_start=True, sol=jsol)

    prob, spec, stg = _port_args(jprob, jspec, jstg)
    w = Workspace(prob, spec, None, stg, device="cpu")
    sol, _ = w.solve()
    w.update(b=torch.tensor(b2))
    sol2, info2 = w.solve(warm_start=True, sol=sol)
    assert info2.status == jinfo2.status
    assert info2.iter == jinfo2.iter
    _same_objective(info2.pobj, jinfo2.pobj, 1e-8)
    _close(sol2.x, jsol2.x, 1e-6)


GEN_CASES = ["planted", "planted_P", "infeasible", "infeasible_P",
             "unbounded", "make_spec"]


@pytest.mark.parametrize("case", GEN_CASES)
def test_generators_bit_identical(case):
    spec = scs_tpu.ConeSpec(z=3, l=9, q=(4, 1, 6))
    tspec = convert.spec_from_dict(dataclasses.asdict(spec))
    if case.startswith("planted"):
        kw = dict(n=11, seed=5, density=0.4, with_P=case.endswith("_P"))
        jp = j_models.gen_planted(spec, **kw)
        tp = t_models.gen_planted(tspec, **kw)
        assert tp.opt == jp.opt
        jprob, tprob = jp.problem, tp.problem
    elif case.startswith("infeasible"):
        kw = dict(n=7, seed=8, with_P=case.endswith("_P"))
        jprob, _, jy = j_models.gen_infeasible(spec, **kw)
        tprob, _, ty = t_models.gen_infeasible(tspec, **kw)
        np.testing.assert_array_equal(ty, jy)
    elif case == "unbounded":
        jprob, _, jx = j_models.gen_unbounded(spec, n=7, seed=9)
        tprob, _, tx = t_models.gen_unbounded(tspec, n=7, seed=9)
        np.testing.assert_array_equal(tx, jx)
    else:
        jspec = j_demo.make_spec(300, 0.1, np.random.RandomState(7))
        tspec = t_demo.make_spec(300, 0.1, np.random.RandomState(7))
        assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
        return
    for name in ("A", "b", "c", "P"):
        jv, tv = getattr(jprob, name), getattr(tprob, name)
        assert (jv is None) == (tv is None), name
        if jv is not None:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _tiny():
    return t_models.gen_planted(ConeSpec(l=6), n=3, seed=0)


def test_entry_points_refuse_the_cpu_by_default(monkeypatch):
    """Without a CUDA device the default device raises instead of solving
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = _tiny()
    stg = Settings(linsys="direct")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_solve(p.problem, p.spec, p.cone_data, stg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Workspace(p.problem, p.spec, p.cone_data, stg)
    _, info = t_solve(p.problem, p.spec, p.cone_data, stg, device="cpu")
    assert info.status == "solved"


@pytest.mark.parametrize("kw, made", [
    (dict(linsys="direct", write_data_filename="t.bin"), "t.bin"),
    (dict(linsys="direct", verbose=True), None),
    (dict(linsys="direct", log_csv_filename="t.csv"), "t.csv"),
    (dict(linsys="direct", psd_rank=2), None),
])
def test_parts_outside_the_slice_raise(kw, made, tmp_path, monkeypatch):
    """The settings that raised until ROADMAP items 13 and 14 were ported
    now run: the same solve, and the file each asks for written
    (tests/test_torch_compat.py and test_torch_subspace.py hold them
    against the JAX package)."""
    monkeypatch.chdir(tmp_path)
    p = _tiny()
    _, ref = Workspace(p.problem, p.spec, p.cone_data,
                       Settings(linsys="direct"), device="cpu").solve()
    _, info = Workspace(p.problem, p.spec, p.cone_data, Settings(**kw),
                        device="cpu").solve()
    assert info.status == ref.status == "solved"
    assert info.iter == ref.iter
    if made:
        assert (tmp_path / made).stat().st_size > 0
