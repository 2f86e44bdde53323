"""Solves with the spectral cones of scs_tpu_torch (log-determinant,
nuclear-norm, ell1-norm, sum-of-k-largest-eigenvalues) against the JAX
package on the CPU (the cone functions are in tests/test_torch_spectral.py).

tests/test_spectral.py's specs and seeds: pure float64 direct gives the
same status, the same iteration count and the objective within 1e-8
(1 + |pobj|); mixed with float64 state (the sum-largest, nuclear and
logdet specs) the same status and the objective within 1e-4 (1 + |pobj|),
both packages taking the forced float64 polish
(`ConeSpec.f32_polish_cones`); the indirect backend (ell1 and
sum-largest) an iteration count within [0.8, 1.25] of the JAX package's.
Batched (`make_chunked_batch_solver`, 4 lanes of the logdet spec): pure
float64 gives every lane the JAX package's iteration count and objective
within 1e-8; with float32 state (the card's default, here through the
double-single splits' plain versions) the same statuses, objectives
within 1e-4 (1 + |pobj|) and every lane polished. The JAX package's own
float32-state phase fails at trace time on the spectral cones (ROADMAP
R5, tests/test_torch_spectral.py), so the float32-state lanes are held to
its float64-state mixed solves, lane by lane (ROADMAP R1's rule); the
batch is held to the JAX package's single-problem solves, whose programs
the solve tests compile already (the port's batched and single pure
counts are equal).

Every JAX solve goes through one cache, so each spec and mode compiles
once."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

import scs_tpu
from scs_tpu import api as j_api
from scs_tpu import models as j_models
from scs_tpu_torch import Workspace, api, config, convert
from scs_tpu_torch.parallel import make_chunked_batch_solver


SOLVE_SPECS = {   # tests/test_spectral.py:166-193, :330-338
    "ell1": (dict(l=5, ell1=(6,)), 10, 101, 0.5, {}),
    "sum_largest": (dict(l=4, sl_n=(4,), sl_k=(2,)), 10, 103, 0.5, {}),
    "nuclear": (dict(l=4, nuc_m=(4,), nuc_n=(3,)), 10, 105, 0.5, {}),
    "logdet": (dict(l=4, d=(3,)), 10, 107, 0.5, dict(max_iters=20000)),
    "several_logdet": (dict(l=6, d=(3, 3)), 8, 33, 0.3,
                       dict(eps_abs=1e-5, eps_rel=1e-5)),
}
MODES = {"pure": dict(linsys="direct", mixed_precision=False),
         "mixed": dict(linsys="direct", mixed_precision=True),
         "indirect": dict(mixed_precision=False)}


def _instance(case, seed=None):
    kw, n, s, density, _ = SOLVE_SPECS[case]
    jspec = scs_tpu.ConeSpec(**kw)
    return j_models.gen_planted(jspec, n=n, seed=s if seed is None else seed,
                                density=density), jspec


def _settings(case, mode):
    return scs_tpu.Settings(**MODES[mode], **SOLVE_SPECS[case][4])


def _port(problem, jspec, jstg):
    prob = convert.problem_from_numpy(np.asarray(problem.A),
                                      np.asarray(problem.b),
                                      np.asarray(problem.c))
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    return prob, spec, convert.settings_from_dict(dataclasses.asdict(jstg))


@functools.lru_cache(maxsize=None)
def _jax_solve(case, mode, seed=None):
    jp, jspec = _instance(case, seed)
    return scs_tpu.solve(jp.problem, jspec, None, _settings(case, mode))


@pytest.mark.parametrize("case", sorted(SOLVE_SPECS))
def test_pure_f64_solve_matches_jax(case):
    jp, jspec = _instance(case)
    jsol, jinfo = _jax_solve(case, "pure")
    prob, spec, stg = _port(jp.problem, jspec, _settings(case, "pure"))
    sol, info = Workspace(prob, spec, None, stg, device="cpu").solve()
    assert info.status == jinfo.status == "solved"
    assert info.iter == jinfo.iter
    assert abs(info.pobj - jinfo.pobj) <= 1e-8 * (1 + abs(jinfo.pobj))
    assert abs(info.pobj - jp.opt) <= 1e-3 * (1 + abs(jp.opt))


def _spy_polish(monkeypatch):
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


@pytest.mark.parametrize("case", ["logdet", "nuclear", "sum_largest"])
def test_mixed_solve_takes_the_forced_polish(case, monkeypatch):
    took = _spy_polish(monkeypatch)
    jp, jspec = _instance(case)
    jstg = _settings(case, "mixed")
    jsol, jinfo = scs_tpu.solve(jp.problem, jspec, None, jstg)
    prob, spec, stg = _port(jp.problem, jspec, jstg)
    ws = Workspace(prob, spec, None, stg, device="cpu")
    assert ws._mixed and ws._iteration.psd32
    sol, info = ws.solve()
    assert info.status == jinfo.status == "solved"
    assert abs(info.pobj - jinfo.pobj) <= 1e-4 * (1 + abs(jinfo.pobj))
    assert took == {"jax": [True], "port": [True]}


@pytest.mark.parametrize("case", ["ell1", "sum_largest"])
def test_indirect_solve_matches_jax(case):
    jp, jspec = _instance(case)
    jsol, jinfo = _jax_solve(case, "indirect")
    prob, spec, stg = _port(jp.problem, jspec, _settings(case, "indirect"))
    sol, info = Workspace(prob, spec, None, stg, device="cpu").solve()
    assert info.status == jinfo.status == "solved"
    assert 0.8 <= info.iter / jinfo.iter <= 1.25, (info.iter, jinfo.iter)
    assert abs(info.pobj - jinfo.pobj) <= 1e-4 * (1 + abs(jinfo.pobj))


BATCH_SEEDS = (107, 108, 109, 110)


@pytest.mark.parametrize("mode", ["pure", "mixed_f32"])
def test_batch_matches_jax(mode):
    """4 lanes of the logdet spec through the port's chunked batch solver,
    each held to the JAX package's solve of that lane (module docstring);
    with float32 state every lane takes the forced float64 polish."""
    inst = [_instance("logdet", s) for s in BATCH_SEEDS]
    jspec = inst[0][1]
    A, b, c = (np.stack([np.asarray(getattr(p.problem, k)) for p, _ in inst])
               for k in ("A", "b", "c"))
    jmode = "pure" if mode == "pure" else "mixed"
    jres = [_jax_solve("logdet", jmode, s)[1] for s in BATCH_SEEDS]
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    stg = convert.settings_from_dict(dataclasses.asdict(
        _settings("logdet", jmode)))
    tA, _, tb, tc, tbu, tbl = convert.batch_from_numpy(A, b, c)
    solver = make_chunked_batch_solver(spec, stg, device="cpu",
                                       ds_split=mode == "mixed_f32")
    res = solver(tA, tb, tc, tbu, tbl)
    assert res.status.tolist() == [config.SOLVED] * 4
    assert all(j.status == "solved" for j in jres)
    jpo = np.array([j.pobj for j in jres])
    po = res.pobj.numpy()
    if mode == "pure":
        assert res.iters.tolist() == [j.iter for j in jres]
        assert np.all(np.abs(po - jpo) <= 1e-8 * (1 + np.abs(jpo)))
        assert solver.machinery.polished == 0
    else:
        assert solver.machinery.f32_state
        assert np.all(np.abs(po - jpo) <= 1e-4 * (1 + np.abs(jpo)))
        assert solver.machinery.polished == 4


