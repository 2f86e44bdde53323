"""scs_tpu_torch's scs-python layer, CLI and solve extras against the JAX
package on the CPU.

* `compat` (`tests/test_compat.py`'s cases: LP, QP and an update, dense
  against upper-triangular P, box, the legacy 'f' key, unknown keys,
  `use_indirect`, the retained warm start), each against the JAX
  package's `compat` on the same data: the same status and iteration
  count, x within 1e-8 (of the norm of the JAX x, at least 1), in pure
  float64 (the CPU's default): on the direct backend, and on the
  indirect one (scs-python's default) for `use_indirect` and the cases
  that name no backend.
* The verbose log: its lines equal the JAX package's but for the banner
  (the device's name), the times and the timings line.
* The CSV trace: the header is `TRACE_COLUMNS` and `time`, one row an
  iteration, the last row's res_pri, res_dual and gap equal to Info's,
  and every value within 1e-9 relative of the JAX package's CSV (or
  1e-9 of the column's largest magnitude, for values near 0) on the
  pure-f64 direct path; with a logdet cone its spectral columns are
  finite.
* `write_data_filename` writes the JAX package's bytes; `version`; the
  `run_from_file` CLI on a file the JAX package wrote, dense and sparse
  storage; `profile_phases` gives the plain solve's iterations and bits
  and timers of the right structure (not wall-clock ratios).
* The convexity probe of a dense P just above n = 4096, where the JAX
  package switches to ARPACK on a host copy and the port keeps its
  eigvalsh on the solve's device (faster on the card,
  `tools/torch_convexity_probe.py`): an indefinite P with a positive
  diagonal is flagged, a PSD one passes.
"""

import csv
import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

import scs_tpu
from scs_tpu import compat as j_compat
from scs_tpu import io as j_io
from scs_tpu import models as j_models
from scs_tpu.run_from_file import main as j_rff
import scs_tpu_torch
from scs_tpu_torch import Settings, Workspace, compat, config, convert
from scs_tpu_torch import run_from_file
from scs_tpu_torch.models import planted_lowrank_sdp
from scs_tpu_torch.solver import TRACE_COLUMNS
from scs_tpu_torch.types import ConeSpec, Problem
from scs_tpu_torch.validation import ValidationError


def _lp_data():
    """min x0 + x1  s.t.  x0 >= 1, x1 >= 2 (as -x <= -[1,2], l cone)."""
    A = sp.csc_matrix(-np.eye(2))
    return ({"A": A, "b": np.array([-1.0, -2.0]), "c": np.array([1.0, 1.0])},
            {"l": 2})


def _qp_data():
    """scs-python's README example."""
    P = sp.csc_matrix(np.triu(np.array([[3.0, -1.0], [-1.0, 2.0]])))
    A = sp.csc_matrix(np.array([[-1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]))
    return ({"P": P, "A": A, "b": np.array([-1.0, 0.3, -0.5]),
             "c": np.array([-1.0, -1.0])}, {"z": 1, "l": 2})


def _box_data():
    A = sp.csc_matrix(np.vstack([np.zeros((1, 2)), -np.eye(2)]))
    return ({"A": A, "b": np.array([1.0, 0.0, 0.0]),
             "c": np.array([-1.0, -1.0])},
            {"bu": np.array([1.0, 1.0]), "bl": np.array([0.0, 0.0])})


def _lp_random():
    rng = np.random.RandomState(5)
    n, m = 30, 90
    A = rng.randn(m, n) * (rng.rand(m, n) < 0.3)
    x0 = rng.randn(n)
    s0 = np.maximum(rng.randn(m), 0.0)
    y0 = np.maximum(rng.randn(m), 0.0)
    return ({"A": sp.csc_matrix(A), "b": A @ x0 + s0, "c": -A.T @ y0},
            {"l": m})


def _same(sol, jsol, tol=1e-8):
    info, jinfo = sol["info"], jsol["info"]
    assert info["status"] == jinfo["status"]
    assert info["iter"] == jinfo["iter"]
    err = np.linalg.norm(np.asarray(sol["x"]) - np.asarray(jsol["x"]))
    assert err <= tol * max(1.0, np.linalg.norm(np.asarray(jsol["x"]))), err


CASES = {
    "lp": (_lp_data, dict(eps_abs=1e-7, eps_rel=1e-7, use_indirect=False)),
    "qp": (_qp_data, dict(eps_abs=1e-7, eps_rel=1e-7, use_indirect=False)),
    "box": (_box_data, dict(eps_abs=1e-7, eps_rel=1e-7,
                            use_indirect=False)),
    "lp random": (_lp_random, dict(use_indirect=False)),
    "use_indirect": (_lp_data, dict(use_indirect=True)),
    "use_direct": (_lp_data, dict(use_indirect=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_compat_solve_matches_jax(case):
    make, kw = CASES[case]
    data, cone = make()
    jsol = j_compat.solve(data, cone, verbose=False, **kw)
    sol = compat.solve(data, cone, verbose=False, device="cpu", **kw)
    _same(sol, jsol)
    assert sol["info"]["status_val"] == config.SOLVED
    assert sol["info"]["lin_sys_solver"] == jsol["info"]["lin_sys_solver"]
    assert sorted(sol["info"]) == sorted(jsol["info"])


def test_compat_qp_update_warm_matches_jax():
    data, cone = _qp_data()
    kw = dict(verbose=False, eps_abs=1e-7, eps_rel=1e-7)
    js = j_compat.SCS(data, cone, **kw)
    ts = compat.SCS(data, cone, device="cpu", **kw)
    jsol, sol = js.solve(), ts.solve()
    _same(sol, jsol)
    np.testing.assert_allclose(sol["x"], [0.3, -0.7], atol=1e-4)
    b2 = np.array([-1.0, 0.3, -1.0])
    js.update(b=b2)
    ts.update(b=b2)
    _same(ts.solve(warm_start=True, x=sol["x"], y=sol["y"], s=sol["s"]),
          js.solve(warm_start=True, x=jsol["x"], y=jsol["y"], s=jsol["s"]))


def test_compat_dense_and_upper_P_agree():
    data, cone = _qp_data()
    Pu = np.asarray(data["P"].todense())
    full = dict(data, P=sp.csc_matrix(Pu + Pu.T - np.diag(np.diag(Pu))))
    s1 = compat.solve(data, cone, verbose=False, device="cpu")
    s2 = compat.solve(full, cone, verbose=False, device="cpu")
    _same(s1, j_compat.solve(full, cone, verbose=False))
    np.testing.assert_allclose(s1["x"], s2["x"], atol=1e-9)


def test_compat_legacy_f_key_warns():
    data = {"A": sp.csc_matrix(np.array([[1.0]])), "b": np.array([2.0]),
            "c": np.array([1.0])}
    with pytest.warns(DeprecationWarning):
        jsol = j_compat.solve(data, {"f": 1}, verbose=False)
    with pytest.warns(DeprecationWarning):
        sol = compat.solve(data, {"f": 1}, verbose=False, device="cpu")
    _same(sol, jsol)


def test_compat_rejects_unknown_keys_and_reads_gpu():
    data, cone = _lp_data()
    with pytest.raises(ValueError):
        compat.solve(data, {"l": 2, "bogus": 3}, verbose=False,
                     device="cpu")
    with pytest.raises(ValueError):
        compat.solve(data, cone, bogus_setting=1, device="cpu")
    # gpu=True asks for the card: with device="cpu" that is a contradiction
    with pytest.raises(ValueError, match="gpu"):
        compat.solve(data, cone, gpu=True, device="cpu")
    # scs-python's default value changes nothing
    sol = compat.solve(data, cone, gpu=False, verbose=False, device="cpu")
    assert sol["info"]["status_val"] == config.SOLVED


def test_compat_defaults_to_the_card(monkeypatch):
    data, cone = _lp_data()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.solve(data, cone, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.solve(data, cone, verbose=False, gpu=True)


def test_compat_warm_start_retained_iterate():
    data, cone = _lp_random()
    js = j_compat.SCS(data, cone, verbose=False)
    ts = compat.SCS(data, cone, verbose=False, device="cpu")
    s1, j1 = ts.solve(warm_start=False), js.solve(warm_start=False)
    _same(s1, j1)
    js.update(b=data["b"] + 1e-6)
    ts.update(b=data["b"] + 1e-6)
    s2, j2 = ts.solve(), js.solve()
    _same(s2, j2)
    assert s2["info"]["iter"] < s1["info"]["iter"]


def test_compat_sparse_storage():
    data, cone = _lp_random()
    sol = compat.solve(data, cone, verbose=False, device="cpu",
                       storage="sparse", eps_abs=1e-7, eps_rel=1e-7)
    dense = compat.solve(data, cone, verbose=False, device="cpu",
                         eps_abs=1e-7, eps_rel=1e-7)
    assert sol["info"]["status_val"] == config.SOLVED
    np.testing.assert_allclose(sol["x"], dense["x"], atol=1e-6)


def _log_lines(out: str) -> list:
    """The log's lines without the banner, the progress rows' time column
    and the timings line."""
    keep = []
    for line in out.splitlines():
        if "splitting conic solver" in line or line.startswith("timings:"):
            continue
        if "|" in line and line.split("|")[0].strip().isdigit():
            line = line.rsplit(" ", 1)[0]
        keep.append(line)
    return keep


def test_verbose_log_matches_jax(capsys):
    data, cone = _qp_data()
    j_compat.solve(data, cone, verbose=True)
    jout = capsys.readouterr().out
    sol = compat.solve(data, cone, verbose=True, device="cpu")
    out = capsys.readouterr().out
    assert "scs_tpu_torch v" in out and "on the CPU" in out
    assert "status:  solved" in out and "objective = " in out
    assert "variables n: 2, constraints m: 3" in out
    assert _log_lines(out) == _log_lines(jout)
    assert sol["info"]["status_val"] == config.SOLVED


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.array([[float(v) for v in r] for r in rows[1:]])


def _socp_data():
    """A planted SOCP of the JAX package's generator (150 iterations)."""
    spec = scs_tpu.ConeSpec(z=5, l=20, q=(5, 5, 5, 10))
    p = j_models.gen_planted(spec, n=30, seed=3, density=0.3)
    return ({"A": sp.csc_matrix(np.asarray(p.problem.A)),
             "b": np.asarray(p.problem.b), "c": np.asarray(p.problem.c)},
            {"z": 5, "l": 20, "q": [5, 5, 5, 10]})


@pytest.mark.parametrize("make", [_qp_data, _socp_data])
def test_csv_trace_matches_jax(make, tmp_path):
    data, cone = make()
    fj, ft = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    jsol = j_compat.solve(data, cone, verbose=False, log_csv_filename=fj,
                          use_indirect=False)
    sol = compat.solve(data, cone, verbose=False, log_csv_filename=ft,
                       use_indirect=False, device="cpu")
    head, vals = _read_csv(ft)
    jhead, jvals = _read_csv(fj)
    assert head == list(TRACE_COLUMNS) + ["time"] == jhead
    info = sol["info"]
    assert vals.shape[0] == info["iter"] == jvals.shape[0]
    assert list(vals[:, 0]) == list(range(1, info["iter"] + 1))
    for col in ("res_pri", "res_dual", "gap"):
        assert vals[-1, head.index(col)] == info[col], col
    a, b = vals[:, :-1], jvals[:, :-1]          # time differs
    assert np.array_equal(np.isnan(a), np.isnan(b))
    a, b = np.nan_to_num(a), np.nan_to_num(b)
    scale = np.abs(b).max(axis=0, keepdims=True)
    bad = np.abs(a - b) > 1e-9 * np.maximum(np.abs(b), scale)
    assert not bad.any(), [head[j] for j in np.nonzero(bad.any(0))[0]]
    assert jsol["info"]["iter"] == info["iter"]


def test_csv_trace_spectral_columns(tmp_path):
    """A logdet cone fills the three spectral columns (the KKT residuals
    of the first logdet cone's projection), read once per chunk."""
    from scs_tpu_torch.models import spectral_cones  # noqa: F401
    spec = ConeSpec(l=6, d=(3,))
    rng = np.random.RandomState(0)
    m, n = spec.dims(), 4
    A = rng.randn(m, n)
    x = rng.randn(n)
    prob = Problem(A=torch.tensor(A), b=torch.tensor(A @ x + 1.0),
                   c=torch.tensor(rng.randn(n)))
    f = str(tmp_path / "s.csv")
    _, info = Workspace(prob, spec, None,
                        Settings(log_csv_filename=f, max_iters=60),
                        device="cpu").solve()
    head, vals = _read_csv(f)
    assert vals.shape[0] == info.iter
    spectral = vals[:, head.index("res_dual_spectral"):
                    head.index("comp_spectral") + 1]
    assert np.isfinite(spectral).all()


def test_write_data_bytes_equal_jax(tmp_path):
    data, cone = _qp_data()
    fj, ft = str(tmp_path / "j.dat"), str(tmp_path / "t.dat")
    j_compat.solve(data, cone, verbose=False, write_data_filename=fj,
                   eps_abs=1e-6, eps_rel=1e-6)
    sol = compat.solve(data, cone, verbose=False, write_data_filename=ft,
                       eps_abs=1e-6, eps_rel=1e-6, device="cpu")
    with open(fj, "rb") as a, open(ft, "rb") as b:
        assert a.read() == b.read()
    from scs_tpu_torch.io import read_scs_data
    prob, spec, cd, stg = read_scs_data(ft, device="cpu")
    assert stg.eps_abs == 1e-6 and spec.z == 1 and spec.l == 2
    _, info = Workspace(prob, spec, cd, stg, device="cpu").solve()
    assert abs(info.pobj - sol["info"]["pobj"]) < 1e-4


def test_version():
    assert compat.version() == scs_tpu_torch.__version__
    assert scs_tpu_torch.scs_version() == scs_tpu.scs_version()
    assert compat.SOLVED == 1 and compat.INFEASIBLE == -2
    assert compat.UNBOUNDED == -1 and compat.SIGINT == -5


@pytest.mark.parametrize("storage", ["dense", "sparse"])
def test_run_from_file_on_a_jax_file(storage, tmp_path, capsys):
    spec = scs_tpu.ConeSpec(z=2, l=6, q=(4,))
    p = j_models.gen_planted(spec, n=8, seed=3, density=0.5)
    f = str(tmp_path / "prob.dat")
    j_io.write_scs_data(f, p.problem, spec, p.cone_data, scs_tpu.Settings())
    args = ["eps_abs", "1e-6", "eps_rel", "1e-6", "verbose", "0",
            "linsys", "direct"]
    assert j_rff([f] + args) == 0
    jout = capsys.readouterr().out
    rc = run_from_file.main([f, "storage", storage] + args
                            + ["device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "status:  solved" in out
    obj = float(out.split("objective = ")[1].split()[0])
    assert obj == float(jout.split("objective = ")[1].split()[0]) \
        or storage == "sparse"
    assert abs(obj - p.opt) < 1e-4 * (1 + abs(p.opt))
    with pytest.raises(SystemExit):
        run_from_file.override_setting(Settings(), "bogus", "1")


@pytest.mark.parametrize("linsys", ["direct", "indirect"])
def test_profile_phases_keeps_the_trajectory(linsys):
    spec = ConeSpec(z=4, l=10, q=(6,))
    jp = j_models.gen_planted(scs_tpu.ConeSpec(z=4, l=10, q=(6,)), n=10,
                              seed=17)
    prob = convert.problem_from_numpy(np.asarray(jp.problem.A),
                                      np.asarray(jp.problem.b),
                                      np.asarray(jp.problem.c))
    plain, pinfo = Workspace(prob, spec, None, Settings(linsys=linsys),
                             device="cpu").solve()
    sol, info = Workspace(prob, spec, None,
                          Settings(linsys=linsys, profile_phases=True),
                          device="cpu").solve()
    assert info.iter == pinfo.iter
    assert np.array_equal(sol.x, plain.x) and np.array_equal(sol.y, plain.y)
    timers = (info.lin_sys_time, info.cone_time, info.accel_time)
    assert all(math.isfinite(t) and t >= 0 for t in timers)
    assert sum(timers) <= info.solve_time
    assert math.isnan(pinfo.lin_sys_time)
    # no matrix cone: no spectral averages
    assert math.isnan(info.ave_time_matrix_cone_proj)


def test_profile_phases_measured_under_csv_and_fills_spectral(tmp_path):
    """Under the CSV trace the timers are still the measured ones and the
    trajectory the plain solve's; a PSD block fills the matrix-cone
    average."""
    p = planted_lowrank_sdp(ns=8, r=2, n=6)
    plain, pinfo = Workspace(p.problem, p.spec, p.cone_data,
                             Settings(max_iters=100), device="cpu").solve()
    ws = Workspace(p.problem, p.spec, p.cone_data,
                   Settings(profile_phases=True, max_iters=100,
                            log_csv_filename=str(tmp_path / "t.csv")),
                   device="cpu")
    sol, info = ws.solve()
    assert info.iter == pinfo.iter
    assert np.array_equal(sol.x, plain.x) and np.array_equal(sol.y, plain.y)
    timers = (info.lin_sys_time, info.cone_time, info.accel_time)
    assert all(math.isfinite(t) and t >= 0 for t in timers)
    assert sum(timers) <= info.solve_time
    assert info.lin_sys_time > 0 and info.cone_time > 0
    assert math.isfinite(info.ave_time_matrix_cone_proj)
    assert info.ave_time_matrix_cone_proj > 0
    assert math.isnan(info.ave_time_vector_cone_proj)
    with open(tmp_path / "t.csv") as fh:
        assert len(fh.read().strip().splitlines()) == info.iter + 1
    prof = ws.profile(n_calls=2)
    assert set(prof) == {"lin_sys_time_ms", "cone_time_ms",
                         "accel_time_ms", "mat_cone_ms"}


@pytest.mark.parametrize("indefinite", [True, False])
def test_convexity_probe_above_4096_on_a_dense_P(indefinite):
    """n = 4097: P = 0.5 I - 2 h h' (h = 1/sqrt(n), diagonal 0.5 - 2/n > 0,
    one eigenvalue -1.5) is flagged; P = 0.5 I + G G' (G n x 3) passes."""
    n, m = 4097, 6
    rng = np.random.RandomState(0)
    if indefinite:
        h = np.full(n, 1.0 / math.sqrt(n))
        P = 0.5 * np.eye(n) - 2.0 * np.outer(h, h)
    else:
        G = rng.randn(n, 3)
        P = 0.5 * np.eye(n) + G @ G.T
    P = torch.tensor(0.5 * (P + P.T))
    prob = Problem(A=torch.tensor(rng.randn(m, n)),
                   b=torch.ones(m, dtype=torch.float64),
                   c=torch.ones(n, dtype=torch.float64), P=P)
    assert bool((torch.diagonal(P) > 0).all())
    # without equilibration (~8 s on one CPU thread at this n): the probe's
    # answer is the same, congruence keeps the inertia
    stg = Settings(normalize=False)
    if indefinite:
        with pytest.raises(ValidationError, match="non-convexity"):
            Workspace(prob, ConeSpec(l=m), None, stg, device="cpu")
    else:
        Workspace(prob, ConeSpec(l=m), None, stg, device="cpu")
