"""scs_tpu_torch module by module against the JAX package: constants and
settings, cone dims, validation, equilibration, cone projections, the
direct KKT solve, root_plus and Anderson acceleration. Inputs are made
with numpy from seeds and handed to both packages; the port runs on the
CPU."""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

import scs_tpu
import scs_tpu_torch
from scs_tpu import accel as j_accel
from scs_tpu import config as j_config
from scs_tpu import equilibrate as j_eq
from scs_tpu import solver as j_solver
from scs_tpu import validation as j_val
from scs_tpu.cones import project as j_project
from scs_tpu.linsys import Mats as JMats
from scs_tpu.linsys import direct as j_direct
from scs_tpu.models import gen_planted as j_gen_planted
from scs_tpu_torch import accel, config, convert, equilibrate, parallel
from scs_tpu_torch import solver
from scs_tpu_torch import validation
from scs_tpu_torch.cones import project
from scs_tpu_torch.linsys import Mats
from scs_tpu_torch.linsys import direct

REPO = Path(__file__).resolve().parent.parent


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def test_config_constants_equal():
    names = [k for k in dir(j_config) if k.isupper()]
    assert names
    for k in names:
        assert getattr(config, k) == getattr(j_config, k), k
    assert sorted(k for k in dir(config) if k.isupper()) == sorted(names)


def test_settings_defaults_equal_field_by_field():
    jd = dataclasses.asdict(scs_tpu.Settings())
    assert convert.settings_from_dict(jd) == scs_tpu_torch.Settings()
    assert ([f.name for f in dataclasses.fields(scs_tpu.Settings)]
            == [f.name for f in dataclasses.fields(scs_tpu_torch.Settings)])
    s32 = convert.settings_from_dict(dataclasses.asdict(
        scs_tpu.Settings(dtype=jnp.float32, linsys="direct")))
    assert s32.dtype == torch.float32 and s32.linsys == "direct"


SPECS = [
    scs_tpu.ConeSpec(z=2, l=3, q=(3, 4), s=(3,), ep=1, ed=1, p=(0.3, -0.6)),
    scs_tpu.ConeSpec(z=3),
    scs_tpu.ConeSpec(z=5, l=20, q=(5, 5, 5, 10)),
    scs_tpu.ConeSpec(l=7, q=(1, 2, 1, 6, 6)),
    scs_tpu.ConeSpec(z=40, l=120, q=(20, 34, 14, 51, 22, 31, 1, 67)),
    scs_tpu.ConeSpec(q=(0, 3, 0)),
]


@pytest.mark.parametrize("spec", SPECS)
def test_cone_dims_equal(spec):
    tspec = convert.spec_from_dict(dataclasses.asdict(spec))
    assert tspec.dims() == spec.dims()
    assert tspec.num_cones() == spec.num_cones()
    assert project.cone_boundaries(tspec) == j_project.cone_boundaries(spec)
    assert hash(tspec) == hash(convert.spec_from_dict(
        dataclasses.asdict(spec)))


def _bad_inputs():
    """(A, b, c, P, spec, settings-kwargs) cases that validation rejects."""
    rng = np.random.RandomState(0)
    A = rng.randn(6, 3)
    b, c = rng.randn(6), rng.randn(3)
    P = np.eye(3)
    spec = dict(l=6)
    nan_b = b.copy()
    nan_b[2] = np.nan
    inf_A = A.copy()
    inf_A[1, 1] = np.inf
    asym = P.copy()
    asym[0, 1] = 0.5
    return [
        (A, b[:5], c, None, spec, {}),
        (A, b, c[:2], None, spec, {}),
        (A, nan_b, c, None, spec, {}),
        (inf_A, b, c, None, spec, {}),
        (A, b, c, asym, spec, {}),
        (A, b, c, np.eye(2), spec, {}),
        (A, b, c, None, dict(l=5), {}),
        (A, b, c, None, dict(z=2, l=2, q=(3,)), {}),
        (A, b, c, None, dict(l=-6), {}),
        (A, b, c, None, spec, dict(eps_abs=-1.0)),
        (A, b, c, None, spec, dict(alpha=2.0)),
        (A, b, c, None, spec, dict(max_iters=0)),
        (A, b, c, None, spec, dict(scale=0.0)),
        (A, b, c, None, spec, dict(acceleration_relaxation=3.0)),
        (A, b, c, None, spec, dict(psd_rank=-1)),
    ]


@pytest.mark.parametrize("case", range(len(_bad_inputs())))
def test_validation_same_errors(case):
    A, b, c, P, spec, kw = _bad_inputs()[case]
    jprob = scs_tpu.Problem(A=jnp.asarray(A), b=jnp.asarray(b),
                            c=jnp.asarray(c),
                            P=None if P is None else jnp.asarray(P))
    jspec = scs_tpu.ConeSpec(**spec)
    with pytest.raises(j_val.ValidationError) as jerr:
        j_val.validate(jprob, jspec, None, scs_tpu.Settings(**kw))
    tprob = convert.problem_from_numpy(A, b, c, P)
    with pytest.raises(validation.ValidationError) as terr:
        validation.validate(tprob, scs_tpu_torch.ConeSpec(**spec), None,
                            scs_tpu_torch.Settings(**kw))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("with_P", [False, True])
def test_equilibrate_matches(with_P):
    spec = scs_tpu.ConeSpec(z=5, l=20, q=(5, 5, 5, 10))
    p = j_gen_planted(spec, n=30, seed=3, density=0.3, with_P=with_P)
    A, P = p.problem.A, p.problem.P
    jA, jP, jscal = j_eq.equilibrate(A, P, spec)
    jb, jc, jscal = j_eq.normalize_b_c(jscal, p.problem.b, p.problem.c)
    tspec = convert.spec_from_dict(dataclasses.asdict(spec))
    tA, tP, tscal = equilibrate.equilibrate(
        t64(A), None if P is None else t64(P), tspec)
    tb, tc, tscal = equilibrate.normalize_b_c(tscal, t64(p.problem.b),
                                              t64(p.problem.c))
    pairs = [(tscal.D, jscal.D), (tscal.E, jscal.E), (tA, jA), (tb, jb),
             (tc, jc), (tscal.primal_scale, jscal.primal_scale)]
    if with_P:
        pairs.append((tP, jP))
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


def test_proj_dual_cone_matches():
    spec = scs_tpu.ConeSpec(z=3, l=7, q=(1, 4, 4, 2, 9, 1))
    tspec = convert.spec_from_dict(dataclasses.asdict(spec))
    rng = np.random.RandomState(5)
    cd = scs_tpu.ConeData.make(spec)
    for trial in range(6):
        x = rng.randn(spec.dims()) * (1 + trial)
        r = rng.uniform(0.01, 10.0, spec.dims()) if trial % 2 else None
        ref, _ = j_project.proj_dual_cone(
            jnp.asarray(x), spec, cd, jnp.ones(()),
            None if r is None else jnp.asarray(r))
        got, _ = project.proj_dual_cone(t64(x), tspec, None, None,
                                        None if r is None else t64(r))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-12, atol=1e-12)
        jprim, _ = j_project.proj_cone(jnp.asarray(x), spec, cd,
                                       jnp.ones(()), None)
        np.testing.assert_allclose(
            project.proj_cone(t64(x), tspec)[0].numpy(), np.asarray(jprim),
            rtol=1e-12, atol=1e-12)


def test_proj_cone_outside_slice_raises():
    """The spec that raised until the spectral cones came in (logdet beside
    exp) now lays out and projects as the JAX package does."""
    jspec = scs_tpu.ConeSpec(l=3, d=(2,), ep=1)
    tspec = convert.spec_from_dict(dataclasses.asdict(jspec))
    jl, tl = j_project.ConeLayout.make(jspec), project.ConeLayout.make(tspec)
    for f in dataclasses.fields(jl):
        if f.name != "spec":
            assert getattr(tl, f.name) == getattr(jl, f.name), f.name
    x = np.random.RandomState(11).randn(3, jspec.dims()) * 2.0
    cd = scs_tpu.ConeData.make(jspec)
    j_proj = jax.jit(lambda xi: j_project.proj_cone(xi, jspec, cd,
                                                    jnp.ones(()), None)[0])
    ref = np.stack([np.asarray(j_proj(jnp.asarray(xi))) for xi in x])
    got = project.proj_cone(t64(x), tspec)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-10 * (1 + np.abs(x).max()))


@pytest.mark.parametrize("mixed", [False, True])
def test_direct_kkt_solve_matches(mixed):
    spec = scs_tpu.ConeSpec(z=5, l=20, q=(5, 5, 5, 10))
    p = j_gen_planted(spec, n=30, seed=3, density=0.3, with_P=True)
    A, P = p.problem.A, p.problem.P
    m, n = A.shape
    diag_r = j_solver.set_diag_r(spec, n, m, jnp.asarray(0.1), 1e-6,
                                 jnp.float64)
    rhs = np.random.RandomState(1).randn(n + m)
    jm = JMats(A, P, None, None, j_direct.precompute(A, P, spec.z))
    jder = j_direct.derive(jm, diag_r, jnp.asarray(0.1), mixed=mixed)
    ref, _ = j_direct.solve(jm, diag_r, jder, jnp.asarray(rhs), None, None)
    ref = np.asarray(ref)
    for ds in ([False, True] if mixed else [False]):
        tm = Mats(t64(A), t64(P), direct.precompute(t64(A), t64(P), spec.z,
                                                    ds=ds))
        tdr = t64(diag_r)
        der = direct.derive(tm, tdr, torch.tensor(0.1, dtype=torch.float64),
                            mixed=mixed)
        got, _ = direct.solve(tm, tdr, der, t64(rhs))
        rel = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
        assert rel < 1e-10, (ds, rel)


ROOT_PLUS_CASES = [
    ([1.0, -2.0, 0.5], [0.3, 0.7, -0.1], [-0.5, 1.2, 0.8],
     [2.0, 0.5, 1.5], 1.0, 0.5),
    ([-0.1, 3.0, -2.5, 0.7, 1.1, -0.3, 0.9, -1.4],
     [0.5, -0.8, 1.2, -0.4, 0.6, 2.1, -1.0, 0.3],
     [1.0, -1.5, 0.3, 0.8, -0.2, 0.7, 1.3, -0.6],
     [0.1, 1.0, 3.0, 0.5, 2.0, 0.8, 1.5, 0.3], 2.5, -0.3),
    ([0.01, -0.02], [100.0, -50.0], [200.0, 300.0], [1.0, 1.0], 1e6, 1.0),
    ([1.0, 0.0, 0.0, 0.0, 0.0], [0.0] * 5, [0.0] * 5, [1.0] * 5, 1.0, 0.0),
    ([0.5, -1.3, 2.1, -0.7, 0.9, 1.1], [-0.2, 0.8, -1.5, 0.4, -0.6, 1.0],
     [0.3, -0.9, 0.6, 1.2, -0.8, 0.1],
     [1e-4, 1e-2, 1.0, 1e2, 1e4, 1e6], 0.01, 2.0),
    ([0.0], [1.0], [0.0], [1.0], 1.0, -1e8),      # stable c/q branch
    ([0.0], [0.0], [0.0], [1.0], 0.0, 0.0),       # a = 0: degenerate
    ([1.0], [1.0], [0.0], [1.0], 1.0, 1e8),       # b <= 0 branch
]


@pytest.mark.parametrize("case", ROOT_PLUS_CASES)
def test_root_plus_matches(case):
    g, p, mu, r, tau_scale, eta = case
    nm = len(g)
    diag_r = np.concatenate([r, [tau_scale]])
    mu_full = np.concatenate([mu, [eta]])
    ref = float(j_solver.root_plus(
        jnp.asarray(g, jnp.float64), jnp.asarray(p, jnp.float64),
        jnp.asarray(mu_full), jnp.asarray(eta, jnp.float64),
        jnp.asarray(diag_r), nm))
    got = float(solver.root_plus(t64(g), t64(p), t64(mu_full),
                                 torch.tensor(eta, dtype=torch.float64),
                                 t64(diag_r), nm))
    if np.isnan(ref):
        assert np.isnan(got)
    else:
        assert abs(got - ref) <= 1e-12 * max(abs(ref), 1.0), (got, ref)


def _aa_sequence(l=12, steps=36, seed=4):
    """A recorded fixed-point sequence x_{k+1} = F(x_k) + noise."""
    rng = np.random.RandomState(seed)
    M = rng.randn(l, l)
    M *= 0.95 / np.max(np.abs(np.linalg.eigvals(M)))
    c = rng.randn(l)
    xs, fs = [], []
    x = rng.randn(l)
    for k in range(steps):
        f = M @ x + c + (0.3 * rng.randn(l) if k % 7 == 3 else 0.0)
        xs.append(x)
        fs.append(f)
        x = f
    return xs, fs


@pytest.mark.parametrize("kw", [
    dict(type1=True), dict(type1=False),
    dict(type1=True, max_weight_norm=1.0),
    dict(type1=False, relaxation=0.7),
    dict(type1=True, gamma_f32=True),
])
def test_anderson_matches(kw):
    mem, l = 5, 12
    base = dict(mem=mem, regularization=1e-8, relaxation=1.0)
    base.update(kw)
    japply = jax.jit(lambda a, f, x: j_accel.aa_apply(a, f, x, **base))
    jguard = jax.jit(j_accel.aa_safeguard)
    ja = j_accel.aa_init(l, mem, jnp.float64)
    ta = accel.aa_init(l, mem, torch.float64, "cpu")
    xs, fs = _aa_sequence(l)
    rtol = 1e-5 if kw.get("gamma_f32") else 1e-9
    for k in range(len(xs) - 1):
        ja, jf, jn = japply(ja, jnp.asarray(fs[k]), jnp.asarray(xs[k]))
        ta, tf, tn = accel.aa_apply(ta, t64(fs[k]), t64(xs[k]), **base)
        scale = np.linalg.norm(fs[k]) + 1.0
        assert np.linalg.norm(tf.numpy() - np.asarray(jf)) <= rtol * scale
        assert (float(tn) > 0) == (float(jn) > 0)
        if float(jn) > 0:
            ja, jf2, jx2, jrej = jguard(ja, jnp.asarray(fs[k + 1]),
                                       jnp.asarray(xs[k + 1]))
            ta, tf2, tx2, trej = accel.aa_safeguard(ta, t64(fs[k + 1]),
                                                    t64(xs[k + 1]))
            assert bool(trej) == bool(jrej)
            np.testing.assert_allclose(tf2.numpy(), np.asarray(jf2),
                                       rtol=0, atol=rtol * scale)
    for name in ("it", "n_accept", "n_reject", "n_safeguard_reject"):
        assert int(getattr(ta, name)) == int(getattr(ja, name)), name
    assert int(ta.n_accept) + int(ta.n_reject) > 0


def test_batch_from_numpy_round_trip():
    jspec = scs_tpu.ConeSpec(l=6)
    probs = [j_gen_planted(jspec, n=3, seed=i, with_P=True) for i in (1, 2)]
    arrays = [np.stack([np.asarray(getattr(p.problem, k)) for p in probs])
              for k in ("A", "b", "c", "P")]
    tA, tP, tb, tc, tbu, tbl = convert.batch_from_numpy(*arrays)
    for got, ref in zip((tA, tb, tc, tP), arrays):
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), ref)
    assert tbu.shape == tbl.shape == (2, 0)
    assert convert.batch_from_numpy(*arrays[:3])[1] is None
    bnd = np.ones((2, 3))
    np.testing.assert_array_equal(
        convert.batch_from_numpy(*arrays, bu=bnd, bl=-bnd)[5].numpy(), -bnd)
    stg = convert.settings_from_dict(dataclasses.asdict(
        scs_tpu.Settings(linsys="direct")))
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    res = parallel.make_batch_solver(spec, stg, has_P=True, device="cpu")(
        tA, tP, tb, tc, tbu, tbl)
    out = convert.solve_result_to_numpy(res)
    assert out["x"].shape == (2, 3) and out["status"].dtype == np.int64
    np.testing.assert_array_equal(out["iters"], res.iters.numpy())
    assert out["pobj"].shape == (2,)


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|scs_tpu)\b(?!_torch)"
    r"|from\s+(jax|scs_tpu)\b(?!_torch))", re.M)


def test_port_imports_neither_jax_nor_scs_tpu():
    files = sorted((REPO / "scs_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files += sorted((REPO / "tools").glob("torch_*.py"))
    assert len(files) > 10
    names = {p.relative_to(REPO).as_posix() for p in files}
    for module in ("linsys/indirect.py", "linsys/matvec.py",
                   "ops/roofline.py", "ops/dsmatmul.py"):
        assert f"scs_tpu_torch/{module}" in names, module
    for tool in ("torch_f32_state_iterations.py", "torch_indirect_steps.py",
                 "torch_kernel_rows.py", "torch_batch_trees.py"):
        assert f"tools/{tool}" in names, tool
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, (path, hits)


def test_port_runs_without_jax_in_the_process():
    """A fresh interpreter imports the package and every module of its
    entry points, then solves a tiny problem on the CPU through the
    compat layer: neither jax nor scs_tpu enters sys.modules."""
    import subprocess
    import sys

    code = (
        "import sys, numpy as np\n"
        "import scs_tpu_torch\n"
        "from scs_tpu_torch import compat, io, run_from_file\n"
        "from scs_tpu_torch.ops import subspace\n"
        "from scs_tpu_torch.utils import native\n"
        "from scs_tpu_torch.models import planted_lowrank_sdp\n"
        "sol = compat.solve({'A': -np.eye(2), 'b': -np.ones(2),\n"
        "                    'c': np.ones(2)}, {'l': 2}, verbose=False,\n"
        "                   device='cpu')\n"
        "assert sol['info']['status'] == 'solved'\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'scs_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, (out.stdout, out.stderr)
