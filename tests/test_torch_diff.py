"""Differentiation through the solve (`scs_tpu_torch.diff`) against the
JAX package's `make_diff_solver` on the CPU, on every instance of
tests/test_diff.py, with the same numpy inputs (its own generators:
`_gen_strictly_complementary`, `gen_planted`).

Both sides solve to eps 1e-11 and differentiate the same plain map, so
the port's gradients are held to the JAX package's within
GRAD_ATOL + GRAD_RTOL * max(|g_jax|, 1) entry by entry (1e-7 + 1e-6 *
scale; the JAX file holds its gradients to finite differences within
5e-5 + 5e-4 * scale, and the PSD case within 2e-4 + 2e-3 * scale). The
port's own checks: a central finite difference along one random unit
direction per cone family within 5e-5 + 5e-4 * max(|fd|, 1) (two solves
at +-1e-4: the power and exp projections stop their Newton loops at
~1e-9, which a step of 1e-6 would amplify to ~1e-3), d(c'x)/db = -y*
within 5e-6 (the JAX file's), the jvp/vjp adjoint identity within 1e-8
(1 + |<w, J t>|), the forward value against
`make_pure_solver` within 1e-12, a batch of 4 against the same problems
one by one within 1e-9 (1 + |g|) (the lanes run the same arithmetic; the
batched GMRES sums in another order), and the argument errors."""

import functools

import numpy as np
import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import torch.autograd.forward_ad as fwAD

from scs_tpu.diff import make_diff_solver as j_make_diff_solver
from scs_tpu.models import gen_planted as j_gen_planted
from scs_tpu.types import ConeData as JConeData
from scs_tpu.types import ConeSpec as JConeSpec
from scs_tpu.types import Settings as JSettings
from scs_tpu_torch import ConeSpec, Settings, config, convert
from scs_tpu_torch.diff import gmres, make_diff_solver
from scs_tpu_torch.parallel import make_pure_solver
from scs_tpu_torch.validation import ValidationError

from test_diff import _gen_strictly_complementary

J_TIGHT = JSettings(eps_abs=1e-11, eps_rel=1e-11)
TIGHT = Settings(eps_abs=1e-11, eps_rel=1e-11)
GRAD_ATOL, GRAD_RTOL = 1e-7, 1e-6
FD_ATOL, FD_RTOL = 5e-5, 5e-4


def _np(prob):
    return {k: None if getattr(prob, k) is None
            else np.asarray(getattr(prob, k)) for k in ("A", "b", "c", "P")}


def _box_instance():
    """tests/test_diff.py::test_grad_box_cone_bounds's instance."""
    rng = np.random.RandomState(2)
    nb, n = 2, 4
    jspec = JConeSpec(z=1, bsize=nb + 1)
    bu = rng.rand(nb) + 0.5
    bl = -(rng.rand(nb) + 0.5)
    cd = JConeData.make(jspec, bu=bu, bl=bl)
    p = j_gen_planted(jspec, n=n, seed=3, density=0.9, cone_data=cd)
    return jspec, dict(_np(p.problem), bu=bu, bl=bl)


def _medium_instance():
    """tests/test_diff.py::test_grad_medium_scale_directional's LP."""
    rng = np.random.RandomState(0)
    z, l, n = 10, 110, 40
    m = z + l
    act = n - z
    A = rng.randn(m, n)
    y = np.zeros(m)
    s = np.zeros(m)
    y[:z] = rng.randn(z)
    y[z:z + act] = rng.rand(act) + 0.5
    s[z + act:] = rng.rand(l - act) + 0.5
    x = rng.randn(n)
    return JConeSpec(z=z, l=l), dict(A=A, b=A @ x + s, c=-A.T @ y, P=None)


def _instance(name):
    """(JAX spec, numpy data, has_P, wrt, kwargs of make_diff_solver)."""
    sc = _gen_strictly_complementary
    if name == "lp":
        return JConeSpec(z=2, l=6), _np(sc(seed=0)), False, "Abc", {}
    if name == "socp":
        return (JConeSpec(z=1, l=3, q=(3,)),
                _np(sc(z=1, l=3, q=(3,), n=4, seed=2)), False, "Abc", {})
    if name == "qp":
        return (JConeSpec(z=2, l=5),
                _np(sc(z=2, l=5, n=4, act=1, seed=4, with_P=True)), True,
                "AbcP", {})
    if name == "psd":
        spec = JConeSpec(l=2, s=(2,))
        return (spec, _np(j_gen_planted(spec, n=3, seed=19,
                                        density=0.9).problem),
                False, "Abc", {})
    if name in ("exp", "power", "nuclear"):
        kw, n, seed = {"exp": (dict(z=1, ep=1), 3, 0),
                       "power": (dict(z=1, p=(0.6,)), 3, 3),
                       "nuclear": (dict(l=2, nuc_m=(3,), nuc_n=(2,)), 5,
                                   1)}[name]
        spec = JConeSpec(**kw)
        return (spec, _np(j_gen_planted(spec, n=n, seed=seed,
                                        density=0.9).problem),
                False, "bc", {})
    if name == "ell1":
        return (JConeSpec(z=1, l=3, ell1=(4,)),
                _np(sc(z=1, l=3, ell1=(4,), n=4, seed=0)), False, "bc", {})
    if name == "box":
        jspec, data = _box_instance()
        return jspec, data, False, "b", {}
    if name == "medium":
        jspec, data = _medium_instance()
        return jspec, data, False, "Abc", dict(gmres_restart=160)
    raise KeyError(name)


INSTANCES = ("lp", "socp", "qp", "psd", "exp", "power", "ell1", "nuclear",
             "box", "medium")


def _args(name, data, has_P):
    """The positional arguments after (A, b, c)."""
    out = [data["P"]] if has_P else []
    if name == "box":
        out += [data["bu"], data["bl"]]
    return out


def _names(name, has_P):
    return (["A", "b", "c"] + (["P"] if has_P else [])
            + (["bu", "bl"] if name == "box" else []))


def _w(n):
    return np.random.RandomState(7).randn(n)


def _port(name):
    jspec, data, has_P, _, kw = _instance(name)
    spec = convert.spec_from_dict(jspec.__dict__)
    return spec, make_diff_solver(spec, TIGHT, has_P=has_P, device="cpu",
                                  **kw)


@functools.lru_cache(maxsize=None)
def _port_grads(name):
    """(gradients of w'x, the diff solver), once per instance."""
    _, data, has_P, _, _ = _instance(name)
    _, solve = _port(name)
    raw = [data["A"], data["b"], data["c"]] + _args(name, data, has_P)
    ts = [torch.tensor(a, requires_grad=True) for a in raw]
    x, _, _ = solve(*ts)
    (torch.as_tensor(_w(x.shape[0])) @ x).backward()
    return [t.grad.numpy() for t in ts], solve


@pytest.fixture(scope="module")
def jax_grads():
    """Each instance's JAX reverse-mode gradients of w'x, computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            jspec, data, has_P, _, kw = _instance(name)
            solve = j_make_diff_solver(jspec, J_TIGHT, has_P=has_P, **kw)
            raw = ([data["A"], data["b"], data["c"]]
                   + _args(name, data, has_P))
            w = jnp.asarray(_w(data["A"].shape[1]))

            @jax.jit
            def loss(*a):
                return w @ solve(*a)[0]

            g = jax.jit(jax.grad(loss, argnums=tuple(range(len(raw)))))(
                *[jnp.asarray(a) for a in raw])
            cache[name] = [np.asarray(t) for t in g]
        return cache[name]

    return get


def _close(got, want, label):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert np.all(np.isfinite(got)), f"{label}: non-finite gradient"
    assert err <= GRAD_ATOL + GRAD_RTOL * scale, (
        f"{label}: max err {err:.2e} (scale {scale:.2e})\nport\n{got}\n"
        f"jax\n{want}")


@pytest.mark.parametrize("name", INSTANCES)
def test_reverse_mode_matches_jax(name, jax_grads):
    """The gradient of w'x* with respect to every argument equals the JAX
    package's on each instance of tests/test_diff.py."""
    _, _, has_P, _, _ = _instance(name)
    got, solve = _port_grads(name)
    want = jax_grads(name)
    for label, g, j in zip(_names(name, has_P), got, want):
        _close(g, j, f"{name}: d/d{label}")
    steps = solve.core.last_gmres_steps
    # one VJP a GMRES step, one a restart's residual, two around GMRES
    assert int(steps[0]) > 0 and solve.core.last_evals > 2 + int(steps[0])


def _jvp_case(which):
    """(JAX instance name, argument index, direction) of tests/test_diff.
    py's two test_jvp_mode_* cases."""
    if which == "b":
        _, data, _, _, _ = _instance("lp")
        return "lp", 1, np.random.RandomState(1).randn(data["b"].shape[0])
    dP = np.random.RandomState(2).randn(4, 4)
    return "qp", 3, 0.5 * (dP + dP.T)


@pytest.mark.parametrize("which", ["b", "P"])
def test_forward_mode_matches_jax(which):
    """Forward mode (dual tensors through the Function's jvp) equals the
    JAX package's mode='jvp' on the two test_jvp_mode_* instances, and the
    jvp/vjp adjoint identity <w, J t> = <J^T w, t> holds."""
    name, idx, d = _jvp_case(which)
    jspec, data, has_P, _, _ = _instance(name)
    raw = [data["A"], data["b"], data["c"]] + _args(name, data, has_P)
    jsolve = j_make_diff_solver(jspec, J_TIGHT, has_P=has_P)
    f = jax.jit(functools.partial(jsolve, mode="jvp"))
    jraw = [jnp.asarray(a) for a in raw]

    def at(t):
        a = list(jraw)
        a[idx] = t
        return f(*a)

    _, (jdx, jdy, jds) = jax.jvp(at, (jraw[idx],), (jnp.asarray(d),))

    _, solve = _port(name)
    ts = [torch.as_tensor(a) for a in raw]
    with fwAD.dual_level():
        ts[idx] = fwAD.make_dual(ts[idx], torch.as_tensor(d))
        out = solve(*ts, mode="jvp")
        dx, dy, ds = (fwAD.unpack_dual(t).tangent for t in out)
    for label, g, j in (("dx", dx, jdx), ("dy", dy, jdy), ("ds", ds, jds)):
        _close(g.numpy(), np.asarray(j), f"{name} jvp {label}")

    w = _w(raw[0].shape[1])
    ts = [torch.tensor(a, requires_grad=(i == idx))
          for i, a in enumerate(raw)]
    x, _, _ = solve(*ts)
    (torch.as_tensor(w) @ x).backward()
    fwd = float(w @ dx.numpy())
    bwd = float((ts[idx].grad.numpy() * d).sum())
    assert abs(fwd - bwd) < 1e-8 * (1 + abs(fwd)), (fwd, bwd)


def _loss_at(solve, raw, w):
    with torch.no_grad():
        x, _, _ = solve(*[torch.as_tensor(a) for a in raw])
    return float(torch.as_tensor(w) @ x)


@pytest.mark.parametrize("name", ["lp", "socp", "qp", "psd", "exp", "power",
                                  "ell1", "nuclear", "box"])
def test_directional_finite_difference(name):
    """A central finite difference of w'x* along one random unit direction
    in the differentiated arguments (two solves) equals <grad, d>."""
    _, data, has_P, wrt, _ = _instance(name)
    _, solve = _port(name)
    names = _names(name, has_P)
    raw = [data["A"], data["b"], data["c"]] + _args(name, data, has_P)
    got, _ = _port_grads(name)
    rng = np.random.RandomState(11)
    dirs = [rng.randn(*a.shape) if k in wrt or (k in ("bu", "bl"))
            else np.zeros_like(a) for k, a in zip(names, raw)]
    if has_P:
        i = names.index("P")
        dirs[i] = 0.5 * (dirs[i] + dirs[i].T)
    norm = np.sqrt(sum((d * d).sum() for d in dirs))
    dirs = [d / norm for d in dirs]
    w = _w(raw[0].shape[1])
    eps = 1e-4
    fp = _loss_at(solve, [a + eps * d for a, d in zip(raw, dirs)], w)
    fm = _loss_at(solve, [a - eps * d for a, d in zip(raw, dirs)], w)
    fd = (fp - fm) / (2 * eps)
    an = sum(float((g * d).sum()) for g, d in zip(got, dirs))
    assert abs(an - fd) < FD_ATOL + FD_RTOL * max(abs(fd), 1.0), (an, fd)


def test_grad_matches_dual_sensitivity():
    """d(c'x*)/db = -y* for an LP (tests/test_diff.py's identity)."""
    jspec = JConeSpec(z=2, l=6)
    p = j_gen_planted(jspec, n=4, seed=23, density=0.9)
    d = _np(p.problem)
    solve = make_diff_solver(ConeSpec(z=2, l=6), TIGHT, device="cpu")
    A, c = torch.as_tensor(d["A"]), torch.as_tensor(d["c"])
    b = torch.tensor(d["b"], requires_grad=True)
    x, y, _ = solve(A, b, c)
    (c @ x).backward()
    np.testing.assert_allclose(b.grad.numpy(), -y.detach().numpy(),
                               atol=5e-6)


def test_rejects_logdet_and_sum_largest():
    with pytest.raises(ValidationError, match="logdet"):
        make_diff_solver(ConeSpec(d=(3,)), device="cpu")
    with pytest.raises(ValidationError, match="logdet"):
        make_diff_solver(ConeSpec(l=2, sl_n=(3,), sl_k=(1,)), device="cpu")


def test_forward_value_is_the_pure_solve():
    """diff_solve returns the solution of make_pure_solver (same settings)."""
    jspec = JConeSpec(z=2, l=6)
    d = _np(j_gen_planted(jspec, n=4, seed=11, density=0.9).problem)
    spec = ConeSpec(z=2, l=6)
    solve = make_diff_solver(spec, TIGHT, device="cpu")
    A, b, c = (torch.as_tensor(d[k]) for k in "Abc")
    x, y, s = solve(A, b, c)
    res = make_pure_solver(spec, TIGHT, device="cpu")(
        A, None, b, c, torch.zeros(0), torch.zeros(0))
    assert int(res.status) == config.SOLVED
    for got, want in ((x, res.x), (y, res.y), (s, res.s)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12)


def test_batch_equals_one_by_one():
    """A batch of 4 (stacked operands) gives each lane the gradients of
    its problem solved alone."""
    spec = ConeSpec(z=1, l=3, q=(3,))
    probs = [_np(_gen_strictly_complementary(z=1, l=3, q=(3,), n=4,
                                             seed=s)) for s in (2, 3, 5, 6)]
    solve = make_diff_solver(spec, TIGHT, device="cpu")
    w = torch.as_tensor(_w(4))
    singles = []
    for p in probs:
        ts = [torch.tensor(p[k], requires_grad=True) for k in "Abc"]
        (w @ solve(*ts)[0]).backward()
        singles.append([t.grad.numpy() for t in ts])
    ts = [torch.tensor(np.stack([p[k] for p in probs]), requires_grad=True)
          for k in "Abc"]
    x, _, _ = solve(*ts)
    (x @ w).sum().backward()
    assert solve.core.last_gmres_steps.shape == (4,)
    for lane in range(4):
        for k, t in enumerate(ts):
            g = t.grad[lane].numpy()
            want = singles[lane][k]
            assert np.abs(g - want).max() <= 1e-9 * (
                1 + np.abs(want).max()), (lane, "Abc"[k])


def test_argument_errors():
    solve = make_diff_solver(ConeSpec(z=1, l=2), device="cpu")
    A, b, c = torch.ones(3, 2), torch.ones(3), torch.ones(2)
    with pytest.raises(TypeError, match="expects"):
        solve(A, b, c, torch.eye(2))
    with pytest.raises(ValueError, match="mode"):
        solve(A, b, c, mode="hvp")
    solve_p = make_diff_solver(ConeSpec(z=1, l=2), has_P=True, device="cpu")
    with pytest.raises(TypeError, match="expects"):
        solve_p(A, b, c)
    if not torch.cuda.is_available():
        # the card is the default: without one it raises, no CPU run
        with pytest.raises(RuntimeError, match="CUDA"):
            make_diff_solver(ConeSpec(z=1, l=2))


def test_gmres_batched_lanes():
    """The batched GMRES solves each lane's nonsymmetric system to its
    tolerance, freezing lanes independently (one lane already solved by
    x = 0: b = 0)."""
    rng = np.random.RandomState(0)
    B, l = 3, 12
    M = torch.as_tensor(np.eye(l) + 0.3 * rng.randn(B, l, l))
    rhs = torch.as_tensor(rng.randn(B, l))
    rhs[1] = 0.0
    x, steps, calls = gmres(lambda u: torch.einsum("bij,bj->bi", M, u), rhs,
                            tol=1e-12, atol=1e-12, restart=5, maxiter=50)
    want = torch.linalg.solve(M, rhs)
    assert float((x - want).abs().max()) < 1e-9
    assert int(steps[1]) == 0 and int(steps[0]) > 5 and calls > 5


def test_mixed_size_soc_with_a_size_one_block():
    """A mixed-size SOC list with a size-1 block (the headline family's
    layout, at small widths; `models.planted_complementary`): the
    gradient is finite (the size-1 block's tail norm is sqrt(0)) and
    matches a central finite difference along a random unit direction
    within 5e-5 + 5e-4 max(|fd|, 1)."""
    from scs_tpu_torch.models import planted_complementary
    spec = ConeSpec(z=2, l=6, q=(4, 1, 3))
    p = planted_complementary(spec, 8, seed=1)
    solve = make_diff_solver(spec, TIGHT, device="cpu")
    raw = [p.A.numpy(), p.b.numpy(), p.c.numpy()]
    ts = [torch.tensor(a, requires_grad=True) for a in raw]
    w = _w(8)
    (torch.as_tensor(w) @ solve(*ts)[0]).backward()
    got = [t.grad.numpy() for t in ts]
    assert all(np.all(np.isfinite(g)) for g in got)
    rng = np.random.RandomState(3)
    dirs = [rng.randn(*a.shape) for a in raw]
    norm = np.sqrt(sum((d * d).sum() for d in dirs))
    dirs = [d / norm for d in dirs]
    eps = 1e-4
    fp = _loss_at(solve, [a + eps * d for a, d in zip(raw, dirs)], w)
    fm = _loss_at(solve, [a - eps * d for a, d in zip(raw, dirs)], w)
    fd = (fp - fm) / (2 * eps)
    an = sum(float((g * d).sum()) for g, d in zip(got, dirs))
    assert abs(an - fd) < FD_ATOL + FD_RTOL * max(abs(fd), 1.0), (an, fd)


def test_planted_complementary_is_strictly_complementary():
    """`planted_complementary`'s optimum, solved back: every nonnegative
    row has exactly one of y and s above 0.1 (strict complementarity),
    the size-1 SOC block is slack, and the face count holds (as many
    active dimensions as variables); only z, l and q rows are taken."""
    from scs_tpu_torch.models import planted_complementary
    spec = ConeSpec(z=4, l=10, q=(5, 1, 4, 6))
    p = planted_complementary(spec, 12, seed=2, max_cond=50)
    res = make_pure_solver(spec, TIGHT, device="cpu")(
        p.A, None, p.b, p.c, torch.zeros(0), torch.zeros(0))
    assert int(res.status) == config.SOLVED
    y, s = res.y.numpy(), res.s.numpy()
    lin = slice(spec.z, spec.z + spec.l)
    assert np.all((y[lin] > 0.1) != (s[lin] > 0.1))
    assert s[spec.z + spec.l + 5] > 0.1 and abs(y[spec.z + spec.l + 5]) < 1e-8
    # z + active rows + (k - 1) per boundary SOC block = n
    act = int((y[lin] > 0.1).sum())
    off, bnd = spec.z + spec.l, 0
    for k in spec.q:
        if k > 1 and np.linalg.norm(y[off:off + k]) > 0.1:
            bnd += k - 1
        off += k
    assert spec.z + act + bnd == 12
    with pytest.raises(ValueError, match="z, l and q"):
        planted_complementary(ConeSpec(l=2, s=(2,)), 3)
