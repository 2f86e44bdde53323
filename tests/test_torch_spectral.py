"""The spectral cones of scs_tpu_torch (log-determinant, nuclear-norm,
ell1-norm, sum-of-k-largest-eigenvalues) against the JAX package on the
CPU.

Cone functions: the same numpy inputs through both packages, sizes
{2, 3, 5} (ell1 up to 12; 0 < k < n for sum-largest; m >= n for nuclear):
float64 within 1e-10 (1 + |v|), the eigh or SVD in float32 (`f32_eig`)
within 1e-4 (1 + |v|), |v| the input's largest entry; a stack of cones
equals the cones projected one by one. Newton and the KKT check within
1e-10; the IPM within 1e-10 on the lanes whose IPM converged inside its
100-iteration cap, and on the others (where round-off moves the capped
point within the IPM's tolerance, in either package) through SCS's KKT
gate in both packages alike. On tests/test_spectral.py's four hostile
logdet inputs the port's Newton fails the gate where the JAX package's
does, and the cascade returns a point that passes it. The Moreau dual on
a spec with all four families within 1e-10; the layout equals the JAX
package's offsets.

The JAX package's float32-state batched phase fails at trace time on a
spectral cone (ROADMAP R5). Solves: tests/test_torch_spectral_solve.py.

Budget: every JAX function is jitted once per shape and shared through
a module-level cache."""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

import scs_tpu
from scs_tpu import models as j_models
from scs_tpu.cones import project as j_project
from scs_tpu.cones import spectral as J
from scs_tpu.parallel import make_chunked_batch_solver as j_make_chunked
from scs_tpu_torch import convert
from scs_tpu_torch.cones import project, spectral

F64 = jnp.float64
SIZES = [2, 3, 5]
HOSTILE = [   # tests/test_spectral.py:248-315
    (5.082435488032196e-10, 8.506457308922922e-09,
     [-4.272511074887552e-3, 1612.5766570104993, 2.3962479578326507e-4,
      9659001.88718107, -309.40364380125715]),
    (-9.729386358385083, -25.941608729540086,
     [-81.77037740049792, 1.4700323254063617e-7, -96.17041026133768,
      -0.07302622673869442, -8.051350943583813e-4]),
    (-3281893.3130367114, -7.248027788642238e-5,
     [-2.4764898646901777e-6, -419731.503938163, 9.83056199446518e-8,
      -0.035495933924680104, -62266663.29480791]),
    (1726.0136109153, 6.4521160066250675e-12,
     [-1.8278247468388985e-6, 1.4778584650322195e-9, -8.621994661897662e-6,
      -123447.69360212852, 8.872849472327973e-10]),
]


def _close(got, ref, v, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / (1.0 + np.abs(v).max())
    assert err <= tol, err


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


@functools.lru_cache(maxsize=None)
def _jit(name, *static):
    """One jitted, row-vmapped JAX function per (name, static args)."""
    fns = {
        "ell1": lambda: J.proj_ell1,
        "sl_sorted": lambda k: lambda t, x: J.proj_sum_largest_sorted(t, x,
                                                                     k),
        "sl_evals": lambda ns, k, f32: lambda r: J.proj_sum_largest_evals(
            r, ns, k, f32),
        "nuclear": lambda m, n, f32: lambda r: J.proj_nuclear(r, m, n, f32),
        "newton": lambda: J.log_cone_newton,
        "check": lambda: J.check_logdet_opt,
    }
    if name == "logdet":
        ns, f32 = static
        return jax.jit(lambda s: J.proj_logdet_batch(s, ns, f32))
    if name == "gate":
        return jax.jit(J._logdet_gate)
    return jax.jit(jax.vmap(fns[name](*static)))


# ---- vector cones ----

@pytest.mark.parametrize("n", SIZES + [12])
def test_ell1_matches_jax(n):
    rng = np.random.RandomState(n)
    tx = rng.randn(16, n + 1) * 2.0
    tx[:, 1:][rng.rand(16, n) < 0.25] = 0.0           # zeros: sign(0) = +1
    tx[:4, 2:] = tx[:4, 1:2]                           # ties in |x|
    tx[4, 0] = -np.abs(tx[4, 1:]).max() - 1.0          # all to zero
    tx[5, 0] = np.abs(tx[5, 1:]).sum() + 1.0           # inside the cone
    ref = np.asarray(_jit("ell1")(jnp.asarray(tx)))
    got = spectral.proj_ell1(t64(tx).reshape(2, 8, n + 1)).reshape(16, -1)
    _close(got, ref, tx, 1e-10)
    np.testing.assert_array_equal(got[5].numpy(), tx[5])
    xs = -np.sort(-np.abs(tx[:, 1:]), axis=1)
    tp, xp = spectral.ell1_proj_sorted(t64(tx[:, 0]), t64(xs))
    jt, jx = jax.vmap(J.ell1_proj_sorted)(jnp.asarray(tx[:, 0]),
                                          jnp.asarray(xs))
    _close(tp, jt, tx, 1e-10)
    _close(xp, jx, tx, 1e-10)


@pytest.mark.parametrize("n", SIZES)
def test_sum_largest_sorted_matches_jax(n):
    rng = np.random.RandomState(20 + n)
    for k in range(1, n):
        x = -np.sort(-rng.randn(12, n) * 2.0, axis=1)
        t0 = rng.randn(12) * 2.0
        jt, jx = _jit("sl_sorted", k)(jnp.asarray(t0), jnp.asarray(x))
        tp, xp = spectral.proj_sum_largest_sorted(t64(t0), t64(x), k)
        _close(tp, jt, x, 1e-10)
        _close(xp, jx, x, 1e-10)


# ---- matrix cones ----

@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32_eig"])
def test_sum_largest_evals_matches_jax(f32):
    rng = np.random.RandomState(30 + f32)
    for ns in SIZES:
        tri = ns * (ns + 1) // 2
        for k in range(1, ns):
            v = rng.randn(6, tri + 1) * 2.0
            ref = np.asarray(_jit("sl_evals", ns, k, f32)(jnp.asarray(v)))
            got = spectral.proj_sum_largest_evals(
                t64(v).reshape(2, 3, -1), ns, k, f32_eig=f32)
            assert got.dtype == torch.float64
            _close(got.reshape(6, -1), ref, v, 1e-4 if f32 else 1e-10)


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32_eig"])
def test_nuclear_matches_jax(f32):
    rng = np.random.RandomState(40 + f32)
    for m, n in ((2, 2), (3, 2), (3, 3), (5, 2), (5, 3), (5, 5)):
        v = rng.randn(6, m * n + 1) * 2.0
        # one cone inside: t above the nuclear norm
        X = v[0, 1:].reshape(n, m).T
        v[0, 0] = np.linalg.svd(X, compute_uv=False).sum() + 1.0
        ref = np.asarray(_jit("nuclear", m, n, f32)(jnp.asarray(v)))
        got = spectral.proj_nuclear(t64(v).reshape(3, 2, -1), m, n,
                                    f32_eig=f32).reshape(6, -1)
        _close(got, ref, v, 1e-4 if f32 else 1e-10)
        if not f32:
            np.testing.assert_allclose(got[0].numpy(), v[0], rtol=0,
                                       atol=1e-12)


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32_eig"])
def test_logdet_matches_jax_and_stacks_equal_singles(f32):
    rng = np.random.RandomState(50 + f32)
    for ns in SIZES:
        v = rng.randn(6, ns * (ns + 1) // 2 + 2) * 2.0
        ref = np.asarray(_jit("logdet", ns, f32)(jnp.asarray(v)))
        got = spectral.proj_logdet_batch(t64(v).reshape(2, 3, -1), ns,
                                         f32_eig=f32).reshape(6, -1)
        _close(got, ref, v, 1e-4 if f32 else 1e-10)
        singles = torch.stack([spectral.proj_logdet(t64(r), ns, f32_eig=f32)
                               for r in v])
        _close(singles, got, v, 1e-12)


# ---- the logarithmic cone: Newton, the KKT check, the IPM ----

def _log_inputs(n, seed, count=16):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-2, 2, count), rng.uniform(-1, 2, count),
            rng.uniform(-0.5, 2, (count, n)))


@pytest.mark.parametrize("n", SIZES)
def test_log_cone_newton_and_check_match_jax(n):
    args = _log_inputs(n, 60 + n)
    ref = _jit("newton")(*map(jnp.asarray, args))
    got = spectral.log_cone_newton(*map(t64, args))
    for g, r in zip(got, ref):
        _close(g, r, args[2], 1e-10)
    jchk = _jit("check")(*ref, *map(jnp.asarray, args))
    chk = spectral.check_logdet_opt(*got, *map(t64, args))
    for g, r in zip(chk, jchk):
        _close(g, r, args[2], 1e-10)


@pytest.mark.parametrize("variant", [0, 1])
def test_log_cone_ipm_matches_jax(variant):
    """tests/test_spectral.py:211-231's inputs (n = 6) and more."""
    rng = np.random.RandomState(7)
    t0, v0, x0 = (rng.uniform(-2, 2, 12), rng.uniform(-1, 2, 12),
                  rng.uniform(-1, 3, (12, 6)))
    jres = jax.vmap(lambda a, b, c: J.log_cone_ipm(a, b, c, variant))(
        *map(jnp.asarray, (t0, v0, x0)))
    *got, its = spectral._ipm(*map(t64, (t0, v0, x0)), variant)
    conv = (its < 100).numpy()
    assert conv.any()
    for g, r in zip(got, jres):
        _close(g.numpy()[conv], np.asarray(r)[conv], x0, 1e-10)
    gate = _jit("gate")
    j_ok = np.asarray(gate(*jres, *map(jnp.asarray, (t0, v0, x0))))
    ok = spectral._logdet_gate(*got, *map(t64, (t0, v0, x0))).numpy()
    np.testing.assert_array_equal(ok[~conv], j_ok[~conv])


def test_hostile_logdet_inputs_fail_newton_where_jax_does():
    t0 = np.array([h[0] for h in HOSTILE])
    v0 = np.array([h[1] for h in HOSTILE])
    x0 = np.array([h[2] for h in HOSTILE])
    jn = _jit("newton")(*map(jnp.asarray, (t0, v0, x0)))
    j_ok = np.asarray(_jit("gate")(*jn, *map(jnp.asarray, (t0, v0, x0))))
    args = tuple(map(t64, (t0, v0, x0)))
    tn = spectral.log_cone_newton(*args)
    ok = spectral._logdet_gate(*tn, *args).numpy()
    np.testing.assert_array_equal(ok, j_ok)
    assert not ok.all()          # the cascade has work to do
    tp, vp, xp, info = spectral.logdet_cone_plain(*args)
    assert spectral._logdet_gate(tp, vp, xp, *args).all()
    np.testing.assert_array_equal((info >= 1000).numpy(), ~ok)
    d, p, c = spectral.check_logdet_opt(tp, vp, xp, *args)
    assert (d < 1e-2).all() and (p < 1e-2).all() and (c.abs() < 1e-2).all()


# ---- the dispatcher ----

ALL = dict(z=1, l=2, q=(3,), s=(2,), d=(3, 3, 2), nuc_m=(3,), nuc_n=(2,),
           ell1=(4, 4), sl_n=(3,), sl_k=(1,))


def test_layout_and_moreau_dual_match_jax():
    jspec = scs_tpu.ConeSpec(**ALL)
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    jl, tl = j_project.ConeLayout.make(jspec), project.ConeLayout.make(spec)
    for f in dataclasses.fields(jl):
        if f.name != "spec":
            assert getattr(tl, f.name) == getattr(jl, f.name), f.name
    rng = np.random.RandomState(8)
    x = rng.uniform(-2, 2, (3, spec.dims()))
    cd = scs_tpu.ConeData.make(jspec, dtype=F64)
    j_proj = jax.jit(lambda xi: j_project.proj_dual_cone(
        xi, jspec, cd, jnp.ones(()), None)[0])
    ref = np.stack([np.asarray(j_proj(jnp.asarray(xi, F64))) for xi in x])
    rows = project.proj_dual_cone(t64(x), spec, None, None, None)[0]
    _close(rows, ref, x, 1e-10)
    one = project.proj_dual_cone(t64(x[0]), spec, None, None, None)[0]
    _close(one, ref[0], x, 1e-10)
    # Moreau: Pi_K(x) = x + Pi_{K*}(-x), the two parts orthogonal
    neg = project.proj_dual_cone(t64(-x), spec, None, None, None)[0]
    pk = project.proj_cone(t64(x), spec)[0]
    np.testing.assert_allclose(pk.numpy(), x + neg.numpy(), rtol=0,
                               atol=1e-9)
    assert np.abs((pk * -neg).sum(1).numpy()).max() <= 1e-9 * np.abs(x).max()
    # float32 state projects the spectral cones in float64 (ROADMAP R5)
    r32 = project.proj_dual_cone(t64(x).float(), spec, None, None,
                                 None)[0]
    assert r32.dtype == torch.float32
    _close(r32, ref, x, 1e-6)


def test_jax_float32_state_fails_on_spectral_cones():
    """ROADMAP R5: the JAX package's float32-state batched phase does not
    trace with a spectral cone (its while_loop carries mix float32 and
    float64), where the port projects the spectral cones in float64."""
    jspec = scs_tpu.ConeSpec(l=2, sl_n=(2,), sl_k=(1,))
    jp = j_models.gen_planted(jspec, n=3, seed=1, density=0.5)
    arr = [jnp.asarray(np.asarray(getattr(jp.problem, k)))[None]
           for k in ("A", "b", "c")]
    jstg = scs_tpu.Settings(linsys="direct", mixed_precision=True,
                            fast_f32=True)
    with pytest.raises(TypeError, match=re.escape("carry")):
        j_make_chunked(jspec, jstg)(*arr, jnp.zeros((1, 0)),
                                    jnp.zeros((1, 0)))
