"""The float32-state fast phase of the batched solvers (`fast_f32`) and
what it runs: kernel K3 (the double-single matvec with its float32 pair
returned unsummed), the composed split of G, and the accurate float32
reductions. On the CPU, with ds_split=True, the solvers run the kernels'
plain versions.

Kernels and helpers are held against the JAX package's (Pallas in
interpret mode). The solves are held against the JAX package's mixed
batched solver with float64 state (`fast_f32=False`): the JAX package's
own float32-state path mixes two structures of its factor in one loop
and cannot run where its kernels exist (ROADMAP queue 3, R1), and on the
CPU it runs without them (R2). The bounds are the JAX package's own
tests/test_fast_f32.py's: every lane solved, objectives within 1e-3 of
the planted optimum, iterations within 2x of the float64-state phase,
and the returned split exact to float64 round-off after the finishing
re-projection."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

import scs_tpu  # noqa: F401  (x64 + matmul precision config)
from scs_tpu.ops import dsmatvec as jax_ds
from scs_tpu.ops import dsreduce as jax_red
from scs_tpu.parallel import make_chunked_batch_solver as j_make_chunked
from scs_tpu.types import ConeSpec as JConeSpec
from scs_tpu.types import Settings as JSettings
from scs_tpu_torch import ConeSpec, Settings, config, convert
from scs_tpu_torch.linsys import direct, resolve_ds_split, resolve_fast_f32
from scs_tpu_torch.ops import dsmatvec, dsreduce
from scs_tpu_torch.parallel import (BatchWorkspace,
                                    make_chunked_batch_solver,
                                    make_solver_parts)
from scs_tpu_torch.parallel import batch as batch_mod

from helpers import stack_planted_problems

# ---- K3 and the composed split of G ----

PAIR_SHAPES = [(3, 40, 10), (2, 37, 101), (4, 16, 300)]


def _pair_inputs(B, m, n):
    rng = np.random.RandomState(7 * B + m + n)
    return rng.randn(B, m, n), (rng.randn(B, n) * 22.0).astype(np.float32)


def _jax_splits(A):
    splits = [jax_ds.split_operand(jnp.asarray(a)) for a in A]
    return (jnp.stack([s[0] for s in splits]),
            jnp.stack([s[1] for s in splits]))


@pytest.mark.parametrize("shape", PAIR_SHAPES)
def test_pair_matches_jax_interpret_kernel(shape):
    """The pair's sum against the JAX kernel's (the bound of K2's test) and
    against the float64 product; hi is the sum rounded to float32, lo the
    rest."""
    B, m, n = shape
    A, x = _pair_inputs(B, m, n)
    hi_j, lo_j = _jax_splits(A)
    oh, ol = jax_ds._pair_batched(hi_j, lo_j, jnp.asarray(x), m=m, n=n,
                                  interpret=True)
    ref = np.asarray(oh, np.float64) + np.asarray(ol, np.float64)
    split = dsmatvec.split_operand(torch.tensor(A))
    before = dsmatvec.pair_launches
    hi, lo = dsmatvec.ds_matvec_pair_batched(split, torch.tensor(x))
    assert dsmatvec.pair_launches == before     # CPU: the plain version
    assert hi.dtype == lo.dtype == torch.float32 and hi.shape == (B, m)
    got = hi.double().numpy() + lo.double().numpy()
    for i in range(B):
        exact = A[i] @ x[i].astype(np.float64)
        scale = np.max(np.abs(A[i]) @ np.abs(x[i].astype(np.float64)))
        assert np.max(np.abs(got[i] - ref[i])) / (np.max(np.abs(ref[i]))
                                                  + 1.0) < 1e-8
        assert np.max(np.abs(got[i] - exact)) <= 1e-12 * scale
        np.testing.assert_array_equal(hi[i].numpy(),
                                      exact.astype(np.float32))


def test_float32_x_takes_the_float32_output():
    """K2 with float32 x (the float32-state phase's A x and A' z) returns
    float32, the float64 sum rounded once."""
    A, x = _pair_inputs(2, 9, 5)
    split = dsmatvec.split_operand(torch.tensor(A))
    y = dsmatvec.ds_matvec_batched(split, torch.tensor(x))
    assert y.dtype == torch.float32
    hi, _ = dsmatvec.ds_matvec_pair_batched(split, torch.tensor(x))
    torch.testing.assert_close(y, hi, rtol=0, atol=0)
    with pytest.raises(TypeError):      # the pair takes float32 x only
        dsmatvec.ds_matvec_pair_batched(split, torch.tensor(x).double())


@pytest.mark.parametrize("with_P", [False, True])
def test_compose_gram_matches_jax(with_P):
    """The split of G = scale K + diag(d) [+ P] per lane against the
    float64 value (to 1e-12 of max |G|) and against the JAX package's
    `ds_compose_gram`, both summed in float64: to 1e-10 of max |G|
    without P; with P, the JAX composition adds P to diag(d) in float32
    first, so there it agrees to float32 rounding of max |diag(d) + P|."""
    B, n = 3, 11
    rng = np.random.RandomState(4)
    M = rng.randn(B, 2 * n, n)
    K = np.einsum("bmi,bmj->bij", M, M)
    P = (np.einsum("bmi,bmj->bij", M[:, :n], M[:, :n]).astype(np.float32)
         if with_P else None)
    scale = rng.uniform(0.05, 20.0, B).astype(np.float32)
    diag = rng.uniform(1e-6, 2.0, (B, n)).astype(np.float32)
    got = dsmatvec.ds_compose_gram_batched(
        dsmatvec.split_operand(torch.tensor(K)), torch.tensor(scale),
        torch.tensor(diag), None if P is None else torch.tensor(P))
    assert got.hi.dtype == torch.float32 and got.hi.shape == (B, n, n)
    G = got.hi.double().numpy() + got.lo.double().numpy()
    for i in range(B):
        jh, jl = jax_ds.ds_compose_gram(
            jax_ds.split_operand(jnp.asarray(K[i])), jnp.asarray(scale[i]),
            jnp.asarray(diag[i]), n,
            None if P is None else jnp.asarray(P[i]))
        ref = (np.asarray(jh, np.float64)
               + np.asarray(jl, np.float64))[:n, :n]
        D = np.diag(diag[i]).astype(np.float64)
        if P is not None:
            D = D + P[i].astype(np.float64)
        exact = np.float64(scale[i]) * K[i] + D
        big = np.max(np.abs(exact))
        assert np.max(np.abs(G[i] - exact)) <= 1e-12 * big
        tol = 1e-10 * big if P is None else 2.0 ** -23 * np.max(np.abs(D))
        assert np.max(np.abs(G[i] - ref)) <= tol


def test_accurate_reductions_match_jax():
    """acc_dot / acc_norm on the JAX test's large-cancellation inputs: the
    JAX package's bounds against the float64 value, and the JAX package's
    result to float32 rounding."""
    rng = np.random.RandomState(0)
    x = (rng.randn(501) * np.logspace(0, 3, 501)).astype(np.float32)
    y = rng.randn(501).astype(np.float32)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    exact = float(x64 @ y64)
    got = float(dsreduce.acc_dot(torch.tensor(x), torch.tensor(y)))
    assert abs(got - exact) <= 5e-7 * float(np.abs(x64 * y64).sum())
    assert got == pytest.approx(float(jax_red.acc_dot(jnp.asarray(x),
                                                      jnp.asarray(y))),
                                rel=1e-6)
    nrm = float(dsreduce.acc_norm(torch.tensor(x)))
    assert abs(nrm - float(np.linalg.norm(x64))) <= 1e-6 * nrm
    xb = torch.tensor(np.stack([x, 2 * x]))
    yb = torch.tensor(np.stack([y, y]))
    np.testing.assert_allclose(dsreduce.acc_dot(xb, yb).numpy(),
                               [got, 2 * got], rtol=1e-6)
    with pytest.raises(TypeError):
        dsreduce.acc_dot(torch.tensor(x64), torch.tensor(y64))


# ---- the rules ----

def test_resolve_fast_f32_and_ds_split():
    """Auto follows mixed where the splits exist (R2: off without them);
    asking for it without the splits raises; ds_split=False is refused on
    CUDA, where the mixed path always runs the kernels."""
    auto = Settings(mixed_precision=True)
    assert resolve_fast_f32(auto, mixed=True, ds=True)
    assert not resolve_fast_f32(auto, mixed=True, ds=False)
    assert not resolve_fast_f32(auto, mixed=False, ds=True)
    assert not resolve_fast_f32(Settings(fast_f32=False), True, True)
    assert not resolve_fast_f32(Settings(fast_f32=True), mixed=False,
                                ds=True)
    with pytest.raises(ValueError, match="ds_split=True"):
        resolve_fast_f32(Settings(fast_f32=True), mixed=True, ds=False)
    assert resolve_ds_split(None, "cuda", True)
    assert not resolve_ds_split(None, "cpu", True)
    assert resolve_ds_split(True, "cpu", True)
    with pytest.raises(ValueError, match="ds_split=False"):
        resolve_ds_split(False, "cuda", True)
    spec = ConeSpec(l=6)
    with pytest.raises(ValueError, match="ds_split=True"):
        make_chunked_batch_solver(spec, Settings(linsys="direct",
                                                 mixed_precision=True,
                                                 fast_f32=True),
                                  device="cpu")
    mixed = Settings(linsys="direct", mixed_precision=True)
    off = make_chunked_batch_solver(spec, mixed, device="cpu")
    assert not off.machinery.f32_state
    on = make_chunked_batch_solver(spec, mixed, device="cpu", ds_split=True)
    assert on.machinery.f32_state


def test_f32_view_and_back():
    """The float32 view casts every float64 tensor and keeps the splits;
    the factor gains the split of G and loses it on the way back."""
    spec = ConeSpec(z=2, l=8, q=(4,))
    A, _, b, c, _, _, _ = stack_planted_problems(spec, n=6, count=3)
    tA, _, tb, tc, _, _ = convert.batch_from_numpy(
        np.asarray(A), np.asarray(b), np.asarray(c))
    init_fn, _, _ = make_solver_parts(
        spec, Settings(linsys="direct", mixed_precision=True), device="cpu",
        ds_split=True)
    data, st = init_fn(tA, None, tb, tc)
    d32, s32 = batch_mod.f32_view(data, st, direct)
    assert d32.A.dtype == d32.lin_cache.K.dtype == s32.v.dtype == \
        torch.float32
    assert d32.lin_cache.ds_fwd.hi is data.lin_cache.ds_fwd.hi
    assert len(st.derived) == 2 and len(s32.derived) == 3
    assert s32.iter is st.iter
    back = batch_mod.f64_state(s32, direct)
    assert back.v.dtype == back.derived[1].dtype == torch.float64
    assert len(back.derived) == 2 and back.derived[0].dtype == torch.float32
    torch.testing.assert_close(back.v, st.v, rtol=1e-7, atol=0)


# ---- the solves ----

SPEC = ConeSpec(z=5, l=15, q=(8, 12))
JSPEC = JConeSpec(z=5, l=15, q=(8, 12))
N, B = 20, 6


def _batch(jspec=JSPEC, n=N, count=B, seed0=300):
    A, _, b, c, bu, bl, opts = stack_planted_problems(jspec, n=n,
                                                      count=count,
                                                      seed0=seed0)
    targs = convert.batch_from_numpy(np.asarray(A), np.asarray(b),
                                     np.asarray(c))
    return (A, b, c, bu, bl), targs, opts


def _pair_spy(monkeypatch):
    calls = [0]
    real = dsmatvec.ds_matvec_pair_batched

    def spy(split, x):
        calls[0] += 1
        return real(split, x)

    monkeypatch.setattr(dsmatvec, "ds_matvec_pair_batched", spy)
    return calls


def test_f32_phase_follows_the_float64_state_phase(monkeypatch):
    """The float32-state phase against the JAX mixed solver with float64
    state: equal statuses, objectives at the planted optimum and within
    1e-4 of JAX's, iterations within 2x lane by lane; the refinement
    residual went through K3; after the re-projection s is in K and
    s'y = 0 to float64 round-off."""
    jargs, targs, opts = _batch()
    jstg = JSettings(linsys="direct", mixed_precision=True, fast_f32=False,
                     macro_schedule=False, chunk_iters=100)
    jres = j_make_chunked(JSPEC, jstg)(*jargs)
    calls = _pair_spy(monkeypatch)
    solver = make_chunked_batch_solver(
        SPEC, Settings(linsys="direct", mixed_precision=True,
                       chunk_iters=100), device="cpu", ds_split=True)
    assert solver.machinery.f32_state
    A, _, b, c, bu, bl = targs
    res = convert.solve_result_to_numpy(solver(A, b, c, bu, bl))
    assert calls[0] > 0
    np.testing.assert_array_equal(res["status"], np.asarray(jres.status))
    assert np.all(res["status"] == config.SOLVED)
    err = np.abs(res["pobj"] - opts) / np.maximum(1, np.abs(opts))
    assert err.max() < 1e-3, err
    jp = np.asarray(jres.pobj)
    assert np.all(np.abs(res["pobj"] - jp) <= 1e-4 * (1 + np.abs(jp)))
    ratio = res["iters"] / np.asarray(jres.iters)
    assert np.all((0.5 <= ratio) & (ratio <= 2.0)), ratio
    s, y = res["s"], res["y"]
    nm = np.maximum(np.abs(s).max(axis=1), np.abs(y).max(axis=1))
    sty = np.abs((s * y).sum(axis=1))
    assert (sty <= 1e-10 * np.maximum(nm, 1.0)).all(), sty
    off = SPEC.z + SPEC.l
    for q in SPEC.q:
        blk = s[:, off:off + q]
        dist = np.linalg.norm(blk[:, 1:], axis=1) - blk[:, 0]
        assert (dist <= 1e-10 * np.maximum(nm, 1.0)).all(), dist
        off += q


def test_f32_phase_below_floor_polishes():
    """Targets below the fast floor: the state returns to float64 and the
    polish phase reaches the tight eps (the JAX package's test of this
    fails on the CPU, R2)."""
    _, targs, opts = _batch()
    eps = config.MIXED_FAST_FLOOR / 100.0
    solver = make_chunked_batch_solver(
        SPEC, Settings(linsys="direct", mixed_precision=True, eps_abs=eps,
                       eps_rel=eps, chunk_iters=100),
        device="cpu", ds_split=True)
    A, _, b, c, bu, bl = targs
    r = solver(A, b, c, bu, bl)
    assert torch.all(r.status == config.SOLVED)
    assert solver.machinery.polished == B
    assert {lv[0] for lv in solver.levels} == {"fast", "polish"}
    assert float(r.res_pri.max()) < 10 * eps
    err = np.abs(r.pobj.numpy() - opts) / np.maximum(1, np.abs(opts))
    assert err.max() < 1e-5


def test_f32_phase_warm_resolve():
    _, targs, _ = _batch(count=4)
    A, _, b, c, _, _ = targs
    ws = BatchWorkspace(SPEC, Settings(linsys="direct", mixed_precision=True,
                                       chunk_iters=100),
                        A, None, b, c, device="cpu", ds_split=True)
    assert ws.machinery.f32_state
    r0 = ws.solve()
    assert torch.all(r0.status == config.SOLVED)
    ws.update(b=b * 1.02)
    r1 = ws.solve(warm_start=True)
    assert torch.all(r1.status == config.SOLVED)
    assert r1.iters.double().mean() < 0.6 * r0.iters.double().mean()


def test_f32_phase_infeasible_certificate():
    """Certificates below the certificate floor go through the polish
    phase, normalized to b'y = -1 (scs.c:916-966)."""
    n = 6
    spec = ConeSpec(l=12)
    Ai = np.vstack([-np.eye(n), np.eye(n)])     # x >= 1 and -x >= 1
    A = np.stack([Ai] * 2)
    b = -np.ones((2, 2 * n))
    c = np.random.RandomState(5).randn(2, n)
    tA, _, tb, tc, tbu, tbl = convert.batch_from_numpy(A, b, c)
    r = make_chunked_batch_solver(
        spec, Settings(linsys="direct", mixed_precision=True,
                       chunk_iters=100), device="cpu", ds_split=True)(
        tA, tb, tc, tbu, tbl)
    assert torch.all(r.status == config.INFEASIBLE)
    bty = (r.y * tb).sum(dim=1).numpy()
    np.testing.assert_allclose(bty, -1.0, atol=1e-6)
