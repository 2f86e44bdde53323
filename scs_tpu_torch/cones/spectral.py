"""The spectral cone projections: ell1-norm, sum-of-k-largest-eigenvalues,
nuclear-norm and log-determinant cones.

Counterpart of `scs_tpu/cones/spectral.py` (SCS: src/spectral_cones/,
"Projection onto Spectral Matrix Cones", Cederberg & Boyd 2024), function
for function and under the same names:

  * ell1 cone {(t, x): ||x||_1 <= t}: the exact sort-based projection
    (`proj_ell1`, `ell1_proj_sorted`), with cumulative sums; the sort is
    stable and its inverse a second stable sort and gathers, so the card
    repeats a projection bit for bit.
  * sum-of-k-largest-eigenvalues cone: eigh, then the path-following
    algorithm on the sorted eigenvalues (`proj_sum_largest_sorted`, at
    most 2n + 4 passes; `proj_sum_largest_evals`).
  * nuclear-norm cone {(t, X): ||X||_* <= t}: thin SVD, then the sorted
    ell1 projection of the singular values (`proj_nuclear`).
  * log-determinant cone {(t, v, X): X psd, v >= 0, -v log det(X/v) <= t}:
    eigh, then damped Newton on the vector (logarithmic) cone
    (`log_cone_newton`), the KKT gate of SCS's wrapper
    (`check_logdet_opt`), and, for the cones that fail it, the
    primal-dual IPM in both variants (`log_cone_ipm`), as
    `proj_logdet_batch` and `proj_logdet`.

Every function takes leading lane axes (a run of equal cones of one
problem, or of every problem of a batch). The data-dependent loops (the
path-following passes, Newton, the IPM) are masked loops over all lanes:
a lane that has stopped keeps its state, so each lane's result is that of
its own loop. The line searches inside Newton and the IPM evaluate all
their candidate steps at once, generated by the same repeated
multiplication by beta as the JAX loops, and take the first that passes;
the IPM runs only on the cones that fail the gate after Newton.

On the card two of these loops are hand-written kernels, one cone a
thread or a warp (`ops/sumlargest.py`, `ops/logdet.py`; the functions
here are their plain versions, the CPU's path, run eagerly with one host
read of the stop flag an iteration): the path-following loop, and the
logdet cones' vector-cone cascade (Newton, gate, IPM). As torch ops one
Newton iteration is ~220 kernel launches and one IPM iteration ~1200,
the IPM often runs its 100 iterations on the 1-14 % of cones that need
it, and a path-following pass is ~40 launches. eigh and SVD run outside
them (one host sync each).

Departures from the JAX package, each exact where its loop is finite:
its Newton line search never advances its step counter
(`scs_tpu/cones/spectral.py:280-287`), so it is bounded only by its
Armijo test; here it tries the 61 steps of `_LC_MAX_LS` (log_cone_Newton.c)
and takes the last where none passes. The IPM's step halving (`:541-545`)
is the closed form step * 2^-j, exact, and 0 where the domain bound is
not positive (the JAX loop would not end there).

`proj_logdet_batch_info` is `proj_logdet_batch` that also returns each
cone's Newton iterations and IPM runs (`ops/logdet.logdet_cone`'s info).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ops import logdet, sumlargest
from .psd import mat_to_svec, svec_to_mat

_SQRT2 = math.sqrt(2.0)
_TOL_LARGEST = 1e-9

# log-cone Newton constants (log_cone_Newton.c:20-31)
_LC_MAX_ITER = 100
_LC_ALPHA = 0.01
_LC_BETA = 0.8
_LC_TOL = 1e-12
_LC_MAX_GRAD_STEPS = 5
_LC_MIN_INIT = 1.0
_LC_MIN_DENOM = 1e-14
_LC_MIN_X = 1e-17
_LC_MIN_V = 1e-14
_LC_LS_RELTOL = 1e-14
_LC_MAX_LS = 60

# wrapper tolerances (log_cone_wrapper.c:8-12)
_LW_DUAL_FEAS_TOL = 1e-2
_LW_PRI_FEAS_TOL = 1e-2
_LW_COMP_TOL = 1e-2
_LW_DUAL_T_THRESHOLD = 1e-8
_LW_DUAL_X_THRESHOLD = 1e-8

# IPM constants (log_cone_IPM.c:20-27)
_IPM_FEASTOL = 1e-7
_IPM_ABSTOL = 1e-7
_IPM_RELTOL = 1e-6
_IPM_MAX_ITER = 100
_IPM_BETA = 0.5
_IPM_STEP = 0.99
_IPM_ALPHA = 0.01
_IPM_MAX_RELAXED = 8
_IPM_MAX_LS = 60

def _dot(a, b):
    return (a * b).sum(-1)


def _first(passes: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis; its length where
    there is none."""
    n = passes.shape[-1]
    idx = torch.arange(n, device=passes.device)
    return torch.where(passes, idx, n).amin(-1)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[..., idx] lane by lane (idx one index per lane)."""
    return torch.gather(a, -1, idx.unsqueeze(-1)).squeeze(-1)


def _candidates(step: torch.Tensor, beta: float, count: int) -> torch.Tensor:
    """(..., count): step, step*beta, (step*beta)*beta, ...: the JAX line
    searches' repeated multiplication, bit for bit in float64 on the CPU,
    where cumprod multiplies in index order."""
    factors = torch.cat([step.unsqueeze(-1),
                         step.new_full(step.shape + (count - 1,), beta)], -1)
    return torch.cumprod(factors, -1)


def _loop(step, state: tuple, consts: tuple):
    """Run `step(*state, *consts)`, one masked iteration returning the new
    state and a flag tensor (True when every lane has stopped), until the
    flag is set. Returns the state."""
    while True:
        out = step(*state, *consts)
        state = out[:-1]
        if bool(out[-1]):
            return state


# ------------------------- ell1 cone ---------------------------------------

def ell1_proj_sorted(t0: torch.Tensor, xs: torch.Tensor):
    """Project (t0, xs), xs >= 0 sorted descending along its last axis,
    onto the ell1 cone (ell1_cone.c:98-162). Returns (t_proj, x_proj),
    x_proj in the sorted order."""
    n = xs.shape[-1]
    cs = torch.cumsum(xs, -1)
    idx = torch.arange(n, device=xs.device)
    if n > 1:
        temp = (-t0.unsqueeze(-1) + cs[..., :-1]) / (idx[1:] + 1.0)
        cond = (xs[..., :-1] > temp) & (xs[..., 1:] <= temp)
        found = cond.any(-1)
        k_idx = torch.clamp_max(_first(cond), n - 2)
        k = torch.where(found, k_idx + 1, n)
        x_sum = torch.where(found, _take(cs, k_idx), cs[..., -1])
    else:
        k = torch.full(t0.shape, n, dtype=torch.int64, device=xs.device)
        x_sum = cs[..., -1]
    p0 = -t0 + x_sum
    t_proj = torch.where(p0 > 0, t0 + p0 / (k + 1.0), t0)
    diff = t_proj - t0
    x_proj = torch.where(idx < k.unsqueeze(-1), xs - diff.unsqueeze(-1), 0.0)
    # everything zero when -t0 >= max(x)
    zero_all = -t0 >= xs[..., 0]
    t_proj = torch.where(zero_all, 0.0, t_proj)
    x_proj = torch.where(zero_all.unsqueeze(-1), 0.0, x_proj)
    return t_proj, x_proj


def proj_ell1(tx: torch.Tensor) -> torch.Tensor:
    """Project [t; x] (..., n + 1) onto {(t, x): ||x||_1 <= t}
    (SCS(proj_ell_one))."""
    t0 = tx[..., 0]
    x0 = tx[..., 1:]
    absx = torch.abs(x0)
    order = torch.sort(-absx, dim=-1, stable=True).indices   # descending
    xs = torch.gather(absx, -1, order)
    t_proj, xp_sorted = ell1_proj_sorted(t0, xs)
    inv = torch.sort(order, dim=-1, stable=True).indices
    xp = (torch.gather(xp_sorted, -1, inv)
          * torch.sign(x0 + (x0 == 0).to(x0.dtype)))         # sign(0) -> +1
    return torch.cat([t_proj.unsqueeze(-1), xp], -1)


# --------------------- sum-of-k-largest cone --------------------------------

@functools.lru_cache(maxsize=None)
def _sum_largest_step(k: int):
    """One masked pass of proj_sum_largest_sorted's loop
    (sum_largest_cone.c:42-147) for a given k."""

    def step(t, nu, nt, eta, S, a_u, a_t, it, t0, x):
        n = x.shape[-1]
        act = (S > t + _TOL_LARGEST) & (it < 2 * n + 4)
        nuf = nu.to(x.dtype)
        ntf = nt.to(x.dtype)
        at_k = nu == k
        ratio = torch.where(at_k, 1.0,
                            ntf / torch.where(at_k, 1.0, (k - nuf)))
        s1 = torch.where(at_k, a_u - a_t,
                         (a_u - a_t) / torch.where(at_k | (ratio == 1.0),
                                                   1.0, ratio - 1.0))
        s3 = (S - t) / (ratio * (nuf + 1.0) + (k - nuf))
        s = torch.where(nu == 0, s3, torch.minimum(s3, s1))
        mid = ~((nu + nt == n) | (nt == 0))
        val = a_t - _take(x, torch.clamp_max(nu + nt, n - 1))
        s = torch.where(mid, torch.minimum(s, val), s)

        eta_n = eta + s * ratio
        S_n = S - s * (ratio * nuf + k - nuf)
        t_n = t0 + eta_n
        a_t_n = torch.where(nt > 0, a_t - s, a_t)
        dec = (nu != 0) & (s == s1)
        nu_n = torch.where(dec, nu - 1, nu)
        a_u_n = torch.where(
            nu_n > 0, _take(x, torch.clamp_min(nu_n - 1, 0)) - eta_n, a_u)
        nt_n = torch.where(nt == 0, 2, nt + 1)
        t = torch.where(act, t_n, t)
        nu = torch.where(act, nu_n, nu)
        nt = torch.where(act, nt_n, nt)
        eta = torch.where(act, eta_n, eta)
        S = torch.where(act, S_n, S)
        a_u = torch.where(act, a_u_n, a_u)
        a_t = torch.where(act, a_t_n, a_t)
        it = it + act.to(it.dtype)
        stopped = ~((S > t + _TOL_LARGEST) & (it < 2 * n + 4)).any()
        return t, nu, nt, eta, S, a_u, a_t, it, stopped

    return step


def proj_sum_largest_sorted(t0: torch.Tensor, x: torch.Tensor, k: int):
    """Project (t, x) onto {(t, x): sum of the k largest of x <= t}, x
    sorted descending along its last axis (sum_largest_cone.c:42-147).
    Returns (t_proj, x_proj sorted). Through `ops/sumlargest.py` (the
    card's kernel, or the plain version below on the CPU)."""
    lead = t0.shape
    t, xp = sumlargest.sum_largest_sorted(t0.reshape(-1),
                                          x.reshape(-1, x.shape[-1]), k)
    return t.reshape(lead), xp.reshape(x.shape)


def _sum_largest_sorted_plain(t0: torch.Tensor, x: torch.Tensor, k: int,
                              passes: bool = False):
    """The plain version of `ops/sumlargest.sum_largest_sorted`: the
    path-following loop, at most 2n + 4 masked passes over all lanes.
    With `passes`, each lane's pass count comes third."""
    n = x.shape[-1]
    assert 0 < k < n
    ints = torch.zeros(t0.shape, dtype=torch.int64, device=x.device)
    state = (t0, ints + k, ints, torch.zeros_like(t0), x[..., :k].sum(-1),
             x[..., k - 1], x[..., k], ints)
    t, nu, nt, eta, S, a_u, a_t, its = _loop(
        _sum_largest_step(k), state, (t0, x))
    nt = torch.clamp_min(nt - 1, 0)
    idx = torch.arange(n, device=x.device)
    nu, nt = nu.unsqueeze(-1), nt.unsqueeze(-1)
    x_proj = torch.where(idx < nu, x - eta.unsqueeze(-1),
                         torch.where(idx < nu + nt, a_t.unsqueeze(-1), x))
    return (t, x_proj, its) if passes else (t, x_proj)


def _eigh(M: torch.Tensor, dtype, f32_eig: bool):
    """eigh of the symmetric matrices M, in float32 with `f32_eig`, the
    results in `dtype`."""
    if f32_eig:
        M = M.to(torch.float32)
    w, V = torch.linalg.eigh(M)                 # ascending
    return w.to(dtype), V.to(dtype)


def proj_sum_largest_evals(tX: torch.Tensor, ns: int, k: int,
                           f32_eig: bool = False) -> torch.Tensor:
    """Project [t; svec(X)] (..., tri + 1) onto {(t, X): sum of the k
    largest eigenvalues <= t} (sum_largest_eval_cone.c:56-147); the
    eigenvalues and t scaled by sqrt(2), as the svec packing asks."""
    t0 = tX[..., 0]
    M = svec_to_mat(tX[..., 1:], ns) * _SQRT2
    w, V = _eigh(M, tX.dtype, f32_eig)
    w_desc = torch.flip(w, [-1])
    t_p, w_p_desc = proj_sum_largest_sorted(t0 * _SQRT2, w_desc, k)
    w_p = torch.flip(w_p_desc, [-1])
    Mp = (V * w_p.unsqueeze(-2)) @ V.transpose(-1, -2) / _SQRT2
    return torch.cat([(t_p / _SQRT2).unsqueeze(-1), mat_to_svec(Mp, ns)], -1)


# --------------------------- nuclear cone -----------------------------------

def proj_nuclear(tX: torch.Tensor, m: int, n: int,
                 f32_eig: bool = False) -> torch.Tensor:
    """Project [t; vec(X)] (..., m n + 1), X m x n column-major, m >= n,
    onto {(t, X): ||X||_* <= t} (nuclear_cone.c:47-110): thin SVD, then
    the sorted ell1 projection of the singular values."""
    t0 = tX[..., 0]
    X = tX[..., 1:].reshape(tX.shape[:-1] + (n, m)).transpose(-1, -2)
    if f32_eig:
        X = X.to(torch.float32)
    U, s, Vt = torch.linalg.svd(X, full_matrices=False)
    U, s, Vt = U.to(tX.dtype), s.to(tX.dtype), Vt.to(tX.dtype)
    t_p, s_p = ell1_proj_sorted(t0, s)          # descending, >= 0
    Xp = (U * s_p.unsqueeze(-2)) @ Vt
    return torch.cat([t_p.unsqueeze(-1),
                      Xp.transpose(-1, -2).reshape(tX.shape[:-1] + (m * n,))],
                     -1)


# --------------------------- logdet cone ------------------------------------

def _log_cone_obj(v, x, t0, v0, x0, nf):
    sx = -(v * torch.log(x).sum(-1) - nf * v * torch.log(v))
    return (0.5 * (sx - t0) ** 2 + 0.5 * (v - v0) ** 2
            + 0.5 * ((x - x0) ** 2).sum(-1))


def _newton_step(v, x, obj_old, it, ngrad, done, failed, t0, v0, x0):
    """One masked iteration of log_cone_newton's damped Newton loop
    (log_cone_Newton.c:137-287)."""
    nf = float(x0.shape[-1])
    act = (it < _LC_MAX_ITER) & ~done & ~failed
    failed_n = failed | (v < _LC_MIN_V)
    xc = torch.clamp_min(x, _LC_MIN_X)
    safe_v = torch.clamp_min(v, _LC_MIN_V)

    temp0 = -torch.log(xc).sum(-1) + nf * torch.log(safe_v)
    a = safe_v * temp0 - t0
    cc = temp0 + nf
    v_inv = 1.0 / safe_v
    g0 = a * cc + safe_v - v0
    d0 = 1.0 + a * (-a * v_inv * v_inv + nf * v_inv
                    - 2.0 * cc * v_inv)
    w0 = -(a + safe_v * cc) * v_inv
    av = (a * safe_v).unsqueeze(-1)
    x_inv = 1.0 / xc
    gx = -av * x_inv + xc - x0
    dx = 1.0 + av * x_inv * x_inv
    wx = safe_v.unsqueeze(-1) * x_inv
    grad = torch.cat([g0.unsqueeze(-1), gx], -1)
    d = torch.cat([d0.unsqueeze(-1), dx], -1)
    w = torch.cat([w0.unsqueeze(-1), wx], -1)

    du = -grad / d
    nominator = _dot(w, du)
    temp1 = w / d
    denominator = 1.0 + _dot(w, temp1)
    failed_n = failed_n | (torch.abs(denominator) < _LC_MIN_DENOM)
    du = du + (-nominator / denominator).unsqueeze(-1) * temp1

    dir_der = _dot(grad, du)
    use_grad = dir_der > 0
    failed_n = failed_n | (use_grad & (ngrad >= _LC_MAX_GRAD_STEPS))
    ngrad_n = ngrad + use_grad.to(ngrad.dtype)
    du = torch.where(use_grad.unsqueeze(-1), -grad, du)
    dir_der = torch.where(use_grad, -_dot(grad, grad), dir_der)
    done_now = -dir_der <= 2.0 * _LC_TOL

    # largest domain-feasible step
    u = torch.cat([safe_v.unsqueeze(-1), xc], -1)
    neg = du < 0
    max_steps = torch.where(
        neg, -0.99 * u / torch.where(neg, du, -1.0), math.inf)
    step0 = torch.clamp_max(max_steps.amin(-1), 1.0)

    # backtracking: every candidate at once, the first that passes
    steps = _candidates(step0, _LC_BETA, _LC_MAX_LS + 1)
    vn = torch.clamp_min(safe_v.unsqueeze(-1)
                         + steps * du[..., :1], _LC_MIN_V)
    xn = torch.clamp_min(xc.unsqueeze(-2) + steps.unsqueeze(-1)
                         * du[..., 1:].unsqueeze(-2), _LC_MIN_X)
    objs = _log_cone_obj(vn, xn, t0.unsqueeze(-1), v0.unsqueeze(-1),
                         x0.unsqueeze(-2), nf)
    fail = ((1.0 - _LC_LS_RELTOL) * objs
            > obj_old.unsqueeze(-1)
            + _LC_ALPHA * steps * dir_der.unsqueeze(-1))
    j = torch.clamp_max(_first(~fail), _LC_MAX_LS)
    step = _take(steps, j)
    new_obj = _take(objs, j)

    advance = ~done_now & ~failed_n
    v_new = torch.where(advance, safe_v + step * du[..., 0], v)
    x_new = torch.where(advance.unsqueeze(-1),
                        xc + step.unsqueeze(-1) * du[..., 1:], xc)
    obj_new = torch.where(advance, new_obj, obj_old)
    v = torch.where(act, v_new, v)
    x = torch.where(act.unsqueeze(-1), x_new, x)
    obj_old = torch.where(act, obj_new, obj_old)
    ngrad = torch.where(act, ngrad_n, ngrad)
    done = torch.where(act, done | done_now, done)
    failed = torch.where(act, failed_n, failed)
    it = it + act.to(it.dtype)
    stopped = ~((it < _LC_MAX_ITER) & ~done & ~failed).any()
    return v, x, obj_old, it, ngrad, done, failed, stopped


def _newton(t0, v0, x0):
    """log_cone_newton, with each lane's Newton iterations."""
    nf = float(x0.shape[-1])

    # special cases (log_cone_Newton.c:96-135)
    all_pos = (x0 > 0).all(-1)
    all_nonneg = (x0 >= 0).all(-1)
    sumlog_x0 = torch.log(torch.where(x0 > 0, x0, 1.0)).sum(-1)
    in_cone = ((v0 > 0) & all_pos
               & (-v0 * (sumlog_x0 - nf * torch.log(torch.where(v0 > 0, v0,
                                                                1.0)))
                  <= t0))
    in_cone |= (v0 == 0) & all_nonneg & (t0 >= 0)
    all_neg = (x0 < 0).all(-1)
    ratio = torch.where((x0 < 0) & (t0 < 0).unsqueeze(-1),
                        x0 / torch.where(t0 < 0, t0, -1.0).unsqueeze(-1), 1.0)
    dual_sum = t0 * (-nf - torch.log(ratio).sum(-1))
    in_neg_dual = (t0 < 0) & all_neg & (v0 <= dual_sum)
    analytic = (v0 <= 0) & (t0 >= 0)

    v_init = torch.clamp_min(v0, _LC_MIN_INIT)
    x_init = torch.clamp_min(x0, _LC_MIN_INIT)
    obj_init = _log_cone_obj(v_init, x_init, t0, v0, x0, nf)
    ints = torch.zeros(t0.shape, dtype=torch.int64, device=t0.device)
    flags = torch.zeros(t0.shape, dtype=torch.bool, device=t0.device)
    v_n, x_n, _, its, *_ = _loop(
        _newton_step, (v_init, x_init, obj_init, ints, ints, flags, flags),
        (t0, v0, x0))
    x_n = torch.clamp_min(x_n, _LC_MIN_X)
    v_n = torch.clamp_min(v_n, _LC_MIN_V)
    t_n = -v_n * (torch.log(x_n).sum(-1) - nf * torch.log(v_n))

    t_out = torch.where(in_cone, t0, torch.where(
        in_neg_dual, 0.0, torch.where(analytic, t0, t_n)))
    v_out = torch.where(in_cone, v0, torch.where(
        in_neg_dual, 0.0, torch.where(analytic, 0.0, v_n)))
    x_out = torch.where(in_cone.unsqueeze(-1), x0, torch.where(
        in_neg_dual.unsqueeze(-1), 0.0,
        torch.where(analytic.unsqueeze(-1), torch.clamp_min(x0, 0.0), x_n)))
    return t_out, v_out, x_out, its


def log_cone_newton(t0: torch.Tensor, v0: torch.Tensor, x0: torch.Tensor):
    """Project (t0, v0, x0) (lanes (...,), (...,), (..., n)) onto the
    logarithmic cone cl{(t, v, x): -v (sum log x - n log v) <= t, v > 0,
    x > 0} (log_cone_Newton.c:58-302): damped Newton with a diagonal +
    rank-1 Hessian solved by Sherman-Morrison, gradient-step fallback and
    backtracking. Returns (t, v, x)."""
    return _newton(t0, v0, x0)[:3]


def check_logdet_opt(tp, vp, xp, t0, v0, x0):
    """KKT residuals of a candidate projection, lane by lane
    (check_opt_cond_log_cone, log_cone_wrapper.c:132-204). Returns
    (dual_res, pri_res, comp)."""
    nf = float(x0.shape[-1])
    dualt = tp - t0
    dualt = torch.where(torch.abs(dualt) < _LW_DUAL_T_THRESHOLD,
                        _LW_DUAL_T_THRESHOLD, dualt)
    dualv = vp - v0
    dualx = xp - x0
    dualx = torch.where(torch.abs(dualx) < _LW_DUAL_X_THRESHOLD,
                        _LW_DUAL_X_THRESHOLD, dualx)

    comp = tp * dualt + vp * dualv + _dot(dualx, xp)

    pos_p = (vp > 0) & (xp > 0).all(-1)
    slog_xp = torch.log(torch.where(xp > 0, xp, 1.0)).sum(-1)
    slog_vp = torch.log(torch.where(vp > 0, vp, 1.0))
    pri_in = -vp * (slog_xp - nf * slog_vp) - tp
    pri_out = (vp * vp + torch.where(tp < 0, tp * tp, 0.0)
               + torch.where(xp < 0, xp * xp, 0.0).sum(-1))
    pri_res = torch.where(pos_p, pri_in, pri_out)

    pos_d = (dualt > 0) & (dualx > 0).all(-1)
    slog_dx = torch.log(torch.where(dualx > 0, dualx, 1.0)).sum(-1)
    slog_dt = torch.log(torch.where(dualt > 0, dualt, 1.0))
    dual_in = dualt * (nf * slog_dt - nf - slog_dx) - dualv
    dual_out = (dualt * dualt + torch.where(dualv < 0, dualv * dualv, 0.0)
                + torch.where(dualx < 0, dualx * dualx, 0.0).sum(-1))
    dual_res = torch.where(pos_d, dual_in, dual_out)

    dual_norm = torch.sqrt(dualt ** 2 + dualv ** 2 + _dot(dualx, dualx))
    pri_norm = torch.sqrt(tp ** 2 + vp ** 2 + _dot(xp, xp))
    pn1 = torch.clamp_min(pri_norm, 1.0)
    return (dual_res / torch.clamp_min(dual_norm, 1.0),
            pri_res / pn1,
            comp / torch.maximum(pn1, dual_norm))


# ---- the IPM fallback (log_cone_IPM.c:338-713) ----

def _oracle(u1, r, base, nf):
    """f = (f0, f1, f2) and the scaled-space gradients g0, g1 (..., n + 3)
    at u1 (..., n + 2), base = (t0, v0, x0) scaled."""
    du = u1 - base
    one = torch.ones_like(u1[..., :1])
    g0 = torch.cat([du, -one], -1)
    slog = torch.log(u1[..., 2:]).sum(-1) - nf * torch.log(u1[..., 1])
    f = torch.stack([0.5 * _dot(du, du) - r, -u1[..., 1] * slog - u1[..., 0],
                     -u1[..., 1]], -1)
    g1 = torch.cat([-one, (nf - slog).unsqueeze(-1),
                    -u1[..., 1:2] / u1[..., 2:], 0.0 * one], -1)
    return f, g0, g1


def _residuals(u1, r, z, s, base, nf):
    f, g0, g1 = _oracle(u1, r, base, nf)
    rx = z[..., 0:1] * g0 + z[..., 1:2] * g1
    rx[..., 1] -= z[..., 2]
    rx[..., -1] += 1.0
    return f, g0, g1, rx, f + s


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _halve_to(step, dom, pow2):
    """step * 0.5^j for the least j >= 0 with the product <= dom: the
    JAX loop's repeated halving (`spectral.py:541-545`), exact since
    halving is; 0 where dom <= 0. pow2[j] = 2^-j."""
    need = step > dom
    pos = need & (dom > 0)
    ratio = step / torch.where(pos, dom, 1.0)
    top = pow2.shape[0] - 1
    j0 = torch.ceil(torch.log2(ratio)).clamp(0, top).to(torch.int64)
    out = step
    found = torch.zeros_like(need)
    for dj in (-1, 0, 1, 2):
        j = (j0 + dj).clamp(0, top)
        c = step * pow2[j]
        ok = ~found & (c <= dom)
        out = torch.where(ok, c, out)
        found = found | ok
    out = torch.where(pos, out, step)
    return torch.where(need & ~(dom > 0), 0.0, out)


@functools.lru_cache(maxsize=None)
def _ipm_step(mehrotra: bool):
    """One masked iteration of log_cone_ipm's primal-dual loop."""

    def merit(u1, r, z, s, base, nf, th):
        _, _, _, rx, rznl = _residuals(u1, r, z, s, base, nf)
        gap = _dot(z, s)
        return th[0] * gap + th[1] * _norm(rx) + th[2] * _norm(rznl), gap

    def body(u1, r, z, s, it, done, relaxed, saved, th, norms0, base, pow2):
        n = u1.shape[-1] - 2
        nf = float(n)
        ri = n + 2
        v = u1[..., 1]
        x = u1[..., 2:]
        x_inv = 1.0 / x
        f, g0, g1, rx, rznl = _residuals(u1, r, z, s, base, nf)
        gap = _dot(z, s)
        mu = gap / 3.0
        dres_raw = _norm(rx)
        pres_raw = _norm(rznl)

        first = it == 0
        pres0 = torch.where(first, torch.clamp_min(pres_raw, 1.0), norms0[..., 0])
        dres0 = torch.where(first, torch.clamp_min(dres_raw, 1.0), norms0[..., 1])
        th1 = torch.where(first, 1.0 / gap, th[..., 0])
        th2 = torch.where(first, 1.0 / dres0, th[..., 1])
        th3 = torch.where(first, 1.0 / pres0, th[..., 2])
        ths = (th1.unsqueeze(-1), th2.unsqueeze(-1), th3.unsqueeze(-1))

        relgap = gap / torch.clamp_min(r, 1.0)
        done_now = ((dres_raw / dres0 < _IPM_FEASTOL)
                    & (pres_raw / pres0 < _IPM_FEASTOL)
                    & ((gap < _IPM_ABSTOL) | (relgap <= _IPM_RELTOL)))

        w = torch.sqrt(s / z)
        lm = torch.sqrt(s * z)
        z0, z1 = z[..., 0:1], z[..., 1:2]
        w0, w1, w2 = w[..., 0:1], w[..., 1:2], w[..., 2:3]
        g0s = g0 / w0
        g1s = g1 / w1

        # structured KKT factor (KKT_precompute, :149-200)
        temp1 = z0 + z1 * v.unsqueeze(-1) * x_inv * x_inv
        temp2 = x_inv / temp1
        a_coef = z0 + 1.0 / (w2 * w2) + z1 * nf / v.unsqueeze(-1)
        coeff = a_coef - z1 ** 2 * (x_inv * x_inv / temp1).sum(-1, keepdim=True)

        def ginv(b):
            y1 = (b[..., 1:2] + z1 * _dot(b[..., 2:ri], temp2).unsqueeze(-1)) \
                / coeff
            yx = (b[..., 2:ri] + z1 * y1 * x_inv) / temp1
            return torch.cat([b[..., :1] / z0, y1, yx, -b[..., ri:]], -1)

        ginv_c0 = ginv(g0s)
        ginv_c1 = ginv(g1s)
        R00 = 1.0 + _dot(g0s, ginv_c0)
        R01 = _dot(g0s, ginv_c1)
        R02 = -g0s[..., ri]
        R10 = _dot(g1s, ginv_c0)
        R11 = 1.0 + _dot(g1s, ginv_c1)
        R20 = ginv_c0[..., ri]

        def gapply(du):
            d0 = z0 * du[..., :1]
            d1 = ((z0 + 1.0 / (w2 * w2)) * du[..., 1:2]
                  + z1 * (nf / v.unsqueeze(-1) * du[..., 1:2]
                          - _dot(x_inv, du[..., 2:ri]).unsqueeze(-1)))
            dx = (z0 * du[..., 2:ri]
                  + z1 * (-du[..., 1:2] * x_inv
                          + v.unsqueeze(-1) * du[..., 2:ri] * x_inv * x_inv))
            return torch.cat([d0, d1, dx, -du[..., ri:]], -1)

        def cct(du):
            c0 = _dot(g0s, du).unsqueeze(-1)
            c1 = _dot(g1s, du).unsqueeze(-1)
            out = c0 * g0s + c1 * g1s
            out[..., ri] += du[..., ri]
            return out, c0, c1

        def kkt_solve(rhs1, rhs2):
            """(KKT_solve, :202-331): (du1, dr, dz, ds)."""
            tail = rhs1[..., ri + 1:] - w * (rhs2 / lm)
            bnew = (rhs1[..., :ri + 1] + (tail[..., 0:1] / w0) * g0s
                    + (tail[..., 1:2] / w1) * g1s)
            bnew[..., 1] += -tail[..., 2] / (w2[..., 0] * w2[..., 0])
            du = torch.zeros_like(bnew)
            residual = bnew
            for _ in range(3):
                gres = ginv(residual)
                CT0 = _dot(g0s, gres)
                CT1 = _dot(g1s, gres)
                CT2 = gres[..., ri]
                q0 = CT2 / R20
                q1 = (CT1 - R10 * q0) / R11
                q2 = (CT0 - R00 * q0 - R01 * q1) / R02
                d = (gres - q0.unsqueeze(-1) * ginv_c0
                     - q1.unsqueeze(-1) * ginv_c1)
                d[..., ri] += q2
                du = du + d
                c, _, _ = cct(du)
                residual = bnew - (gapply(du) + c)
            _, c0, c1 = cct(du)
            dz = tail.clone()
            dz[..., 0:1] += -w0 * c0
            dz[..., 1:2] += -w1 * c1
            dz[..., 2] += du[..., 1]
            dz = -dz / (w * w)
            ds = w * (rhs2 / lm - w * dz)
            return du[..., :ri], du[..., ri], dz, ds

        def max_step(du1, dz, ds):
            """find_max_step_size (:90-126)."""
            negz, negs = dz < 0, ds < 0
            sm = torch.minimum(
                torch.where(negz, -z / torch.where(negz, dz, -1.0),
                            10.0).amin(-1),
                torch.where(negs, -s / torch.where(negs, ds, -1.0),
                            10.0).amin(-1))
            sm = torch.clamp_max(sm, 10.0)
            pos = u1[..., 1:ri]
            dpos = du1[..., 1:ri]
            negp = dpos < 0
            dom = torch.where(negp, -pos / torch.where(negp, dpos, -1.0),
                              10.0).amin(-1)
            step = torch.clamp_max(_IPM_STEP * sm, 1.0)
            return _halve_to(step, dom, pow2)

        def point(step, du1, dr, dz, ds, cu1=u1, cr=r, cz=z, cs=s):
            """The iterate moved by `step` (..., C) along the direction:
            (..., C, dims) candidates."""
            st = step.unsqueeze(-1)
            return (cu1.unsqueeze(-2) + st * du1.unsqueeze(-2),
                    cr.unsqueeze(-1) + step * dr.unsqueeze(-1),
                    cz.unsqueeze(-2) + st * dz.unsqueeze(-2),
                    cs.unsqueeze(-2) + st * ds.unsqueeze(-2))

        bc = base.unsqueeze(-2)
        phi = th1 * gap + th2 * dres_raw + th3 * pres_raw
        dphi = -phi   # sigma = 0 at this point (log_cone_IPM.c:559-564)

        rhs1_aff = torch.cat([-rx, -rznl], -1)
        rhs2_aff = -(lm * lm)

        # affine pass: direction and centering parameter (j = 0)
        du1_a, dr_a, dz_a, ds_a = kkt_solve(rhs1_aff, rhs2_aff)
        step_a0 = max_step(du1_a, dz_a, ds_a)
        cands = _candidates(step_a0, _IPM_BETA, _IPM_MAX_LS + 1)
        phis, gaps = merit(*point(cands, du1_a, dr_a, dz_a, ds_a), bc, nf,
                           ths)
        ok = phis[..., :-1] <= (1.0 - _IPM_ALPHA * cands[..., :-1]) \
            * phi.unsqueeze(-1)
        j = _first(ok)
        step_a = _take(cands, j)
        gap_a = _take(gaps, j)
        sigma = gap_a / gap
        sigma = torch.where(sigma < 1.0, sigma ** 3, sigma)

        # corrector / search direction (j = 1)
        if mehrotra:
            rhs1_c = (1.0 - sigma).unsqueeze(-1) * rhs1_aff
            rhs2_c = rhs2_aff + ((sigma * mu).unsqueeze(-1) - ds_a * dz_a)
        else:
            rhs1_c = 1.0 * rhs1_aff
            rhs2_c = rhs2_aff + 0.0
        du1_c, dr_c, dz_c, ds_c = kkt_solve(rhs1_c, rhs2_c)
        step_c0 = max_step(du1_c, dz_c, ds_c)

        # nonmonotone line search (log_cone_IPM.c:640-692): its first
        # evaluation runs the relaxed-window state machine; a lane left
        # backtracking (plain mode, or the saved iterate restored) then
        # tries the remaining candidates at once
        (sv_u1, sv_r, sv_z, sv_s, sv_du1, sv_dr, sv_dz, sv_ds, sv_phi,
         sv_dphi, sv_step) = saved
        cur = (u1, r, z, s, du1_c, dr_c, dz_c, ds_c, phi, dphi)
        phi_n, _ = merit(*point(step_c0.unsqueeze(-1), du1_c, dr_c, dz_c,
                                ds_c), bc, nf, ths)
        phi_n = phi_n[..., 0]
        armijo = phi_n <= phi + _IPM_ALPHA * step_c0 * dphi
        armijo0 = phi_n <= sv_phi + _IPM_ALPHA * sv_step * sv_dphi
        rel = relaxed
        plain = rel == -1
        fresh = rel == 0
        at_max = rel == _IPM_MAX_RELAXED
        mid = (rel > 0) & (rel < _IPM_MAX_RELAXED)
        step_next = torch.where(plain & ~armijo, step_c0 * _IPM_BETA, step_c0)
        bt = plain & ~armijo
        open_win = fresh & ~armijo
        rel_next = torch.where(open_win, 1, rel)

        def pick(mask, new, old):
            m = mask.view(mask.shape + (1,) * (new.dim() - mask.dim()))
            return torch.where(m, new, old)

        saved_n = tuple(pick(open_win, a, b) for a, b in
                        zip(cur + (step_c0,), saved))
        rel_next = torch.where(mid & armijo0, 0,
                               torch.where(mid & ~armijo0, rel + 1, rel_next))
        restore = at_max & ~armijo0
        bt = bt | restore
        rel_next = torch.where(restore, -1, rel_next)
        cur = tuple(pick(restore, b, a) for a, b in zip(cur, saved[:-1]))
        step_next = torch.where(restore, sv_step, step_next)
        (fu1, fr, fz, fs, fdu1, fdr, fdz, fds, fphi, fdphi) = cur

        # plain backtracking for the lanes still searching: evaluations
        # 2..60 at step_next * beta^j, the last candidate if none passes
        cands = _candidates(step_next, _IPM_BETA, _IPM_MAX_LS)
        phis, _ = merit(*point(cands[..., :-1], fdu1, fdr, fdz, fds,
                               fu1, fr, fz, fs), bc, nf, ths)
        ok = phis <= fphi.unsqueeze(-1) + _IPM_ALPHA * cands[..., :-1] \
            * fdphi.unsqueeze(-1)
        step_f = torch.where(bt, _take(cands, _first(ok)), step_next)

        u1_new = fu1 + step_f.unsqueeze(-1) * fdu1
        r_new = fr + step_f * fdr
        z_new = fz + step_f.unsqueeze(-1) * fdz
        s_new = fs + step_f.unsqueeze(-1) * fds

        keep = done | done_now
        return (pick(keep, u1, u1_new), torch.where(keep, r, r_new),
                pick(keep, z, z_new), pick(keep, s, s_new), it + 1, keep,
                rel_next, saved_n, torch.stack([th1, th2, th3], -1),
                torch.stack([pres0, dres0], -1))

    def step(u1, r, z, s, it, done, relaxed, *rest):
        saved = rest[:11]
        th, norms0, base, pow2 = rest[11:]
        act = (it < _IPM_MAX_ITER) & ~done
        new = body(u1, r, z, s, it, done, relaxed, saved, th, norms0,
                   base, pow2)
        old = (u1, r, z, s, it, done, relaxed, saved, th, norms0)

        def sel(a, b):
            if isinstance(a, tuple):
                return tuple(sel(x, y) for x, y in zip(a, b))
            m = act.view(act.shape + (1,) * (a.dim() - act.dim()))
            return torch.where(m, a, b)

        (u1, r, z, s, it, done, relaxed, saved, th, norms0) = sel(new, old)
        stopped = ~((it < _IPM_MAX_ITER) & ~done).any()
        return (u1, r, z, s, it, done, relaxed) + tuple(saved) + (
            th, norms0, stopped)

    return step


@functools.lru_cache(maxsize=8)
def _pow2_table(dtype, device) -> torch.Tensor:
    """2^-j for j = 0 .. 1100, exact (0 below the subnormals)."""
    return torch.as_tensor(np.ldexp(1.0, -np.arange(1101)), dtype=dtype,
                           device=device)


def log_cone_ipm(t0_in: torch.Tensor, v0_in: torch.Tensor,
                 x0_in: torch.Tensor, variant=0):
    """Primal-dual IPM projection onto the logarithmic cone, lane by lane
    (log_cone_IPM.c:338-713): min r subject to 0.5||u1 - u0||^2 <= r,
    -v (sum log x - n log v) <= t, v >= 0, with Nesterov-Todd scaling,
    Mehrotra centering and correction (variant 0) or plain damped steps
    (variant 1), a structured O(n) KKT solve with three refinement passes,
    and the reference's nonmonotone line search. Returns (t, v, x)."""
    return _ipm(t0_in, v0_in, x0_in, variant)[:3]


def _ipm(t0_in, v0_in, x0_in, variant):
    """log_cone_ipm, with each lane's IPM iterations (100: the cap)."""
    mehrotra = bool(variant == 0) if isinstance(variant, (bool, int)) \
        else bool(variant)
    n = x0_in.shape[-1]
    dtype, dev = x0_in.dtype, x0_in.device
    # cone projections commute with positive scaling (log_cone_IPM.c:392-397)
    scale1 = torch.maximum(torch.abs(x0_in).amax(-1),
                           torch.maximum(t0_in, v0_in))
    scale1 = torch.clamp_min(scale1, 1e-100)
    base = torch.cat([(t0_in / scale1).unsqueeze(-1),
                      (v0_in / scale1).unsqueeze(-1),
                      x0_in / scale1.unsqueeze(-1)], -1)
    lead = t0_in.shape

    def full(shape, val, dt=dtype):
        return torch.full(lead + shape, val, dtype=dt, device=dev)

    u1_0 = full((n + 2,), 1.0)
    z0 = full((3,), 1.0)
    zero = full((), 0.0)
    saved0 = (u1_0, zero, z0, z0, full((n + 2,), 0.0), zero,
              full((3,), 0.0), full((3,), 0.0), zero, zero, zero)
    state = ((u1_0, zero, z0, z0, full((), 0, torch.int64),
              full((), False, torch.bool), full((), 0, torch.int64))
             + saved0 + (full((3,), 1.0), full((2,), 1.0)))
    out = _loop(_ipm_step(mehrotra), state,
                (base, _pow2_table(dtype, dev)))
    u1_f = out[0] * scale1.unsqueeze(-1)
    return u1_f[..., 0], u1_f[..., 1], u1_f[..., 2:], out[4]


def _logdet_gate(tp, vp, xp, t0, v0, w):
    """KKT acceptance gate lane by lane (log_cone_wrapper.c:47-129)."""
    d, p, cm = check_logdet_opt(tp, vp, xp, t0, v0, w)
    return ((tp >= t0 - 0.1 * torch.abs(t0))
            & (d < _LW_DUAL_FEAS_TOL) & (p < _LW_PRI_FEAS_TOL)
            & (torch.abs(cm) < _LW_COMP_TOL))


def logdet_cone_plain(t0, v0, x0):
    """The logarithmic-cone cascade of a logdet projection, lanes (L,),
    (L,), (L, n) (log_cone_proj_wrapper, log_cone_wrapper.c:47-129):
    Newton on every lane, the KKT gate, then the IPM on the lanes that
    fail it, variant 0 and variant 1 on those still failing. A lane whose
    attempts all fail takes the last, as the reference's wrapper
    overwrites its projection on every attempt (log_cone_wrapper.c:80-103;
    the JAX package runs the IPM on every lane of the call when one fails
    and takes it where the gate failed, the same result). Returns (t, v,
    x, info), info = Newton iterations + 1000 x IPM variants run. The
    plain version of the kernel `ops/logdet.logdet_cone`."""
    tp, vp, xp, its = _newton(t0, v0, x0)
    info = its.to(torch.int32)
    lanes = torch.nonzero(~_logdet_gate(tp, vp, xp, t0, v0, x0)).squeeze(-1)
    for variant in (0, 1):
        if lanes.shape[0] == 0:
            break
        ti, vi, xi = log_cone_ipm(t0[lanes], v0[lanes], x0[lanes], variant)
        tp[lanes], vp[lanes], xp[lanes] = ti, vi, xi
        info[lanes] += 1000
        passed = _logdet_gate(ti, vi, xi, t0[lanes], v0[lanes], x0[lanes])
        lanes = lanes[~passed]
    return tp, vp, xp, info


def proj_logdet_batch(seg: torch.Tensor, ns: int,
                      f32_eig: bool = False) -> torch.Tensor:
    """Project (..., tri + 2) log-determinant cones of dimension ns
    (SCS(proj_logdet_cone), logdet_cone.c:46-150): one batched eigh, then
    the logarithmic-cone cascade on the eigenvalues of every cone
    (`ops/logdet.logdet_cone`: Newton, the KKT gate, the IPM where it
    fails), then V diag(max(x, 0)) V'."""
    return proj_logdet_batch_info(seg, ns, f32_eig)[0]


def proj_logdet_batch_info(seg: torch.Tensor, ns: int,
                           f32_eig: bool = False):
    """`proj_logdet_batch` and its cones' info (lead,) int32: Newton
    iterations + 1000 x IPM variants run (`ops/logdet.logdet_cone`)."""
    lead = seg.shape[:-1]
    seg = seg.reshape(-1, seg.shape[-1])
    t0 = seg[:, 0] * _SQRT2
    v0 = seg[:, 1] * _SQRT2
    M = svec_to_mat(seg[:, 2:], ns) * _SQRT2
    w, V = _eigh(M, seg.dtype, f32_eig)
    t_p, v_p, x_p, info = logdet.logdet_cone(t0, v0, w)
    x_p = torch.clamp_min(x_p, 0.0)
    Mp = (V * x_p.unsqueeze(-2)) @ V.transpose(-1, -2) / _SQRT2
    out = torch.cat([(t_p / _SQRT2).unsqueeze(-1),
                     (v_p / _SQRT2).unsqueeze(-1), mat_to_svec(Mp, ns)], -1)
    return out.reshape(lead + (out.shape[-1],)), info.reshape(lead)


def proj_logdet(tvX: torch.Tensor, ns: int,
                f32_eig: bool = False) -> torch.Tensor:
    """Project [t; v; svec(X)] onto the log-determinant cone
    cl{(t, v, X): X psd, v >= 0, -v log det(X/v) <= t} (logdet_cone.c:
    46-150), one cone: `proj_logdet_batch` on a stack of one."""
    return proj_logdet_batch(tvX.unsqueeze(0), ns, f32_eig=f32_eig)[0]
