"""Exponential cone projection, vectorized over cone triples.

Counterpart of `scs_tpu/cones/exp.py`: Friberg's univariate root-finding
formulation ("Projection onto the exponential cone: a univariate
root-finding problem", 2021; SCS: src/exp_cone.c). SCS runs a loop over
triples with early exits; here every stage is branchless masked
arithmetic over all triples at once, the Newton and bisection loops run a
fixed number of steps, and nothing reads the device from the host, so
that on the card the whole projection is one CUDA graph
(`cones.graphs`).

Triple layout: v = (r, s, t); primal cone K = cl{(r,s,t) : s*exp(r/s) <= t,
s > 0}; dual via Pi_{K*}(v) = -Pi_{K_polar}(-v). The triples are carried
as three component tensors of any shape.
"""

import math

import torch

from .. import config
from .graphs import settled

_INF = config.EXP_CONE_INFINITY
_NEWTON_ITERS = 20
_BISECT_ITERS = 40
_EPS = 1e-15
_DFTOL = 1e-13
_LODAMP = 0.05
_HIDAMP = 0.95
_TOL = 1e-8


def _sq(x):
    return x * x


def _hfun(r0, s0, t0, rho, df: bool = True):
    """(f, df) of Friberg's h at rho; (f, None) without `df` (the same f,
    with the derivative's kernels left out)."""
    exprho = torch.exp(rho)
    expnegrho = 1.0 / exprho
    f = (((rho - 1.0) * r0 + s0) * exprho - (r0 - rho * s0) * expnegrho
         - (rho * (rho - 1.0) + 1.0) * t0)
    if not df:
        return f, None
    d = ((rho * r0 + s0) * exprho + (r0 - (rho - 1.0) * s0) * expnegrho
         - (2.0 * rho - 1.0) * t0)
    return f, d


def _proj_primal_heuristic(r0, s0, t0):
    # perspective boundary
    vr, vs, vt = torch.clamp_max(r0, 0.0), torch.zeros_like(s0), \
        torch.clamp_min(t0, 0.0)
    dist_sq = _sq(r0 - vr) + _sq(s0 - vs) + _sq(t0 - vt)
    # perspective interior (s0 > 0)
    safe_s = torch.where(s0 > 0, s0, 1.0)
    tp = torch.maximum(t0, safe_s * torch.exp(r0 / safe_s))
    newdist = _sq(tp - t0)
    use = (s0 > 0) & (newdist < dist_sq)
    return ((torch.where(use, r0, vr), torch.where(use, s0, vs),
             torch.where(use, tp, vt)),
            torch.where(use, newdist, dist_sq))


def _proj_polar_heuristic(r0, s0, t0):
    vr, vs, vt = torch.zeros_like(r0), torch.clamp_max(s0, 0.0), \
        torch.clamp_max(t0, 0.0)
    dist_sq = _sq(r0 - vr) + _sq(s0 - vs) + _sq(t0 - vt)
    safe_r = torch.where(r0 > 0, r0, 1.0)
    td = torch.minimum(t0, -safe_r * torch.exp(s0 / safe_r - 1.0))
    newdist = _sq(t0 - td)
    use = (r0 > 0) & (newdist < dist_sq)
    return ((torch.where(use, r0, vr), torch.where(use, s0, vs),
             torch.where(use, td, vt)),
            torch.where(use, newdist, dist_sq))


def _safediv_pos(x, y):
    return torch.where(y < config.DIV_EPS_TOL, x / config.DIV_EPS_TOL, x / y)


def _ppsi(r0, s0):
    rad = torch.sqrt(r0 * r0 + s0 * s0 - r0 * s0)
    psi_hi = (r0 - s0 + rad) / torch.where(r0 != 0, r0, 1.0)
    den = r0 - s0 - rad
    psi_lo = -s0 / torch.where(den != 0, den, 1.0)
    psi = torch.where(r0 > s0, psi_hi, psi_lo)
    return ((psi - 1.0) * r0 + s0) / (psi * (psi - 1.0) + 1.0)


def _dpsi(r0, s0):
    rad = torch.sqrt(r0 * r0 + s0 * s0 - r0 * s0)
    psi_hi = (r0 - rad) / torch.where(s0 != 0, s0, 1.0)
    den = r0 + rad
    psi_lo = (r0 - s0) / torch.where(den != 0, den, 1.0)
    psi = torch.where(s0 > r0, psi_hi, psi_lo)
    return (r0 - psi * s0) / (psi * (psi - 1.0) + 1.0)


def _pomega(rho):
    val = torch.exp(rho) / (rho * (rho - 1.0) + 1.0)
    return torch.where(rho < 2.0, torch.clamp_max(val, _E2_3), val)


def _domega(rho):
    val = -torch.exp(-rho) / (rho * (rho - 1.0) + 1.0)
    return torch.where(rho > -1.0, torch.clamp_min(val, -_E1_3), val)


_E2_3 = math.exp(2.0) / 3.0
_E1_3 = math.exp(1.0) / 3.0


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _search_bracket(r0, s0, t0, pdist_sq, ddist_sq):
    """Bracket [low, upr] for the root of hfun (exp_cone.c:261-323)."""
    baselow = torch.full_like(r0, -_INF)
    baseupr = torch.full_like(r0, _INF)
    low = torch.full_like(r0, -_INF)
    upr = torch.full_like(r0, _INF)

    Dp = torch.sqrt(torch.clamp_min(pdist_sq - _sq(torch.clamp_max(s0, 0.0)),
                                    0.0))
    Dd = torch.sqrt(torch.clamp_min(ddist_sq - _sq(torch.clamp_max(r0, 0.0)),
                                    0.0))

    # t0 > 0: low bound from ppsi; t0 < 0: upper bound from dpsi
    ppsi_v = _ppsi(r0, s0)
    dpsi_v = _dpsi(r0, s0)
    safe_pp = torch.where(ppsi_v != 0, ppsi_v, 1.0)
    safe_dp = torch.where(dpsi_v != 0, dpsi_v, 1.0)
    low = torch.where(t0 > 0, torch.maximum(
        low, torch.log(torch.abs(t0 / safe_pp))), low)
    upr = torch.where(t0 < 0, torch.minimum(
        upr, -torch.log(torch.abs(-t0 / safe_dp))), upr)

    # r0 > 0 branch
    safe_r = torch.where(r0 != 0, r0, 1.0)
    baselow_r = 1.0 - s0 / safe_r
    low_r = torch.maximum(low, baselow_r)
    tpu_ = torch.clamp_min(torch.minimum(Dd, Dp + t0), 1e-12)
    val_r = r0 * _pomega(low_r)
    sgn_r = torch.where(val_r < 0, -1.0, 1.0)
    curbnd_r = torch.maximum(
        low_r, baselow_r + _safediv_pos(tpu_, torch.abs(val_r)) * sgn_r)
    pos_r = r0 > 0
    baselow = torch.where(pos_r, baselow_r, baselow)
    low = torch.where(pos_r, low_r, low)
    upr = torch.where(pos_r, torch.minimum(upr, curbnd_r), upr)

    # s0 > 0 branch
    safe_s = torch.where(s0 != 0, s0, 1.0)
    baseupr_s = r0 / safe_s
    upr_s = torch.minimum(upr, baseupr_s)
    tdl = -torch.clamp_min(torch.minimum(Dp, Dd - t0), 1e-12)
    val_s = s0 * _domega(upr_s)
    sgn_s = torch.where(val_s < 0, -1.0, 1.0)
    curbnd_s = torch.minimum(
        upr_s, baseupr_s - _safediv_pos(tdl, torch.abs(val_s)) * sgn_s)
    pos_s = s0 > 0
    baseupr = torch.where(pos_s, baseupr_s, baseupr)
    upr = torch.where(pos_s, upr_s, upr)
    low = torch.where(pos_s, torch.maximum(low, curbnd_s), low)

    # guarantee a valid bracket
    low = _clip(torch.minimum(low, upr), baselow, baseupr)
    upr = _clip(torch.maximum(low, upr), baselow, baseupr)

    fl, _ = _hfun(r0, s0, t0, low, df=False)
    fu, _ = _hfun(r0, s0, t0, upr, df=False)
    same_sign = (fl * fu > 0.0) & (low != upr)
    pick_low = torch.abs(fl) < torch.abs(fu)
    upr = torch.where(same_sign & pick_low, low, upr)
    low = torch.where(same_sign & ~pick_low, upr, low)
    return low, upr


def _root_newton(r0, s0, t0, xl, xu, x0):
    """Damped, safeguarded Newton with a bisection fallback
    (exp_cone.c:98-162), both a fixed number of masked steps."""
    x = x0
    done = torch.zeros(x0.shape, dtype=torch.bool, device=x0.device)
    for _ in range(_NEWTON_ITERS):
        f, df = _hfun(r0, s0, t0, x)
        conv_root = torch.abs(f) <= _EPS
        xl_n = torch.where(f < 0.0, x, xl)
        xu_n = torch.where(f < 0.0, xu, x)
        collapsed = xu_n <= xl_n
        mid = 0.5 * (xu_n + xl_n)
        xl_n = torch.where(collapsed, mid, xl_n)
        xu_n = torch.where(collapsed, mid, xu_n)
        flat = ~torch.isfinite(f) | (torch.abs(f) >= _INF) | (df < _DFTOL)
        x_plus = x - f / torch.where(df != 0, df, 1.0)
        small_step = (torch.abs(x_plus - x)
                      <= _EPS * torch.clamp_min(torch.abs(x_plus), 1.0))
        x_damped = torch.where(
            x_plus >= xu_n,
            torch.minimum(_LODAMP * x + _HIDAMP * xu_n, xu_n),
            torch.where(x_plus <= xl_n,
                        torch.maximum(_LODAMP * x + _HIDAMP * xl_n, xl_n),
                        x_plus))
        stop_now = conv_root | collapsed | flat | small_step
        keep = done | conv_root
        x = torch.where(done | stop_now, x, x_damped)
        xl = torch.where(keep, xl, xl_n)
        xu = torch.where(keep, xu, xu_n)
        done = done | stop_now
        if settled(done):
            break
    # Newton converged iff it stopped before running out of steps;
    # otherwise bisect from the refined bracket
    needs_bisect = ~done
    x_newton = _clip(x, xl, xu)

    done = ~needs_bisect
    for _ in range(_BISECT_ITERS):
        f, _ = _hfun(r0, s0, t0, x, df=False)
        xl_n = torch.where(f < 0.0, x, xl)
        xu_n = torch.where(f < 0.0, xu, x)
        x_plus = 0.5 * (xl_n + xu_n)
        conv = ((torch.abs(x_plus - x)
                 <= 1e-12 * torch.clamp_min(torch.abs(x_plus), 1.0))
                | (x_plus == xl_n) | (x_plus == xu_n))
        x = torch.where(done, x, x_plus)
        xl = torch.where(done, xl, xl_n)
        xu = torch.where(done, xu, xu_n)
        done = done | conv
        if settled(done):
            break
    return torch.where(needs_bisect, x, x_newton)


def _proj_sol_primal(r0, s0, t0, rho):
    linrho = (rho - 1.0) * r0 + s0
    exprho = torch.exp(rho)
    quadrho = rho * (rho - 1.0) + 1.0
    ok = (linrho > 0.0) & (torch.abs(exprho) < _INF)
    q = torch.where(ok, quadrho, 1.0)
    vr = torch.where(ok, rho * linrho / q, 0.0)
    vs = torch.where(ok, linrho / q, 0.0)
    vt = torch.where(ok, exprho * linrho / q, _INF)
    dist_sq = torch.where(ok, _sq(vr - r0) + _sq(vs - s0) + _sq(vt - t0),
                          _INF)
    return (vr, vs, vt), dist_sq


def _proj_sol_polar(r0, s0, t0, rho):
    linrho = r0 - rho * s0
    exprho = torch.exp(-rho)
    quadrho = rho * (rho - 1.0) + 1.0
    ok = (linrho > 0.0) & (torch.abs(exprho) < _INF)
    q = torch.where(ok, quadrho, 1.0)
    vr = torch.where(ok, linrho / q, 0.0)
    vs = torch.where(ok, (1.0 - rho) * linrho / q, 0.0)
    vt = torch.where(ok, -exprho * linrho / q, -_INF)
    dist_sq = torch.where(ok, _sq(r0 - vr) + _sq(s0 - vs) + _sq(t0 - vt),
                          _INF)
    return (vr, vs, vt), dist_sq


def proj_exp_batch(v: torch.Tensor, primal_mask: torch.Tensor) -> torch.Tensor:
    """Project triples v (..., k, 3) onto primal (mask True) or dual exp
    cones; primal_mask (k,) bool."""
    # dual: Pi_{K*}(v) = -Pi_{K_polar}(-v)
    r0, s0, t0 = (torch.where(primal_mask, v[..., i], -v[..., i])
                  for i in range(3))

    vp, pdist_sq = _proj_primal_heuristic(r0, s0, t0)
    vd, ddist_sq = _proj_polar_heuristic(r0, s0, t0)

    err = torch.maximum(torch.maximum(torch.abs(vp[0] + vd[0] - r0),
                                      torch.abs(vp[1] + vd[1] - s0)),
                        torch.abs(vp[2] + vd[2] - t0))
    opt = (s0 <= 0.0) & (r0 <= 0.0)
    opt = opt | (torch.minimum(pdist_sq, ddist_sq) <= _TOL * _TOL)
    opt = opt | ((err <= _TOL)
                 & (vp[0] * vd[0] + vp[1] * vd[1] + vp[2] * vd[2] <= _TOL))

    # rows the heuristics settled take the heuristic result below; the
    # root-finding pipeline gets a fixed generic triple for them, so that
    # it computes finite (discarded) values, as the JAX package does
    r1 = torch.where(opt, 1.0, r0)
    s1 = torch.where(opt, 0.5, s0)
    t1 = torch.where(opt, 2.0, t0)
    pdist_safe = torch.where(opt, 1.0, pdist_sq)
    ddist_safe = torch.where(opt, 1.0, ddist_sq)
    xl, xh = _search_bracket(r1, s1, t1, pdist_safe, ddist_safe)
    rho = _root_newton(r1, s1, t1, xl, xh, 0.5 * (xl + xh))

    vp_hat, pdist_hat = _proj_sol_primal(r1, s1, t1, rho)
    vd_hat, ddist_hat = _proj_sol_polar(r1, s1, t1, rho)
    p_hat = pdist_hat <= pdist_sq
    d_hat = ddist_hat <= ddist_sq
    out = []
    for i in range(3):
        vp_out = torch.where(opt, vp[i], torch.where(p_hat, vp_hat[i], vp[i]))
        vd_out = torch.where(opt, vd[i], torch.where(d_hat, vd_hat[i], vd[i]))
        # primal result vp; dual result -vd (polar -> dual)
        out.append(torch.where(primal_mask, vp_out, -vd_out))
    return torch.stack(out, dim=-1)
