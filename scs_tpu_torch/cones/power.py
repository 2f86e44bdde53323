"""Power cone projection, vectorized over triples.

Counterpart of `scs_tpu/cones/power.py` (SCS: src/cones.c:1284-1332):
K_a = { (x, y, z) : x^a y^(1-a) >= |z|, x >= 0, y >= 0 }, a in (0, 1),
by Newton's method on r, the |z| component of the projection, run for a
fixed number of masked steps with no host read (one CUDA graph on the
card, `cones.graphs`). Dual cones (a negative exponent in the spec) go
through Moreau: Pi_{K*}(v) = v + Pi_{K_{-a}}(-v).
"""

import torch

from .. import config
from .graphs import settled

_TOL = config.POW_CONE_TOL
_ITERS = config.POW_CONE_MAX_ITERS


def _pow_calc_x(r, xh, rh, a):
    x = 0.5 * (xh + torch.sqrt(xh * xh + 4.0 * a * (rh - r) * r))
    return torch.clamp_min(x, 1e-12)


def _proj_primal_pow(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Project triples v (..., k, 3) onto primal power cones with
    exponents a (k,) in (0, 1)."""
    xh, yh, zh = v[..., 0], v[..., 1], v[..., 2]
    rh = torch.abs(zh)

    # membership in K_a: x^a y^(1-a) >= |z| (x, y >= 0)
    pow_xy = torch.where((xh > 0) & (yh > 0),
                         torch.pow(torch.clamp_min(xh, 0.0), a)
                         * torch.pow(torch.clamp_min(yh, 0.0), 1 - a), 0.0)
    in_cone = (xh >= 0) & (yh >= 0) & (_TOL + pow_xy >= rh)

    # membership of -v in the polar cone
    pow_neg = torch.where((xh < 0) & (yh < 0),
                          torch.pow(-xh, a) * torch.pow(-yh, 1 - a), 0.0)
    in_polar = (xh <= 0) & (yh <= 0) & (
        _TOL + pow_neg >= rh * torch.pow(a, a) * torch.pow(1 - a, 1 - a))

    r = rh / 2.0
    # the rows inside the cone or its polar take v or 0 below, whatever r
    # becomes: starting them settled changes no output
    done = in_cone | in_polar
    for _ in range(_ITERS):
        x = _pow_calc_x(r, xh, rh, a)
        y = _pow_calc_x(r, yh, rh, 1 - a)
        xa = torch.pow(x, a)
        y1a = torch.pow(y, 1 - a)
        f = xa * y1a - r
        conv = torch.abs(f) < _TOL
        dxdr = a * (rh - 2.0 * r) / (2.0 * x - xh)
        dydr = (1 - a) * (rh - 2.0 * r) / (2.0 * y - yh)
        fp = xa * y1a * (a * dxdr / x + (1 - a) * dydr / y) - 1.0
        r_new = torch.minimum(torch.clamp_min(
            r - f / torch.where(fp != 0, fp, 1.0), 0.0), rh)
        r = torch.where(done | conv, r, r_new)
        done = done | conv
        if settled(done):
            break

    x = _pow_calc_x(r, xh, rh, a)
    y = _pow_calc_x(r, yh, rh, 1 - a)
    proj = torch.stack([x, y, torch.where(zh < 0, -r, r)], dim=-1)
    return torch.where(in_cone[..., None], v,
                       torch.where(in_polar[..., None],
                                   torch.zeros_like(proj), proj))


def proj_power_batch(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Project triples v (..., k, 3); a (k,): a >= 0 the primal cone K_a,
    a < 0 the dual cone K_|a|*. The JAX package projects every row on
    both branches and selects; here each row goes through the one it
    takes (the primal projection is row by row, so the rows are the
    same)."""
    is_primal = (a >= 0)[..., None]
    # dual via Moreau: v + Pi_{K_a}(-v)
    proj = _proj_primal_pow(torch.where(is_primal, v, -v), torch.abs(a))
    return torch.where(is_primal, proj, v + proj)
