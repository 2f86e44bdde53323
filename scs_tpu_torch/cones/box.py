"""Box cone projection: { (t, s) : t*bl <= s <= t*bu, t >= 0 }.

Counterpart of `scs_tpu/cones/box.py` (SCS: src/cones.c:1179-1245,
proj_box_cone, BOX_CONE_MAX_ITERS = 25): Newton's method on the scalar t
under the (inverse) metric r_box, warm-started across ADMM iterations.
The loop runs a fixed number of masked steps with no host read, so that
on the card the whole projection is one CUDA graph (`cones.graphs`); a
leading batch axis projects one box per problem.
"""

import torch

from .. import config
from .graphs import settled


def proj_box_cone(tx, bl, bu, t_warm, r_box=None):
    """Project tx = [t; x] (..., bsize) onto the box cone.

    Args:
      tx: (..., bsize), tx[..., 0] the cone scale t.
      bl, bu: (..., bsize - 1) bounds (may hold +-inf).
      t_warm: (...) warm start for t.
      r_box: (..., bsize) metric weights (the diag_r segment) or None for
        the identity.

    Returns (projected tx, new t warm start).
    """
    if tx.shape[-1] == 1:
        t = torch.clamp_min(tx[..., 0], 0.0)
        return t[..., None], t

    x = tx[..., 1:]
    t0 = tx[..., 0]
    if r_box is None:
        rho_t, rinv = 1.0, 1.0
    else:
        rho_t = 1.0 / r_box[..., 0]
        rinv = 1.0 / r_box[..., 1:]

    t = t_warm
    done = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
    for _ in range(config.BOX_CONE_MAX_ITERS):
        tb = t[..., None]
        tu, tl = tb * bu, tb * bl
        above = x > tu
        below = x < tl
        # gradient and Hessian of 0.5 sum r^-1 (clip residuals)^2
        # + rho_t (t - t0)^2
        gu = torch.where(above, rinv * (tu - x) * bu, 0.0)
        gl = torch.where(below, rinv * (tl - x) * bl, 0.0)
        hu = torch.where(above, rinv * bu * bu, 0.0)
        hl = torch.where(below, rinv * bl * bl, 0.0)
        gt = rho_t * (t - t0) + torch.sum(gu + gl, dim=-1)
        ht = rho_t + torch.sum(hu + hl, dim=-1)
        t_new = torch.clamp_min(t - gt / torch.clamp_min(ht, 1e-8), 0.0)
        big = torch.clamp_min(t_new, 1.0)
        conv = ((torch.abs(gt / torch.clamp_min(ht, 1e-6)) < 1e-12 * big)
                | (torch.abs(t_new - t) < 1e-11 * big))
        t = torch.where(done, t, t_new)
        done = done | conv
        if settled(done):
            break

    # clamp as the reference does: comparisons against NaN (t = 0 with an
    # infinite bound gives t * inf = NaN) are false, leaving x unclamped
    tu = t[..., None] * bu
    tl = t[..., None] * bl
    x_proj = torch.where(x > tu, tu, torch.where(x < tl, tl, x))
    return torch.cat([t[..., None], x_proj], dim=-1), t


def scale_box_bounds(bu, bl, D_box):
    """Equilibration of the box bounds (normalize_box_cone, cones.c:
    1161-1177): factor = D[j + 1] / D[0]; entries at +-MAX_BOX_VAL are
    treated as infinite. D_box (..., bsize), bounds (..., bsize - 1)."""
    factor = D_box[..., 1:] / D_box[..., :1]
    bu_s = torch.where(bu >= config.MAX_BOX_VAL, torch.inf, bu * factor)
    bl_s = torch.where(bl <= -config.MAX_BOX_VAL, -torch.inf, bl * factor)
    return bu_s, bl_s
