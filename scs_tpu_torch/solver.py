"""The ADMM iteration on the homogeneous self-dual embedding.

Counterpart of the single-problem core of `scs_tpu/solver.py` (SCS:
src/scs.c:1356-1455). The JAX package compiles the loop into one
`lax.while_loop`; here it is a Python loop over plain steps. Every
CONVERGED_INTERVAL iterations a checked step computes the residuals and
the status, and the host reads the status and the adaptive-scale decision
in one transfer: that is the loop's only wait for the device. Everything
else that depends on the data (root_plus branches, Anderson acceptance,
the safeguard) is a `torch.where` select on the device.

Iteration order (scs.c:1356-1455):
  1. Anderson acceleration (every acceleration_interval iterations, i > 0)
  2. normalize v to constant L2 norm (i >= FEASIBLE_ITERS)
  3. u_t = (R + Q)^{-1} R v  -- linear system solve + root_plus for tau
  4. u = Pi_C(2 u_t - v)     -- cone projection via Moreau
  5. rsk = R (v + u - 2 u_t)
  6. residuals + convergence / certificate check (every 25 iterations)
  7. adaptive scale update (on a checked step)
  8. v += alpha (u - u_t)
  9. AA safeguard

The iteration counter, the status and the scale-update bookkeeping live on
the host; vectors and residual scalars stay on the device.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Optional

import torch

from . import accel, config
from .cones.project import proj_dual_cone
from .equilibrate import Scaling
from .linsys import Mats, get_backend
from .linsys.matvec import ds_mv
from .types import ConeData, ConeSpec, Settings


@dataclasses.dataclass(frozen=True)
class ProblemData:
    """Normalized problem data + originals, tensors on the solve's device
    (A and P dense, or `ops.sparse.SparseA`)."""

    A: torch.Tensor                 # (m, n) normalized
    P: Optional[torch.Tensor]       # (n, n) normalized or None
    b: torch.Tensor                 # (m,) normalized
    c: torch.Tensor                 # (n,) normalized
    b_orig: torch.Tensor
    c_orig: torch.Tensor
    nm_b_orig: torch.Tensor         # inf-norm of original b
    nm_c_orig: torch.Tensor
    scal: Scaling
    cone: ConeData
    eps_abs: float
    eps_rel: float
    eps_infeas: float
    alpha: float
    lin_cache: Any = None           # backend precompute output
    A32: Optional[torch.Tensor] = None  # float32 shadows (mixed indirect)
    P32: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class Residuals:
    """Scalar residual snapshot in the original problem space (0-d
    tensors)."""

    last_iter: int
    tau: torch.Tensor
    kap: torch.Tensor
    res_pri: torch.Tensor
    res_dual: torch.Tensor
    gap: torch.Tensor
    res_infeas: torch.Tensor
    res_unbdd_a: torch.Tensor
    res_unbdd_p: torch.Tensor
    ctx: torch.Tensor
    bty: torch.Tensor
    xt_p_x: torch.Tensor
    pobj: torch.Tensor
    dobj: torch.Tensor
    bty_tau: torch.Tensor
    ctx_tau: torch.Tensor
    nm_ax: torch.Tensor
    nm_s: torch.Tensor
    nm_px: torch.Tensor
    nm_aty: torch.Tensor
    nm_ax_s_btau: torch.Tensor
    nm_px_aty_ctau: torch.Tensor
    # normalized-space norms for the indirect backend's CG tolerance
    nm_ax_s_btau_norm: torch.Tensor
    nm_px_aty_ctau_norm: torch.Tensor

    @staticmethod
    def zeros(dtype, device) -> "Residuals":
        z = torch.zeros((), dtype=dtype, device=device)
        vals = {f.name: z for f in dataclasses.fields(Residuals)}
        vals.update(last_iter=-1, tau=z + 1.0)
        return Residuals(**vals)


@dataclasses.dataclass(frozen=True)
class LoopState:
    u: torch.Tensor
    u_t: torch.Tensor
    v: torch.Tensor
    v_prev: torch.Tensor          # AA safeguard snapshot (post-normalize v)
    rsk: torch.Tensor
    diag_r: torch.Tensor
    g: torch.Tensor               # (l-1,) cache: (I+M)^{-1} [c; -b]
    derived: Any                  # linsys factor
    scale: torch.Tensor
    box_t_warm: torch.Tensor      # box cone Newton warm start (0-d)
    res: Residuals
    sum_log_scale_factor: torch.Tensor
    n_log_scale_factor: int
    last_scale_update_iter: int
    scale_updates: int
    status: int                   # exit flag (0 = running)
    iter: int
    aa: accel.AAState
    aa_norm: torch.Tensor
    accepted_accel: torch.Tensor
    rejected_accel: torch.Tensor
    tot_cg_its: Any               # CG iterations (0-d int64 on the device)


def _norm_inf(x):
    return torch.amax(torch.abs(x))


def _dot(x, y):
    return torch.dot(x, y)


def _norm_2(x):
    return torch.linalg.vector_norm(x)


def _safediv_pos(x, y):
    return torch.where(y < config.DIV_EPS_TOL, x / config.DIV_EPS_TOL, x / y)


def pack_warm_v(x, y, s, diag_r, scrub_nan: bool = False):
    """v = [x; y + s/R_y; 1]: the DR fixed point of a solution
    (warm-start packing, scs.c:660-685)."""
    n, m = x.shape[0], y.shape[0]
    vy = y + s / diag_r[n:n + m]
    if scrub_nan:
        x = torch.nan_to_num(x, nan=0.0, posinf=math.inf, neginf=-math.inf)
        vy = torch.nan_to_num(vy, nan=0.0, posinf=math.inf,
                              neginf=-math.inf)
    return torch.cat([x, vy, torch.ones(1, dtype=x.dtype, device=x.device)])


def renormalize_v(v):
    """Rescale v to the loop's constant norm sqrt(l) * ITERATE_NORM
    (scs.c:813-821). A zero v is returned unchanged."""
    nrm = _norm_2(v)
    return v * (math.sqrt(v.shape[0]) * config.ITERATE_NORM
                / torch.where(nrm > 0, nrm, 1.0))


def set_diag_r(spec: ConeSpec, n: int, m: int, scale, rho_x, dtype, device):
    """diag_r = [rho_x 1_n; r_y; TAU_FACTOR] (scs.c:971-980,
    cones.c:349-363): zero-cone rows get r_y = 1/(1000 scale), all other
    rows 1/scale."""
    scale = torch.as_tensor(scale, dtype=dtype, device=device)
    rows = torch.arange(m, device=device)
    r_y = torch.where(rows < spec.z, 1.0 / (1000.0 * scale), 1.0 / scale)
    return torch.cat([
        torch.full((n,), rho_x, dtype=dtype, device=device),
        r_y.to(dtype),
        torch.full((1,), config.TAU_FACTOR, dtype=dtype, device=device),
    ])


def root_plus(g, p, mu, eta, diag_r, nm: int):
    """Homogeneous tau from the scalar quadratic (scs.c:689-730): stable
    quadratic formula with the repeated-root fallback; NaN when the
    quadratic is degenerate."""
    r = diag_r[:nm]
    gs = g * r
    gg = _dot(gs, g)
    mug = _dot(mu[:nm], gs)
    pg = _dot(p[:nm], gs)
    ps = p[:nm] * r
    pp = _dot(ps, p[:nm])
    pmu = _dot(ps, mu[:nm])
    tau_scale = diag_r[nm]
    a = tau_scale + gg
    b = mug - 2.0 * pg - eta * tau_scale
    c = pp - pmu
    rad = b * b - 4.0 * a * c
    sqrt_rad = torch.sqrt(torch.clamp_min(rad, 0.0))
    res_neg_rad = -b / (2.0 * a)
    res_b_neg = (-b + sqrt_rad) / (2.0 * a)
    q = -0.5 * (b + sqrt_rad)
    res_b_pos = torch.where(q != 0.0, c / torch.where(q != 0.0, q, 1.0), 0.0)
    out = torch.where(rad < 0.0, res_neg_rad,
                      torch.where(b <= 0.0, res_b_neg, res_b_pos))
    ok = (torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(c)
          & (a > 0.0) & torch.isfinite(rad))
    return torch.where(ok, out, math.nan)


def _res_matvec(data: ProblemData, x, transpose: bool):
    """A x / A' x through the double-single kernels when the cache holds
    the splits (K1; K2s and K1 for a sparse A), else in plain float64."""
    ds = getattr(data.lin_cache, "ds_bwd" if transpose else "ds_fwd", None)
    if ds is None:
        return (data.A.T @ x) if transpose else (data.A @ x)
    return ds_mv(ds, x)


def populate_residuals(data: ProblemData, spec: ConeSpec, u, rsk, it: int,
                       use_ds: bool = False) -> Residuals:
    """Normalized residuals, unnormalized and reduced to scalars
    (populate_residual_struct + unnormalize_residuals, scs.c:454-607).

    use_ds routes the A matvecs through the double-single kernel (the
    mixed path's in-loop checks); the final report stays plain float64."""
    m, n = data.A.shape
    dtype = u.dtype
    x = u[:n]
    y = u[n:n + m]
    s = rsk[n:n + m]
    tau = torch.abs(u[n + m])
    kap = torch.abs(rsk[n + m])

    ax = _res_matvec(data, x, False) if use_ds else data.A @ x
    ax_s = ax + s
    ax_s_btau = ax_s - tau * data.b
    if data.P is not None:
        px = data.P @ x
        xt_p_x_tau = _dot(px, x)
    else:
        px = torch.zeros(n, dtype=dtype, device=u.device)
        xt_p_x_tau = torch.zeros((), dtype=dtype, device=u.device)
    aty = _res_matvec(data, y, True) if use_ds else data.A.T @ y
    px_aty_ctau = px + aty + tau * data.c
    bty_tau = _dot(y, data.b)
    ctx_tau = _dot(x, data.c)

    # -- unnormalize (scs.c:487-531) --
    scal = data.scal
    pd = scal.primal_scale * scal.dual_scale
    fac_m = 1.0 / (scal.D * scal.dual_scale)   # primal-side vectors
    fac_n = 1.0 / (scal.E * scal.primal_scale)  # dual-side vectors
    ax_o = ax * fac_m
    ax_s_o = ax_s * fac_m
    ax_s_btau_o = ax_s_btau * fac_m
    px_o = px * fac_n
    aty_o = aty * fac_n
    px_aty_ctau_o = px_aty_ctau * fac_n
    s_o = s / (scal.D * scal.dual_scale)
    kap_o = kap / pd
    bty_tau_o = bty_tau / pd
    ctx_tau_o = ctx_tau / pd
    xt_p_x_tau_o = xt_p_x_tau / pd

    bty = _safediv_pos(bty_tau_o, tau)
    ctx = _safediv_pos(ctx_tau_o, tau)
    xt_p_x = _safediv_pos(xt_p_x_tau_o, tau * tau)
    gap = torch.abs(xt_p_x + ctx + bty)
    pobj = xt_p_x / 2.0 + ctx
    dobj = -xt_p_x / 2.0 - bty

    # -- compute_residuals in the original space (scs.c:463-485) --
    tol = config.INFEAS_NEGATIVITY_TOL / pd
    res_pri = _safediv_pos(_norm_inf(ax_s_btau_o), tau)
    res_dual = _safediv_pos(_norm_inf(px_aty_ctau_o), tau)
    unbdd_cond = ctx_tau_o < -tol
    res_unbdd_a = torch.where(
        unbdd_cond, _safediv_pos(_norm_inf(ax_s_o), -ctx_tau_o), math.nan)
    res_unbdd_p = torch.where(
        unbdd_cond, _safediv_pos(_norm_inf(px_o), -ctx_tau_o), math.nan)
    infeas_cond = bty_tau_o < -tol
    res_infeas = torch.where(
        infeas_cond, _safediv_pos(_norm_inf(aty_o), -bty_tau_o), math.nan)

    return Residuals(
        last_iter=it, tau=tau, kap=kap_o,
        res_pri=res_pri, res_dual=res_dual, gap=gap,
        res_infeas=res_infeas, res_unbdd_a=res_unbdd_a,
        res_unbdd_p=res_unbdd_p, ctx=ctx, bty=bty, xt_p_x=xt_p_x,
        pobj=pobj, dobj=dobj, bty_tau=bty_tau_o, ctx_tau=ctx_tau_o,
        nm_ax=_norm_inf(ax_o), nm_s=_norm_inf(s_o),
        nm_px=_norm_inf(px_o), nm_aty=_norm_inf(aty_o),
        nm_ax_s_btau=_norm_inf(ax_s_btau_o),
        nm_px_aty_ctau=_norm_inf(px_aty_ctau_o),
        nm_ax_s_btau_norm=_norm_inf(ax_s_btau),
        nm_px_aty_ctau_norm=_norm_inf(px_aty_ctau))


def has_converged(r: Residuals, data: ProblemData) -> torch.Tensor:
    """Termination test (scs.c:611-649), as a 0-d int64 exit flag. NaN
    comparisons are false, matching the reference's isless semantics for
    unset certificate residuals."""
    grl = torch.maximum(torch.maximum(torch.abs(r.xt_p_x), torch.abs(r.ctx)),
                        torch.abs(r.bty))
    prl = torch.maximum(torch.maximum(data.nm_b_orig * r.tau, r.nm_s),
                        r.nm_ax) / r.tau
    drl = torch.maximum(torch.maximum(data.nm_c_orig * r.tau, r.nm_px),
                        r.nm_aty) / r.tau
    solved = ((r.tau > 0.0)
              & (r.res_pri < data.eps_abs + data.eps_rel * prl)
              & (r.res_dual < data.eps_abs + data.eps_rel * drl)
              & (r.gap < data.eps_abs + data.eps_rel * grl))
    unbounded = ((r.res_unbdd_a < data.eps_infeas)
                 & (r.res_unbdd_p < data.eps_infeas))
    infeasible = r.res_infeas < data.eps_infeas
    return torch.where(
        solved, config.SOLVED,
        torch.where(unbounded, config.UNBOUNDED,
                    torch.where(infeasible, config.INFEASIBLE,
                                config.UNFINISHED)))


def moreau_repolish(data: ProblemData, spec: ConeSpec, st):
    """One float64 Moreau re-projection of the dual block at the finish
    (the JAX `make_moreau_repolish`, solver.py:750-781). A float32-state
    phase, or float32 exp projections (`Settings.exp_f32`), leave the
    returned (s, y) in their cones only to float32 accuracy; the last
    projection's argument w = u_y - rsk_y / R_y is recovered from the
    carried split, projected again in float64, and both halves of the
    split are rewritten, so s in K, y in K* and s'y = 0 hold to float64
    round-off. Idempotent up to round-off where the last projection was
    float64 already. Takes one problem's state (LoopState) or a batch's
    (rows of B lanes)."""
    m, n = data.A.shape[-2:]
    r_y = st.diag_r[..., n:n + m]
    w = st.u[..., n:n + m] - st.rsk[..., n:n + m] / r_y
    y, box_t = proj_dual_cone(w, spec, data.cone, st.box_t_warm, r_y)
    u, rsk = st.u.clone(), st.rsk.clone()
    u[..., n:n + m] = y
    rsk[..., n:n + m] = (y - w) * r_y
    return dataclasses.replace(st, u=u, rsk=rsk, box_t_warm=box_t)


class Iteration:
    """The ADMM iteration for one cone layout and one set of settings
    (the JAX package's `_build_iteration`): `step(data, st)` runs one
    iteration, `update_work_cache` recomputes g after a re-factorization."""

    def __init__(self, spec: ConeSpec, stg: Settings, mixed: bool):
        self.spec = spec
        self.stg = stg
        self.mixed = mixed
        # float32 PSD projections follow mixed unless Settings.cone_f32
        # says otherwise (the JAX package's solver.py:440-447); float32
        # exp projections only where Settings.exp_f32 asks for them: the
        # JAX package also turns them on with mixed, the port does not
        # (ROADMAP section 3, R4)
        self.psd32 = mixed if stg.cone_f32 is None else bool(stg.cone_f32)
        self.exp32 = bool(stg.exp_f32)
        self.backend = get_backend(stg.linsys)
        self.is_indirect = stg.linsys == "indirect"
        self.use_aa = stg.acceleration_lookback > 0
        self.mem = max(stg.acceleration_lookback, 1)

    @staticmethod
    def mats(data: ProblemData) -> Mats:
        return Mats(data.A, data.P, data.lin_cache, data.A32, data.P32)

    def update_work_cache(self, data: ProblemData, diag_r, derived):
        """g = (I + M)^{-1} [c; -b] (scs.c:1118-1128)."""
        h = torch.cat([data.c, -data.b])
        g, _ = self.backend.solve(self.mats(data), diag_r, derived, h,
                                  None, config.CG_BEST_TOL)
        return g

    def _project_lin_sys(self, data: ProblemData, st: LoopState):
        """u_t from the KKT solve; returns (u_t, CG iterations). The
        indirect backend warm-starts CG from u[:n] + tau g[:n] and asks for
        a tolerance that tightens with the residuals and the iteration
        count (solver.py:462-485 of the JAX package)."""
        m, n = data.A.shape
        l = n + m + 1
        v, dr = st.v, st.diag_r
        rhs = torch.cat([v[:n] * dr[:n], -v[n:l - 1] * dr[n:l - 1]])
        warm, tol = None, None
        if self.is_indirect:
            warm = st.u[:n] + st.u[l - 1] * st.g[:n]
            tol = torch.minimum(st.res.nm_ax_s_btau_norm,
                                st.res.nm_px_aty_ctau_norm)
            nm_ws = _norm_inf(warm) / float(st.iter + 1) ** config.CG_RATE
            tol = torch.clamp_min(
                config.CG_TOL_FACTOR * torch.minimum(tol, nm_ws),
                config.CG_BEST_TOL)
        sol, cg_its = self.backend.solve(self.mats(data), dr, st.derived,
                                         rhs, warm, tol)
        if st.iter < config.FEASIBLE_ITERS:
            tau = torch.ones((), dtype=v.dtype, device=v.device)
        else:
            tau = root_plus(st.g, sol, v, v[l - 1], dr, l - 1)
        return torch.cat([sol - tau * st.g, tau[None]]), cg_its

    def _project_cones(self, data: ProblemData, st: LoopState, u_t):
        """(u, new box warm start)."""
        m, n = data.A.shape
        l = n + m + 1
        u_pre = 2.0 * u_t - st.v
        # the tracked-rank PSD path's warm range is the previous inner
        # projection, the carried rsk rows (rsk = R (v + u - 2 u_t) with
        # the v the projection consumed; v_prev is overwritten with the
        # current v before this point); the scale remap keeps rsk
        psd_warm = st.rsk[n:n + m] if self.stg.psd_rank > 0 else None
        y_proj, box_t = proj_dual_cone(u_pre[n:n + m], self.spec, data.cone,
                                       st.box_t_warm, st.diag_r[n:n + m],
                                       exp_f32=self.exp32,
                                       psd_f32=self.psd32, psd_warm=psd_warm,
                                       psd_rank=self.stg.psd_rank)
        if st.iter < config.FEASIBLE_ITERS:
            tau = torch.ones((), dtype=u_pre.dtype, device=u_pre.device)
        else:
            tau = torch.clamp_min(u_pre[l - 1], 0.0)
        return torch.cat([u_pre[:n], y_proj, tau[None]]), box_t

    def _scale_proposal(self, data: ProblemData, st: LoopState):
        """The adaptive-scale candidate (scs.c:1164-1241): (new_scale,
        sum_log, wanted), wanted the part of the update test that reads
        the device."""
        r = st.res
        denom_pri = torch.maximum(torch.maximum(r.nm_ax, r.nm_s),
                                  data.nm_b_orig * r.tau)
        rel_pri = torch.clamp_min(_safediv_pos(r.nm_ax_s_btau, denom_pri),
                                  config.DIV_EPS_TOL)
        denom_dual = torch.maximum(torch.maximum(r.nm_px, r.nm_aty),
                                   data.nm_c_orig * r.tau)
        rel_dual = torch.clamp_min(_safediv_pos(r.nm_px_aty_ctau,
                                                denom_dual),
                                   config.DIV_EPS_TOL)
        sum_log = (st.sum_log_scale_factor + torch.log(rel_pri)
                   - torch.log(rel_dual))
        n_log = st.n_log_scale_factor + 1.0
        factor = torch.sqrt(torch.exp(sum_log / n_log))
        new_scale = torch.clamp(st.scale * factor, config.MIN_SCALE_VALUE,
                                config.MAX_SCALE_VALUE)
        wanted = ((new_scale != st.scale)
                  & ((factor > math.sqrt(10.0))
                     | (factor < 1.0 / math.sqrt(10.0))))
        return new_scale, sum_log, wanted

    def _apply_scale(self, data: ProblemData, st: LoopState, new_scale):
        m, n = data.A.shape
        diag_r = set_diag_r(self.spec, n, m, new_scale, self.stg.rho_x,
                            st.v.dtype, st.v.device)
        derived = self.backend.derive(self.mats(data), diag_r, new_scale,
                                      mixed=self.mixed)
        g = self.update_work_cache(data, diag_r, derived)
        # remap v: R+ (v+ + u - 2u_t) = rsk  =>  v+ = R+^-1 rsk + 2u_t - u
        v = st.rsk / diag_r + 2.0 * st.u_t - st.u
        return dataclasses.replace(
            st, diag_r=diag_r, derived=derived, g=g, v=v, scale=new_scale,
            sum_log_scale_factor=torch.zeros_like(st.sum_log_scale_factor),
            n_log_scale_factor=0, last_scale_update_iter=st.iter,
            scale_updates=st.scale_updates + 1, aa=accel._reset(st.aa))

    def _aa(self, st: LoopState) -> LoopState:
        stg = self.stg
        a, v, aa_norm = accel.aa_apply(
            st.aa, st.v, st.v_prev, mem=self.mem,
            type1=stg.acceleration_type_1,
            regularization=stg.acceleration_regularization,
            relaxation=stg.acceleration_relaxation, gamma_f32=self.mixed)
        return dataclasses.replace(st, aa=a, v=v, aa_norm=aa_norm)

    def _guard(self, st: LoopState) -> LoopState:
        """AA safeguard, applied where AA took a step this iteration."""
        a, f_out, x_out, rejected = accel.aa_safeguard(st.aa, st.v,
                                                       st.v_prev)
        gate = st.aa_norm > 0
        a = accel._select(gate, a, st.aa)
        rej = gate & rejected
        return dataclasses.replace(
            st, aa=a, v=torch.where(gate, f_out, st.v),
            v_prev=torch.where(gate, x_out, st.v_prev),
            rejected_accel=st.rejected_accel + rej.to(torch.int64),
            accepted_accel=st.accepted_accel
            + (gate & ~rejected).to(torch.int64))

    def _pre(self, st: LoopState) -> LoopState:
        """Normalize v to L2 norm sqrt(l) (homogeneity; scs.c:813-821) and
        snapshot it for the AA safeguard."""
        v = st.v
        if st.iter >= config.FEASIBLE_ITERS:
            v = torch.where(_norm_2(v) > 0.0, renormalize_v(v), v)
        return dataclasses.replace(st, v=v, v_prev=v)

    def _post(self, data: ProblemData, st: LoopState) -> LoopState:
        """Residuals, the convergence check and the scale update on a
        checked step (a step that terminates stops here), then the dual
        update v += alpha (u - u_t) (scs.c:788-793)."""
        i = st.iter
        if i % config.CONVERGED_INTERVAL == 0:
            res = populate_residuals(data, self.spec, st.u, st.rsk, i,
                                     use_ds=self.mixed)
            st = dataclasses.replace(st, res=res)
            flags = [has_converged(res, data)]
            if self.stg.adaptive_scale:
                new_scale, sum_log, wanted = self._scale_proposal(data, st)
                flags.append(wanted)
            # the loop's one host read of the device
            read = torch.stack([f.to(torch.int64) for f in flags]).tolist()
            st = dataclasses.replace(st, status=read[0])
            if st.status != config.UNFINISHED:
                return st
            if self.stg.adaptive_scale:
                if (read[1] and i - st.last_scale_update_iter
                        >= config.RESCALING_MIN_ITERS):
                    st = self._apply_scale(data, st, new_scale)
                else:
                    st = dataclasses.replace(
                        st, sum_log_scale_factor=sum_log,
                        n_log_scale_factor=st.n_log_scale_factor + 1)
        return dataclasses.replace(st, v=st.v + data.alpha * (st.u - st.u_t),
                                   iter=i + 1)

    def step(self, data: ProblemData, st: LoopState,
             clock: Optional["PhaseClock"] = None) -> LoopState:
        """One ADMM iteration; checked when iter % CONVERGED_INTERVAL == 0.
        A checked step that terminates leaves iter and v as they were.
        `clock` times the linear-system, cone and Anderson phases of the
        step (`PhaseClock`); the step's arithmetic is the same with or
        without it."""
        timed = clock or _untimed
        i = st.iter
        st = dataclasses.replace(st, aa_norm=torch.zeros_like(st.aa_norm))
        aa_now = self.use_aa and i > 0 and i % self.stg.acceleration_interval == 0
        if aa_now:
            st = timed("accel_ms", self._aa, st)
        st = self._pre(st)
        u_t, cg_its = timed("lin_ms", self._project_lin_sys, data, st)
        u, box_t = timed("cone_ms", self._project_cones, data, st, u_t)
        # rsk = R (v + u - 2 u_t), before the dual update (scs.c:781-786)
        rsk = (st.v + u - 2.0 * u_t) * st.diag_r
        st = dataclasses.replace(st, u=u, u_t=u_t, rsk=rsk, box_t_warm=box_t,
                                 tot_cg_its=st.tot_cg_its + cg_its)
        st = self._post(data, st)
        if aa_now and st.status == config.UNFINISHED:
            st = timed("accel_ms", self._guard, st)
        return st

    def run(self, data: ProblemData, st: LoopState, iter_cap: int,
            clock: Optional["PhaseClock"] = None,
            tracer: Optional["Tracer"] = None):
        """Iterate until termination or iter_cap (the JAX make_loop).
        `clock` times the phases of every step; `tracer` records a trace
        row after every step."""
        while st.status == config.UNFINISHED and st.iter < iter_cap:
            st = self.step(data, st, clock)
            if tracer is not None:
                tracer.record(data, st)
        return st


def _untimed(key, fn, *args):
    return fn(*args)


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU, whose operators return when done)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseClock:
    """Measured per-phase timers (`Settings.profile_phases`; scs.c:1380-
    1393 wraps a timer around each phase call): the host clock around each
    linear-system, cone and Anderson phase of a step, with the device
    synchronized before and after the phase on the card (on the CPU the
    operators return when done), accumulated in milliseconds in `times`.
    The synchronizations cost a profiled solve time; its trajectory is the
    plain solve's (the JAX `make_instrumented_runner`)."""

    def __init__(self, device: torch.device):
        self.times = {"lin_ms": 0.0, "cone_ms": 0.0, "accel_ms": 0.0}
        self.device = device

    def __call__(self, key: str, fn, *args):
        synchronize(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        synchronize(self.device)
        self.times[key] += (time.perf_counter() - t0) * 1e3
        return out


# ---------------------------------------------------------------------------
# the per-iteration trace (log_data_to_csv, rw.c:707-861)

# The JAX package's column set (`scs_tpu/solver.py:1135-1160`): the
# original-space and the normalized-space residual families, iterate norms,
# objective terms, Anderson and scale diagnostics, and the KKT residuals of
# the first logdet cone's projection (rw.c:854-859; NaN without one).
TRACE_COLUMNS = (
    "iter", "res_pri", "res_dual", "gap",
    "x_nrm_inf", "y_nrm_inf", "s_nrm_inf",
    "x_nrm_2", "y_nrm_2", "s_nrm_2",
    "x_nrm_inf_normalized", "y_nrm_inf_normalized", "s_nrm_inf_normalized",
    "x_nrm_2_normalized", "y_nrm_2_normalized", "s_nrm_2_normalized",
    "ax_s_btau_nrm_inf", "px_aty_ctau_nrm_inf",
    "ax_s_btau_nrm_2", "px_aty_ctau_nrm_2",
    "res_infeas", "res_unbdd_a", "res_unbdd_p",
    "pobj", "dobj", "tau", "kap",
    "res_pri_normalized", "res_dual_normalized", "gap_normalized",
    "ax_s_btau_nrm_inf_normalized", "px_aty_ctau_nrm_inf_normalized",
    "ax_s_btau_nrm_2_normalized", "px_aty_ctau_nrm_2_normalized",
    "res_infeas_normalized", "res_unbdd_a_normalized",
    "res_unbdd_p_normalized", "pobj_normalized", "dobj_normalized",
    "tau_normalized", "kap_normalized",
    "ax_nrm_inf", "ax_s_nrm_inf", "px_nrm_inf", "aty_nrm_inf",
    "xt_p_x", "xt_p_x_tau", "ctx", "ctx_tau", "bty", "bty_tau",
    "b_nrm_inf", "c_nrm_inf", "scale",
    "diff_u_ut_nrm_2", "diff_v_v_prev_nrm_2",
    "diff_u_ut_nrm_inf", "diff_v_v_prev_nrm_inf",
    "aa_norm", "accepted_accel_steps", "rejected_accel_steps",
    "tot_cg_its", "scale_updates",
    "res_dual_spectral", "res_pri_spectral", "comp_spectral",
)
_SPECTRAL_COLUMNS = 3


def trace_row(data: ProblemData, spec: ConeSpec,
              st: LoopState) -> torch.Tensor:
    """The trace values of the current state but the spectral columns, as
    one (len(TRACE_COLUMNS) - 3,) tensor on the state's device (the JAX
    `trace_row`); no host read."""
    from .equilibrate import unnormalize_xys

    m, n = data.A.shape
    dtype, dev = st.u.dtype, st.u.device
    u, rsk = st.u, st.rsk
    x_n, y_n, s_n = u[:n], u[n:n + m], rsk[n:n + m]
    tau = torch.abs(u[n + m])
    kap = torch.abs(rsk[n + m])
    r = populate_residuals(data, spec, u, rsk, st.iter)

    # normalized-space quantities
    ax = data.A @ x_n
    ax_s = ax + s_n
    ax_s_btau = ax_s - tau * data.b
    if data.P is not None:
        px = data.P @ x_n
        xt_p_x_tau_nm = _dot(px, x_n)
    else:
        px = torch.zeros(n, dtype=dtype, device=dev)
        xt_p_x_tau_nm = torch.zeros((), dtype=dtype, device=dev)
    aty = data.A.T @ y_n
    px_aty_ctau = px + aty + tau * data.c
    bty_tau_nm = _dot(y_n, data.b)
    ctx_tau_nm = _dot(x_n, data.c)
    bty_nm = _safediv_pos(bty_tau_nm, tau)
    ctx_nm = _safediv_pos(ctx_tau_nm, tau)
    xpx_nm = _safediv_pos(xt_p_x_tau_nm, tau * tau)
    tol = config.INFEAS_NEGATIVITY_TOL
    res_unbdd_a_nm = torch.where(
        ctx_tau_nm < -tol, _safediv_pos(_norm_inf(ax_s), -ctx_tau_nm),
        math.nan)
    res_unbdd_p_nm = torch.where(
        ctx_tau_nm < -tol, _safediv_pos(_norm_inf(px), -ctx_tau_nm),
        math.nan)
    res_infeas_nm = torch.where(
        bty_tau_nm < -tol, _safediv_pos(_norm_inf(aty), -bty_tau_nm),
        math.nan)

    # original-space iterates
    x_o, y_o, s_o = unnormalize_xys(data.scal, x_n, y_n, s_n)
    tau_d = torch.clamp_min(tau, config.DIV_EPS_TOL)
    x_o, y_o, s_o = x_o / tau_d, y_o / tau_d, s_o / tau_d
    fac_m = 1.0 / (data.scal.D * data.scal.dual_scale)
    fac_n = 1.0 / (data.scal.E * data.scal.primal_scale)

    def host(v):
        return torch.full((), float(v), dtype=dtype, device=dev)

    vals = [
        host(st.iter), r.res_pri, r.res_dual, r.gap,
        _norm_inf(x_o), _norm_inf(y_o), _norm_inf(s_o),
        _norm_2(x_o), _norm_2(y_o), _norm_2(s_o),
        _norm_inf(x_n), _norm_inf(y_n), _norm_inf(s_n),
        _norm_2(x_n), _norm_2(y_n), _norm_2(s_n),
        r.nm_ax_s_btau, r.nm_px_aty_ctau,
        _norm_2(ax_s_btau * fac_m), _norm_2(px_aty_ctau * fac_n),
        r.res_infeas, r.res_unbdd_a, r.res_unbdd_p,
        r.pobj, r.dobj, r.tau, r.kap,
        _safediv_pos(_norm_inf(ax_s_btau), tau),
        _safediv_pos(_norm_inf(px_aty_ctau), tau),
        torch.abs(xpx_nm + ctx_nm + bty_nm),
        _norm_inf(ax_s_btau), _norm_inf(px_aty_ctau),
        _norm_2(ax_s_btau), _norm_2(px_aty_ctau),
        res_infeas_nm, res_unbdd_a_nm, res_unbdd_p_nm,
        xpx_nm / 2.0 + ctx_nm, -xpx_nm / 2.0 - bty_nm,
        tau, kap,
        r.nm_ax, _norm_inf(ax_s * fac_m), r.nm_px, r.nm_aty,
        r.xt_p_x, r.xt_p_x * (r.tau * r.tau), r.ctx, r.ctx_tau,
        r.bty, r.bty_tau,
        data.nm_b_orig, data.nm_c_orig, st.scale,
        _norm_2(st.u - st.u_t), _norm_2(st.v - st.v_prev),
        _norm_inf(st.u - st.u_t), _norm_inf(st.v - st.v_prev),
        st.aa_norm, st.accepted_accel, st.rejected_accel,
        st.tot_cg_its, host(st.scale_updates),
    ]
    return torch.stack([torch.as_tensor(v).to(dtype) for v in vals])


class Tracer:
    """Trace rows of the steps of one chunk, collected in preallocated
    device buffers; `take()` reads them to the host in one transfer (the
    JAX trace runner's ring buffer). With a logdet cone, each step also
    keeps the input and output segments of the first logdet cone's last
    projection (the inner projection's output is rsk_y, its input
    rsk_y - R_y u_y), and `take()` computes the three spectral columns of
    the chunk in one batched eigvalsh (`spectral.check_logdet_opt`)."""

    def __init__(self, spec: ConeSpec, capacity: int, dtype, device):
        self.spec = spec
        self.rows = torch.empty((capacity, len(TRACE_COLUMNS)
                                 - _SPECTRAL_COLUMNS), dtype=dtype,
                                device=device)
        self.count = 0
        self.segs = None
        if spec.d:
            from .cones.project import ConeLayout
            d0 = spec.d[0]
            off = ConeLayout.make(spec).d_off
            self._seg = slice(off, off + d0 * (d0 + 1) // 2 + 2)
            self.segs = torch.empty((capacity, 2, self._seg.stop - off),
                                    dtype=dtype, device=device)

    def record(self, data: ProblemData, st: LoopState) -> None:
        self.rows[self.count] = trace_row(data, self.spec, st)
        if self.segs is not None:
            m, n = data.A.shape
            rsk_y = st.rsk[n:n + m]
            seg_out = rsk_y[self._seg]
            seg_in = (rsk_y - st.diag_r[n:n + m] * st.u[n:n + m])[self._seg]
            self.segs[self.count] = torch.stack([seg_in, seg_out])
        self.count += 1

    def take(self):
        """The chunk's rows (count, len(TRACE_COLUMNS)) as a numpy array;
        the buffers are then empty again."""
        k, self.count = self.count, 0
        rows = self.rows[:k]
        if self.segs is None:
            spec_cols = torch.full((k, _SPECTRAL_COLUMNS), math.nan,
                                   dtype=rows.dtype, device=rows.device)
        else:
            from .cones import spectral
            from .cones.psd import svec_to_mat
            d0 = self.spec.d[0]
            seg = self.segs[:k] * spectral._SQRT2       # (k, 2, ln)
            w = torch.linalg.eigvalsh(svec_to_mat(seg[:, :, 2:], d0))
            spec_cols = torch.stack(spectral.check_logdet_opt(
                seg[:, 1, 0], seg[:, 1, 1], w[:, 1], seg[:, 0, 0],
                seg[:, 0, 1], w[:, 0]), dim=-1)
        return torch.cat([rows, spec_cols], dim=1).cpu().numpy()
