"""The ADMM iteration for a batch of problems of one shape.

Counterpart of the batched parts of `scs_tpu/solver.py`: the per-lane
freeze `_mask_lanes` (408-426), the iteration of `_build_iteration`
(434-741) with a leading batch axis, and `make_batched_loop` (886-1075).

Every vector of the state has a leading batch axis (B, l) and lives on the
solve's device; each lane keeps its own scale, factor, Anderson history,
residuals and status. The lanes step in lockstep: a host counter `k`
drives the cadences (Anderson acceleration when k > 0 and k %
acceleration_interval == 0, the residual check when k % 25 == 0), while
each lane's own `iter` drives FEASIBLE_ITERS, RESCALING_MIN_ITERS and the
iteration cap. A lane is alive while its status is UNFINISHED, its
iteration count is below the cap and it is not a padding row; the rows of
the other lanes are kept as they were (the freeze).

The per-lane counters (iter, status, cadence, last_scale_update_iter,
scale_updates) are int64 tensors on the host: they change only in ways
the host knows (lanes that step, statuses read at a check), so the loop
always knows which lanes are alive without asking the device. The CG
iteration counts (tot_cg_its) stay on the device, where the indirect
backend counts them. The loop reads the device once per check step:
every lane's new status and its adaptive-scale wish, in one transfer (the
indirect backend's CG adds reads of its own, `linsys.indirect`). A lane
whose scale changes is re-factored alone (gather, derive, scatter).

With float32 state (the `fast_f32` phase of the batched solvers,
`BatchedIteration(f32_state=True)`) the same iteration runs on float32
tensors, its steering reductions (root_plus's dots, the iterate norm, the
objective dots of the check) in the accurate form of `ops.dsreduce`, and
its linear solve in the backend's float32-state regime. The flag is
explicit: the pure float32 mode keeps plain reductions.

With the indirect backend every lane's CG is warm-started from its own
u[:n] + tau g[:n] and stops at its own tolerance (the JAX package's
vmapped `project_lin_sys`); the lanes that do not step this time
(finished, or padding rows of a bucket) take no CG iteration, since their
rows are restored anyway.

The JAX loop is a compiled `while_loop` whose body is either one unrolled
macro of lcm(acceleration_interval, 25) steps or a per-step conditional
(`Settings.macro_schedule`); both give the same trajectory. This loop is
Python, so the setting has no effect here. A level run stops for
compaction or its step budget only at multiples of that macro from its
first step, so the lanes still running keep equal cadences.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Optional

import torch

from . import accel, config
from .cones.project import proj_dual_cone_batched
from .linsys import Mats, get_backend
from .linsys.matvec import bmv
from .ops import dsmatvec, dsreduce
from .solver import ProblemData, Residuals, _safediv_pos
from .types import ConeSpec, Settings


@dataclasses.dataclass(frozen=True)
class BatchedState:
    """The loop state of B lanes. Device tensors: u, u_t, v, v_prev, rsk,
    diag_r (B, l); g (B, l - 1); derived (the batch's factors); scale,
    box_t_warm, sum_log_scale_factor, n_log_scale_factor, aa_norm (B,)
    float; res
    (Residuals of (B,) tensors); aa (batched AAState); accepted_accel,
    rejected_accel, tot_cg_its (B,) int64. Host int64 tensors (B,): iter,
    status, cadence, last_scale_update_iter, scale_updates."""

    u: torch.Tensor
    u_t: torch.Tensor
    v: torch.Tensor
    v_prev: torch.Tensor
    rsk: torch.Tensor
    diag_r: torch.Tensor
    g: torch.Tensor
    derived: Any
    scale: torch.Tensor
    box_t_warm: torch.Tensor
    res: Residuals
    sum_log_scale_factor: torch.Tensor
    n_log_scale_factor: torch.Tensor
    aa: accel.AAState
    aa_norm: torch.Tensor
    accepted_accel: torch.Tensor
    rejected_accel: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    cadence: torch.Tensor
    last_scale_update_iter: torch.Tensor
    scale_updates: torch.Tensor
    tot_cg_its: torch.Tensor


# ---- walking the nested state (dataclasses, named tuples, tuples) ----

def tree_map(fn, obj, *rest):
    """fn over the tensors of obj (and of rest, same structure); None,
    numbers and strings pass through."""
    if isinstance(obj, torch.Tensor):
        return fn(obj, *rest)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name),
                             *[getattr(r, f.name) for r in rest])
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        vals = [tree_map(fn, *xs) for xs in zip(obj, *rest)]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    return obj


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device`, copied without waiting for the device."""
    return t.to(device, non_blocking=True)


class Rows:
    """A row index on the host and on the solve's device."""

    def __init__(self, idx, device):
        self.host = torch.as_tensor(idx, dtype=torch.int64)
        self.dev = to_device(self.host, device)

    def of(self, t: torch.Tensor) -> torch.Tensor:
        return self.host if t.device.type == "cpu" else self.dev


def take_rows(obj, rows: Rows):
    """The rows `rows` of every tensor in obj (a gather: new tensors)."""
    return tree_map(lambda t: t.index_select(0, rows.of(t)), obj)


def put_rows(full, sub, into: Rows):
    """full with its rows `into` replaced by sub's rows (new tensors)."""
    return tree_map(lambda f, s: f.index_copy(0, into.of(f), s), full, sub)


def mask_lanes(new, old, act: torch.Tensor, act_dev: torch.Tensor):
    """Per-lane freeze (the JAX `_mask_lanes`): old's rows where act is
    False. Tensors that the step did not replace are kept as they are."""
    def sel(n, o):
        if n is o:
            return o
        return accel.bwhere(act if n.device.type == "cpu" else act_dev, n, o)
    return tree_map(sel, new, old)


# ---- batched counterparts of the one-problem helpers ----

def _plain_dot(x, y):
    return torch.sum(x * y, dim=-1)


def _norm_inf(x):
    return torch.amax(torch.abs(x), dim=-1)


def set_diag_r_batched(spec: ConeSpec, n: int, m: int, scale, rho_x):
    """`set_diag_r` for scale (B,): (B, n + m + 1)."""
    B = scale.shape[0]
    rows = torch.arange(m, device=scale.device)
    s = scale[:, None]
    r_y = torch.where(rows < spec.z, 1.0 / (1000.0 * s), 1.0 / s)
    return torch.cat([
        torch.full((B, n), rho_x, dtype=scale.dtype, device=scale.device),
        r_y,
        torch.full((B, 1), config.TAU_FACTOR, dtype=scale.dtype,
                   device=scale.device),
    ], dim=1)


def pack_warm_v_batched(x, y, s, diag_r, scrub_nan: bool = False):
    """`pack_warm_v` for rows: v = [x; y + s/R_y; 1] (B, l)."""
    n, m = x.shape[1], y.shape[1]
    vy = y + s / diag_r[:, n:n + m]
    if scrub_nan:
        x = torch.nan_to_num(x, nan=0.0, posinf=math.inf, neginf=-math.inf)
        vy = torch.nan_to_num(vy, nan=0.0, posinf=math.inf,
                              neginf=-math.inf)
    one = torch.ones(x.shape[0], 1, dtype=x.dtype, device=x.device)
    return torch.cat([x, vy, one], dim=1)


def root_plus_batched(g, p, mu, eta, diag_r, nm: int, acc: bool = False):
    """`root_plus` per lane: g, p (B, nm), mu (B, >= nm), eta (B,). acc:
    the accurate float32 dots of the float32-state phase."""
    _dot = dsreduce.acc_dot if acc else _plain_dot
    r = diag_r[:, :nm]
    gs = g * r
    gg = _dot(gs, g)
    mug = _dot(mu[:, :nm], gs)
    pg = _dot(p[:, :nm], gs)
    ps = p[:, :nm] * r
    pp = _dot(ps, p[:, :nm])
    pmu = _dot(ps, mu[:, :nm])
    tau_scale = diag_r[:, nm]
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
    ds = getattr(data.lin_cache, "ds_bwd" if transpose else "ds_fwd", None)
    if ds is not None:
        return dsmatvec.ds_matvec_batched(ds, x)
    return bmv(data.A.transpose(1, 2) if transpose else data.A, x)


def populate_residuals_batched(data: ProblemData, spec: ConeSpec, u, rsk,
                               it: torch.Tensor, use_ds: bool = False,
                               acc: bool = False) -> Residuals:
    """`populate_residuals` per lane: every field of the result is (B,);
    last_iter is the host tensor `it`. use_ds routes A x and A' y through
    the batched double-single kernel (K2), reading x and y where they lie
    in u; acc takes the accurate float32 dots of the float32-state
    phase."""
    _dot = dsreduce.acc_dot if acc else _plain_dot
    m, n = data.A.shape[1:]
    x = u[:, :n]
    y = u[:, n:n + m]
    s = rsk[:, n:n + m]
    tau = torch.abs(u[:, n + m])
    kap = torch.abs(rsk[:, n + m])

    ax = _res_matvec(data, x, False) if use_ds else bmv(data.A, x)
    ax_s = ax + s
    ax_s_btau = ax_s - tau[:, None] * data.b
    if data.P is not None:
        px = bmv(data.P, x)
        xt_p_x_tau = _dot(px, x)
    else:
        px = torch.zeros_like(x)
        xt_p_x_tau = torch.zeros_like(tau)
    aty = (_res_matvec(data, y, True) if use_ds
           else bmv(data.A.transpose(1, 2), y))
    px_aty_ctau = px + aty + tau[:, None] * data.c
    bty_tau = _dot(y, data.b)
    ctx_tau = _dot(x, data.c)

    scal = data.scal
    pd = scal.primal_scale * scal.dual_scale
    fac_m = 1.0 / (scal.D * scal.dual_scale[:, None])
    fac_n = 1.0 / (scal.E * scal.primal_scale[:, None])
    ax_o = ax * fac_m
    ax_s_o = ax_s * fac_m
    ax_s_btau_o = ax_s_btau * fac_m
    px_o = px * fac_n
    aty_o = aty * fac_n
    px_aty_ctau_o = px_aty_ctau * fac_n
    s_o = s / (scal.D * scal.dual_scale[:, None])
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


def has_converged_batched(r: Residuals, data: ProblemData) -> torch.Tensor:
    """`has_converged` per lane: (B,) int64 exit flags."""
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


def residuals_zeros_batched(B: int, dtype, device) -> Residuals:
    z = torch.zeros(B, dtype=dtype, device=device)
    vals = {f.name: z for f in dataclasses.fields(Residuals)}
    vals.update(last_iter=torch.full((B,), -1, dtype=torch.int64),
                tau=z + 1.0)
    return Residuals(**vals)


def fresh_state(v, diag_r, g, derived, scale, mem: int) -> BatchedState:
    """A state at iteration 0 from the first v (B, l) (cold: e_l; warm:
    the packed solution)."""
    B, l = v.shape
    dtype, dev = v.dtype, v.device
    zero_l = torch.zeros(B, l, dtype=dtype, device=dev)
    zf = torch.zeros(B, dtype=dtype, device=dev)
    zi = torch.zeros(B, dtype=torch.int64, device=dev)
    zh = torch.zeros(B, dtype=torch.int64)
    return BatchedState(
        u=zero_l, u_t=zero_l, v=v, v_prev=v, rsk=zero_l, diag_r=diag_r,
        g=g, derived=derived, scale=scale,
        box_t_warm=torch.ones(B, dtype=dtype, device=dev),
        res=residuals_zeros_batched(B, dtype, dev),
        sum_log_scale_factor=zf, n_log_scale_factor=zf,
        aa=accel.aa_init_batched(B, l, mem, dtype, dev), aa_norm=zf,
        accepted_accel=zi, rejected_accel=zi,
        iter=zh, status=zh, cadence=zh, last_scale_update_iter=zh,
        scale_updates=zh, tot_cg_its=zi)


class BatchedIteration:
    """The ADMM iteration of B lanes for one cone layout and one set of
    settings: `substep` runs one lockstep step, `run` a level of steps
    (the JAX `make_batched_loop`). f32_state: the iteration of the
    float32-state phase (accurate reductions; see the module docstring)."""

    def __init__(self, spec: ConeSpec, stg: Settings, mixed: bool,
                 f32_state: bool = False):
        self.spec = spec
        self.stg = stg
        self.mixed = mixed
        self.f32_state = f32_state
        self.exp32 = bool(stg.exp_f32)      # as `solver.Iteration`
        self.backend = get_backend(stg.linsys)
        self.is_indirect = stg.linsys == "indirect"
        self.use_aa = stg.acceleration_lookback > 0
        self.mem = max(stg.acceleration_lookback, 1)
        self.interval = max(stg.acceleration_interval, 1)
        ci = config.CONVERGED_INTERVAL
        self.macro = (self.interval * ci // math.gcd(self.interval, ci)
                      if self.use_aa else ci)

    @staticmethod
    def mats(data: ProblemData) -> Mats:
        return Mats(data.A, data.P, data.lin_cache, data.A32, data.P32)

    def update_work_cache(self, data: ProblemData, diag_r, derived):
        """g = (I + M)^{-1} [c; -b] per lane (scs.c:1118-1128)."""
        h = torch.cat([data.c, -data.b], dim=1)
        g, _ = self.backend.solve_batched(self.mats(data), diag_r, derived,
                                          h, None, config.CG_BEST_TOL)
        return g

    @staticmethod
    def _cg_warm_tol(st: BatchedState, n: int):
        """Per-lane CG warm start u[:n] + tau g[:n] and tolerance: the JAX
        `project_lin_sys` (solver.py:462-485) per lane, from each lane's
        own residual norms and iteration count."""
        warm = st.u[:, :n] + st.u[:, -1:] * st.g[:, :n]
        tol = torch.minimum(st.res.nm_ax_s_btau_norm,
                            st.res.nm_px_aty_ctau_norm)
        growth = to_device((st.iter + 1).to(warm.dtype) ** config.CG_RATE,
                           warm.device)
        nm_ws = _norm_inf(warm) / growth
        tol = torch.clamp_min(
            config.CG_TOL_FACTOR * torch.minimum(tol, nm_ws),
            config.CG_BEST_TOL)
        return warm, tol

    def derive(self, data: ProblemData, diag_r, scale):
        return self.backend.derive_batched(self.mats(data), diag_r, scale,
                                           mixed=self.mixed)

    def _scale_proposal(self, data: ProblemData, st: BatchedState, res):
        """The adaptive-scale candidate per lane (scs.c:1164-1241):
        (new_scale, sum_log, n_log, wanted); wanted is the part of the
        update test that reads the device."""
        r = res
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
        return new_scale, sum_log, n_log, wanted

    def _apply_scale(self, data: ProblemData, st: BatchedState,
                     update: torch.Tensor, new_scale) -> BatchedState:
        """Re-factor the lanes in `update` (host bool) at their new scale:
        gather those lanes, derive, scatter; remap their v and reset their
        Anderson history."""
        m, n = data.A.shape[1:]
        rows = Rows(torch.nonzero(update).flatten(), st.v.device)
        sub = take_rows(data, rows)
        scale = new_scale.index_select(0, rows.dev)
        diag_r = set_diag_r_batched(self.spec, n, m, scale, self.stg.rho_x)
        derived = self.derive(sub, diag_r, scale)
        g = self.update_work_cache(sub, diag_r, derived)
        # remap v: R+ (v+ + u - 2u_t) = rsk  =>  v+ = R+^-1 rsk + 2u_t - u
        old = take_rows((st.rsk, st.u_t, st.u), rows)
        v = old[0] / diag_r + 2.0 * old[1] - old[2]
        full = put_rows((st.diag_r, st.derived, st.g, st.v, st.scale),
                        (diag_r, derived, g, v, scale), rows)
        up = update.to(torch.int64)
        return dataclasses.replace(
            st, diag_r=full[0], derived=full[1], g=full[2], v=full[3],
            scale=full[4],
            last_scale_update_iter=torch.where(
                update, st.iter, st.last_scale_update_iter),
            scale_updates=st.scale_updates + up,
            aa=accel.reset_lanes(to_device(update, st.v.device), st.aa))

    def substep(self, data: ProblemData, st: BatchedState, k: int,
                act: torch.Tensor, act_dev: torch.Tensor) -> BatchedState:
        """One lockstep step at phase counter k for the lanes in act (host
        bool (B,), act_dev its copy on the device); the other lanes keep
        their rows."""
        spec, stg = self.spec, self.stg
        m, n = data.A.shape[1:]
        l = n + m + 1
        dev = st.v.device
        old = st
        aa_due = self.use_aa and k > 0 and k % self.interval == 0
        check = k % config.CONVERGED_INTERVAL == 0

        # 1. Anderson acceleration
        if aa_due:
            a, v, aa_norm = accel.aa_apply_batched(
                st.aa, st.v, st.v_prev, mem=self.mem,
                type1=stg.acceleration_type_1,
                regularization=stg.acceleration_regularization,
                relaxation=stg.acceleration_relaxation,
                gamma_f32=self.mixed)
            st = dataclasses.replace(st, aa=a, v=v, aa_norm=aa_norm)

        # lanes whose tau is pinned to 1 (iter < FEASIBLE_ITERS)
        pin = st.iter < config.FEASIBLE_ITERS
        pin_dev = to_device(pin, dev) if bool(pin.any()) else None

        # 2. normalize v to L2 norm sqrt(l) (homogeneity; scs.c:813-821)
        v = st.v
        nrm = (dsreduce.acc_norm(v) if self.f32_state
               else torch.linalg.vector_norm(v, dim=1))
        scaled = v * (math.sqrt(l) * config.ITERATE_NORM
                      / torch.where(nrm > 0, nrm, 1.0))[:, None]
        renorm = nrm > 0.0
        if pin_dev is not None:
            renorm = renorm & ~pin_dev
        v = accel.bwhere(renorm, scaled, v)

        # 4. linear system projection (3. v_prev = v is set below)
        dr = st.diag_r
        rhs = torch.cat([v[:, :n] * dr[:, :n],
                         -v[:, n:l - 1] * dr[:, n:l - 1]], dim=1)
        warm, tol = (self._cg_warm_tol(st, n) if self.is_indirect
                     else (None, None))
        sol, its = self.backend.solve_batched(self.mats(data), dr,
                                              st.derived, rhs, warm, tol,
                                              act_dev)
        tau = root_plus_batched(st.g, sol, v, v[:, l - 1], dr, l - 1,
                                acc=self.f32_state)
        if pin_dev is not None:
            tau = torch.where(pin_dev, 1.0, tau)
        u_t = torch.cat([sol - tau[:, None] * st.g, tau[:, None]], dim=1)

        # 5. cone projection
        u_pre = 2.0 * u_t - v
        y_proj, box_t = proj_dual_cone_batched(
            u_pre[:, n:n + m], spec, data.cone, st.box_t_warm,
            dr[:, n:n + m], exp_f32=self.exp32)
        tau_c = torch.clamp_min(u_pre[:, l - 1], 0.0)
        if pin_dev is not None:
            tau_c = torch.where(pin_dev, 1.0, tau_c)
        u = torch.cat([u_pre[:, :n], y_proj, tau_c[:, None]], dim=1)

        # 6. rsk = R (v + u - 2 u_t), before the dual update
        rsk = (v + u - 2.0 * u_t) * dr
        st = dataclasses.replace(
            st, v=v, v_prev=v, u=u, u_t=u_t, rsk=rsk, box_t_warm=box_t,
            tot_cg_its=st.tot_cg_its + its * act_dev)

        proceed, proceed_dev = act, act_dev
        if check:
            # 7. residuals + convergence check, and the scale update
            res = populate_residuals_batched(data, spec, u, rsk, st.iter,
                                             use_ds=self.mixed,
                                             acc=self.f32_state)
            flags = [has_converged_batched(res, data)]
            if stg.adaptive_scale:
                new_scale, sum_log, n_log, wanted = self._scale_proposal(
                    data, st, res)
                flags.append(wanted)
            # the loop's one read of the device
            read = torch.stack([f.to(torch.int64) for f in flags]).cpu()
            status = torch.where(act, read[0], st.status)
            proceed = act & (status == config.UNFINISHED)
            if not torch.equal(proceed, act):
                proceed_dev = to_device(proceed, dev)
            st = dataclasses.replace(st, res=res, status=status)
            if stg.adaptive_scale:
                update = proceed & (read[1] != 0) & (
                    st.iter - st.last_scale_update_iter
                    >= config.RESCALING_MIN_ITERS)
                keep = proceed_dev
                if bool(update.any()):
                    keep = proceed_dev & ~to_device(update, dev)
                zf = torch.zeros_like(sum_log)
                st = dataclasses.replace(
                    st, sum_log_scale_factor=torch.where(
                        keep, sum_log,
                        torch.where(proceed_dev, zf, st.sum_log_scale_factor)),
                    n_log_scale_factor=torch.where(
                        keep, n_log,
                        torch.where(proceed_dev, zf, st.n_log_scale_factor)))
                if bool(update.any()):
                    st = self._apply_scale(data, st, update, new_scale)

        # 8. dual update: v += alpha (u - u_t), lanes that go on
        v_new = st.v + data.alpha * (st.u - st.u_t)
        if proceed is not act:
            v_new = accel.bwhere(proceed_dev, v_new, st.v)
        inc = proceed.to(torch.int64)
        st = dataclasses.replace(st, v=v_new, iter=st.iter + inc,
                                 cadence=st.cadence + inc)

        # 9. AA safeguard where AA took a step and the lane goes on
        if aa_due:
            a, f_out, x_out, rejected = accel.aa_safeguard_batched(
                st.aa, st.v, st.v_prev)
            gate = (st.aa_norm > 0) & proceed_dev
            st = dataclasses.replace(
                st, aa=accel.select_lanes(gate, a, st.aa),
                v=accel.bwhere(gate, f_out, st.v),
                v_prev=accel.bwhere(gate, x_out, st.v_prev),
                rejected_accel=st.rejected_accel
                + (gate & rejected).to(torch.int64),
                accepted_accel=st.accepted_accel
                + (gate & ~rejected).to(torch.int64))

        if bool(act.all()):
            return st
        return mask_lanes(st, old, act, act_dev)

    def alive(self, st: BatchedState, iter_cap: int,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        a = (st.status == config.UNFINISHED) & (st.iter < iter_cap)
        return a if valid is None else a & valid

    def run(self, data: ProblemData, st: BatchedState, iter_cap: int,
            stop_alive: int = 0, k_budget: Optional[int] = None,
            valid: Optional[torch.Tensor] = None,
            deadline: Optional[float] = None,
            interruptible: bool = False):
        """One level: step the alive lanes until none is left, or, at a
        macro boundary, until at most `stop_alive` are, `k_budget` steps
        have run or time.perf_counter() has passed `deadline`.

        valid: host bool (B,), False for padding rows. Returns (state,
        stop, steps) with stop None, "timeout", or, when `interruptible`,
        "sigint" on a KeyboardInterrupt (the state is then the last whole
        step's), and steps the number of lockstep steps run.
        """
        alive = self.alive(st, iter_cap, valid)
        k0 = int(st.cadence[alive].max()) if bool(alive.any()) else 0
        k = k0
        prev, act_dev = None, None
        try:
            while True:
                alive = self.alive(st, iter_cap, valid)
                n_alive = int(alive.sum())
                if n_alive == 0:
                    return st, None, k - k0
                if (k - k0) % self.macro == 0:
                    if n_alive <= stop_alive:
                        return st, None, k - k0
                    if k_budget is not None and k - k0 >= k_budget:
                        return st, None, k - k0
                    if deadline is not None and (time.perf_counter()
                                                 >= deadline):
                        return st, "timeout", k - k0
                if prev is None or not torch.equal(alive, prev):
                    prev, act_dev = alive, to_device(alive, st.v.device)
                st = self.substep(data, st, k, alive, act_dev)
                k += 1
        except KeyboardInterrupt:
            if not interruptible:
                raise
            return st, "sigint", k - k0
