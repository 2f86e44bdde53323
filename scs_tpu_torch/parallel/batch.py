"""Batched solves: many problems of one shape, solved together on the card.

Counterpart of `scs_tpu/parallel/batch.py`. The JAX package writes one
problem's solve as a pure function and `vmap`s it; here every function
takes and returns a leading batch axis (B, ...), and the loop is the
lockstep Python loop of `solver_batched`:

  * `make_batch_solver` runs every lane to completion in one level;
  * `make_chunked_batch_solver` adds straggler compaction: the full batch
    runs until at most B/8 lanes are alive, then the survivors are
    gathered into a power-of-two bucket (padding rows masked by `valid`)
    and run on; rows are scattered back once, when they leave the work
    set;
  * `BatchWorkspace` sets a batch up once and re-solves it after b/c
    updates, cold or warm.

Mixed precision (the default on the card) solves in two phases, as the
JAX package does: a fast phase against targets floored at
MIXED_FAST_FLOOR, a repair of the lanes whose true targets lie below the
floor, and a polish phase on those lanes only, with float64 state. The
fast phase runs with float32 state (`Settings.fast_f32`, auto: on with
mixed) on a float32 view of the problem: A, K, b, c and the state cast to
float32, the double-single splits kept, so that its residual checks, and
the direct backend's solves, stay float64-accurate through kernels K2 and
K3; each backend converts its factor between the two regimes
(`enter_f32_state`, `leave_f32_state`). The state returns to float64 at
the phase's end. The exp and power cones project in float64 in every
phase unless `Settings.exp_f32=True` (`cones/project.py` says where this
leaves the reference). Where a mixed solve has exp or power cones, or
ran float32 state, every lane's dual block is re-projected in float64
at the finish (`solver.moreau_repolish`).

Every entry point solves on the card (`device="cuda"`) unless the caller
passes `device="cpu"`, and raises without a card. `ds_split=True` builds
the double-single operand splits on the CPU, where the mixed path then
runs the kernels' plain versions (a test's switch; on CUDA the splits are
always built, and ds_split=False raises there).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import config
from ..api import _not_ported, _resolve_device
from ..cones.box import scale_box_bounds
from ..cones.project import require_supported
from ..equilibrate import (equilibrate_batched, identity_scaling_batched,
                           normalize_b_c_batched, normalize_xys_batched,
                           unnormalize_xys_batched)
from ..linsys import (Mats, get_backend, prepare_operands_batched,
                      resolve_ds_split, resolve_fast_f32, resolve_mixed)
from ..solver import ProblemData, moreau_repolish
from ..solver_batched import (BatchedIteration, BatchedState, Rows,
                              fresh_state, pack_warm_v_batched,
                              populate_residuals_batched, put_rows,
                              set_diag_r_batched, take_rows, tree_map)
from ..types import ConeData, ConeSpec, Settings


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Solutions and diagnostics of a batch, each with a leading batch axis,
    on the solve's device."""

    x: torch.Tensor
    y: torch.Tensor
    s: torch.Tensor
    status: torch.Tensor        # int64 exit flags
    iters: torch.Tensor
    pobj: torch.Tensor
    dobj: torch.Tensor
    res_pri: torch.Tensor
    res_dual: torch.Tensor
    gap: torch.Tensor
    tau: torch.Tensor
    scale_updates: torch.Tensor
    tot_cg_its: torch.Tensor


def _check(spec: ConeSpec, stg: Settings) -> None:
    """Raise for what the batched solvers do not run (yet)."""
    get_backend(stg.linsys)
    _not_ported(stg)
    require_supported(spec)


def make_solver_parts(spec: ConeSpec, stg: Settings, *, device="cuda",
                      ds_split: Optional[bool] = None):
    """(init_fn, chunk_fn, final_fn), each on a leading batch axis.

    init_fn(A, P, b, c, bu=None, bl=None) -> (data, state): equilibrate,
        factor and cold-start every lane (scs_init per lane).
    chunk_fn(data, state, iter_cap) -> state: run until every lane has
        terminated or reached iter_cap.
    final_fn(data, state) -> SolveResult (branch-free per lane).

    chunk_fn runs the float64-state iteration; `f32_view` and
    `BatchedIteration(..., f32_state=True)` give the float32-state one.
    """
    return _parts(spec, stg, device, ds_split)[1:]


def _parts(spec: ConeSpec, stg: Settings, device, ds_split):
    """(iteration, init_fn, chunk_fn, final_fn) of make_solver_parts."""
    dev = _resolve_device(device)
    _check(spec, stg)
    mixed = resolve_mixed(stg, dev)
    ds = resolve_ds_split(ds_split, dev, mixed)
    it = BatchedIteration(spec, stg, mixed)
    backend = it.backend
    dtype = stg.dtype

    def init_fn(A, P, b, c, bu=None, bl=None):
        def put(t):
            return None if t is None else torch.as_tensor(
                t, dtype=dtype, device=dev)

        A, P, b, c = put(A), put(P), put(b), put(c)
        B, m, n = A.shape
        k = max(spec.bsize - 1, 0)
        bu = torch.zeros(B, k, dtype=dtype, device=dev) if bu is None \
            else put(bu)
        bl = torch.zeros(B, k, dtype=dtype, device=dev) if bl is None \
            else put(bl)
        if stg.normalize:
            A_n, P_n, scal = equilibrate_batched(A, P, spec)
            if spec.bsize > 1:
                box = slice(spec.z + spec.l, spec.z + spec.l + spec.bsize)
                bu, bl = scale_box_bounds(bu, bl, scal.D[:, box])
            b_n, c_n, scal = normalize_b_c_batched(scal, b, c)
        else:
            A_n, P_n = A, P
            scal = identity_scaling_batched(B, m, n, dtype, dev)
            b_n, c_n = b, c
        A32, P32, lin_cache = prepare_operands_batched(
            backend, A_n, P_n, spec.z, mixed, ds)
        data = ProblemData(
            A=A_n, P=P_n, b=b_n, c=c_n, b_orig=b, c_orig=c,
            nm_b_orig=torch.amax(torch.abs(b), dim=1),
            nm_c_orig=torch.amax(torch.abs(c), dim=1),
            scal=scal, cone=ConeData(bu=bu, bl=bl),
            eps_abs=float(stg.eps_abs), eps_rel=float(stg.eps_rel),
            eps_infeas=float(stg.eps_infeas), alpha=float(stg.alpha),
            lin_cache=lin_cache, A32=A32, P32=P32)
        scale = torch.full((B,), float(stg.scale), dtype=dtype, device=dev)
        diag_r = set_diag_r_batched(spec, n, m, scale, stg.rho_x)
        derived = it.derive(data, diag_r, scale)
        g = it.update_work_cache(data, diag_r, derived)
        v = torch.zeros(B, n + m + 1, dtype=dtype, device=dev)
        v[:, -1] = 1.0
        return data, fresh_state(v, diag_r, g, derived, scale, it.mem)

    def chunk_fn(data: ProblemData, st: BatchedState, iter_cap):
        return it.run(data, st, int(iter_cap))[0]

    def final_fn(data: ProblemData, st: BatchedState) -> SolveResult:
        m, n = data.A.shape[1:]
        r = populate_residuals_batched(data, spec, st.u, st.rsk, st.iter)
        x = st.u[:, :n]
        y = st.u[:, n:n + m]
        s_ = st.rsk[:, n:n + m]
        if stg.normalize:
            x, y, s_ = unnormalize_xys_batched(data.scal, x, y, s_)
        tau, kap = r.tau, r.kap
        status = st.status.to(dev)
        # resolve UNFINISHED into inaccurate statuses (set_unfinished)
        cert_like = (kap > tau) & ((r.bty_tau < 0) | (r.ctx_tau < 0))
        infeas_like = (r.bty_tau < 0) & (r.bty_tau < r.ctx_tau)
        unfinished = torch.where(
            cert_like,
            torch.where(infeas_like, config.INFEASIBLE_INACCURATE,
                        config.UNBOUNDED_INACCURATE),
            torch.where(tau > 0, config.SOLVED_INACCURATE, config.FAILED))
        status = torch.where(status == config.UNFINISHED, unfinished, status)
        is_solved = ((status == config.SOLVED)
                     | (status == config.SOLVED_INACCURATE))
        is_infeas = ((status == config.INFEASIBLE)
                     | (status == config.INFEASIBLE_INACCURATE))
        is_unbdd = ((status == config.UNBOUNDED)
                    | (status == config.UNBOUNDED_INACCURATE))
        inv_tau = torch.where(tau >= config.DIV_EPS_TOL, 1.0 / tau,
                              1.0 / config.DIV_EPS_TOL)[:, None]
        safe_bty = torch.where(r.bty_tau != 0, r.bty_tau, 1.0)[:, None]
        safe_ctx = torch.where(r.ctx_tau != 0, r.ctx_tau, 1.0)[:, None]
        nan = float("nan")
        sol, inf, unb = is_solved[:, None], is_infeas[:, None], is_unbdd[:, None]
        x_out = torch.where(sol, x * inv_tau,
                            torch.where(unb, x * (-1.0 / safe_ctx), nan))
        y_out = torch.where(sol, y * inv_tau,
                            torch.where(inf, y * (-1.0 / safe_bty), nan))
        s_out = torch.where(sol, s_ * inv_tau,
                            torch.where(unb, s_ * (-1.0 / safe_ctx), nan))
        pobj = torch.where(is_solved, r.xt_p_x / 2.0 + r.ctx,
                           torch.where(is_infeas, float("inf"),
                                       torch.where(is_unbdd, -float("inf"),
                                                   nan)))
        dobj = torch.where(is_solved, -r.xt_p_x / 2.0 - r.bty,
                           torch.where(is_infeas, float("inf"),
                                       torch.where(is_unbdd, -float("inf"),
                                                   nan)))
        return SolveResult(
            x=x_out, y=y_out, s=s_out, status=status,
            iters=st.iter.to(dev), pobj=pobj, dobj=dobj,
            res_pri=r.res_pri, res_dual=r.res_dual, gap=r.gap, tau=tau,
            scale_updates=st.scale_updates.to(dev),
            tot_cg_its=st.tot_cg_its.to(dev))

    return it, init_fn, chunk_fn, final_fn


def _floored_data(data: ProblemData) -> ProblemData:
    """Fast-phase targets: tolerances floored at the mixed path's true-
    residual floor."""
    return dataclasses.replace(
        data, eps_abs=max(data.eps_abs, config.MIXED_FAST_FLOOR),
        eps_rel=max(data.eps_rel, config.MIXED_FAST_FLOOR),
        eps_infeas=max(data.eps_infeas, config.MIXED_CERT_FLOOR))


def f32_view(data: ProblemData, st: BatchedState, backend):
    """(data, state) of the float32-state phase: every float64 tensor cast
    to float32 (the double-single splits and the float32 shadows kept as
    they are), and the mixed factor in the structure that the backend's
    float32-state regime reads (`backend.enter_f32_state`: the direct
    backend adds the split of G)."""
    def demote(t):
        return t.to(torch.float32) if t.dtype == torch.float64 else t

    data32 = tree_map(demote, data)
    st32 = tree_map(demote, dataclasses.replace(st, derived=None))
    mats = Mats(data32.A, data32.P, data32.lin_cache, data32.A32,
                data32.P32)
    derived = backend.enter_f32_state(mats, st32.diag_r,
                                      tree_map(demote, st.derived))
    return data32, dataclasses.replace(st32, derived=derived)


def f64_state(st: BatchedState, backend) -> BatchedState:
    """The float32-state phase's state back in float64, its factor in the
    float64-state regime's structure (`backend.leave_f32_state`)."""
    def promote(t):
        return t.to(torch.float64) if t.dtype == torch.float32 else t

    st64 = tree_map(promote, dataclasses.replace(st, derived=None))
    return dataclasses.replace(st64,
                               derived=backend.leave_f32_state(st.derived))


def _polish_settings(stg: Settings) -> Settings:
    """Settings of the polish phase: the mixed linear solver kept, every
    cone in float64 (the JAX package's `_polish_settings`)."""
    return dataclasses.replace(stg, mixed_precision=True, cone_f32=False,
                               exp_f32=None)


def _needs_polish(stg: Settings, status: torch.Tensor) -> torch.Tensor:
    """Host bool (B,): lanes whose fast-phase termination does not meet the
    caller's targets, which lie below the fast floors."""
    floor = config.MIXED_FAST_FLOOR
    needs = torch.zeros_like(status, dtype=torch.bool)
    if stg.eps_abs < floor or stg.eps_rel < floor:
        needs |= status == config.SOLVED
    if stg.eps_infeas < config.MIXED_CERT_FLOOR:
        needs |= ((status == config.INFEASIBLE)
                  | (status == config.UNBOUNDED))
    return needs


def make_repair_fn(spec: ConeSpec, stg: Settings, *, device="cuda"):
    """repair(data, state) -> state: the transition from the fast phase
    into the polish phase. The lanes whose targets lie below the fast
    floor get their factor and g re-derived and their status reset to
    UNFINISHED; every lane's cadence restarts at 0 (the polish phase's
    lockstep counter). `stg` is the caller's settings."""
    dev = _resolve_device(device)
    it = BatchedIteration(spec, _polish_settings(stg), True)

    def repair(data: ProblemData, st: BatchedState) -> BatchedState:
        needs = _needs_polish(stg, st.status)
        if bool(needs.any()):
            rows = Rows(torch.nonzero(needs).flatten(), dev)
            sub = take_rows(data, rows)
            diag_r, scale = take_rows((st.diag_r, st.scale), rows)
            derived = it.derive(sub, diag_r, scale)
            g = it.update_work_cache(sub, diag_r, derived)
            derived, g = put_rows((st.derived, st.g), (derived, g), rows)
            st = dataclasses.replace(st, derived=derived, g=g)
        return dataclasses.replace(
            st, status=torch.where(needs, config.UNFINISHED, st.status),
            cadence=torch.zeros_like(st.cadence))

    return repair


def make_update_fn(stg: Settings):
    """update_fn(data, b_new, c_new) -> data: swap b/c of every lane
    without re-equilibrating or re-factoring (scs_update, scs.c:1287-1325),
    re-normalizing through the cached D/E."""

    def update_fn(data: ProblemData, b_new, c_new) -> ProblemData:
        nm_b = torch.amax(torch.abs(b_new), dim=1)
        nm_c = torch.amax(torch.abs(c_new), dim=1)
        if stg.normalize:
            b_n, c_n, scal = normalize_b_c_batched(data.scal, b_new, c_new)
        else:
            b_n, c_n, scal = b_new, c_new, data.scal
        return dataclasses.replace(
            data, b=b_n, c=c_n, b_orig=b_new, c_orig=c_new,
            nm_b_orig=nm_b, nm_c_orig=nm_c, scal=scal)

    return update_fn


def make_restart_fn(spec: ConeSpec, stg: Settings, warm: bool, *,
                    device="cuda"):
    """restart(data, state, [x, y, s]) -> a fresh state per lane for a
    re-solve: each lane keeps its adapted diag_r and scale, its factor is
    re-derived and its g recomputed (needed after a b/c update). warm
    packs v from (x, y, s) with NaN scrubbing (warm_start_vars,
    scs.c:660-679); cold starts from e_l. iter restarts at 0."""
    dev = _resolve_device(device)
    it = BatchedIteration(spec, stg, resolve_mixed(stg, dev))

    def restart(data: ProblemData, st: BatchedState, *warm_xys):
        derived = it.derive(data, st.diag_r, st.scale)
        g = it.update_work_cache(data, st.diag_r, derived)
        B, l = st.u.shape
        dtype = st.u.dtype
        if warm:
            x, y, s = (torch.as_tensor(a, dtype=dtype, device=dev)
                       for a in warm_xys)
            if stg.normalize:
                x, y, s = normalize_xys_batched(data.scal, x, y, s)
            v = pack_warm_v_batched(x, y, s, st.diag_r, scrub_nan=True)
        else:
            v = torch.zeros(B, l, dtype=dtype, device=dev)
            v[:, -1] = 1.0
        return fresh_state(v, st.diag_r, g, derived, st.scale, it.mem)

    return restart


def _solve_args(has_P: bool, arrays):
    """(A, P, b, c, bu, bl) from the positional arguments of a batched
    solve: (A, [P], b, c, bu, bl)."""
    if has_P:
        return arrays
    A, b, c, bu, bl = arrays
    return A, None, b, c, bu, bl


def make_pure_solver(spec: ConeSpec, stg: Settings,
                     max_iters: Optional[int] = None, *, device="cuda",
                     ds_split: Optional[bool] = None):
    """solve_fn(A, P, b, c, bu, bl) -> SolveResult of ONE problem (no
    batch axis), built from the batched parts on a batch of one. The JAX
    package's callers vmap this function; here, solve a batch through
    `make_batch_solver` instead."""
    solve_b = make_batch_solver(spec, stg, max_iters, has_P=True,
                                device=device, ds_split=ds_split)

    def solve_fn(A, P, b, c, bu, bl) -> SolveResult:
        def one(t):
            return None if t is None else torch.as_tensor(t)[None]
        res = solve_b(one(A), one(P), one(b), one(c), one(bu), one(bl))
        return SolveResult(**{f.name: getattr(res, f.name)[0]
                              for f in dataclasses.fields(SolveResult)})

    return solve_fn


class _Machinery:
    """The level dispatch of the batched solvers (the JAX
    `_chunk_machinery`): phases, compaction, the time limit, SIGINT.

    `levels` records the last solve's levels as (phase, bucket, lanes
    alive at the end, lockstep steps, host seconds), and `polished` the
    number of lanes that entered the polish phase, for the caller to
    read."""

    def __init__(self, spec: ConeSpec, stg: Settings, device, ds_split,
                 compact: bool):
        self.spec, self.stg = spec, stg
        # the pure solve and a float64-state fast phase run this
        # iteration; the polish phase runs its own (`_polish_settings`:
        # every cone in float64)
        self.it, self.init_fn, _, self.final_fn = _parts(
            spec, stg, device, ds_split)
        self.it_polish = BatchedIteration(spec, _polish_settings(stg), True)
        self.mixed = self.it.mixed
        self.device = _resolve_device(device)
        self.f32_state = resolve_fast_f32(
            stg, self.mixed, resolve_ds_split(ds_split, self.device,
                                              self.mixed))
        self.it32 = (BatchedIteration(spec, stg, True, f32_state=True)
                     if self.f32_state else None)
        self.compact = compact
        self.repair = (make_repair_fn(spec, stg, device=device)
                       if self.mixed else None)
        self.levels: list[tuple] = []
        self.polished = 0

    def run_phase(self, phase: str, it: BatchedIteration, data,
                  st: BatchedState, cap: int, entry_alive=None,
                  deadline=None):
        """Level dispatch with straggler compaction. Returns (state,
        needs_full, stop): needs_full a host (B,) bool of lanes whose
        fast-phase status needs the polish phase; stop None, "timeout" or
        "sigint".

        entry_alive: host (B,) bool of the lanes active at phase entry
        (the polish phase: the lanes that need it), gathered into their
        own bucket before the first step."""
        stg = self.stg
        budget = 8 * max(stg.chunk_iters, config.CONVERGED_INTERVAL)
        B = st.status.shape[0]
        min_bucket = max(B // 8, 1) if self.compact else B
        act = np.arange(B)
        bucket = B
        data_c, st_c = data, st
        valid = torch.ones(B, dtype=torch.bool)

        def gather(rows_np, size):
            pad = np.concatenate([rows_np,
                                  np.repeat(rows_np[:1], size - rows_np.size)])
            rows = Rows(pad, self.device)
            return (take_rows(data, rows), take_rows(st, rows),
                    torch.as_tensor(np.arange(size) < rows_np.size))

        def settle(st_full):
            """Scatter the work set's rows back into the full state."""
            if bucket < B:
                return put_rows(st_full, take_rows(
                    st_c, Rows(np.arange(act.size), self.device)),
                    Rows(act, self.device))
            return st_c

        if entry_alive is not None:
            act0 = np.nonzero(entry_alive.numpy())[0]
            if act0.size == 0:
                return st, np.zeros(B, bool), None
            eb = max(1 << (int(act0.size) - 1).bit_length(), 8)
            if eb < B:
                min_bucket = min(min_bucket, eb)
                act, bucket = act0, eb
                data_c, st_c, valid = gather(act, bucket)

        while True:
            stop_alive = min_bucket if bucket > min_bucket else 0
            k_budget = budget if self.compact else None
            t0 = time.perf_counter()
            st_c, stop, steps = it.run(data_c, st_c, cap, stop_alive,
                                       k_budget, valid, deadline,
                                       interruptible=True)
            alive = it.alive(st_c, cap, valid)[:act.size].numpy()
            sub = np.nonzero(alive)[0]
            self.levels.append((phase, bucket, int(sub.size), steps,
                                time.perf_counter() - t0))
            if stop is not None or sub.size == 0:
                st = settle(st)
                return st, _needs_polish(stg, st.status).numpy(), stop
            new_bucket = max(1 << (int(sub.size) - 1).bit_length(),
                             min_bucket)
            if new_bucket < bucket:
                # compact: settle the rows leaving the work set, gather
                # the survivors into the smaller bucket
                if bucket >= B:
                    st = st_c
                else:
                    leave = np.setdiff1d(np.arange(act.size), sub)
                    if leave.size:
                        st = put_rows(st, take_rows(
                            st_c, Rows(leave, self.device)),
                            Rows(act[leave], self.device))
                act = act[sub]
                bucket = new_bucket
                data_c, st_c, valid = gather(act, bucket)

    def resolve_stop(self, st: BatchedState, stop: str) -> BatchedState:
        """The reference's stop semantics for lanes still running: SIGINT
        marks them interrupted; a timeout leaves them UNFINISHED (resolved
        to inaccurate statuses at finalize) and, under mixed precision,
        downgrades lanes that terminated only against the floored targets
        to their inaccurate variants."""
        status = st.status
        if stop == "sigint":
            status = torch.where(status == config.UNFINISHED,
                                 config.SIGINT, status)
        elif stop == "timeout" and self.mixed:
            needs = _needs_polish(self.stg, status)
            down = torch.full_like(status, config.UNFINISHED)
            down = torch.where(status == config.SOLVED,
                               config.SOLVED_INACCURATE, down)
            down = torch.where(status == config.INFEASIBLE,
                               config.INFEASIBLE_INACCURATE, down)
            down = torch.where(status == config.UNBOUNDED,
                               config.UNBOUNDED_INACCURATE, down)
            status = torch.where(needs, down, status)
        return dataclasses.replace(st, status=status)

    def solve_from(self, data, st: BatchedState, cap: int, deadline=None):
        """Run every phase from (data, state). Returns (SolveResult, final
        state); the final state carries each lane's adapted diag_r and
        scale for later re-solves."""
        self.levels = []
        self.polished = 0
        if not self.mixed:
            try:
                st, _, stop = self.run_phase("solve", self.it, data, st, cap,
                                             deadline=deadline)
            except KeyboardInterrupt:
                stop = "sigint"
            if stop:
                st = self.resolve_stop(st, stop)
            return self.final_fn(data, st), st
        if self.f32_state:
            fdata, fst = f32_view(_floored_data(data), st, self.it.backend)
        else:
            fdata, fst = _floored_data(data), st
        try:
            st, needs, stop = self.run_phase(
                "fast", self.it32 or self.it, fdata, fst, cap,
                deadline=deadline)
        except KeyboardInterrupt:
            st, stop = fst, "sigint"
        if self.f32_state:
            st = f64_state(st, self.it.backend)
        if stop:
            st = self.resolve_stop(st, stop)
            return self.finalize(data, st)
        if needs.any():
            self.polished = int(needs.sum())
            st = self.repair(data, st)
            try:
                st, _, stop = self.run_phase(
                    "polish", self.it_polish, data, st, cap,
                    entry_alive=torch.as_tensor(needs), deadline=deadline)
            except KeyboardInterrupt:
                stop = "sigint"
            if stop == "sigint":
                st = self.resolve_stop(st, stop)
        return self.finalize(data, st)

    def finalize(self, data, st: BatchedState):
        """(SolveResult, state) of a mixed solve; after a float32-state
        phase, or where the fast phase projected exp/power cones in
        float32, every lane's dual block is re-projected in float64 first
        (the JAX chunked solver's `_finalize`)."""
        spec = self.spec
        if self.f32_state or spec.ep or spec.ed or spec.p:
            st = moreau_repolish(data, spec, st)
        return self.final_fn(data, st), st


def _deadline(stg: Settings) -> Optional[float]:
    if stg.time_limit_secs and stg.time_limit_secs > 0:
        return time.perf_counter() + stg.time_limit_secs
    return None


class _BatchSolver:
    """solve(A, [P], b, c, bu, bl, max_iters=None) -> SolveResult."""

    def __init__(self, spec, stg, max_iters, has_P, device, ds_split,
                 compact):
        self.machinery = _Machinery(spec, stg, device, ds_split, compact)
        self.stg = stg
        self.max_iters = max_iters
        self.has_P = has_P

    @property
    def levels(self):
        return self.machinery.levels

    def __call__(self, *arrays, max_iters: Optional[int] = None):
        cap = self.max_iters if max_iters is None else max_iters
        cap = self.stg.max_iters if cap is None else cap
        deadline = _deadline(self.stg)
        data, st = self.machinery.init_fn(*_solve_args(self.has_P, arrays))
        return self.machinery.solve_from(data, st, int(cap),
                                         deadline=deadline)[0]


def make_batch_solver(spec: ConeSpec, stg: Settings,
                      max_iters: Optional[int] = None, has_P: bool = False,
                      *, device="cuda", ds_split: Optional[bool] = None):
    """Batched solve, every lane run to completion in one level (no
    compaction): fn(A (B, m, n), [P (B, n, n)], b (B, m), c (B, n),
    bu (B, k), bl (B, k)) -> SolveResult. Finished lanes freeze."""
    return _BatchSolver(spec, stg, max_iters, has_P, device, ds_split,
                        compact=False)


def make_chunked_batch_solver(spec: ConeSpec, stg: Settings,
                              has_P: bool = False, *, device="cuda",
                              ds_split: Optional[bool] = None):
    """Batched solve with level dispatch and straggler compaction (see
    `_Machinery.run_phase`): fn(A, [P], b, c, bu, bl, max_iters=None) ->
    SolveResult. For parametric sequences (update b/c, warm re-solve) use
    BatchWorkspace."""
    return _BatchSolver(spec, stg, None, has_P, device, ds_split,
                        compact=True)


class BatchWorkspace:
    """The batched `api.Workspace`: equilibrate and factor a batch once,
    then update b/c and re-solve, cold or warm, without paying setup again
    (scs_update + scs_solve(warm_start=1); scs.c:660-679, 1287-1325).

        ws = BatchWorkspace(spec, stg, A, P, b, c)     # on the card
        r0 = ws.solve()                   # cold
        ws.update(b=b_next)               # no re-equilibration/refactor
        r1 = ws.solve(warm_start=True)    # seeds each lane from r0
    """

    def __init__(self, spec: ConeSpec, stg: Settings, A, P, b, c,
                 bu=None, bl=None, *, device="cuda",
                 ds_split: Optional[bool] = None):
        self.spec, self.stg = spec, stg
        self.machinery = _Machinery(spec, stg, device, ds_split,
                                    compact=True)
        self._update = make_update_fn(stg)
        self._restart = {w: make_restart_fn(spec, stg, w, device=device)
                         for w in (False, True)}
        self.data, self._st = self.machinery.init_fn(A, P, b, c, bu, bl)
        # _fresh: _st is still the cold state whose g matches b/c
        self._fresh = True
        self.last_result: Optional[SolveResult] = None

    @property
    def levels(self):
        return self.machinery.levels

    def update(self, b=None, c=None) -> None:
        """Replace b and/or c of every lane ((B, m) / (B, n)); the
        equilibration and the factors are kept."""
        d = self.data
        dev, dtype = d.b.device, d.b.dtype
        b_new = d.b_orig if b is None else torch.as_tensor(
            b, dtype=dtype, device=dev)
        c_new = d.c_orig if c is None else torch.as_tensor(
            c, dtype=dtype, device=dev)
        self.data = self._update(d, b_new, c_new)
        self._fresh = False

    def solve(self, warm_start: bool = False,
              sol: Optional[SolveResult] = None,
              max_iters: Optional[int] = None) -> SolveResult:
        """Solve every lane. warm_start seeds each lane's v from `sol`
        (default: the previous result); NaN entries (failed or certificate
        lanes) are scrubbed to a cold seed."""
        cap = self.stg.max_iters if max_iters is None else max_iters
        src = sol if sol is not None else self.last_result
        if warm_start and src is not None:
            st = self._restart[True](self.data, self._st, src.x, src.y,
                                     src.s)
        elif self._fresh:
            st = self._st
        else:
            st = self._restart[False](self.data, self._st)
        self._fresh = False
        result, st_final = self.machinery.solve_from(
            self.data, st, int(cap), deadline=_deadline(self.stg))
        self._st = st_final     # each lane's adapted diag_r / scale
        self.last_result = result
        return result
