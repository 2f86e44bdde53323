"""Public API: the solver workspace and the one-shot solve.

Counterpart of `scs_tpu/api.py` (SCS's scs_init / scs_update / scs_solve,
include/scs.h:271-338). The workspace equilibrates and factors once on its
device, and `solve` runs the iteration in chunks of `chunk_iters`, checking
the time limit between chunks.

The device is a keyword of the entry points, not a setting: it defaults to
"cuda", and without a CUDA device the workspace raises rather than solving
on the CPU. The tests pass device="cpu".
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from . import accel, config
from .cones.box import scale_box_bounds
from .equilibrate import (equilibrate, identity_scaling, normalize_b_c,
                          normalize_xys, unnormalize_xys)
from .linsys import Mats, get_backend, prepare_operands, resolve_mixed
from .ops.sparse import is_sparse, sparse_to_csc
from .solver import (Iteration, LoopState, ProblemData, Residuals,
                     moreau_repolish, pack_warm_v, populate_residuals,
                     set_diag_r)
from .types import ConeData, ConeSpec, Info, Problem, Settings, Solution
from .validation import ValidationError, validate


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; scs_tpu_torch solves on the card "
            "unless device='cpu' is passed")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    return dev


def _not_ported(stg: Settings) -> None:
    """Raise for settings that ask for parts of the JAX package that this
    package does not have yet."""
    asked = {
        "verbose": (stg.verbose, 14),
        "log_csv_filename": (stg.log_csv_filename, 14),
        "write_data_filename": (stg.write_data_filename, 14),
        "profile_phases": (stg.profile_phases, 14),
        "psd_rank": (stg.psd_rank, 13),
    }
    for name, (val, item) in asked.items():
        if val:
            raise NotImplementedError(
                f"Settings.{name} is not ported yet (ROADMAP queue 1, "
                f"item {item})")


def _lam_min_host(P) -> float:
    """Smallest eigenvalue of a large sparse P by float64 ARPACK Lanczos on
    a host CSC copy (`scs_tpu/api.py:58-80`). Raises ImportError where
    scipy is missing, RuntimeError (ArpackError) where ARPACK fails."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    n = P.shape[0]
    colptr, rows, vals = sparse_to_csc(P)
    Ph = sp.csc_matrix((vals, rows, colptr), shape=(n, n))
    try:
        lam = spla.eigsh(Ph, k=1, which="SA", return_eigenvectors=False,
                         maxiter=10 * n, tol=1e-10)
    except spla.ArpackNoConvergence as e:
        if len(e.eigenvalues) == 0:
            raise
        lam = e.eigenvalues
    return float(np.min(lam))


def _lam_min_lobpcg(P) -> float:
    """Smallest eigenvalue of a sparse P by LOBPCG on P's device (the JAX
    package's fallback where ARPACK fails, `scs_tpu/api.py:300-315`: 8
    vectors from RandomState(0), 50 iterations). torch.lobpcg takes a
    tensor, so P goes in as a torch sparse COO tensor of its CSC
    triplets."""
    n = P.shape[0]
    colptr, rows, vals = sparse_to_csc(P)
    cols = np.repeat(np.arange(n), np.diff(colptr))
    Pt = torch.sparse_coo_tensor(
        torch.as_tensor(np.stack([rows, cols])), torch.as_tensor(vals),
        (n, n), check_invariants=True).to(P.device)
    X0 = torch.as_tensor(np.random.RandomState(0).randn(n, 8),
                         device=P.device)
    theta, _ = torch.lobpcg(Pt, X=X0, niter=50, largest=False)
    return float(theta.min())


class Workspace:
    """Reusable solver workspace (ScsWork analog).

        w = Workspace(problem, spec, cone_data, settings)   # on the card
        sol, info = w.solve()
        w.update(b=new_b)          # no re-equilibration / refactorization
        sol, info = w.solve(warm_start=True, sol=sol)

    `ds_split` forces the double-single operand splits on or off (None:
    on for the mixed path on CUDA); on the CPU the splits make the mixed
    path run the kernel's plain version.
    """

    def __init__(self, problem: Problem, spec: ConeSpec,
                 cone_data: Optional[ConeData] = None,
                 settings: Settings = Settings(), *, device="cuda",
                 ds_split: Optional[bool] = None):
        t0 = time.perf_counter()
        stg = settings
        dev = _resolve_device(device)
        _not_ported(stg)
        dtype = stg.dtype
        validate(problem, spec, cone_data, stg)
        self.spec = spec
        self.stg = stg
        self.device = dev
        self.backend = get_backend(stg.linsys)
        self._mixed = resolve_mixed(stg, dev)

        def put(t):
            if t is None:
                return None
            if is_sparse(t):
                return t.to(dev).astype(dtype)
            return torch.as_tensor(t, dtype=dtype, device=dev)

        A, P = put(problem.A), put(problem.P)
        m, n = A.shape
        self.m, self.n = m, n
        self.l = n + m + 1
        if cone_data is None:
            cone_data = ConeData.make(spec, dtype=dtype)
        cone_data = ConeData(bu=put(cone_data.bu), bl=put(cone_data.bl))

        if stg.normalize:
            A_n, P_n, scal = equilibrate(A, P, spec)
            if spec.bsize > 1:
                box = slice(spec.z + spec.l, spec.z + spec.l + spec.bsize)
                bu_s, bl_s = scale_box_bounds(cone_data.bu, cone_data.bl,
                                              scal.D[box])
                cone_data = ConeData(bu=bu_s, bl=bl_s)
        else:
            A_n, P_n = A, P
            scal = identity_scaling(m, n, dtype, dev)

        b_orig, c_orig = put(problem.b), put(problem.c)
        zero = torch.zeros((), dtype=dtype, device=dev)
        A32, P32, lin_cache = prepare_operands(self.backend, A_n, P_n,
                                               spec.z, self._mixed, ds_split)
        self.data = ProblemData(
            A=A_n, P=P_n, b=b_orig, c=c_orig,  # b/c replaced by update()
            b_orig=b_orig, c_orig=c_orig, nm_b_orig=zero, nm_c_orig=zero,
            scal=scal, cone=cone_data,
            eps_abs=float(stg.eps_abs), eps_rel=float(stg.eps_rel),
            eps_infeas=float(stg.eps_infeas), alpha=float(stg.alpha),
            lin_cache=lin_cache, A32=A32, P32=P32)
        self.update(problem.b, problem.c)

        self.scale = float(stg.scale)
        self.diag_r = set_diag_r(spec, n, m, self.scale, stg.rho_x, dtype,
                                 dev)
        self.derived = self.backend.derive(
            self._mats(), self.diag_r,
            torch.tensor(self.scale, dtype=dtype, device=dev),
            mixed=self._mixed)
        self._check_convexity()
        self._iteration = Iteration(spec, stg, self._mixed)
        # the polish phase of a mixed solve keeps the mixed linear solver
        # and projects every cone in float64 (the JAX package's
        # _polish_stg)
        self._polish_iteration = Iteration(spec, dataclasses.replace(
            stg, mixed_precision=True, cone_f32=False, exp_f32=None),
            True) if self._mixed else None
        # one float64 Moreau re-projection at the finish (the JAX
        # package's condition: mixed, with exp or power cones) restores
        # exactness where exp projected in float32 (Settings.exp_f32)
        self._repolish = self._mixed and bool(spec.ep or spec.ed or spec.p)
        # CG iterations of the last solve (indirect backend; the direct
        # backend counts its refinement passes)
        self.tot_cg_its = 0
        self.setup_time_ms = (time.perf_counter() - t0) * 1e3

    def _mats(self) -> Mats:
        d = self.data
        return Mats(d.A, d.P, d.lin_cache, d.A32, d.P32)

    def _check_convexity(self) -> None:
        """Setup-time non-convexity detection (the analog of the
        reference's factorization inertia checks): G = R_x + P +
        A'R_y^{-1}A is SPD iff P is PSD. Direct: a failed Cholesky (a
        non-finite factor) flags an indefinite P. Indirect: a nonpositive
        or non-finite Jacobi diagonal, and, since an indefinite P with a
        positive diagonal passes that test, the smallest eigenvalue of
        the normalized P (congruence keeps the inertia) from a float64
        eigvalsh on the solve's device, held to -1e-8 max(1, max|P|): the
        JAX package's exact (CPU) branch, on either device. A sparse P is
        densified for the eigvalsh up to n = 4096; beyond, its smallest
        eigenvalue comes from ARPACK on a host CSC copy (`_lam_min_host`,
        same tolerance), or, where ARPACK fails, from LOBPCG on the
        device, held to -2e-4 max(1, max|P|) as the JAX package's
        LOBPCG branch."""
        factor = (self.derived[0] if isinstance(self.derived, tuple)
                  else self.derived)
        if self.stg.linsys == "direct":
            bad = not bool(torch.isfinite(factor).all())
        else:
            bad = bool(((factor <= 0.0) | ~torch.isfinite(factor)).any())
            P = self.data.P
            if not bad and P is not None:
                tol = 1e-8
                if not is_sparse(P):
                    lam_min = float(torch.linalg.eigvalsh(
                        P.to(torch.float64)).min())
                elif P.shape[0] <= 4096:
                    lam_min = float(torch.linalg.eigvalsh(
                        P.todense().to(torch.float64)).min())
                else:
                    try:
                        lam_min = _lam_min_host(P)
                    except (ImportError, RuntimeError):   # ARPACK failed
                        lam_min, tol = _lam_min_lobpcg(P), 2e-4
                scale_ref = max(1.0, float(P.abs_max() if is_sparse(P)
                                           else P.abs().max()))
                bad = lam_min < -tol * scale_ref
        if bad:
            raise ValidationError(
                "non-convexity detected: the KKT Schur complement is not "
                "positive definite (P must be positive semidefinite)")

    # -- scs_update (scs.c:1287-1325) --
    def update(self, b=None, c=None) -> None:
        """Replace b and/or c without re-equilibrating or refactorizing."""
        dtype, dev = self.stg.dtype, self.device
        d = self.data
        b_orig = d.b_orig if b is None else torch.as_tensor(
            b, dtype=dtype, device=dev)
        c_orig = d.c_orig if c is None else torch.as_tensor(
            c, dtype=dtype, device=dev)
        nm_b = torch.amax(torch.abs(b_orig))
        nm_c = torch.amax(torch.abs(c_orig))
        if self.stg.normalize:
            b_n, c_n, scal = normalize_b_c(d.scal, b_orig, c_orig)
        else:
            b_n, c_n, scal = b_orig, c_orig, d.scal
        self.data = dataclasses.replace(
            d, b=b_n, c=c_n, b_orig=b_orig, c_orig=c_orig,
            nm_b_orig=nm_b, nm_c_orig=nm_c, scal=scal)

    def _init_state(self, warm_sol: Optional[Solution]) -> LoopState:
        stg = self.stg
        dtype, dev = stg.dtype, self.device
        l = self.l
        zero_l = torch.zeros(l, dtype=dtype, device=dev)

        if warm_sol is not None:
            x, y, s = (torch.as_tensor(t, dtype=dtype, device=dev)
                       for t in (warm_sol.x, warm_sol.y, warm_sol.s))
            if stg.normalize:
                x, y, s = normalize_xys(self.data.scal, x, y, s)
            v = pack_warm_v(x, y, s, self.diag_r, scrub_nan=True)
        else:
            v = zero_l.clone()
            v[l - 1] = 1.0

        g = self._iteration.update_work_cache(self.data, self.diag_r,
                                              self.derived)
        zf = torch.zeros((), dtype=dtype, device=dev)
        zi = torch.zeros((), dtype=torch.int64, device=dev)
        return LoopState(
            u=zero_l, u_t=zero_l, v=v, v_prev=v, rsk=zero_l,
            diag_r=self.diag_r, g=g, derived=self.derived,
            scale=torch.tensor(self.scale, dtype=dtype, device=dev),
            box_t_warm=torch.ones((), dtype=dtype, device=dev),
            res=Residuals.zeros(dtype, dev),
            sum_log_scale_factor=zf, n_log_scale_factor=0,
            last_scale_update_iter=0, scale_updates=0,
            status=config.UNFINISHED, iter=0,
            aa=accel.aa_init(l, self._iteration.mem, dtype, dev),
            aa_norm=zf, accepted_accel=zi, rejected_accel=zi,
            tot_cg_its=zi)

    # -- scs_solve (scs.c:1327-1484) --
    def solve(self, warm_start: bool = False,
              sol: Optional[Solution] = None,
              checkpoint_file: Optional[str] = None,
              checkpoint_every: int = 0,
              resume_from: Optional[str] = None) -> tuple[Solution, Info]:
        """Run the solve loop.

        Mixed precision solves in two phases, as the JAX package does: a
        fast phase against targets floored at MIXED_FAST_FLOOR (the mixed
        path's true-residual floor), then, where the user's targets lie
        below it, a polish phase from the same state against them."""
        if checkpoint_file or checkpoint_every or resume_from:
            raise NotImplementedError(
                "checkpoint/resume is not ported yet (ROADMAP queue 1, "
                "item 14)")
        stg = self.stg
        t0 = time.perf_counter()
        st = self._init_state(sol if (warm_start and sol is not None)
                              else None)
        time_limit_reached = False
        interrupted = False
        chunk = max(stg.chunk_iters, config.CONVERGED_INTERVAL)

        if self._mixed:
            data1 = dataclasses.replace(
                self.data,
                eps_abs=max(self.data.eps_abs, config.MIXED_FAST_FLOOR),
                eps_rel=max(self.data.eps_rel, config.MIXED_FAST_FLOOR),
                eps_infeas=max(self.data.eps_infeas,
                               config.MIXED_CERT_FLOOR))
            phases = [data1, self.data]
        else:
            phases = [self.data]

        iteration = self._iteration
        try:
            for phase_idx, data in enumerate(phases):
                if phase_idx > 0:
                    st, iteration = self._enter_polish_phase(st)
                    if iteration is None:
                        break
                while (st.status == config.UNFINISHED
                       and st.iter < stg.max_iters):
                    if stg.time_limit_secs and (
                            time.perf_counter() - t0) > stg.time_limit_secs:
                        time_limit_reached = True
                        break
                    cap = min(st.iter + chunk, stg.max_iters)
                    st = iteration.run(data, st, cap)
                if time_limit_reached:
                    break
        except KeyboardInterrupt:
            # scs_is_interrupted polling (src/ctrlc.c, scs.c:1400-1403)
            interrupted = True

        solution, info = self._finalize(st, time_limit_reached, interrupted)
        info.solve_time = (time.perf_counter() - t0) * 1e3
        info.setup_time = self.setup_time_ms
        # persist the adapted scale and factor for later warm solves
        self.scale = float(st.scale)
        self.diag_r = st.diag_r
        self.derived = st.derived
        self.tot_cg_its = int(st.tot_cg_its)
        return solution, info

    def _enter_polish_phase(self, st: LoopState):
        """Decide whether the polish phase must run after the fast phase
        and, if so, re-derive the factor and the g cache from the fast
        phase's state. The polish keeps the mixed linear solver, so the
        factor keeps its structure. Returns (state, the polish phase's
        Iteration, or None where no polish runs).

        As in the JAX package, a spec with PSD cones
        (`ConeSpec.f32_polish_cones`) always polishes a SOLVED or
        certificate status: the fast phase's float32 eigh can break exact
        complementarity by ~1e-3 scale on clustered spectra. Where that is
        the polish's only reason (SOLVED at targets at or above the fast
        floor), the JAX package runs its exp and power cones in float32
        (exp_f32=True); the port's polish projects every cone, exp
        included, in float64 (ROADMAP section 3, R4: float32 exp can fail
        SCS's gap test after the finishing re-projection)."""
        stg = self.stg
        floor = config.MIXED_FAST_FLOOR
        has_psd = self.spec.f32_polish_cones
        needs = False
        if st.iter < stg.max_iters:
            if st.status == config.SOLVED:
                needs = (stg.eps_abs < floor or stg.eps_rel < floor
                         or has_psd)
            elif st.status in (config.INFEASIBLE, config.UNBOUNDED):
                needs = (stg.eps_infeas < config.MIXED_CERT_FLOOR
                         or has_psd)
            elif st.status == config.UNFINISHED:
                needs = True
        if not needs:
            return st, None
        iteration = self._polish_iteration
        derived = self.backend.derive(self._mats(), st.diag_r, st.scale,
                                      mixed=True)
        g = iteration.update_work_cache(self.data, st.diag_r, derived)
        return dataclasses.replace(st, derived=derived, g=g,
                                   status=config.UNFINISHED), iteration

    def _finalize(self, st: LoopState, time_limit_reached: bool,
                  interrupted: bool = False) -> tuple[Solution, Info]:
        """Extract the solution or certificate (finalize, scs.c:847-966),
        after the finishing float64 re-projection where the fast phase
        projected exp/power cones in float32."""
        n, m = self.n, self.m
        if self._repolish and not interrupted:
            st = moreau_repolish(self.data, self.spec, st)
        r = populate_residuals(self.data, self.spec, st.u, st.rsk, st.iter)
        x = st.u[:n]
        y = st.u[n:n + m]
        s = st.rsk[n:n + m]
        if self.stg.normalize:
            x, y, s = unnormalize_xys(self.data.scal, x, y, s)
        x, y, s = (t.cpu().numpy() for t in (x, y, s))
        it = st.iter
        # one device-to-host transfer for every scalar
        names = [f.name for f in dataclasses.fields(Residuals)
                 if f.name != "last_iter"]
        scalars = [getattr(r, k) for k in names] + [
            st.scale, st.accepted_accel, st.rejected_accel]
        vals = torch.stack([t.to(torch.float64) for t in scalars]).tolist()
        rf = dict(zip(names, vals))
        scale, accepted, rejected = vals[-3], int(vals[-2]), int(vals[-1])
        tau, kap = rf["tau"], rf["kap"]
        bty_tau, ctx_tau = rf["bty_tau"], rf["ctx_tau"]
        method = self.backend.METHOD_NAME

        status = st.status
        inaccurate_suffix = ""
        if interrupted and status == config.UNFINISHED:
            info = Info(iter=it, status="interrupted",
                        status_val=config.SIGINT,
                        scale_updates=st.scale_updates, scale=scale,
                        lin_sys_solver=method)
            return Solution(x=np.full_like(x, np.nan),
                            y=np.full_like(y, np.nan),
                            s=np.full_like(s, np.nan)), info
        if status == config.UNFINISHED:
            if kap > tau and (bty_tau < 0 or ctx_tau < 0):
                if bty_tau < 0 and bty_tau < ctx_tau:
                    status = config.INFEASIBLE_INACCURATE
                else:
                    status = config.UNBOUNDED_INACCURATE
            elif tau > 0:
                status = config.SOLVED_INACCURATE
            else:
                status = config.FAILED
            if time_limit_reached:
                inaccurate_suffix = " (inaccurate - reached time_limit_secs)"
            else:
                inaccurate_suffix = " (inaccurate - reached max_iters)"

        info = Info(iter=it, status_val=status,
                    scale_updates=st.scale_updates, scale=scale,
                    res_infeas=rf["res_infeas"],
                    res_unbdd_a=rf["res_unbdd_a"],
                    res_unbdd_p=rf["res_unbdd_p"],
                    rejected_accel_steps=rejected,
                    accepted_accel_steps=accepted,
                    lin_sys_solver=method)
        info.comp_slack = float(abs(np.dot(s, y)))

        def safediv(v):
            return (v / tau if tau >= config.DIV_EPS_TOL
                    else v / config.DIV_EPS_TOL)

        if status in (config.SOLVED, config.SOLVED_INACCURATE):
            x, y, s = safediv(x), safediv(y), safediv(s)
            info.gap = rf["gap"]
            info.res_pri = rf["res_pri"]
            info.res_dual = rf["res_dual"]
            info.pobj = rf["xt_p_x"] / 2.0 + rf["ctx"]
            info.dobj = -rf["xt_p_x"] / 2.0 - rf["bty"]
            base = "solved"
        elif status in (config.INFEASIBLE, config.INFEASIBLE_INACCURATE):
            y = y * (-1.0 / bty_tau)
            x = np.full_like(x, np.nan)
            s = np.full_like(s, np.nan)
            info.pobj = np.inf
            info.dobj = np.inf
            base = "infeasible"
        elif status in (config.UNBOUNDED, config.UNBOUNDED_INACCURATE):
            x = x * (-1.0 / ctx_tau)
            s = s * (-1.0 / ctx_tau)
            y = np.full_like(y, np.nan)
            info.pobj = -np.inf
            info.dobj = -np.inf
            base = "unbounded"
        else:
            base = "failure"
        info.status = base + inaccurate_suffix
        info.status_val = status
        return Solution(x=x, y=y, s=s), info


def solve(problem: Problem, spec: ConeSpec,
          cone_data: Optional[ConeData] = None,
          settings: Settings = Settings(),
          warm_sol: Optional[Solution] = None, *,
          device="cuda") -> tuple[Solution, Info]:
    """One-shot solve (scs() analog, scs.c:1538-1551)."""
    w = Workspace(problem, spec, cone_data, settings, device=device)
    return w.solve(warm_start=warm_sol is not None, sol=warm_sol)
