"""Public API: the solver workspace and the one-shot solve.

Counterpart of `scs_tpu/api.py` (SCS's scs_init / scs_update / scs_solve,
include/scs.h:271-338). The workspace equilibrates and factors once on its
device, and `solve` runs the iteration in chunks of `chunk_iters`, checking
the time limit between chunks.

The device is a keyword of the entry points, not a setting: it defaults to
"cuda", and without a CUDA device the workspace raises rather than solving
on the CPU. The tests pass device="cpu".

Beside the solve, as in the JAX package: the reference's verbose log
(`Settings.verbose`), the per-iteration CSV trace (`log_csv_filename`),
measured phase timers (`profile_phases`), the problem written to a file
at setup (`write_data_filename`), and checkpoint/resume of a solve in
progress (`Workspace.solve(checkpoint_file=..., resume_from=...)`).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from . import accel, config
from .cones.box import scale_box_bounds
from .cones.project import proj_dual_cone
from .equilibrate import (equilibrate, identity_scaling, normalize_b_c,
                          normalize_xys, unnormalize_xys)
from .linsys import Mats, get_backend, prepare_operands, resolve_mixed
from .ops.rowshard import is_row_sharded
from .ops.sparse import is_sparse, sparse_to_csc
from .solver import (TRACE_COLUMNS, Iteration, LoopState, PhaseClock,
                     ProblemData, Residuals, Tracer, moreau_repolish,
                     pack_warm_v, populate_residuals, set_diag_r,
                     synchronize)
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


class _CsvTrace:
    """The per-iteration CSV trace (log_data_to_csv, rw.c:707-861; the
    JAX package's `_CsvTrace`): the columns of `solver.TRACE_COLUMNS` and
    `time`, the chunk's end on the host clock, shared by its rows. Values
    are written with repr(float). The solver's `Tracer` collects a chunk's
    rows on the device and the host reads them once per chunk. A check
    step that terminates leaves iter as it was, so its row shares its
    iter with the row before; the later row wins, and a row is written
    once a later iter arrives, or at close."""

    COLUMNS = ",".join(TRACE_COLUMNS) + ",time"

    def __init__(self, filename: str):
        self._f = open(filename, "w")
        self._f.write(self.COLUMNS + "\n")
        self._pending = None      # (iter, row, elapsed_s)

    def _flush(self) -> None:
        if self._pending is not None:
            _, row, elapsed_s = self._pending
            self._f.write(",".join(repr(float(v)) for v in row)
                          + f",{elapsed_s!r}\n")
            self._pending = None

    def write_rows(self, rows: np.ndarray, elapsed_s: float) -> None:
        for row in rows:
            it = int(row[0])
            if self._pending is not None and it > self._pending[0]:
                self._flush()
            self._pending = (it, row, elapsed_s)

    def close(self) -> None:
        self._flush()
        self._f.close()


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
        dtype = stg.dtype
        if is_row_sharded(problem.A):
            raise TypeError(
                "a row-sharded A (ops.rowshard.RowShardedA) solves through "
                "scs_tpu_torch.parallel's make_pure_solver, "
                "make_batch_solver or make_chunked_batch_solver")
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
        orig_cone = cone_data

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
        self._phase_ms = None
        if stg.write_data_filename:
            # the original (unnormalized) data; a sparse operand streams
            # its CSC triplets through the writer at O(nnz)
            from .io import write_scs_data
            write_scs_data(stg.write_data_filename,
                           Problem(A=A, b=b_orig, c=c_orig, P=P), spec,
                           orig_cone, stg)
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
        JAX package's exact (CPU) branch, on either device, for a dense P
        of any size: above n = 4096 the JAX package probes by ARPACK on a
        host copy (`scs_tpu/api.py:283-306`), which the card's eigvalsh
        beats end to end (`tools/torch_convexity_probe.py`; PERF.md,
        ROADMAP section 3). A sparse P is densified for the eigvalsh up to
        n = 4096; beyond, its smallest eigenvalue comes from ARPACK on a
        host CSC copy (`_lam_min_host`, same tolerance), or, where ARPACK
        fails, from LOBPCG on the device, held to -2e-4 max(1, max|P|) as
        the JAX package's LOBPCG branch."""
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
        below it, a polish phase from the same state against them.

        checkpoint_file / checkpoint_every write the whole solver state
        (`io.save_state`) every `checkpoint_every` iterations, rounded up
        to a chunk's end, with the phase it was taken in; resume_from
        restores such a checkpoint and continues in that phase, so a
        resumed solve ends on the same iteration count and the same bits
        as the uninterrupted one on the same device (capability beyond
        the reference, for preemptible machines)."""
        stg = self.stg
        t0 = time.perf_counter()
        st = self._init_state(sol if (warm_start and sol is not None)
                              else None)
        first_phase = 0
        if resume_from is not None:
            from .io import load_state
            st, first_phase = load_state(resume_from, st)
        if stg.verbose:
            self._print_header()
        csv = tracer = None
        if stg.log_csv_filename:
            csv = _CsvTrace(stg.log_csv_filename)
            tracer = Tracer(self.spec, config.CONVERGED_INTERVAL,
                            stg.dtype, self.device)
        clock = PhaseClock(self.device) if stg.profile_phases else None

        time_limit_reached = False
        interrupted = False
        chunk = max(stg.chunk_iters, config.CONVERGED_INTERVAL)
        if stg.verbose:
            chunk = min(chunk, config.PRINT_INTERVAL)
        if csv is not None:
            chunk = config.CONVERGED_INTERVAL
        if checkpoint_file and checkpoint_every > 0:
            chunk = min(chunk, max(checkpoint_every,
                                   config.CONVERGED_INTERVAL))
        next_ckpt = checkpoint_every if checkpoint_every > 0 else None

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
                if phase_idx < first_phase:
                    continue
                if phase_idx > first_phase:
                    st, iteration = self._enter_polish_phase(st)
                    if iteration is None:
                        break
                elif phase_idx > 0:     # resumed inside the polish phase
                    iteration = self._polish_iteration
                while (st.status == config.UNFINISHED
                       and st.iter < stg.max_iters):
                    if stg.time_limit_secs and (
                            time.perf_counter() - t0) > stg.time_limit_secs:
                        time_limit_reached = True
                        break
                    cap = min(st.iter + chunk, stg.max_iters)
                    st = iteration.run(data, st, cap, clock, tracer)
                    if csv is not None:
                        # the chunk's one read of its trace rows
                        csv.write_rows(tracer.take(),
                                       time.perf_counter() - t0)
                    if (checkpoint_file and next_ckpt is not None
                            and cap >= next_ckpt):
                        from .io import save_state
                        save_state(checkpoint_file, st, phase_idx)
                        next_ckpt = cap + checkpoint_every
                    if stg.verbose:
                        self._print_progress(st, time.perf_counter() - t0)
                if time_limit_reached:
                    break
        except KeyboardInterrupt:
            # scs_is_interrupted polling (src/ctrlc.c, scs.c:1400-1403)
            interrupted = True
        finally:
            if csv is not None:
                csv.close()

        solution, info = self._finalize(st, time_limit_reached, interrupted)
        info.solve_time = (time.perf_counter() - t0) * 1e3
        info.setup_time = self.setup_time_ms
        if stg.profile_phases:
            self._fill_timers(info, clock)
        # persist the adapted scale and factor for later warm solves
        self.scale = float(st.scale)
        self.diag_r = st.diag_r
        self.derived = st.derived
        self.tot_cg_its = int(st.tot_cg_its)
        if stg.verbose:
            self._print_footer(info)
        return solution, info

    def _fill_timers(self, info: Info, clock: PhaseClock) -> None:
        """Info's phase timers (scs.h:230-243), measured by the solve's
        PhaseClock, with or without the CSV trace. The matrix-cone and
        spectral vector-cone averages are per-call times of `profile`
        (the fused cone phase cannot split them)."""
        info.lin_sys_time = clock.times["lin_ms"]
        info.cone_time = clock.times["cone_ms"]
        info.accel_time = clock.times["accel_ms"]
        spec = self.spec
        if spec.s or spec.cs or spec.d or spec.nuc_m or spec.sl_n:
            if self._phase_ms is None:
                self._phase_ms = self.profile(n_calls=5)
            pm = self._phase_ms
            if "mat_cone_ms" in pm:
                info.ave_time_matrix_cone_proj = pm["mat_cone_ms"]
            if "vec_cone_ms" in pm:
                info.ave_time_vector_cone_proj = pm["vec_cone_ms"]

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

    def profile(self, n_calls: int = 20) -> dict:
        """Per-call costs of the phases SCS times (scs.h:230-236), each
        measured standalone on this problem's shapes: the linear-system
        solve, the cone projection and the Anderson apply, in ms per
        call (host clock over n_calls calls after a first one, the device
        synchronized before and after), plus the matrix and spectral
        vector cones' (`_profile_spectral`). The JAX package's
        `Workspace.profile`."""
        stg, dtype, dev = self.stg, self.stg.dtype, self.device
        n, m, l = self.n, self.m, self.l
        rng = np.random.RandomState(0)

        def rand(*shape):
            return torch.as_tensor(rng.randn(*shape), dtype=dtype,
                                   device=dev)

        rhs, vy, v = rand(n + m), rand(m), rand(l)
        it = self._iteration
        mats, r_y = self._mats(), self.diag_r[n:n + m]
        one = torch.ones((), dtype=dtype, device=dev)

        def clock(fn, *args):
            fn(*args)
            synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(n_calls):
                fn(*args)
            synchronize(dev)
            return (time.perf_counter() - t0) / n_calls * 1e3

        aa0 = accel.aa_init(l, it.mem, dtype, dev)
        out = {
            "lin_sys_time_ms": clock(
                lambda: self.backend.solve(mats, self.diag_r, self.derived,
                                           rhs, None, 1e-9)),
            "cone_time_ms": clock(
                lambda: proj_dual_cone(vy, self.spec, self.data.cone, one,
                                       r_y, exp_f32=it.exp32,
                                       psd_f32=it.psd32)),
            "accel_time_ms": clock(
                lambda: accel.aa_apply(
                    aa0, v, v, mem=it.mem, type1=stg.acceleration_type_1,
                    regularization=stg.acceleration_regularization,
                    relaxation=stg.acceleration_relaxation,
                    gamma_f32=self._mixed)),
        }
        out.update(self._profile_spectral(clock, rand))
        return out

    def _profile_spectral(self, clock, rand) -> dict:
        """SPECTRAL_TIMING (cones.c:1345-1489, scs.h:237-243): per-call ms
        of the matrix-cone projections (PSD, complex PSD, logdet,
        nuclear, sum-of-k-largest) and of the spectral vector-cone
        projections (the logarithmic cone's Newton, ell1, the sorted
        sum-of-k-largest), each run of equal cones timed standalone on
        its segment shapes (the JAX package's `_profile_spectral`)."""
        from .cones import psd as psd_mod
        from .cones import spectral as sp
        from .cones.project import _contiguous_runs

        spec, f32 = self.spec, self._iteration.psd32
        mat_ms = vec_ms = 0.0
        has_mat = has_vec = False
        for sizes, fn, width in (
                (spec.s, psd_mod.proj_psd_batch, lambda z: z * (z + 1) // 2),
                (spec.cs, psd_mod.proj_cpsd_batch, lambda z: z * z)):
            for sz, ct in _contiguous_runs(sizes):
                if sz:
                    has_mat = True
                    mat_ms += clock(functools.partial(fn, ns=sz, f32_eig=f32),
                                    rand(ct, width(sz)))
        for di, ct in _contiguous_runs(spec.d):
            has_mat = has_vec = True
            mat_ms += clock(functools.partial(sp.proj_logdet_batch, ns=di,
                                              f32_eig=f32),
                            rand(ct, di * (di + 1) // 2 + 2))
            vec_ms += clock(sp.log_cone_newton, rand(ct),
                            torch.abs(rand(ct)) + 1.0, rand(ct, di))
        for (mi, ni), ct in _contiguous_runs(list(zip(spec.nuc_m,
                                                      spec.nuc_n))):
            has_mat = has_vec = True
            mat_ms += clock(functools.partial(sp.proj_nuclear, m=mi, n=ni,
                                              f32_eig=f32),
                            rand(ct, mi * ni + 1))
            vec_ms += clock(sp.proj_ell1, rand(ct, min(mi, ni) + 1))
        for (si, ki), ct in _contiguous_runs(list(zip(spec.sl_n,
                                                      spec.sl_k))):
            has_mat = has_vec = True
            mat_ms += clock(functools.partial(sp.proj_sum_largest_evals,
                                              ns=si, k=ki, f32_eig=f32),
                            rand(ct, si * (si + 1) // 2 + 1))
            r = rand(ct, si + 1)
            vec_ms += clock(functools.partial(sp.proj_sum_largest_sorted,
                                              k=ki),
                            r[:, 0], torch.sort(r[:, 1:], descending=True,
                                                dim=-1).values)
        out = {}
        if has_mat:
            out["mat_cone_ms"] = mat_ms
        if has_vec:
            out["vec_cone_ms"] = vec_ms
        return out

    def _print_header(self) -> None:
        """The init banner (print_init_header, scs.c:123-177; the JAX
        package's table), naming the device the solve runs on."""
        stg, spec = self.stg, self.spec
        where = (torch.cuda.get_device_name(self.device)
                 if self.device.type == "cuda" else "the CPU")
        bar = "-" * 71
        print(bar)
        print(f"          scs_tpu_torch v{config.VERSION} - splitting conic "
              f"solver on {where}")
        print(bar)
        print(f"problem:  variables n: {self.n}, constraints m: {self.m}")
        parts = []
        if spec.z:
            parts.append(f"z (zero): {spec.z}")
        if spec.l:
            parts.append(f"l (linear): {spec.l}")
        if spec.bsize:
            parts.append(f"b (box): {spec.bsize}")
        if spec.q:
            parts.append(f"q (soc): {sum(spec.q)} in {len(spec.q)} cones")
        if spec.s:
            parts.append(f"s (psd): {sum(x * (x + 1) // 2 for x in spec.s)}"
                         f" in {len(spec.s)} cones")
        if spec.cs:
            parts.append(f"cs (complex psd): {sum(x * x for x in spec.cs)}"
                         f" in {len(spec.cs)} cones")
        if spec.ep or spec.ed:
            parts.append(f"e (exp): {3 * (spec.ep + spec.ed)}")
        if spec.p:
            parts.append(f"p (power): {3 * len(spec.p)}")
        for extra, label in ((spec.d, "d (logdet)"), (spec.ell1, "ell1"),
                             (spec.nuc_m, "nuc"), (spec.sl_n, "sl")):
            if extra:
                parts.append(f"{label}: {len(extra)} cones")
        print("cones:    " + "; ".join(parts))
        print(f"settings: eps_abs: {stg.eps_abs:.1e}, eps_rel: "
              f"{stg.eps_rel:.1e}, eps_infeas: {stg.eps_infeas:.1e}")
        print(f"          alpha: {stg.alpha:.2f}, scale: {stg.scale:.2e}, "
              f"adaptive_scale: {int(stg.adaptive_scale)}")
        print(f"          max_iters: {stg.max_iters}, normalize: "
              f"{int(stg.normalize)}, rho_x: {stg.rho_x:.2e}")
        print(f"          acceleration_lookback: {stg.acceleration_lookback},"
              f" acceleration_interval: {stg.acceleration_interval}")
        print(f"lin-sys:  {self.backend.METHOD_NAME} (dtype "
              f"{str(stg.dtype).replace('torch.', '')})")
        print(bar)
        print(" iter | pri res | dua res |   gap   | pri obj |  scale  |"
              " time (s)")
        print(bar)

    def _print_progress(self, st: LoopState, elapsed_s: float) -> None:
        """A progress row (print_summary, scs.c:198-235), its values in
        one read of the device."""
        r = st.res
        rp, rd, gap, pobj, scale = torch.stack([
            t.to(torch.float64) for t in (r.res_pri, r.res_dual, r.gap,
                                          r.pobj, st.scale)]).tolist()
        print(f"{st.iter:6d}| {rp:.2e} {rd:.2e} {gap:.2e} {pobj: .2e} "
              f"{scale:.2e} {elapsed_s:.2e}")

    def _print_footer(self, info: Info) -> None:
        """The exit summary (print_footer, scs.c:237-274)."""
        bar = "-" * 71
        print(bar)
        print(f"status:  {info.status}")
        print(f"timings: total: {(info.setup_time + info.solve_time) / 1e3:.2e}s"
              f" = setup: {info.setup_time / 1e3:.2e}s"
              f" + solve: {info.solve_time / 1e3:.2e}s")
        if info.status_val in (config.SOLVED, config.SOLVED_INACCURATE):
            print(f"objective = {info.pobj:.6f}")
        print(bar)

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
