"""Differentiable conic solves: implicit differentiation of the solution map.

Counterpart of `scs_tpu/diff.py` (the diffcp workflow: Agrawal, Barratt,
Boyd, Busseti, Moursi 2019, "Differentiating Through a Cone Program"):
gradients of the primal/dual solution (x, y, s) with respect to the
problem data (A, b, c, P, box bounds), so that `loss.backward()` flows
through a conic solve.

Design, the JAX package's: the implicit function theorem on the solver's
own Douglas-Rachford fixed point,

    v* = Phi(v*, theta)        one plain step of the batched iteration,
                               theta = (A, P, b, c, bu, bl)
    sol = h(v*, theta)         (x, y, s) = (u_x, u_y, rsk_s) / tau

Phi is built from the port's own parts: `parallel.batch._parts` rebuilds
the problem data (the Gram K = A'A + 999 A_z'A_z and its Cholesky factor)
from theta inside the function, and `solver_batched.BatchedIteration.
substep` takes one step at iteration 1 (a plain step: no convergence
check, no Anderson step, no host read of the device). Its settings are
the deterministic ones of `_fp_settings`: no equilibration, no adaptive
scale, no acceleration, the direct backend in pure float64 (so no
double-single split exists: the kernels K1-K3 have no derivative), no
float32 cones, no tracked-rank PSD. The forward solve keeps the caller's
settings (mixed precision on the card, CG, Ruiz), since the derivative of
the solution map does not depend on how the solve got there.

The Function's backward solves the adjoint system

    (I - dPhi/dv)^T w = (dh/dv)^T g

matrix-free by GMRES on vector-Jacobian products of ONE recorded Phi
(`torch.autograd.grad(..., retain_graph=True)`), then returns
(dh/dtheta)^T g + (dPhi/dtheta)^T w. Its jvp (forward mode, under
`torch.autograd.forward_ad`) solves (I - dPhi/dv) dv = (dPhi/dtheta)
dtheta and returns (dh/dv) dv + (dh/dtheta) dtheta. Forward mode pushes
dual tensors through Phi (`forward_ad`, at the caller's dual level): the
problem data is rebuilt once without tangents and each GMRES step runs
the step alone with a dual v. `torch.func.jvp` is not used: the cone
loops' CPU early exits read the device (`cones.graphs.settled`), which
torch.func refuses, and a double-VJP would record a second-order graph
of every cone loop. One Function carries both rules (the JAX package
needs a `mode` switch because a JAX function carries one custom rule);
`mode` stays in the signature for parity and takes "vjp" or "jvp".

On the card, the box, exp and power projections of the SOLVER replay
CUDA graphs, through which autograd records nothing (`cones.graphs`); Phi
runs them eagerly under `graphs.eager()`, and `graphs.run` raises where
autograd would record through a replay.

A batch: stacked operands (A (B, m, n), b (B, m), ...) are differentiated
lane by lane at once (the JAX package's `jax.vmap(diff_solve)`): the
forward solve runs through `make_batch_solver`, Phi over the B lanes, and
GMRES keeps each lane's Krylov space, rotations and stopping test, each
lane frozen once its residual meets the tolerance.

Supported cones: z, l, box, q, s, cs, ep, ed, p, nuclear, ell1. logdet (d)
and sum-largest (sl) are rejected: their projections are the data-
dependent loops of kernels K6 and K7 on the card, which have no
derivative (the JAX package rejects them for its while_loops).

Caveats, the JAX package's: the gradient exists where the solution map
is differentiable (strict complementarity, distinct eigenvalues inside
active PSD blocks; eigh's backward is infinite at repeated eigenvalues).
v* is a fixed point only to the solve's tolerance, so solve tight (the
default here is eps 1e-9). A lane whose status is not solved returns NaN
and NaN gradients. Degenerate instances (piecewise-linear cones at
degenerate vertices, one-sided inactive exp blocks, box cones with an
active bound) make (I - dPhi/dv) singular; GMRES then returns a finite
least-squares-like generalized gradient, not to be trusted.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.autograd.forward_ad as fwAD

from . import config
from .api import _resolve_device
from .cones import graphs
from .parallel.batch import _parts, make_batch_solver, make_pure_solver
from .solver_batched import pack_warm_v_batched, set_diag_r_batched
from .types import ConeSpec, Settings
from .validation import ValidationError

_DEF_EPS = 1e-9


def _fp_settings(stg: Settings) -> Settings:
    """Deterministic plain-map settings for the implicit function theorem
    (the JAX package's, with the port's float32 cone switches and the
    tracked-rank PSD off as well)."""
    return dataclasses.replace(
        stg, normalize=False, adaptive_scale=False,
        acceleration_lookback=0, linsys="direct", mixed_precision=False,
        verbose=False, warm_start=False, write_data_filename=None,
        log_csv_filename=None, cone_f32=False, exp_f32=None, fast_f32=None,
        psd_rank=0, profile_phases=False)


# ---- GMRES (jax.scipy.sparse.linalg.gmres, solve_method="incremental") --

def _safe_normalize(x, thresh):
    """(x / ||x||, ||x||) per row, (0, 0) where ||x|| <= thresh."""
    nrm = torch.linalg.vector_norm(x, dim=-1)
    use = nrm > thresh
    unit = torch.where(use[:, None], x / torch.where(use, nrm, 1.0)[:, None],
                       0.0)
    return unit, torch.where(use, nrm, 0.0)


def _givens(a, b):
    """(cs, sn) zeroing b against a (JAX's `_givens_rotation`)."""
    b_zero = b == 0
    a_lt_b = torch.abs(a) < torch.abs(b)
    t = -torch.where(a_lt_b, a, b) / torch.where(
        a_lt_b, b, torch.where(a == 0, 1.0, a))
    r = torch.rsqrt(1 + t * t)
    cs = torch.where(b_zero, 1.0, torch.where(a_lt_b, r * t, r))
    sn = torch.where(b_zero, 0.0, torch.where(a_lt_b, r, r * t))
    return cs, sn


def _rotate_(M, k: int, cs, sn):
    """Rotate entries (rows, for a matrix per lane) k and k + 1 of M in
    place by each lane's (cs, sn): (cs x - sn y, sn x + cs y) (JAX's
    `_rotate_vectors`)."""
    shape = (-1,) + (1,) * (M.dim() - 2)
    c, s_ = cs.view(shape), sn.view(shape)
    x, y = M[:, k].clone(), M[:, k + 1].clone()
    M[:, k] = c * x - s_ * y
    M[:, k + 1] = s_ * x + c * y


def gmres(op, b, tol: float, atol: float, restart: int, maxiter: int):
    """Solve op(x) = b for each row of b (B, l) by restarted GMRES.

    The port's copy of `jax.scipy.sparse.linalg.gmres(...,
    solve_method="incremental")`, batched: every row keeps its own Krylov
    basis, Givens rotations and stopping test ||r|| <= max(tol ||b||,
    atol), and is frozen once it meets it (its x and counts stay as they
    are; op is applied to all rows, a frozen row's result is not read).
    The rotations of a cycle are kept accumulated in one orthogonal
    matrix per row (each new rotation updates two of its rows), so
    applying them to a new Hessenberg column is one batched product, not
    k small steps. Breakdown-safe: an Arnoldi vector
    below eps times its operator image's norm ends the row's cycle.

    Returns (x, arnoldi steps per row (host int64), calls of op).
    """
    B, l = b.shape
    dtype, dev = b.dtype, b.device
    restart = max(min(restart, l), 1)
    eps = torch.finfo(dtype).eps
    bnorm = torch.linalg.vector_norm(b, dim=1)
    atol_r = torch.clamp_min(tol * bnorm, atol)
    ptol = torch.where(bnorm > 0,
                       bnorm * torch.clamp_max(
                           atol_r / torch.where(bnorm > 0, bnorm, 1.0), 1.0),
                       0.0)
    x = torch.zeros_like(b)
    unit, rnorm = _safe_normalize(b, eps)
    steps = torch.zeros(B, dtype=torch.int64)
    outer = torch.zeros(B, dtype=torch.int64, device=dev)
    calls = 0
    eye = torch.eye(restart + 1, dtype=dtype, device=dev)
    while True:
        active = (outer < maxiter) & (rnorm > ptol)
        if not bool(active.any()):
            break
        V = torch.zeros(B, restart + 1, l, dtype=dtype, device=dev)
        V[:, 0] = unit
        # R holds the rotated Hessenberg columns as rows (JAX's layout);
        # the unused rows stay those of the identity, so the triangular
        # solve below is well posed for a row that stopped early
        R = torch.eye(restart, restart + 1, dtype=dtype,
                      device=dev).repeat(B, 1, 1)
        Q = eye.repeat(B, 1, 1)          # the cycle's rotations so far
        beta = torch.zeros(B, restart + 1, dtype=dtype, device=dev)
        beta[:, 0] = rnorm
        err = rnorm
        run = active
        for k in range(restart):
            run = run & (err > ptol)
            if not bool(run.any()):
                break
            w = op(V[:, k])
            calls += 1
            w0 = torch.linalg.vector_norm(w, dim=1)
            # classical Gram-Schmidt, twice ("twice is enough")
            h = torch.einsum("bjl,bl->bj", V, w)
            w = w - torch.einsum("bjl,bj->bl", V, h)
            h2 = torch.einsum("bjl,bl->bj", V, w)
            w = w - torch.einsum("bjl,bj->bl", V, h2)
            h = h + h2
            unit_w, wn = _safe_normalize(w, eps * w0)
            h[:, k + 1] = wn
            row = torch.einsum("bij,bj->bi", Q, h)
            cs, sn = _givens(row[:, k], row[:, k + 1])
            # a frozen row's rotation is the identity
            cs = torch.where(run, cs, 1.0)
            sn = torch.where(run, sn, 0.0)
            for M in (row, Q, beta):
                _rotate_(M, k, cs, sn)
            r2 = run[:, None]
            V[:, k + 1] = torch.where(r2, unit_w, V[:, k + 1])
            R[:, k] = torch.where(r2, row, R[:, k])
            err = torch.where(run, torch.abs(beta[:, k + 1]), err)
            steps += run.cpu().to(torch.int64)
        y = torch.linalg.solve_triangular(
            R[:, :, :-1].transpose(1, 2), beta[:, :-1, None],
            upper=True)[..., 0]
        x = torch.where(active[:, None],
                        x + torch.einsum("bjl,bj->bl", V[:, :-1], y), x)
        r = b - op(x)
        calls += 1
        unit_n, rnorm_n = _safe_normalize(r, eps)
        unit = torch.where(active[:, None], unit_n, unit)
        rnorm = torch.where(active, rnorm_n, rnorm)
        outer = outer + active.to(torch.int64)
    return x, steps, calls


# ---- the plain map and its derivatives ----

class _Core:
    """The forward solvers and the plain map Phi of one diff solver."""

    def __init__(self, spec: ConeSpec, stg: Settings, dev, gmres_tol,
                 gmres_restart, gmres_maxiter, ridge):
        self.spec, self.dev = spec, dev
        self.stg_fp = _fp_settings(stg)
        self.pure = make_pure_solver(spec, stg, device=dev)
        self.batch = make_batch_solver(spec, stg, has_P=True, device=dev)
        self.it, self.init_fn, _, _ = _parts(spec, self.stg_fp, dev, False)
        self.gmres_kw = dict(tol=gmres_tol, atol=gmres_tol,
                             restart=gmres_restart, maxiter=gmres_maxiter)
        self.ridge = ridge
        # the last backward's or jvp's GMRES steps per lane and evaluations
        # of Phi's derivative (VJPs, or JVPs in forward mode)
        self.last_gmres_steps: Optional[torch.Tensor] = None
        self.last_evals = 0

    def solve(self, single: bool, theta):
        """The forward solve (caller's settings): (x, y, s), batched."""
        A, P, b, c, bu, bl = theta
        P = _sym(P)
        if single:
            res = self.pure(A[0], None if P is None else P[0], b[0], c[0],
                            bu[0], bl[0])
            return res.x[None], res.y[None], res.s[None]
        res = self.batch(A, P, b, c, bu, bl)
        return res.x, res.y, res.s

    def prepare(self, theta):
        """(data, state) of Phi, rebuilt from theta so that derivatives
        reach the raw tensors."""
        A, P, b, c, bu, bl = theta
        data, st = self.init_fn(A, _sym(P), b, c, bu, bl)
        # Phi is pure float64: no double-single split (K1-K3 have no
        # derivative)
        assert data.lin_cache.ds_fwd is None
        return data, st

    def step(self, prepared, v):
        """(Phi(v), h(v)) = (v after one plain step, (x, y, s))."""
        data, st = prepared
        B = v.shape[0]
        m, n = data.A.shape[1:]
        st = dataclasses.replace(st, v=v, v_prev=v,
                                 iter=torch.ones(B, dtype=torch.int64))
        act = torch.ones(B, dtype=torch.bool)
        with graphs.eager():
            st = self.it.substep(data, st, 1, act, act.to(v.device))
        tau = st.u[:, n + m]
        inv_tau = (1.0 / torch.where(torch.abs(tau) > config.DIV_EPS_TOL,
                                     tau, config.DIV_EPS_TOL))[:, None]
        return st.v, (st.u[:, :n] * inv_tau, st.u[:, n:n + m] * inv_tau,
                      st.rsk[:, n:n + m] * inv_tau)

    def fixed_point(self, x, y, s):
        """v* = [x; y + s/R_y; 1], renormalized (`pack_warm_v`, then the
        loop's iterate normalization, so that Phi maps v* to itself)."""
        B, n = x.shape
        m = y.shape[1]
        scale = torch.full((B,), float(self.stg_fp.scale), dtype=x.dtype,
                           device=x.device)
        diag_r = set_diag_r_batched(self.spec, n, m, scale,
                                    self.stg_fp.rho_x)
        v = pack_warm_v_batched(x, y, s, diag_r)
        nrm = torch.linalg.vector_norm(v, dim=1, keepdim=True)
        return v * (math.sqrt(v.shape[1]) * config.ITERATE_NORM
                    / torch.where(nrm > 0, nrm, 1.0))

    def gmres(self, op, rhs):
        ridge = self.ridge
        x, steps, calls = gmres(lambda u: op(u) + ridge * u, rhs,
                                **self.gmres_kw)
        self.last_gmres_steps = steps
        return x, calls


def _sym(P):
    # P is defined on symmetric matrices; symmetrizing makes the map well
    # defined on full matrices, so the returned P-cotangent is the
    # symmetric-convention gradient
    return None if P is None else 0.5 * (P + P.transpose(-2, -1))


def _primal(t):
    return None if t is None else fwAD.unpack_dual(t).primal.detach()


class _DiffSolve(torch.autograd.Function):
    """(x, y, s) of the solve of theta, with the implicit-function rules."""

    @staticmethod
    def forward(ctx, core, single, A, P, b, c, bu, bl):
        x, y, s = core.solve(single, (A, P, b, c, bu, bl))
        ctx.core = core
        ctx.save_for_backward(A, P, b, c, bu, bl, x, y, s)
        ctx.save_for_forward(A, P, b, c, bu, bl, x, y, s)
        return x, y, s

    @staticmethod
    def backward(ctx, gx, gy, gs):
        core = ctx.core
        saved = ctx.saved_tensors
        theta, (x, y, s) = saved[:6], saved[6:]
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            v = core.fixed_point(x, y, s).detach().requires_grad_()
            th = [None if t is None else
                  t.detach().requires_grad_(bool(need))
                  for t, need in zip(theta, needs)]
            wrt = [t for t in th if t is not None and t.requires_grad]
            phi, sol = core.step(core.prepare(th), v)
            pulled = torch.autograd.grad(sol, [v] + wrt, (gx, gy, gs),
                                         retain_graph=True,
                                         allow_unused=True)
            hv = _zeros_for(pulled[0], v)

            def op(w):
                jw = torch.autograd.grad(phi, v, w, retain_graph=True,
                                         allow_unused=True)[0]
                return w - _zeros_for(jw, v)

            w, calls = core.gmres(op, hv)
            jth = (torch.autograd.grad(phi, wrt, w, allow_unused=True)
                   if wrt else ())
        core.last_evals = calls + 2
        grads, k = [], 0
        for t in th:
            if t is None or not t.requires_grad:
                grads.append(None)
                continue
            g = _zeros_for(pulled[1 + k], t) + _zeros_for(jth[k], t)
            grads.append(g)
            k += 1
        return (None, None, *grads)

    @staticmethod
    def jvp(ctx, _core, _single, *tangents):
        core = ctx.core
        saved = ctx.saved_tensors
        theta = [_primal(t) for t in saved[:6]]
        x, y, s = (_primal(t) for t in saved[6:])
        v = core.fixed_point(x, y, s)
        dth = [None if t is None or d is None else d
               for t, d in zip(theta, tangents)]

        def dual_theta():
            return [t if d is None else fwAD.make_dual(t, d)
                    for t, d in zip(theta, dth)]

        def tangent(t, like):
            out = fwAD.unpack_dual(t).tangent
            return torch.zeros_like(like) if out is None else out

        with fwAD._set_fwd_grad_enabled(True):
            plain = core.prepare(theta)
            moved = core.prepare(dual_theta())
            phi, _ = core.step(moved, v)
            rhs = tangent(phi, v)

            def op(u):
                phi_u, _ = core.step(plain, fwAD.make_dual(v, u))
                return u - tangent(phi_u, v)

            dv, calls = core.gmres(op, rhs)
            _, sol = core.step(moved, fwAD.make_dual(v, dv))
            out = tuple(tangent(t, p) for t, p in zip(sol, (x, y, s)))
        core.last_evals = calls + 2
        return out


def _zeros_for(g, like):
    return torch.zeros_like(like) if g is None else g


def make_diff_solver(spec: ConeSpec, settings: Optional[Settings] = None,
                     has_P: bool = False, gmres_tol: float = 1e-10,
                     gmres_restart: int = 40, gmres_maxiter: int = 25,
                     ridge: float = 0.0, *, device="cuda"):
    """Build diff_solve(A, b, c[, P][, bu, bl], mode="vjp") -> (x, y, s),
    through which gradients flow into every tensor argument.

    Reverse mode: `loss.backward()` or `torch.autograd.grad`. Forward
    mode: call it on dual tensors under `torch.autograd.forward_ad.
    dual_level()` and read the outputs' tangents (diffcp's `derivative`
    against its `adjoint_derivative`); `mode` ("vjp" or "jvp") is kept for
    the JAX package's signature, both rules are always there. Forward
    solves run with `settings` (default `Settings(eps_abs=1e-9,
    eps_rel=1e-9)`) on `device` (the card unless "cpu" is passed); the
    implicit-function system is solved by GMRES to `gmres_tol` (restart
    min(gmres_restart, l), at most gmres_maxiter restarts; `ridge` > 0
    regularizes it near nondifferentiable points, shifting the gradient
    by O(ridge)). `diff_solve.core.last_gmres_steps` (GMRES steps per
    lane) and `diff_solve.core.last_evals` (evaluations of Phi's
    derivative) report the last backward or forward-mode call.

    Stacked operands (A (B, m, n), b (B, m), c (B, n), P (B, n, n), bu
    and bl (B, bsize - 1)) differentiate B problems at once, lane by lane.
    P (with `has_P`) is the full symmetric matrix, and so is its gradient;
    the box bounds (bu, bl) follow when the spec has a box cone.
    """
    if spec.d or spec.sl_n:
        raise ValidationError(
            "differentiation does not support logdet (d) / sum-largest "
            "(sl) cones: their projections are data-dependent loops "
            "(kernels K6 and K7 on the card) with no derivative")
    dev = _resolve_device(device)
    stg = settings if settings is not None else Settings(
        eps_abs=_DEF_EPS, eps_rel=_DEF_EPS)
    core = _Core(spec, stg, dev, gmres_tol, gmres_restart, gmres_maxiter,
                 ridge)
    has_box = spec.bsize > 1
    nb = max(spec.bsize - 1, 0)

    def put(t):
        if t is None:
            return None
        if isinstance(t, torch.Tensor):
            return t.to(device=dev, dtype=torch.float64)
        return torch.as_tensor(t, dtype=torch.float64, device=dev)

    def diff_solve(A, b, c, *args, mode: str = "vjp"):
        expected = (1 if has_P else 0) + (2 if has_box else 0)
        if len(args) != expected:
            raise TypeError(
                "diff_solve expects (A, b, c"
                + (", P" if has_P else "")
                + (", bu, bl" if has_box else "")
                + f"); got {3 + len(args)} args")
        if mode not in ("vjp", "jvp"):
            raise ValueError(f"mode must be 'vjp' or 'jvp', got {mode!r}")
        A, b, c = put(A), put(b), put(c)
        P = put(args[0]) if has_P else None
        single = A.dim() == 2
        lead = () if single else (A.shape[0],)
        if has_box:
            bu, bl = put(args[-2]), put(args[-1])
        else:
            bu = torch.zeros(lead + (nb,), dtype=torch.float64, device=dev)
            bl = torch.zeros(lead + (nb,), dtype=torch.float64, device=dev)
        theta = (A, P, b, c, bu, bl)
        if single:
            theta = tuple(None if t is None else t.unsqueeze(0)
                          for t in theta)
        x, y, s = _DiffSolve.apply(core, single, *theta)
        if single:
            return x[0], y[0], s[0]
        return x, y, s

    diff_solve.core = core
    return diff_solve
