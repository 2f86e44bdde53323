"""Indirect KKT solver: Jacobi-preconditioned conjugate gradient.

Counterpart of `scs_tpu/linsys/indirect.py` (SCS's indirect backend,
linsys/cpu/indirect/private.c:50-324). Each ADMM iteration solves the
quasi-definite system

    [ R_x + P    A' ] [x]   [rx]
    [   A      -R_y ] [y] = [ry]

through the Schur reduction

    x = (R_x + P + A' R_y^{-1} A)^{-1} (rx + A' R_y^{-1} ry)
    y = R_y^{-1} (A x - ry)

with conjugate gradient on x, preconditioned by the inverse diagonal
M = 1/diag(R_x + P + scale K), K = A'A + 999 A_z'A_z.

Mixed precision: the CG inner loop runs in float32 on the float32 shadows
A32 and P32 that `Mats` carries (a plain float32 product; TF32 is off,
`scs_tpu_torch/__init__.py`), inside a float64 iterative-refinement loop
that recomputes the true residual b - G x through the double-single
kernels (K1 for one problem, K2 for a batch) and solves again for the
correction, at most MAX_REFINE times. The right-hand side's A' z and the
y-recovery's A x take the same kernels.

A sparse A or P (`ops.sparse.SparseA`, one problem) takes the same
path: the diagonal from its structure-aware column sums, its products
through `matvec.mv` (the CG's on the float32 shadow, re-tiled:
`SparseA.retiled`), its double-single applies through K2s (and K1 for
its dense tails), `ops.sparse.ds_sparse_matvec`.

A row-sharded A (`ops.rowshard.RowShardedA`, one problem or a batch)
takes the same path too: the diagonal is summed over the model group
(a rank's zero-cone rows weighted by their global index), the Schur
product A' R_y^{-1} A x of every CG iteration is each rank's A_r' R_y,r^{-1}
A_r x summed in one collective (`RowShardedA.schur_matvec`, and
`ops.rowshard.ds_schur_matvec` on the kernels), and the right-hand side's
A' z and the y-recovery's A x each take one. The CG blocks then run
eagerly (`_pcg`): a collective cannot sit inside the CUDA graph that
`_CGGraph` captures (gloo's host staging least of all), so the choice
is made by the operand's type, not by a switch.

Every function takes one problem (vectors (n,), 0-d scalars) or a batch
(a leading axis B on every operand): the arithmetic is elementwise or a
reduction over the last axis, and the products dispatch on the operand's
rank (`matvec.mv`, `matvec.ds_mv`). So `precompute_batched`,
`derive_batched` and `solve_batched` are the same functions.

The JAX package's CG loops are `lax.while_loop`s, vmapped in a batch, so
a lane that has converged is frozen by a select while the others run.
Here the loops are Python loops over device tensors: every update is
masked by the lanes' `done` flags (`torch.where`), and the host reads the
flags only every READ_EVERY iterations (and once before the loop where a
warm start may already satisfy the tolerance). A lane that finishes
between two reads stays frozen, so the result is the JAX loop's whatever
the interval; the loop just runs up to READ_EVERY - 1 masked iterations
past the last lane. `host_reads` counts those reads. The JAX package's
`lax.cond` on a zero right-hand side and its `already` test are masks
too, not host branches.

On the card the host would spend ~30 kernel launches per CG iteration,
far longer than the card spends on them, so each block of READ_EVERY
iterations is a CUDA graph captured once (`_CGGraph`, cached by the
addresses of what it reads) and replayed with one launch: the
counterpart of the JAX loop's single compiled program. The graph runs
the same kernels in the same order as the eager loop, which the CPU runs.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import NamedTuple, Optional

import torch

from .. import config
from ..ops import dsmatvec, rowshard, sparse
from ..ops.dsmatvec import DsSplit
from .matvec import ds_mv, mT, mv

METHOD_NAME = "dense-indirect-jacobi-pcg"

# Refinement passes cap: each pass gains ~5 decades of accuracy (float32
# CG stall floor), so 6 cover the float64 range with margin.
MAX_REFINE = 6
# Per-pass accuracy target relative to the pass's starting residual: stay
# above the float32 CG stall floor (~1e-7 relative).
REFINE_PASS_RTOL = 3e-6
# CG iterations between two host reads of the lanes' done flags; on the
# card also the iterations that one CUDA graph replay runs
READ_EVERY = 4
GRAPH_CACHE_SIZE = 16

# host reads of the device made by the CG and refinement loops, and
# refinement passes run (mixed), since the counts were last set to 0
host_reads = 0
refine_passes = 0


class IndirectCache(NamedTuple):
    """Loop-invariant operand cache (ProblemData.lin_cache)."""

    diagK: torch.Tensor           # scale-free preconditioner diagonal
    ds_fwd: Optional[DsSplit]     # (hi, lo) split of A (DsSparse if sparse)
    ds_bwd: Optional[DsSplit]     # (hi, lo) split of A'


def precompute(A, P, n_zero: int, ds: bool = False) -> IndirectCache:
    """diag(K) = diag(A'A + 999 A_z'A_z) of A (m, n), of a SparseA or of
    each problem of a stack (B, m, n), plus the double-single splits of A
    and A' when `ds` is set (the mixed path on the card; a test may set it
    on the CPU to drive the solver through the kernels' plain versions).
    A SparseA's diagonal is its column sums with the zero-cone rows
    weighted 1000 (scs_tpu/linsys/indirect.py:56-72)."""
    del P
    if rowshard.is_row_sharded(A):
        d = A.diag_gram(n_zero)
        if not ds:
            return IndirectCache(d, None, None)
        return IndirectCache(d, *A.split())
    sparse.require_operand(A)
    if sparse.is_sparse(A):
        rows = torch.arange(A.shape[0], device=A.device)
        w = torch.where(rows < n_zero, 1000.0, 1.0).to(A.dtype)
        d = A.col_sumsq(w)
        if not ds:
            return IndirectCache(d, None, None)
        return IndirectCache(d, sparse.ds_split_sparse(A),
                             sparse.ds_split_sparse(A.T))
    d = torch.sum(A * A, dim=-2)
    if n_zero:
        Az = A[..., :n_zero, :]
        d = d + 999.0 * torch.sum(Az * Az, dim=-2)
    if not ds:
        return IndirectCache(d, None, None)
    return IndirectCache(d, dsmatvec.split_operand(A),
                         dsmatvec.split_operand(A.transpose(-2, -1)))


def derive(mats, diag_r, scale, mixed: bool = False):
    """Inverse Jacobi preconditioner M = 1/diag(R_x + P + scale K)
    (set_preconditioner, private.c:50-82): M (pure), or (float32 M,
    float32 diag_r) (mixed). `scale` is 0-d, or (B,) for a batch."""
    n = mats.A.shape[-1]
    d = diag_r[..., :n] + scale[..., None] * mats.cache.diagK
    if mats.P is not None:
        d = d + (mats.P.diagonal() if sparse.is_sparse(mats.P)
                 else torch.diagonal(mats.P, dim1=-2, dim2=-1))
    M = 1.0 / d
    if not mixed:
        return M
    return (M.to(torch.float32), diag_r.to(torch.float32))


precompute_batched = precompute
derive_batched = derive


def enter_f32_state(mats, diag_r, derived):
    """The mixed preconditioner as the float32-state regime holds it: it
    is float32 already, so the structure is the same in both regimes."""
    del mats, diag_r
    return derived


def leave_f32_state(derived):
    return derived


def _dot(a, b):
    return torch.dot(a, b) if a.dim() == 1 else torch.linalg.vecdot(a, b)


def _amax(r):
    return torch.linalg.vector_norm(r, math.inf, dim=-1)


def _mat_vec(A, P, diag_r, x):
    """(R_x + P + A' R_y^{-1} A) x in the operands' own precision."""
    m, n = A.shape[-2:]
    if rowshard.is_row_sharded(A):
        y = A.schur_matvec(x, diag_r[..., n:n + m]) + diag_r[..., :n] * x
    else:
        z = mv(A, x) / diag_r[..., n:n + m]
        y = mv(mT(A), z) + diag_r[..., :n] * x
    if P is not None:
        y = y + mv(P, x)
    return y


def _A_matvec(mats, x):
    ds = mats.cache.ds_fwd
    return mv(mats.A, x) if ds is None else ds_mv(ds, x)


def _At_matvec(mats, z):
    ds = mats.cache.ds_bwd
    return mv(mT(mats.A), z) if ds is None else ds_mv(ds, z)


def _schur_matvec(mats, diag_r, x):
    """(R_x + P + A' R_y^{-1} A) x with A x and A' z on the double-single
    kernels where the cache holds the splits."""
    m, n = mats.A.shape[-2:]
    cache = mats.cache
    if cache.ds_fwd is None:
        return _mat_vec(mats.A, mats.P, diag_r, x)
    if isinstance(cache.ds_fwd, rowshard.RowShardedSplit):
        y = rowshard.ds_schur_matvec(cache.ds_fwd, cache.ds_bwd, x,
                                     diag_r[..., n:n + m])
    else:
        z = ds_mv(cache.ds_fwd, x) / diag_r[..., n:n + m]
        y = ds_mv(cache.ds_bwd, z)
    y = y + diag_r[..., :n] * x
    if mats.P is not None:
        y = y + mv(mats.P, x)
    return y


def _all_done(done) -> bool:
    global host_reads
    host_reads += 1
    return bool(done.all())


def _cg_step(ops, M, tol, state) -> None:
    """One masked CG iteration, in place on state = (x, r, p, ztr, its,
    done): lanes already done keep their values (the JAX loop's select).
    ops = (A, P, diag_r) of the system (R_x + P + A' R_y^{-1} A)."""
    x, r, p, ztr, its, done = state
    live = ~done
    lv = live.unsqueeze(-1)
    Gp = _mat_vec(*ops, p)
    alpha = (ztr / _dot(p, Gp)).unsqueeze(-1)
    torch.where(lv, torch.addcmul(x, alpha, p), x, out=x)
    torch.where(lv, torch.addcmul(r, alpha, Gp, value=-1.0), r, out=r)
    z = M * r
    ztr_new = _dot(z, r)
    conv = _amax(r) < tol
    stalled = ztr == 0.0
    beta = (ztr_new / torch.where(ztr != 0, ztr, 1.0)).unsqueeze(-1)
    torch.where(lv, torch.addcmul(z, beta, p), p, out=p)
    torch.where(live, ztr_new, ztr, out=ztr)
    its.add_(live)
    torch.logical_or(done, conv | stalled, out=done)


class _CGGraph:
    """READ_EVERY CG iterations (`_cg_step`) on persistent state buffers,
    captured once as a CUDA graph and replayed: one launch from the host
    for a block that the eager loop launches as ~30 kernels per
    iteration (the counterpart of the JAX package's compiled while_loop,
    one dispatch). The graph reads the operands, the preconditioner and
    the tolerance buffer by address, so `_graph` caches it under those
    addresses and shapes: the ADMM steps between two scale updates or
    compactions replay one graph, with the tolerance and the initial
    state copied into its buffers first."""

    def __init__(self, ops, M, tol, state):
        dev = M.device
        self.state = tuple(t.clone() for t in state)
        self.tol = tol.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # warm-up on copies (no library set-up may happen during a
            # capture); the captured block itself runs only on replay
            scratch = tuple(t.clone() for t in state)
            for _ in range(READ_EVERY):
                _cg_step(ops, M, self.tol, scratch)
            self.graph = torch.cuda.CUDAGraph()
            self.graph.capture_begin()
            try:
                for _ in range(READ_EVERY):
                    _cg_step(ops, M, self.tol, self.state)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)

    def load(self, tol, state) -> None:
        self.tol.copy_(tol)
        for buf, t in zip(self.state, state):
            buf.copy_(t)


_graphs: "OrderedDict[tuple, _CGGraph]" = OrderedDict()


def _tensors(*ops) -> list:
    """The operands as the tensors a graph reads: a SparseA contributes
    every tensor of both directions and its tails (a key that missed one
    would replay a graph on a freed operand)."""
    out = []
    for t in ops:
        out.extend(t.tensors() if sparse.is_sparse(t) else (t,))
    return out


def _graph(ops, M, tol, state) -> _CGGraph:
    """The cached graph for these operands (captured on a miss), loaded
    with `tol` and `state`."""
    key = tuple(None if t is None else
                (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                for t in _tensors(*ops, M)) + (
        tuple(tol.shape), state[0].shape, state[0].dtype, READ_EVERY)
    g = _graphs.pop(key, None)
    if g is None:
        g = _CGGraph(ops, M, tol, state)
        while len(_graphs) >= GRAPH_CACHE_SIZE:
            _graphs.popitem(last=False)
    _graphs[key] = g
    g.load(tol, state)
    return g


def _pcg(ops, M, s, b, max_its: int, tol, active=None,
         read_first: bool = True, eager: bool = False):
    """Preconditioned CG on every lane of (R_x + P + A' R_y^{-1} A) x = b,
    ops = (A, P, diag_r); returns (x, iterations per lane). Matches
    private.c:133-217, including the inf-norm convergence test and the
    ztr == 0 early exit. `active`: lanes to solve (the others return x0
    after no iteration). `read_first`: read the flags before the first
    iteration (worth it where a warm start may already be good enough).
    On a CUDA tensor the blocks of READ_EVERY iterations replay a CUDA
    graph (`_CGGraph`), except on a row-sharded operand, whose products
    take collectives; `eager` launches them one kernel at a time instead
    (for comparisons only: nothing in the solver sets it)."""
    eager = eager or rowshard.is_row_sharded(ops[0])
    if s is None:
        x = torch.zeros_like(b)
        r = b.clone()
    else:
        x = s.clone()
        r = b - _mat_vec(*ops, s)
    z = M * r
    done = _amax(r) < torch.clamp_min(tol, 1e-12)
    if active is not None:
        done = done | ~active
    its = torch.zeros(done.shape, dtype=torch.int64, device=b.device)
    state = (x, r, z, _dot(z, r), its, done)     # p starts at z
    if read_first and _all_done(done):
        return x, its
    graph = None
    k = 0
    while k < max_its:
        steps = min(READ_EVERY, max_its - k)
        if steps == READ_EVERY and b.is_cuda and not eager:
            if graph is None:
                graph = _graph(ops, M, tol, state)
                state = graph.state
            graph.graph.replay()
        else:
            for _ in range(steps):
                _cg_step(ops, M, tol, state)
        k += steps
        if _all_done(state[5]):
            break
    x, its = state[0], state[4]
    if graph is not None:       # the buffers stay with the cached graph
        x, its = x.clone(), its.clone()
    return x, its


def _solve_schur_mixed(mats, diag_r, derived, b, warm_start, tol,
                       max_its: int, active):
    """Float32 CG inner loop + float64 iterative refinement outer loop
    (the float32-state regime: float32 b, the residual formed in float32
    from the kernels' float32 output). The host reads once per pass
    whether any lane still needs one."""
    global host_reads, refine_passes
    M32, dr32 = derived
    f32, dtype = torch.float32, b.dtype
    if warm_start is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = warm_start
        r = b - _schur_matvec(mats, diag_r, x)
    its = torch.zeros(b.shape[:-1], dtype=torch.int64, device=b.device)

    for _ in range(MAX_REFINE):
        rn = _amax(r)
        need = (rn > tol) & active
        host_reads += 1
        if not bool(need.any()):
            break
        refine_passes += 1
        pass_tol = torch.maximum(tol, REFINE_PASS_RTOL * rn)
        d32, k = _pcg((mats.A32, mats.P32, dr32), M32, None, r.to(f32),
                      max_its, pass_tol.to(f32), active=need,
                      read_first=False)
        # a lane outside `need` gets d32 = 0: its x and r stay as they are
        x = x + d32.to(dtype)
        r = b - _schur_matvec(mats, diag_r, x)
        its = its + k
    return x, its


def solve(mats, diag_r, derived, rhs, warm_start=None, tol=None,
          active=None):
    """Solve the full (n+m) KKT system of one problem (rhs (n+m,)) or of
    each lane of a batch (rhs (B, n+m), diag_r (B, l), tol (B,)).
    rhs = [rx; ry]; returns (solution, CG iterations per lane, int64 on
    the device). tol defaults to CG_BEST_TOL; `active` (a batch: bool
    (B,) on the device) limits the iterations to those lanes, the others
    return values the caller discards.

    Reference: scs_solve_lin_sys, private.c:284-324."""
    A, P = mats.A, mats.P
    m, n = A.shape[-2:]
    r_y = diag_r[..., n:n + m]
    if tol is None:
        tol = config.CG_BEST_TOL
    tol = torch.as_tensor(tol, dtype=rhs.dtype, device=rhs.device)
    is_zero = _amax(rhs) <= 1e-12
    run = ~is_zero if active is None else active & ~is_zero
    rx = rhs[..., :n]
    ry = rhs[..., n:]
    # RHS build and y-recovery need float64-grade accuracy: on the mixed
    # path the double-single kernels give it
    if isinstance(derived, tuple):
        b = rx + _At_matvec(mats, ry / r_y)
        x, its = _solve_schur_mixed(mats, diag_r, derived, b, warm_start,
                                    tol, 10 * n, run)
        y = (_A_matvec(mats, x) - ry) / r_y
    else:
        b = rx + mv(mT(A), ry / r_y)
        x, its = _pcg((A, P, diag_r), derived, warm_start, b, 10 * n, tol,
                      active=run)
        y = (mv(A, x) - ry) / r_y
    sol = torch.cat([x, y], dim=-1).masked_fill(is_zero.unsqueeze(-1), 0.0)
    return sol, its.masked_fill(is_zero, 0)


solve_batched = solve
