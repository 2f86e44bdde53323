"""Linear-system backends (counterpart of `scs_tpu/linsys/__init__.py`).

Each backend module exports:
  precompute(A, P, n_zero, ds) -> loop-invariant operand cache (built
      through `prepare_operands`)
  derive(mats, diag_r, scale, mixed=False) -> factor; re-deriving is the
      diag-R update after an adaptive scale change
  solve(mats, diag_r, derived, rhs, warm_start, tol) -> (solution, iters)
  precompute_batched, derive_batched, solve_batched(..., active=None):
      the same for a stack of B problems (leading batch axis everywhere)
  enter_f32_state(mats, diag_r, derived), leave_f32_state(derived): the
      mixed factor between the batched float64- and float32-state regimes
  METHOD_NAME: human-readable backend name

Both backends are ported: `indirect` (Jacobi-preconditioned conjugate
gradient, the default `Settings.linsys`) and `direct` (dense
Schur-complement Cholesky). Each takes one problem or, through its
`*_batched` functions, a stack of problems of one shape, and brings its
own converters between the batched solvers' float64-state and
float32-state regimes (`enter_f32_state`, `leave_f32_state`).

Mixed precision: with `mixed` on, the inner work runs in float32 (the
direct backend's explicit float32 inverse, the indirect backend's CG on
the float32 shadows A32 and P32 that `Mats` carries) and float64
iterative refinement recovers full accuracy, with the refinement's
matvecs on the double-single kernels (`ops.dsmatvec`) where the operand
splits exist.
"""

from typing import Any, NamedTuple, Optional

import torch

from ..ops import rowshard, sparse
from . import direct, indirect


class Mats(NamedTuple):
    """Loop-invariant linear-system operands (A and P dense tensors or, for
    one problem, `ops.sparse.SparseA`s; A may be row-sharded,
    `ops.rowshard.RowShardedA`)."""

    A: torch.Tensor
    P: Optional[torch.Tensor]
    cache: Any                          # backend precompute output
    A32: Optional[torch.Tensor] = None  # float32 shadows (mixed indirect CG)
    P32: Optional[torch.Tensor] = None


BACKENDS = {"indirect": indirect, "direct": direct}


def get_backend(name: str):
    if name not in BACKENDS:
        raise ValueError(f"unknown linsys backend {name!r}; "
                         f"available: {sorted(BACKENDS)}")
    return BACKENDS[name]


def resolve_mixed(stg, device: torch.device) -> bool:
    """Resolve Settings.mixed_precision: auto (None) is on for float64 off
    the CPU, the JAX package's rule."""
    if stg.mixed_precision is not None:
        return bool(stg.mixed_precision)
    return stg.dtype == torch.float64 and torch.device(device).type != "cpu"


def resolve_ds_split(ds_split: Optional[bool], device, mixed: bool) -> bool:
    """Whether the mixed path builds the double-single operand splits that
    its matvecs read. On CUDA it always does, and they go to the kernels:
    asking for a mixed solve without them raises. On the CPU they are off
    unless `ds_split` is set, which makes the mixed path run the kernels'
    plain versions (the tests' way of driving the kernel path)."""
    on_cuda = torch.device(device).type == "cuda"
    if ds_split is None:
        return on_cuda
    if mixed and on_cuda and not ds_split:
        raise ValueError("ds_split=False: on CUDA the mixed path always runs "
                         "the double-single kernels; the switch is for CPU "
                         "tests")
    return bool(ds_split)


def resolve_fast_f32(stg, mixed: bool, ds: bool) -> bool:
    """Resolve Settings.fast_f32, the float32-state fast phase of the
    batched solvers: auto (None) follows the mixed flag, as in the JAX
    package, and explicit True needs mixed. The phase leans on the
    double-single kernels (K2, and K3 for its refinement residual), so it
    runs only where the operand splits exist (`ds`): auto resolves to off
    without them, and asking for it without them raises. The JAX package
    turns it on even where its kernels are missing (ROADMAP queue 3,
    R2)."""
    if not mixed:
        return False
    want = True if stg.fast_f32 is None else bool(stg.fast_f32)
    if want and not ds:
        if stg.fast_f32:
            raise ValueError(
                "Settings.fast_f32 needs the double-single operand splits: "
                "on CUDA every mixed solve has them; on the CPU pass "
                "ds_split=True")
        return False
    return want


def _shadows(backend, A, P, mixed: bool):
    """(A32, P32): the float32 shadows the mixed indirect CG runs on (the
    JAX package builds them for both backends; only indirect reads them).
    A SparseA's shadow is the SparseA of its float32 kernel tiles (each
    direction re-tiled at its chosen width, `SparseA.retiled`) and tails,
    a RowShardedA's the RowShardedA of its float32 rows."""
    if not (mixed and backend is indirect):
        return None, None

    def f32(M):
        if M is None:
            return None
        if sparse.is_sparse(M):
            return M.retiled(torch.float32)
        if rowshard.is_row_sharded(M):
            return M.astype(torch.float32)
        return M.to(torch.float32)

    return f32(A), f32(P)


def prepare_operands(backend, A, P, n_zero: int, mixed: bool,
                     ds_split: Optional[bool] = None):
    """(A32, P32, cache): the float32 shadows and the backend's
    loop-invariant operand cache (ProblemData.lin_cache), with the
    double-single splits where `resolve_ds_split` says so."""
    ds = resolve_ds_split(ds_split, A.device, mixed)
    return (*_shadows(backend, A, P, mixed),
            backend.precompute(A, P, n_zero, ds=mixed and ds))


def prepare_operands_batched(backend, A, P, n_zero: int, mixed: bool,
                             ds: bool):
    """`prepare_operands` for a (B, m, n) stack (the batched solvers);
    `ds` as resolved by `resolve_ds_split`."""
    return (*_shadows(backend, A, P, mixed),
            backend.precompute_batched(A, P, n_zero, ds=mixed and ds))
