"""Linear-system backends (counterpart of `scs_tpu/linsys/__init__.py`).

Each backend module exports:
  precompute(A, P, n_zero, ds) -> loop-invariant operand cache (built
      through `prepare_operands`)
  derive(mats, diag_r, scale, mixed=False) -> factor; re-deriving is the
      diag-R update after an adaptive scale change
  solve(mats, diag_r, derived, rhs, warm_start, tol) -> (solution, iters)
  METHOD_NAME: human-readable backend name

Only the direct backend (dense Schur-complement Cholesky) is ported; the
indirect one (Jacobi PCG) is ROADMAP queue 1, item 10.

Mixed precision: with `mixed` on, the factor is an explicit float32
inverse and float64 iterative refinement recovers full accuracy, with the
refinement's matvecs on the double-single kernel (`ops.dsmatvec`) where
the operand splits exist.
"""

from typing import Any, NamedTuple, Optional

import torch

from . import direct


class Mats(NamedTuple):
    """Loop-invariant linear-system operands."""

    A: torch.Tensor
    P: Optional[torch.Tensor]
    cache: Any               # backend precompute output


BACKENDS = {"direct": direct}


def get_backend(name: str):
    if name == "indirect":
        raise NotImplementedError(
            "linsys='indirect' (Jacobi PCG) is not ported yet (ROADMAP "
            "queue 1, item 10); use Settings(linsys='direct')")
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


def prepare_operands(backend, A, P, n_zero: int, mixed: bool,
                     ds_split: Optional[bool] = None):
    """The backend's loop-invariant operand cache (ProblemData.lin_cache).

    The double-single splits that the mixed path's matvecs read are built
    for a mixed solve on CUDA, where they go to the kernel. `ds_split`
    forces them on or off; on the CPU, on makes the mixed path run the
    kernel's plain version."""
    if ds_split is None:
        ds_split = A.device.type == "cuda"
    return backend.precompute(A, P, n_zero, ds=mixed and ds_split)
