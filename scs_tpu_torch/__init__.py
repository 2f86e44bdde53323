"""scs_tpu_torch: the splitting conic solver of `scs_tpu`, on PyTorch and
CUDA for an NVIDIA H100.

Solves the quadratic cone program

    minimize    (1/2) x'Px + c'x
    subject to  Ax + s = b,  s in K

by Douglas-Rachford splitting on the homogeneous self-dual embedding, with
Anderson acceleration, Ruiz equilibration, adaptive dual scaling and
warm-startable b/c updates (SCS 3.2.11 semantics). It ports the JAX
package's solves of one problem (`Workspace`, `solve`) and of batches
(`scs_tpu_torch.parallel`) for every cone of the JAX package: zero,
nonnegative, box, second-order, PSD, complex PSD, exponential, power, and
the spectral cones (log-determinant, nuclear-norm, ell1-norm and
sum-of-k-largest-eigenvalues), through the indirect (Jacobi-preconditioned
CG, the default) or the direct (Cholesky) linear-system backend, in pure
and mixed precision. A and P may be dense tensors or sparse operands
(`ops.sparse.SparseA`, blocked-ELL tiles with dense row and column
tails, built by `ops.sparse.sparse_from_scipy`), on both backends.
Problems come also from SCS's binary files (`io.read_scs_data`, or
`python -m scs_tpu_torch.run_from_file FILE`) and from scs-python's data
and cone dicts (`compat.SCS`, `compat.solve`); a solve can print SCS's
log, write a per-iteration CSV trace, time its phases, checkpoint and
resume, and track a low-rank PSD projection (`Settings.psd_rank`).
Gradients flow through a solve, one problem or a batch, in reverse and in
forward mode (`make_diff_solver`, `diff.py`: implicit differentiation of
the solver's fixed point as a `torch.autograd.Function`), and a batch
splits over processes, one a card (`parallel.multihost`,
`parallel.make_mesh`, `parallel.shard_problem_batch`: `torch.distributed`,
NCCL between cards, gloo on the CPU), and so do one problem's rows of A
over a mesh's "model" dimension (`shard_rows=True`, `ops.rowshard`).
`scs_tpu_torch.examples` holds the
JAX package's examples.
The double-single matvec that the mixed path runs is a hand-written CUDA
kernel (`ops/dsmatvec.py`, `csrc/dsmatvec.cu`); so are the double-single
matmul (`ops/dsmatmul.py`) and the roofline probe's read kernel
(`ops/roofline.py`).

Entry points solve on the card (`device="cuda"`) unless the caller passes
`device="cpu"`.
"""

import torch

# The mixed path's float32 inverse-apply must be true float32: no TF32 in
# matrix products or convolutions (the JAX package pins "highest" matmul
# precision for the same reason).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import config  # noqa: E402
from .api import Workspace, solve  # noqa: E402
from .diff import make_diff_solver  # noqa: E402
from .types import (ConeData, ConeSpec, Info, Problem,  # noqa: E402
                    Settings, Solution, problem_from_csc)

__version__ = config.VERSION


def scs_version() -> str:
    """The version string (scs_version(), src/scs_version.c:1-13)."""
    return __version__


__all__ = [
    "Workspace", "solve", "Problem", "ConeSpec", "ConeData", "Settings",
    "Solution", "Info", "config", "__version__", "problem_from_csc",
    "scs_version", "make_diff_solver",
]
