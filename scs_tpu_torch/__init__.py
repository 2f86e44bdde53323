"""scs_tpu_torch: the splitting conic solver of `scs_tpu`, on PyTorch and
CUDA for an NVIDIA H100.

Solves the quadratic cone program

    minimize    (1/2) x'Px + c'x
    subject to  Ax + s = b,  s in K

by Douglas-Rachford splitting on the homogeneous self-dual embedding, with
Anderson acceleration, Ruiz equilibration, adaptive dual scaling and
warm-startable b/c updates (SCS 3.2.11 semantics). It ports the JAX
package's solves of one problem (`Workspace`, `solve`) and of batches
(`scs_tpu_torch.parallel`) for the zero, nonnegative, box, second-order,
exponential and power cones, through the indirect (Jacobi-preconditioned
CG, the default) or the direct (Cholesky) linear-system backend, in pure
and mixed precision.
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
from .types import (ConeData, ConeSpec, Info, Problem,  # noqa: E402
                    Settings, Solution)

__version__ = config.VERSION

__all__ = [
    "Workspace", "solve", "Problem", "ConeSpec", "ConeData", "Settings",
    "Solution", "Info", "config", "__version__",
]
