"""Matrix-vector products shared by the linear-system backends and the
batched iteration: one problem (M (p, q), x (q,)) or a batch (M (B, p, q),
x (B, q)), through the double-single kernels where the operand's split is
given."""

from __future__ import annotations

import torch

from ..ops import dsmatvec


def bmv(M, x):
    """Batched matrix-vector product: (B, p, q) @ (B, q) -> (B, p)."""
    return torch.matmul(M, x.unsqueeze(-1)).squeeze(-1)


def mv(M, x):
    """M x for one matrix (p, q) or a stack of them (B, p, q)."""
    return M @ x if M.dim() == 2 else bmv(M, x)


def ds_mv(split, x):
    """(hi + lo) x through K1 (one problem) or K2 (a batch)."""
    if split.hi.dim() == 2:
        return dsmatvec.ds_matvec(split, x)
    return dsmatvec.ds_matvec_batched(split, x)
