"""Matrix-vector products shared by the linear-system backends and the
batched iteration: one problem (M (p, q) or a sparse operand
`ops.sparse.SparseA`, x (q,)) or a batch (M (B, p, q), x (B, q)), through
the double-single kernels where the operand's split is given. A
row-sharded operand (`ops.rowshard.RowShardedA`, its transpose, or its
split `RowShardedSplit`), one problem or a batch, runs its local product
and the model group's collective."""

from __future__ import annotations

import torch

from ..ops import dsmatvec, rowshard, sparse


def bmv(M, x):
    """Batched matrix-vector product: (B, p, q) @ (B, q) -> (B, p)."""
    return torch.matmul(M, x.unsqueeze(-1)).squeeze(-1)


def mv(M, x):
    """M x for one matrix (p, q), a SparseA, a row-sharded operand or a
    stack of matrices (B, p, q)."""
    if rowshard.is_row_sharded(M):
        return M.matvec(x)
    return M @ x if sparse.is_sparse(M) or M.dim() == 2 else bmv(M, x)


def mT(M):
    """The transpose of one matrix, a SparseA, a row-sharded operand or
    each of a stack."""
    if sparse.is_sparse(M) or rowshard.is_row_sharded(M):
        return M.T
    return M.transpose(-2, -1)


def ds_mv(split, x):
    """(hi + lo) x through K1 (one problem) or K2 (a batch); a sparse
    operand's split (`ops.sparse.DsSparse`) through K2s and K1 for its
    tails; a row-sharded split (`ops.rowshard.RowShardedSplit`) through
    K1, K2 or K3 on this rank's block and the group's collective."""
    if isinstance(split, rowshard.RowShardedSplit):
        return split.apply(x)
    if isinstance(split, sparse.DsSparse):
        return sparse.ds_sparse_matvec(split, x)
    if split.hi.dim() == 2:
        return dsmatvec.ds_matvec(split, x)
    return dsmatvec.ds_matvec_batched(split, x)
