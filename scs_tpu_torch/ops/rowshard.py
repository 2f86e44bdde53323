"""Row (model-axis) sharding of one problem's constraint matrix over the
ranks of a process group.

Counterpart of the row sharding of `scs_tpu/parallel/sharding.py`, which
places A's rows and b's entries on the mesh's "model" axis and leaves the
reductions that cross shards to the psums XLA inserts. Here only the
operand is sharded: each rank of the model group holds its rows A_r of A
(and, made from them, their double-single split and float32 shadow),
and every vector of the solve (x, y, s, u, v, b, c, D, E, ...) is whole
on every rank. The work that grows with the problem is A (m n a product,
m n^2 the Gram); the vectors are O(m + n).

Rows are cut in rank order into shards of per = ceil(m / k) rows for k
ranks (the last may hold fewer; each holds at least one). The places
that cross shards take one collective each (`parallel.collectives`):

  * A x: the local product A_r x, the pieces gathered (`matvec`);
  * A' z: the local product A_r' z_r over this rank's entries of z, the
    n-partials summed (`rmatvec`);
  * the Schur product A' W A x of the indirect backend's CG: each rank's
    A_r' W_r A_r x summed, one collective (`schur_matvec`);
  * setup: the Gram A'A + 999 A_z'A_z summed (`gram`; the n x n factor is
    replicated, a rank's zero-cone rows being those whose GLOBAL index
    is below z), the equilibration's column statistics reduced (max or
    sum), its row statistics gathered.

Everything else (the cone projections, Anderson acceleration, CG's dots,
the residual norms) runs unchanged on the replicated vectors, so a cone
block that straddles a shard edge needs nothing. Every host decision
reads replicated values, which `parallel.collectives` keeps equal on
every rank.

`RowShardedA` stands where a dense A does in the batched solvers (lanes
first: (B, m_r, n), so that lane compaction gathers its rows like any
tensor) and in the linear-system backends: `shape` is the global shape;
`A @ x`, `A.T`, the statistics `equilibrate` reads, `scale`, `astype`,
`to`. `RowShardedSplit` is the double-single split of A_r (or of A_r'):
its product runs K1 (one problem, float64 x), K2 (a batch, or float32
x), and, for A' z with float32 z (the float32-state phase), K3: each
rank's partial comes out as a float32 (hi, lo) pair, is composed in
float64, summed over ranks in float64 and rounded once, which keeps the
double-single accuracy that summing float32 partials would lose. On a
CUDA tensor these launch the kernels or raise; on the CPU they run the
kernels' plain versions. Dense operands only: the JAX package places
only dense arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from . import dsmatvec
from .dsmatvec import DsSplit


def _coll():
    # parallel/ imports the solvers, which import this module
    from ..parallel import collectives
    return collectives


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """M x for a matrix (p, q) or a stack (B, p, q)."""
    if M.dim() == 2:
        return M @ x
    return torch.matmul(M, x.unsqueeze(-1)).squeeze(-1)


def shard_bounds(m: int, k: int, r: int) -> tuple[int, int, int]:
    """(row0, rows, per): the first global row, the row count of rank r's
    shard of m rows over k ranks, and the rows a shard, ceil(m / k)."""
    per = -(-m // k)
    if per * (k - 1) >= m:
        raise ValueError(f"{m} rows cannot be cut into {k} non-empty "
                         f"shards of ceil({m} / {k}) = {per} rows")
    row0 = r * per
    return row0, min(per, m - row0), per


@dataclasses.dataclass(frozen=True)
class RowShardedA:
    """This rank's rows [row0, row0 + m_r) of a global (m, n) matrix, or of
    each of a stack (B, m, n), and the model group that holds the rest.
    `group` is a `torch.distributed` process group."""

    local: torch.Tensor       # (m_r, n) or (B, m_r, n)
    row0: int
    m: int
    per: int
    group: Any

    @property
    def shape(self) -> tuple:
        return (*self.local.shape[:-2], self.m, self.local.shape[-1])

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def m_local(self) -> int:
        return self.local.shape[-2]

    @property
    def T(self) -> "RowShardedAT":
        return RowShardedAT(self)

    # -- this rank's entries, and the group's reductions --

    def rows(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's entries of a global (..., m) vector."""
        return v[..., self.row0:self.row0 + self.m_local]

    def zero_rows(self, n_zero: int) -> int:
        """How many of this rank's rows lie in the zero cone (global row
        index below n_zero): its first ones."""
        return max(0, min(n_zero - self.row0, self.m_local))

    def gather(self, piece: torch.Tensor) -> torch.Tensor:
        """The global (..., m) vector from every rank's (..., m_r)."""
        return _coll().gather_rows(piece, self.group, self.per, self.m)

    def reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (or max) of every rank's `t`, in rank order."""
        return _coll().reduce(t, self.group, op)

    def any_rank(self, flag: bool) -> bool:
        """Whether `flag` holds on any rank of the group (a host decision
        that every rank must take alike)."""
        t = torch.tensor([float(flag)], device=self.device)
        return bool(self.reduce(t, "max").item())

    # -- products --

    def local_matvec(self, x: torch.Tensor) -> torch.Tensor:
        return _mv(self.local, x)

    def local_rmatvec(self, z: torch.Tensor) -> torch.Tensor:
        return _mv(self.local.transpose(-2, -1), self.rows(z))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A x (..., m) for x (..., n)."""
        return self.gather(self.local_matvec(x))

    def rmatvec(self, z: torch.Tensor) -> torch.Tensor:
        """A' z (..., n) for z (..., m)."""
        return self.reduce(self.local_rmatvec(z))

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)

    def local_schur(self, x: torch.Tensor, r_y: torch.Tensor):
        return _mv(self.local.transpose(-2, -1),
                   self.local_matvec(x) / self.rows(r_y))

    def schur_matvec(self, x: torch.Tensor, r_y: torch.Tensor):
        """A' R_y^{-1} A x, r_y (..., m) the diagonal of R_y: one
        collective."""
        return self.reduce(self.local_schur(x, r_y))

    # -- the Gram and the equilibration's statistics --

    def local_gram(self, n_zero: int = 0) -> torch.Tensor:
        L = self.local
        K = torch.matmul(L.transpose(-2, -1), L)
        nz = self.zero_rows(n_zero)
        if nz:
            Az = L[..., :nz, :]
            K = K + 999.0 * torch.matmul(Az.transpose(-2, -1), Az)
        return K

    def gram(self, n_zero: int = 0) -> torch.Tensor:
        """K = A'A + 999 A_z'A_z (the direct backend's), replicated."""
        return self.reduce(self.local_gram(n_zero))

    def local_diag_gram(self, n_zero: int = 0) -> torch.Tensor:
        L = self.local
        d = torch.sum(L * L, dim=-2)
        nz = self.zero_rows(n_zero)
        if nz:
            Az = L[..., :nz, :]
            d = d + 999.0 * torch.sum(Az * Az, dim=-2)
        return d

    def diag_gram(self, n_zero: int = 0) -> torch.Tensor:
        """diag(A'A + 999 A_z'A_z) (the indirect backend's
        preconditioner), replicated."""
        return self.reduce(self.local_diag_gram(n_zero))

    def row_abs_max(self) -> torch.Tensor:
        return self.gather(torch.amax(torch.abs(self.local), dim=-1))

    def row_sumsq(self) -> torch.Tensor:
        return self.gather(torch.sum(self.local * self.local, dim=-1))

    def col_abs_max(self) -> torch.Tensor:
        return self.reduce(torch.amax(torch.abs(self.local), dim=-2), "max")

    def col_sumsq(self) -> torch.Tensor:
        return self.reduce(torch.sum(self.local * self.local, dim=-2))

    def scale(self, D: torch.Tensor, E: torch.Tensor) -> "RowShardedA":
        """diag(D) A diag(E) for global D (..., m) and E (..., n)."""
        Dr = self.rows(D)
        return dataclasses.replace(
            self, local=Dr[..., :, None] * self.local * E[..., None, :])

    # -- types, devices, checks --

    def astype(self, dtype) -> "RowShardedA":
        return dataclasses.replace(self, local=self.local.to(dtype))

    def to(self, device) -> "RowShardedA":
        return dataclasses.replace(self, local=self.local.to(device))

    def with_batch(self) -> "RowShardedA":
        """The operand of one problem as a batch of one."""
        return dataclasses.replace(self, local=self.local[None])

    def split(self) -> tuple["RowShardedSplit", "RowShardedSplit"]:
        """The double-single splits of A_r and of A_r' (the mixed path's
        forward and transposed products)."""
        meta = dict(row0=self.row0, m=self.m, per=self.per, group=self.group)
        return (RowShardedSplit(dsmatvec.split_operand(self.local), False,
                                **meta),
                RowShardedSplit(dsmatvec.split_operand(
                    self.local.transpose(-2, -1)), True, **meta))


@dataclasses.dataclass(frozen=True)
class RowShardedAT:
    """A' of a RowShardedA: `@` is A' z."""

    parent: RowShardedA

    @property
    def shape(self) -> tuple:
        *lead, m, n = self.parent.shape
        return (*lead, n, m)

    @property
    def dtype(self) -> torch.dtype:
        return self.parent.dtype

    @property
    def T(self) -> RowShardedA:
        return self.parent

    def matvec(self, z: torch.Tensor) -> torch.Tensor:
        return self.parent.rmatvec(z)

    def __matmul__(self, z: torch.Tensor) -> torch.Tensor:
        return self.parent.rmatvec(z)


def is_row_sharded(A) -> bool:
    return isinstance(A, (RowShardedA, RowShardedAT))


def shard_rows(A: torch.Tensor, group, rank: Optional[int] = None,
               size: Optional[int] = None) -> RowShardedA:
    """Rank `rank`'s shard (default: this process's rank in `group`) of
    the rows of A (m, n), or of each of a stack (B, m, n), over the `size`
    ranks of `group` (default: its size). Only the shard's rows are kept
    (a contiguous copy). Dense operands only: anything else raises
    TypeError."""
    if not isinstance(A, torch.Tensor) or A.layout != torch.strided:
        raise TypeError(f"row sharding takes a dense (strided) tensor, got "
                        f"{type(A).__name__}; the JAX package places only "
                        f"dense arrays")
    k = dist.get_world_size(group) if size is None else size
    r = dist.get_rank(group) if rank is None else rank
    m = A.shape[-2]
    row0, rows, per = shard_bounds(m, k, r)
    return RowShardedA(A[..., row0:row0 + rows, :].contiguous(), row0, m,
                       per, group)


# ---- the double-single products on the shards ----


def _local_ds(split: DsSplit, x: torch.Tensor) -> torch.Tensor:
    """(hi + lo) x on this rank's block: K1 for one problem with float64
    x (a stack of one included), else K2 (y in x's type)."""
    if split.hi.dim() == 2:
        return dsmatvec.ds_matvec(split, x)
    if split.hi.shape[0] == 1 and x.dtype == torch.float64:
        one = DsSplit(split.hi[0], split.lo[0])
        return dsmatvec.ds_matvec(one, x[0].contiguous())[None]
    return dsmatvec.ds_matvec_batched(split, x)


def _local_ds_partial(split: DsSplit, z: torch.Tensor) -> torch.Tensor:
    """This rank's partial of A' z in float64: with float32 z (the
    float32-state phase) K3's float32 pair composed exactly, else K1 or
    K2."""
    if z.dtype == torch.float32:
        hi, lo = dsmatvec.ds_matvec_pair_batched(split, z)
        return hi.to(torch.float64) + lo.to(torch.float64)
    return _local_ds(split, z)


@dataclasses.dataclass(frozen=True)
class RowShardedSplit:
    """The (hi, lo) float32 split of this rank's rows A_r ((..., m_r, n),
    `transposed` False) or of A_r' ((..., n, m_r), True), and where the
    shard lies. `apply` is A x or A' z over the group."""

    split: DsSplit
    transposed: bool
    row0: int
    m: int
    per: int
    group: Any

    def _rows(self, v: torch.Tensor) -> torch.Tensor:
        return v[..., self.row0:self.row0 + self.split.hi.shape[-1]]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A x (gathered) or A' z (summed over the ranks in float64, then
        in z's type)."""
        if not self.transposed:
            return _coll().gather_rows(_local_ds(self.split, x), self.group,
                                       self.per, self.m)
        return self.sum64(x).to(x.dtype)

    def sum64(self, z: torch.Tensor) -> torch.Tensor:
        """A' z in float64 (this split transposed): every rank's partial
        (K3's pair composed, for float32 z) summed over the ranks."""
        return _coll().reduce(_local_ds_partial(self.split, self._rows(z)),
                              self.group)


def ds_schur_matvec(fwd: RowShardedSplit, bwd: RowShardedSplit,
                    x: torch.Tensor, r_y: torch.Tensor) -> torch.Tensor:
    """A' R_y^{-1} A x through the kernels, one collective: each rank's
    A_r x (K1 or K2, in x's type), divided by its entries of r_y, then
    A_r' of that (K1, K2, or K3 with float32 x), summed over the ranks in
    float64 and returned in x's type."""
    z = _local_ds(fwd.split, x) / bwd._rows(r_y)
    part = _local_ds_partial(bwd.split, z)
    return _coll().reduce(part, bwd.group).to(x.dtype)
