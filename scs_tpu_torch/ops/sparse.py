"""Blocked-ELL sparse operator: a constraint matrix stored in O(nnz blocks).

Counterpart of `scs_tpu/ops/sparse.py`, with the same names. The matrix
is tiled into (bm x bn) blocks and only the nonzero blocks are kept, as
dense tiles (ELL by block-row):

  data:  (nbr, bm, kmax*bn) the <= kmax nonzero tiles of each block-row,
         side by side, padded with zero tiles
  idx:   (nbr, kmax) int32  the column block of each tile slot (padding
         slots point at block 0 and hold a zero tile)
  count: (nbr,) int32       the slots of each block-row that hold a tile
         (they come first; the port's addition, made once with the
         operand)

A product y = A x reads only the tiles below the count. On a CUDA tensor
it is kernel K2s (`csrc/ellmatvec.cu`, launched by `ops/ellmatvec.py`): a
warp a block-row reads x through the tile indices, so no gathered copy of
x is made. Its kinds: the (hi, lo) float32 pair with float64 x (the mixed
path's float64-accurate apply, `ds_ell_matvec`, which replaces the TPU's
K2 on a gathered x), float32 (the indirect CG's shadow) and float64 (the
pure path), the last two through `ell_matvec`. On a CPU tensor the plain
versions run: the gather of x per block-row, the padded slots masked out,
and a batched product (`ell_matvec_plain`, `ds_ell_matvec_plain`). Any
other device raises.

The kernels' operands are re-tiled: `choose_width` picks from the tiles'
fill the widest column-block width (bn / 1, 2, 4 or 8) whose tiles store
at most RETILE_SLACK times the elements of the narrowest, and
`kernel_tiles` cuts each tile into subtiles of that width and keeps those
that hold a nonzero, once, at setup, on the operand's device. The
double-single split (`ds_split_ell`) and the float32 shadow
(`SparseA.retiled`) are made from those tiles; the SparseA keeps the JAX
package's tiles bit for bit (the Gram, the column sums, equilibration and
the pure path read them). `SparseA` stores the transpose (A') too, and
optional dense row and column tails, so that a few dense rows do not pad
every block-row (the reference's CSC never pads: linsys/csparse.c).

Sums run in a fixed order, so that the card repeats a solve bit for bit
(no `index_add_` or `scatter_add`, whose atomics add in no fixed order):
a product row is summed by one warp in a fixed order; a column sum is a
padded gather over the tiles sorted by column block
(`cones/segments.segment_sum`); the Gram's block pairs are summed by one
contraction over a padded gather of their tile pairs, chunk by chunk of
block-rows in order; a scatter writes each target once (the tails' index
sets have no repeats; `ell_to_dense` adds one tile slot at a time).

The constructors (`ell_from_coo`, `sparse_from_scipy`, `sparse_from_dense`,
`sparse_to_csc`) are host-side numpy, copied from the JAX package. The
index tensors of the tails are made once, on the operand's device, when
the operand is built or moved (`to`): a CUDA graph that applies the
operand reads them by address.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..cones.segments import segment_sum
from . import dsmatvec, ellmatvec
from .dsmatvec import DsSplit

# a kernel operand's width is the widest whose tiles store at most this
# many times the elements of the narrowest width's (`choose_width`)
RETILE_SLACK = 1.1
# the narrowest width `choose_width` considers (the kernel's fast path
# takes 16 to 128)
MIN_WIDTH = 16


@dataclasses.dataclass(frozen=True)
class BlockedEll:
    """One direction of a blocked-ELL matrix (see the module docstring).
    `count` is made from the tiles where it is not given: one past the
    last slot that holds a nonzero, for each block-row."""

    data: torch.Tensor       # (nbr, bm, kmax*bn)
    idx: torch.Tensor        # (nbr, kmax) int32, on data's device
    m: int                   # logical rows
    n: int                   # logical columns
    bm: int
    bn: int
    kmax: int
    count: Optional[torch.Tensor] = None    # (nbr,) int32, on data's device

    def __post_init__(self):
        if self.count is None:
            nz = _slot_nonzero(self.data, self.bm, self.bn)
            slot = torch.arange(1, self.kmax + 1, device=nz.device)
            object.__setattr__(self, "count", torch.amax(
                nz * slot, dim=1).to(torch.int32))

    @property
    def nbr(self) -> int:
        return -(-self.m // self.bm)

    @property
    def ncb(self) -> int:
        return -(-self.n // self.bn)

    def nnz_stored(self) -> int:
        return self.data.numel()

    def to(self, device) -> "BlockedEll":
        return dataclasses.replace(self, data=self.data.to(device),
                                   idx=self.idx.to(device),
                                   count=self.count.to(device))

    def astype(self, dtype) -> "BlockedEll":
        return dataclasses.replace(self, data=self.data.to(dtype))


def _slot_nonzero(data: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """(nbr, slots) bool: whether each bn-wide tile slot holds a nonzero."""
    nbr = data.shape[0]
    return torch.any(data.reshape(nbr, bm, -1, bn) != 0, dim=3).any(dim=1)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def ell_from_coo(rows, cols, vals, m: int, n: int, bm: int = 8,
                 bn: int = 128, dtype=torch.float64,
                 device="cpu") -> BlockedEll:
    """Host-side construction from COO triplets (unique coordinates)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    nbr = -(-max(m, 1) // bm)
    br = rows // bm
    bc = cols // bn
    # unique nonzero blocks, and each entry's slot within its block-row
    blk = br * (1 << 32) + bc
    uniq, entry_u = np.unique(blk, return_inverse=True)
    u_br = (uniq >> 32).astype(np.int64)
    u_bc = (uniq & 0xFFFFFFFF).astype(np.int64)
    order = np.argsort(u_br, kind="stable")
    slot_sorted = np.arange(uniq.size) - np.searchsorted(
        u_br[order], u_br[order])
    slot = np.empty(uniq.size, np.int64)
    slot[order] = slot_sorted
    counts = np.bincount(u_br, minlength=nbr)
    kmax = max(int(counts.max()) if counts.size else 0, 1)

    data = np.zeros((nbr, bm, kmax * bn), np.float64)
    idx = np.zeros((nbr, kmax), np.int32)
    idx[u_br, slot] = u_bc.astype(np.int32)
    e_slot = slot[entry_u.reshape(-1)]
    data[br, rows % bm, e_slot * bn + (cols % bn)] = vals
    return BlockedEll(
        data=torch.as_tensor(data, dtype=_torch_dtype(dtype), device=device),
        idx=torch.as_tensor(idx, device=device),
        m=m, n=n, bm=bm, bn=bn, kmax=kmax,
        count=torch.as_tensor(counts.astype(np.int32), device=device))


def _gather_x(ell: BlockedEll, x: torch.Tensor) -> torch.Tensor:
    """x (n,) or (n, k) -> the gathered input of each block-row,
    (nbr, kmax*bn) or (nbr, kmax*bn, k)."""
    pad = ell.ncb * ell.bn - ell.n
    tail = x.shape[1:]
    xp = F.pad(x, (0, 0) * len(tail) + (0, pad)) if pad else x
    xg = xp.reshape((ell.ncb, ell.bn) + tail).index_select(
        0, ell.idx.reshape(-1))
    return xg.reshape((ell.idx.shape[0], ell.kmax * ell.bn) + tail)


def _real_tiles(data: torch.Tensor, count: torch.Tensor, bm: int,
                bn: int) -> torch.Tensor:
    """The tiles with every slot past its block-row's count set to zero,
    whatever it holds (the plain versions read no padding either)."""
    d = data.reshape(data.shape[0], bm, -1, bn)
    real = torch.arange(d.shape[2], device=d.device) < count[:, None]
    return torch.where(real[:, None, :, None], d, 0.0).reshape(data.shape)


def ell_matvec_plain(ell: BlockedEll, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K2s (float32 or float64): the gathered x of each
    block-row times its real tiles, in the data's dtype."""
    xg = _gather_x(ell, x.to(ell.data.dtype))
    d = _real_tiles(ell.data, ell.count, ell.bm, ell.bn)
    return torch.bmm(d, xg.unsqueeze(-1)).reshape(-1)[: ell.m]


def ell_matvec(ell: BlockedEll, x: torch.Tensor) -> torch.Tensor:
    """y = A x in the data's dtype (float32 or float64): kernel K2s on a
    CUDA tensor, its plain version on a CPU tensor."""
    x = x.to(ell.data.dtype)
    if dsmatvec._batched_device("ell_matvec", x) == "cpu":
        return ell_matvec_plain(ell, x)
    kind = {torch.float32: "f32", torch.float64: "f64"}.get(ell.data.dtype)
    if kind is None:
        raise TypeError(f"ell_matvec's kernel takes float32 or float64 "
                        f"tiles, not {ell.data.dtype}")
    return ellmatvec.launch(kind, ell.data, None, ell.idx, ell.count,
                            x.contiguous(), ell.m, ell.n, ell.bm, ell.bn,
                            ell.kmax)


def ell_matmat(ell: BlockedEll, X: torch.Tensor) -> torch.Tensor:
    """Y (m, k) = A X for X (n, k) (the convexity probe's LOBPCG and the
    Gram's tail terms)."""
    Xg = _gather_x(ell, X.to(ell.data.dtype))
    return torch.bmm(ell.data, Xg).reshape(-1, X.shape[1])[: ell.m]


def ell_diagonal(ell: BlockedEll) -> torch.Tensor:
    """diag(A) (min(m, n),): row i's entry lies in block-row i // bm at
    in-block row i % bm, in the tile slot (if any) that points at column
    block i // bn, at lane i % bn."""
    nd = min(ell.m, ell.n)
    dev = ell.data.device
    rows = torch.arange(nd, device=dev)
    r = rows // ell.bm
    d = ell.data[r, rows % ell.bm].reshape(nd, ell.kmax, ell.bn)
    off = (rows % ell.bn).reshape(nd, 1, 1).expand(nd, ell.kmax, 1)
    picked = d.gather(2, off)[:, :, 0]
    mask = ell.idx[r].long() == (rows // ell.bn)[:, None]
    return torch.where(mask, picked, 0.0).sum(1)


def ell_row_abs_max(ell: BlockedEll) -> torch.Tensor:
    return torch.amax(torch.abs(ell.data), dim=2).reshape(-1)[: ell.m]


def ell_row_sumsq(ell: BlockedEll) -> torch.Tensor:
    return torch.sum(ell.data * ell.data, dim=2).reshape(-1)[: ell.m]


def _row_pad(ell: BlockedEll, v: torch.Tensor, fill: float) -> torch.Tensor:
    """v (m,) padded to (nbr, bm) with `fill`."""
    return F.pad(v, (0, ell.nbr * ell.bm - ell.m), value=fill).reshape(
        ell.nbr, ell.bm)


def ell_col_sumsq(ell: BlockedEll, row_weights=None) -> torch.Tensor:
    """sum_r w_r A_rc^2 for every column c (the Jacobi preconditioner's
    diagonal). The tiles' column sums are summed per column block in a
    fixed order: the tile slots sorted by block (a stable sort) and
    segment-summed by a padded gather."""
    d2 = ell.data * ell.data
    if row_weights is not None:
        d2 = d2 * _row_pad(ell, row_weights.to(d2.dtype), 0.0)[:, :, None]
    t = torch.sum(d2, dim=1).reshape(-1, ell.bn)      # (nbr*kmax, bn)
    ids = ell.idx.reshape(-1).long()
    order = torch.argsort(ids, stable=True)
    sizes = tuple(torch.bincount(ids, minlength=ell.ncb).tolist())
    out = segment_sum(t.index_select(0, order).T, sizes)   # (bn, ncb)
    return out.T.reshape(-1)[: ell.n]


def ell_to_dense(ell: BlockedEll) -> torch.Tensor:
    """The dense (m, n) matrix. One tile slot at a time: within a slot
    every block-row writes one block of its own, so no target repeats in
    a scatter, and padding slots add exact zeros."""
    nbr, bm, bn, ncb = ell.nbr, ell.bm, ell.bn, ell.ncb
    d = ell.data.reshape(nbr, bm, ell.kmax, bn)
    full = torch.zeros(nbr, ncb, bm, bn, dtype=d.dtype, device=d.device)
    r = torch.arange(nbr, device=d.device)
    for a in range(ell.kmax):
        c = ell.idx[:, a].long()
        full[r, c] = full[r, c] + d[:, :, a, :]
    dense = full.permute(0, 2, 1, 3).reshape(nbr * bm, ncb * bn)
    return dense[: ell.m, : ell.n]


def _gram_plan(idx: np.ndarray, ncb: int, chunk_rows: int):
    """For each chunk of `chunk_rows` block-rows, in order: the block-pair
    ids it touches (unique) and, for each, the flat tile slots (r*kmax +
    a, r*kmax + b) of its contributions, padded with the index of one
    appended zero tile."""
    nbr, kmax = idx.shape
    zero = nbr * kmax
    plan = []
    for r0 in range(0, nbr, chunk_rows):
        ic = idx[r0:r0 + chunk_rows].astype(np.int64)
        rr = np.arange(r0, r0 + ic.shape[0])[:, None, None]
        a = np.arange(kmax)[None, :, None]
        b = np.arange(kmax)[None, None, :]
        pid = (ic[:, :, None] * ncb + ic[:, None, :]).reshape(-1)
        ta = np.broadcast_to(rr * kmax + a, (ic.shape[0], kmax, kmax))
        tb = np.broadcast_to(rr * kmax + b, (ic.shape[0], kmax, kmax))
        uniq, inv = np.unique(pid, return_inverse=True)
        inv = inv.reshape(-1)
        order = np.argsort(inv, kind="stable")
        counts = np.bincount(inv, minlength=uniq.size)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = np.arange(pid.size) - starts[inv[order]]
        ia = np.full((uniq.size, int(counts.max())), zero, np.int64)
        ib = ia.copy()
        ia[inv[order], pos] = ta.reshape(-1)[order]
        ib[inv[order], pos] = tb.reshape(-1)[order]
        plan.append((uniq, ia, ib))
    return plan


def ell_gram(ell: BlockedEll, row_weight=None,
             chunk_rows: int = 0) -> torch.Tensor:
    """Dense (n, n) Gram K = A' diag(w) A straight from the tiles, never
    forming the dense A: for block-row r and tile slots (a, b) the block
    data[r,:,a,:]' W_r data[r,:,b,:] lands at block (idx[r,a], idx[r,b]).

    Chunk by chunk of block-rows (as the JAX package's scan, ~32 MB of
    tiles a chunk by default), the contributions of each block pair are
    gathered into one padded row and summed by one contraction over
    (contribution, row); the chunks add into the block grid in order. The
    JAX package's segment-sum over pair ids is an atomic scatter on the
    card; this order is fixed. Reads the index to the host once (setup)."""
    nbr, bm, bn, kmax, ncb = ell.nbr, ell.bm, ell.bn, ell.kmax, ell.ncb
    d = ell.data.reshape(nbr, bm, kmax, bn)
    dw = d if row_weight is None else d * _row_pad(
        ell, row_weight.to(d.dtype), 0.0)[:, :, None, None]
    zero = d.new_zeros(1, bm, bn)

    def tiles(t):
        return torch.cat([t.permute(0, 2, 1, 3).reshape(-1, bm, bn), zero])

    T = tiles(d)
    Tw = T if row_weight is None else tiles(dw)
    if chunk_rows <= 0:
        chunk_rows = max(1, (1 << 22) // max(kmax * kmax * bn * bn, 1))
    Kb = d.new_zeros(ncb * ncb, bn, bn)
    for uniq, ia, ib in _gram_plan(ell.idx.cpu().numpy(), ncb, chunk_rows):
        u = torch.as_tensor(uniq, device=d.device)
        ia = torch.as_tensor(ia, device=d.device)
        ib = torch.as_tensor(ib, device=d.device)
        contrib = torch.einsum("uwmx,uwmy->uxy", Tw[ia], T[ib])
        Kb[u] = Kb[u] + contrib
    K = Kb.reshape(ncb, ncb, bn, bn).permute(0, 2, 1, 3).reshape(
        ncb * bn, ncb * bn)
    return K[: ell.n, : ell.n]


def ell_scale(ell: BlockedEll, D, E) -> BlockedEll:
    """The structure of diag(D) A diag(E) (same pattern)."""
    Dp = _row_pad(ell, D, 1.0)
    Ep = F.pad(E, (0, ell.ncb * ell.bn - ell.n), value=1.0)
    Eg = Ep.reshape(ell.ncb, ell.bn).index_select(
        0, ell.idx.reshape(-1)).reshape(ell.nbr, ell.kmax * ell.bn)
    data = ell.data * Dp[:, :, None] * Eg[:, None, :]
    return dataclasses.replace(ell, data=data)


def _widths(bn: int) -> list:
    """The widths `choose_width` considers, widest first: bn / 1, 2, 4
    and 8 that are multiples of MIN_WIDTH."""
    return [bn // s for s in (1, 2, 4, 8)
            if bn % s == 0 and (bn // s) % MIN_WIDTH == 0]


def choose_width(ell: BlockedEll) -> int:
    """The column-block width of ell's kernel operand: the widest of
    `_widths(ell.bn)` whose subtiles that hold a nonzero store at most
    RETILE_SLACK times the elements of the narrowest's (a narrower tile
    reads fewer stored zeros, a wider one takes fewer steps a block-row).
    ell.bn where no narrower width divides it. Reads one count a width to
    the host (setup)."""
    cands = _widths(ell.bn)
    if len(cands) < 2:
        return ell.bn
    w0 = cands[-1]
    nz = _live_subtiles(ell, w0)
    stored = {w: w * int(nz.reshape(nz.shape[0], -1, w // w0).any(2).sum())
              for w in cands}
    least = min(stored.values())
    return next(w for w in cands if stored[w] <= RETILE_SLACK * least)


def _live_subtiles(ell: BlockedEll, w: int) -> torch.Tensor:
    """(nbr, kmax * bn / w) bool: the w-wide subtiles below the count that
    hold a nonzero."""
    s = ell.bn // w
    nz = _slot_nonzero(ell.data, ell.bm, w)
    slot = torch.arange(nz.shape[1], device=nz.device) // s
    return nz & (slot < ell.count[:, None])


def ell_retile(ell: BlockedEll, w: int) -> BlockedEll:
    """The same matrix in tiles of width w (a divisor of ell.bn): each tile
    cut into ell.bn / w subtiles, those below the count that hold a
    nonzero kept in their order (slot, then column), on ell's device; kmax
    the most a block-row keeps. Reads kmax to the host (setup)."""
    s = ell.bn // w
    nbr, bm = ell.data.shape[0], ell.bm
    live = _live_subtiles(ell, w)
    count = live.sum(1, dtype=torch.int32)
    kmax = max(int(count.max()), 1)
    r, j = live.nonzero(as_tuple=True)
    slot = (live.cumsum(1) - 1)[r, j]
    idx = torch.zeros(nbr, kmax, dtype=torch.int32, device=live.device)
    idx[r, slot] = (ell.idx[r, j // s] * s + j % s).to(torch.int32)
    d = ell.data.reshape(nbr, bm, -1, w)
    data = d.new_zeros(nbr, bm, kmax, w)
    data[r, :, slot, :] = d[r, :, j, :]
    return BlockedEll(data=data.reshape(nbr, bm, kmax * w), idx=idx,
                      m=ell.m, n=ell.n, bm=bm, bn=w, kmax=kmax, count=count)


def kernel_tiles(ell: BlockedEll) -> BlockedEll:
    """ell's kernel operand: ell re-tiled at `choose_width(ell)`, or ell
    itself where that is its own width."""
    w = choose_width(ell)
    return ell if w == ell.bn else ell_retile(ell, w)


# ---------------------------------------------------------------------------
# the two-sided operator


def _index(ix: tuple, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ix, np.int64).reshape(-1),
                           device=device)


@dataclasses.dataclass(frozen=True)
class SparseA:
    """A sparse constraint matrix with both directions stored, plus
    optional dense row and column tails: A = S + rows + cols, S
    blocked-ELL, the dense rows `rows_val` (dr, n) at the row indices
    `rows_idx`, the dense columns `cols_val` (m, dc) at `cols_idx`. An
    entry lies in exactly one part (rows extracted first, then columns
    from the rest), so additive combinations are exact.

    Acts like the dense A wherever the solver touches it: `.shape`,
    `.dtype`, `.device`, `A @ x` (x (n,) or (n, k)), `A.T`, `.astype`,
    `.to`. `rows_index`/`cols_index` are the index tuples as int64
    tensors on the operand's device, made once (by `sparse_from_*`, `to`
    or here where not given)."""

    fwd: BlockedEll                        # S
    bwd: BlockedEll                        # S'
    rows_val: Optional[torch.Tensor] = None
    cols_val: Optional[torch.Tensor] = None
    rows_idx: tuple = ()
    cols_idx: tuple = ()
    rows_index: Optional[torch.Tensor] = None
    cols_index: Optional[torch.Tensor] = None

    def __post_init__(self):
        dev = self.fwd.data.device
        if self.rows_index is None:
            object.__setattr__(self, "rows_index", _index(self.rows_idx, dev))
        if self.cols_index is None:
            object.__setattr__(self, "cols_index", _index(self.cols_idx, dev))

    @property
    def shape(self) -> tuple:
        return (self.fwd.m, self.fwd.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.fwd.data.dtype

    @property
    def device(self) -> torch.device:
        return self.fwd.data.device

    @property
    def T(self) -> "SparseA":
        return SparseA(
            fwd=self.bwd, bwd=self.fwd,
            rows_val=None if self.cols_val is None else self.cols_val.T,
            cols_val=None if self.rows_val is None else self.rows_val.T,
            rows_idx=self.cols_idx, cols_idx=self.rows_idx,
            rows_index=self.cols_index, cols_index=self.rows_index)

    def tensors(self) -> tuple:
        """Every tensor the operand's applies read (a CUDA graph's cache
        key names them all)."""
        return tuple(t for t in (
            self.fwd.data, self.fwd.idx, self.bwd.data, self.bwd.idx,
            self.rows_val, self.cols_val, self.rows_index, self.cols_index,
            self.fwd.count, self.bwd.count)
            if t is not None)

    def _add_tails(self, y, x):
        """y += rows x (at rows_idx) + cols x[cols_idx], in place; x (n,)
        or (n, k)."""
        if self.rows_val is not None:
            y[self.rows_index] += self.rows_val @ x.to(self.dtype)
        if self.cols_val is not None:
            y += self.cols_val @ x.index_select(0, self.cols_index).to(
                self.dtype)
        return y

    def __matmul__(self, x):
        if x.dim() == 2:
            return self._add_tails(ell_matmat(self.fwd, x), x)
        return self._add_tails(ell_matvec(self.fwd, x), x)

    def abs_max(self) -> torch.Tensor:
        r = torch.amax(torch.abs(self.fwd.data))
        for t in (self.rows_val, self.cols_val):
            if t is not None:
                r = torch.maximum(r, torch.amax(torch.abs(t)))
        return r

    def diagonal(self) -> torch.Tensor:
        d = ell_diagonal(self.fwd)
        nd = d.shape[0]
        dev = d.device
        if self.rows_val is not None:
            ri = np.asarray(self.rows_idx, np.int64)
            keep = np.nonzero(ri < nd)[0]
            at = torch.as_tensor(ri[keep], device=dev)
            d[at] += self.rows_val[torch.as_tensor(keep, device=dev), at]
        if self.cols_val is not None:
            ci = np.asarray(self.cols_idx, np.int64)
            keep = np.nonzero(ci < nd)[0]
            at = torch.as_tensor(ci[keep], device=dev)
            d[at] += self.cols_val[at, torch.as_tensor(keep, device=dev)]
        return d

    # -- reductions over the three parts --

    def row_abs_max(self) -> torch.Tensor:
        r = ell_row_abs_max(self.fwd)
        if self.rows_val is not None:
            ri = self.rows_index
            r[ri] = torch.maximum(r[ri],
                                  torch.amax(torch.abs(self.rows_val), dim=1))
        if self.cols_val is not None:
            r = torch.maximum(r, torch.amax(torch.abs(self.cols_val), dim=1))
        return r

    def col_abs_max(self) -> torch.Tensor:
        return self.T.row_abs_max()

    def row_sumsq(self) -> torch.Tensor:
        r = ell_row_sumsq(self.fwd)
        if self.rows_val is not None:
            r[self.rows_index] += torch.sum(self.rows_val * self.rows_val,
                                            dim=1)
        if self.cols_val is not None:
            r = r + torch.sum(self.cols_val * self.cols_val, dim=1)
        return r

    def col_sumsq(self, row_weights=None) -> torch.Tensor:
        """sum_r w_r A_rc^2 for every column c."""
        r = ell_col_sumsq(self.fwd, row_weights)
        if self.rows_val is not None:
            rv2 = self.rows_val * self.rows_val
            if row_weights is not None:
                rv2 = rv2 * row_weights[self.rows_index][:, None]
            r = r + torch.sum(rv2, dim=0)
        if self.cols_val is not None:
            cv2 = self.cols_val * self.cols_val
            if row_weights is not None:
                cv2 = cv2 * row_weights[:, None]
            r[self.cols_index] += torch.sum(cv2, dim=0)
        return r

    def scale(self, D, E) -> "SparseA":
        """diag(D) A diag(E), every part, both directions."""
        rv, cv = self.rows_val, self.cols_val
        if rv is not None:
            rv = rv * D[self.rows_index][:, None] * E[None, :]
        if cv is not None:
            cv = cv * D[:, None] * E[self.cols_index][None, :]
        return dataclasses.replace(self, fwd=ell_scale(self.fwd, D, E),
                                   bwd=ell_scale(self.bwd, E, D),
                                   rows_val=rv, cols_val=cv)

    def todense(self) -> torch.Tensor:
        """The dense (m, n) matrix (all three parts)."""
        D = ell_to_dense(self.fwd)
        if self.rows_val is not None:
            D[self.rows_index] += self.rows_val
        if self.cols_val is not None:
            D[:, self.cols_index] += self.cols_val
        return D

    def astype(self, dtype) -> "SparseA":
        return dataclasses.replace(
            self, fwd=self.fwd.astype(dtype), bwd=self.bwd.astype(dtype),
            rows_val=None if self.rows_val is None
            else self.rows_val.to(dtype),
            cols_val=None if self.cols_val is None
            else self.cols_val.to(dtype))

    def retiled(self, dtype) -> "SparseA":
        """A in `dtype` with each direction's tiles its kernel operand
        (`kernel_tiles`): the float32 shadow that the indirect CG
        multiplies by. Only its products read it."""
        def cast(t):
            return None if t is None else t.to(dtype)
        return dataclasses.replace(
            self, fwd=kernel_tiles(self.fwd).astype(dtype),
            bwd=kernel_tiles(self.bwd).astype(dtype),
            rows_val=cast(self.rows_val), cols_val=cast(self.cols_val))

    def to(self, device) -> "SparseA":
        def mv(t):
            return None if t is None else t.to(device)
        return dataclasses.replace(
            self, fwd=self.fwd.to(device), bwd=self.bwd.to(device),
            rows_val=mv(self.rows_val), cols_val=mv(self.cols_val),
            rows_index=mv(self.rows_index), cols_index=mv(self.cols_index))

    def all_finite(self) -> bool:
        return all(bool(torch.isfinite(t).all()) for t in (
            self.fwd.data, self.rows_val, self.cols_val) if t is not None)

    def nnz_stored(self) -> int:
        return sum(t.numel() for t in (self.fwd.data, self.bwd.data,
                                       self.rows_val, self.cols_val)
                   if t is not None)


def is_sparse(A) -> bool:
    return isinstance(A, SparseA)


def scale_sparse(A: SparseA, D, E) -> SparseA:
    """diag(D) A diag(E), every stored part."""
    return A.scale(D, E)


def require_operand(A) -> None:
    """Raise TypeError for a matrix that is neither a strided tensor nor
    a SparseA (a torch sparse tensor, say)."""
    if not is_sparse(A) and A.layout != torch.strided:
        raise TypeError(
            f"A must be a dense (strided) tensor or an ops.sparse.SparseA, "
            f"got a tensor of layout {A.layout}; build the sparse operand "
            f"with scs_tpu_torch.ops.sparse.sparse_from_scipy")


def sparse_gram(A: SparseA, row_weight=None) -> torch.Tensor:
    """Dense (n, n) K = A' diag(w) A of a SparseA with dense tails: K =
    S'WS + C'WC + S'WC + (S'WC)' + R'WR (S and C have zero rows at
    rows_idx, so the S-R and R-C terms vanish)."""
    w = row_weight
    K = ell_gram(A.fwd, w)
    if A.cols_val is not None:
        ci = A.cols_index
        Cw = A.cols_val if w is None else A.cols_val * w[:, None].to(A.dtype)
        cross = ell_matmat(A.bwd, Cw)                    # S'WC (n, dc)
        K[:, ci] += cross
        K[ci, :] += cross.T
        K[ci[:, None], ci[None, :]] += A.cols_val.T @ Cw
    if A.rows_val is not None:
        Rw = (A.rows_val if w is None
              else A.rows_val * w[A.rows_index][:, None].to(A.dtype))
        K = K + A.rows_val.T @ Rw
    return K


# ---------------------------------------------------------------------------
# double-single (float64-accurate from float32 pairs) products


@dataclasses.dataclass(frozen=True)
class DsBlocked:
    """The (hi, lo) float32 pair of a BlockedEll's kernel operand
    (`kernel_tiles`) for kernel K2s; the same layout and count."""

    hi: torch.Tensor             # (nbr, bm, kmax*bn) float32
    lo: torch.Tensor
    idx: torch.Tensor            # (nbr, kmax) int32
    count: torch.Tensor          # (nbr,) int32
    m: int
    n: int
    bm: int
    bn: int
    kmax: int

    @property
    def ncb(self) -> int:
        return -(-self.n // self.bn)

    def to(self, device) -> "DsBlocked":
        return dataclasses.replace(self, hi=self.hi.to(device),
                                   lo=self.lo.to(device),
                                   idx=self.idx.to(device),
                                   count=self.count.to(device))


def ds_split_ell(ell: BlockedEll) -> DsBlocked:
    """The pair of ell's kernel operand, re-tiled at its chosen width."""
    t = kernel_tiles(ell)
    hi, lo = dsmatvec.split_operand(t.data)
    return DsBlocked(hi=hi, lo=lo, idx=t.idx, count=t.count, m=t.m, n=t.n,
                     bm=t.bm, bn=t.bn, kmax=t.kmax)


def ds_ell_matvec_plain(ds: DsBlocked, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K2s on the pair: each real element formed exactly
    in float64 as hi + lo, times the gathered x, y float64."""
    A = _real_tiles(ds.hi.to(torch.float64) + ds.lo.to(torch.float64),
                    ds.count, ds.bm, ds.bn)
    xg = _gather_x(ds, x.to(torch.float64))
    return torch.bmm(A, xg.unsqueeze(-1)).reshape(-1)[: ds.m]


def ds_ell_matvec(ds: DsBlocked, x: torch.Tensor,
                  plain: bool = False) -> torch.Tensor:
    """y = A x to ~1e-13 relative, float64 x and y: K2s on a CUDA tensor,
    its plain version on a CPU tensor; any other device raises. `plain`
    runs the plain version whatever the device (the card's
    comparisons)."""
    if x.dtype != torch.float64:
        raise TypeError(f"ds_ell_matvec takes float64 x, got {x.dtype}")
    if plain or dsmatvec._batched_device("ds_ell_matvec", x) == "cpu":
        return ds_ell_matvec_plain(ds, x)
    return ellmatvec.launch("pair", ds.hi, ds.lo, ds.idx, ds.count,
                            x.contiguous(), ds.m, ds.n, ds.bm, ds.bn,
                            ds.kmax)


@dataclasses.dataclass(frozen=True)
class DsSparse:
    """The double-single operand of ONE direction of a SparseA: the
    blocked-ELL pair for K2s, and the dense tails' pairs for K1, added at
    the tails' indices (int64 tensors on the operand's device)."""

    ell: DsBlocked
    rows_split: Optional[DsSplit]
    cols_split: Optional[DsSplit]
    rows_index: torch.Tensor
    cols_index: torch.Tensor

    def to(self, device) -> "DsSparse":
        def mv(s):
            return None if s is None else DsSplit(s.hi.to(device),
                                                  s.lo.to(device))
        return DsSparse(self.ell.to(device), mv(self.rows_split),
                        mv(self.cols_split), self.rows_index.to(device),
                        self.cols_index.to(device))


def ds_split_sparse(A: SparseA) -> DsSparse:
    """The double-single operand of A's forward direction (call it on A.T
    for the transpose)."""
    return DsSparse(
        ell=ds_split_ell(A.fwd),
        rows_split=(None if A.rows_val is None
                    else dsmatvec.split_operand(A.rows_val)),
        cols_split=(None if A.cols_val is None
                    else dsmatvec.split_operand(A.cols_val)),
        rows_index=A.rows_index, cols_index=A.cols_index)


def ds_sparse_matvec(ds: DsSparse, x: torch.Tensor,
                     plain: bool = False) -> torch.Tensor:
    """y = A x (~1e-13 relative): K2s on the blocked-ELL part, K1 on each
    dense tail (their plain versions on a CPU tensor). `plain` runs the
    plain versions whatever the device (the card's comparisons)."""
    single = dsmatvec.ds_matvec_plain if plain else dsmatvec.ds_matvec
    y = ds_ell_matvec(ds.ell, x, plain)
    if ds.rows_split is not None:
        y[ds.rows_index] += single(ds.rows_split, x)
    if ds.cols_split is not None:
        y = y + single(ds.cols_split, x.index_select(0, ds.cols_index))
    return y


# ---------------------------------------------------------------------------
# host-side constructors


# tail extraction: a row or column is dense when its nonzeros exceed both
# this many column blocks' worth of entries and this multiple of the
# mean; one such row would otherwise pad EVERY block-row to its tile count
_TAIL_MIN_NNZ_BLOCKS = 4       # x bn entries
_TAIL_MEAN_MULT = 16.0
_TAIL_MAX = 128                # cap: tails are meant to be a few lines


def _pick_tails(counts, axis_len, other_len, bn, explicit):
    """Indices to extract as dense tails along one axis. explicit: None ->
    the heuristic; a sequence -> exactly those; () -> none."""
    if explicit is not None:
        return np.asarray(sorted(set(int(i) for i in explicit)), np.int64)
    if counts.size == 0 or other_len <= _TAIL_MIN_NNZ_BLOCKS * bn:
        return np.zeros(0, np.int64)
    thresh = max(_TAIL_MIN_NNZ_BLOCKS * bn,
                 _TAIL_MEAN_MULT * counts.mean())
    cand = np.nonzero(counts > thresh)[0]
    if cand.size > _TAIL_MAX:
        cand = cand[np.argsort(counts[cand])[::-1][:_TAIL_MAX]]
        cand = np.sort(cand)
    return cand.astype(np.int64)


def sparse_from_scipy(A_sp, bm: int = 8, bn: int = 128,
                      dtype=torch.float64, dense_rows=None,
                      dense_cols=None, device="cpu") -> SparseA:
    """A SparseA from any scipy.sparse matrix, on `device`. dense_rows /
    dense_cols: None detects the rows and columns dense enough to pad the
    blocked-ELL storage and extracts them as dense tails; a sequence of
    indices extracts exactly those, () none."""
    coo = A_sp.tocoo()
    coo.sum_duplicates()        # ell_from_coo takes unique coordinates
    m, n = coo.shape
    rows, cols, vals = (np.asarray(coo.row, np.int64),
                        np.asarray(coo.col, np.int64),
                        np.asarray(coo.data, np.float64))

    ri = _pick_tails(np.bincount(rows, minlength=m), m, n, bn, dense_rows)
    in_rows = np.isin(rows, ri)
    ci = _pick_tails(np.bincount(cols[~in_rows], minlength=n), n, m, bn,
                     dense_cols)
    in_cols = np.isin(cols, ci) & ~in_rows

    rows_val = cols_val = None
    if ri.size:
        rows_val = np.zeros((ri.size, n))
        rows_val[np.searchsorted(ri, rows[in_rows]), cols[in_rows]] = \
            vals[in_rows]
        rows_val = torch.as_tensor(rows_val, dtype=dtype, device=device)
    if ci.size:
        cols_val = np.zeros((m, ci.size))
        cols_val[rows[in_cols], np.searchsorted(ci, cols[in_cols])] = \
            vals[in_cols]
        cols_val = torch.as_tensor(cols_val, dtype=dtype, device=device)

    keep = ~in_rows & ~in_cols
    r_k, c_k, v_k = rows[keep], cols[keep], vals[keep]
    fwd = ell_from_coo(r_k, c_k, v_k, m, n, bm, bn, dtype, device)
    bwd = ell_from_coo(c_k, r_k, v_k, n, m, bm, bn, dtype, device)
    return SparseA(fwd=fwd, bwd=bwd, rows_val=rows_val, cols_val=cols_val,
                   rows_idx=tuple(int(i) for i in ri),
                   cols_idx=tuple(int(i) for i in ci))


def sparse_from_dense(A, bm: int = 8, bn: int = 128,
                      drop_tol: float = 0.0) -> SparseA:
    """A SparseA on the CPU from a dense numpy array or tensor, keeping
    the entries with |a| > drop_tol, in the input's dtype."""
    An = A.detach().cpu().numpy() if torch.is_tensor(A) else np.asarray(A)
    r, c = np.nonzero(np.abs(An) > drop_tol)
    m, n = An.shape
    v = An[r, c]
    fwd = ell_from_coo(r, c, v, m, n, bm, bn, An.dtype)
    bwd = ell_from_coo(c, r, v, n, m, bm, bn, An.dtype)
    return SparseA(fwd=fwd, bwd=bwd)


def sparse_to_csc(A: SparseA, upper_only: bool = False):
    """(colptr, rowidx, vals) CSC triplets of a SparseA, on the host, in
    O(nnz log nnz), never forming the dense matrix. Stored zeros are
    dropped; upper_only keeps row <= col (P's upper triangle)."""
    m, n = A.shape
    rows_l, cols_l, vals_l = [], [], []

    ell = A.fwd
    data = ell.data.detach().cpu().double().numpy()
    idx = ell.idx.cpu().numpy().astype(np.int64)
    nbr, bm, _ = data.shape
    kmax, bn = ell.kmax, ell.bn
    d4 = data.reshape(nbr, bm, kmax, bn)
    br, r, e, cb = np.nonzero(d4)
    rows_l.append(br * bm + r)
    cols_l.append(idx[br, e] * bn + cb)
    vals_l.append(d4[br, r, e, cb])

    if A.rows_val is not None:
        rv = A.rows_val.detach().cpu().double().numpy()
        rr, cc = np.nonzero(rv)
        rows_l.append(np.asarray(A.rows_idx, np.int64)[rr])
        cols_l.append(cc.astype(np.int64))
        vals_l.append(rv[rr, cc])
    if A.cols_val is not None:
        cv = A.cols_val.detach().cpu().double().numpy()
        rr, cc = np.nonzero(cv)
        rows_l.append(rr.astype(np.int64))
        cols_l.append(np.asarray(A.cols_idx, np.int64)[cc])
        vals_l.append(cv[rr, cc])

    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l)
    keep = (rows < m) & (cols < n)       # blocks pad the row/col space
    if upper_only:
        keep &= rows <= cols
    rows, cols, vals = rows[keep], cols[keep], vals[keep]

    order = np.lexsort((rows, cols))
    rows, cols, vals = rows[order], cols[order], vals[order]
    colptr = np.zeros(n + 1, np.int64)
    colptr[1:] = np.cumsum(np.bincount(cols, minlength=n))
    return colptr, rows, np.asarray(vals, np.float64)
