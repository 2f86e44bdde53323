"""Sums over consecutive segments of a vector, in a fixed order.

The SOC tail norms of a mixed-size cone list and the equilibration's
cone-wise means sum the rows of each cone. A scatter-add (`index_add_`,
`scatter_reduce`) does that with atomics on the card, which add in no
fixed order, so the last bits of the sums, and through them a solve's
trajectory, change from run to run. Here every segment is gathered into
a row of a padded (segments, width) block through a cached index whose
padding points at one appended zero, and the rows are summed with one
reduction along the last axis: the same shape gives the same order on
every run, on the card and on the CPU.

Padding costs memory where sizes differ much (one cone of 5000 rows
among many of 3). Where one block would hold more than 4x the data plus
1024 entries, the segments go into classes of sizes (2^(k-1), 2^k], one
block each, and a static permutation puts the sums back in segment order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _plan_np(sizes: tuple[int, ...]):
    """(blocks, order): the gather index of each block into the data
    padded with one zero at position sum(sizes), and the permutation that
    puts the blocks' concatenated sums in segment order (None where there
    is one block in segment order)."""
    sz = np.asarray(sizes, np.int64)
    total = int(sz.sum())
    starts = np.concatenate([[0], np.cumsum(sz)[:-1]]).astype(np.int64)
    width = int(sz.max()) if sz.size else 0
    if sz.size * width <= 4 * total + 1024:
        groups = [np.arange(sz.size)]
    else:
        cls = np.ceil(np.log2(np.maximum(sz, 1))).astype(np.int64)
        groups = [np.nonzero(cls == k)[0] for k in np.unique(cls)]
    blocks = []
    for segs in groups:
        w = max(int(sz[segs].max()), 1)
        idx = np.full((segs.size, w), total, np.int64)
        for row, j in enumerate(segs):
            idx[row, :sz[j]] = np.arange(starts[j], starts[j] + sz[j])
        blocks.append(idx)
    order = None
    if len(groups) > 1:
        order = np.argsort(np.concatenate(groups), kind="stable")
    return blocks, order


@functools.lru_cache(maxsize=256)
def _plan(sizes: tuple[int, ...], device: torch.device):
    blocks, order = _plan_np(sizes)
    return ([torch.as_tensor(b, device=device) for b in blocks],
            None if order is None else torch.as_tensor(order, device=device))


def segment_sum(x: torch.Tensor, sizes: tuple[int, ...]) -> torch.Tensor:
    """Sums of consecutive segments of sizes `sizes` along the last axis of
    x (..., sum(sizes)) -> (..., len(sizes)); a size-0 segment sums to 0."""
    sizes = tuple(int(s) for s in sizes)
    if not sizes:
        return x.new_zeros(x.shape[:-1] + (0,))
    blocks, order = _plan(sizes, x.device)
    pad = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
    sums = [pad[..., idx].sum(-1) for idx in blocks]
    if order is None:
        return sums[0]
    return torch.cat(sums, dim=-1)[..., order]
