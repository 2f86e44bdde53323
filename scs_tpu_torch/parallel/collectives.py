"""The model group's collectives: the ranks that hold the row shards of
one problem (`ops.rowshard.RowShardedA`) gather pieces and reduce
partials through `torch.distributed`, one code path for NCCL and gloo.

Two primitives, both built on `all_gather` of equal-sized tensors:

  * `gather_rows(piece, group, per, m)`: each rank's rows of a vector
    (..., m_r), padded to `per` along the last axis, gathered in rank
    order and cut to the global m;
  * `reduce(t, group, op)`: the elementwise sum ("sum") or maximum
    ("max") of every rank's tensor.

`reduce` gathers the ranks' partials and sums them on each rank in rank
order, not through `all_reduce`: every rank then computes the same sum in
the same order, so the ranks of a group hold the same bits whatever
algorithm the backend picks, and the host-side decisions that read those
values (termination, the Anderson safeguard, the scale update, CG's done
flags, lane compaction) agree on every rank; a rank that decided
otherwise would wait in a collective forever. A model group is a few
ranks, and the reduced tensors are vectors (the Gram, n x n, once at
setup), so the extra bytes are small.

gloo takes CUDA tensors for both calls (torch 2.11 on the H100's
machine, `tools/torch_gloo_cuda_probe.py`): it stages them through host
memory itself, so two gloo ranks can share one card, where NCCL refuses
two ranks on one device. A failed collective raises (torch.distributed's
error); nothing falls back.

`calls` and `seconds` count the collectives since they were last set to
0, and the host time spent in them.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

calls = 0
seconds = 0.0


def all_gather(t: torch.Tensor, group) -> list:
    """Every rank's `t` (equal shapes and types on every rank), in rank
    order."""
    global calls, seconds
    t0 = time.perf_counter()
    t = t.contiguous()
    parts = [torch.empty_like(t)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    calls += 1
    seconds += time.perf_counter() - t0
    return parts


def gather_rows(piece: torch.Tensor, group, per: int, m: int) -> torch.Tensor:
    """The global (..., m) vector from each rank's rows (..., m_r), m_r <=
    per: the pieces padded to `per`, gathered and concatenated in rank
    order, and the padding cut."""
    pad = per - piece.shape[-1]
    if pad:
        piece = F.pad(piece, (0, pad))
    return torch.cat(all_gather(piece, group), dim=-1)[..., :m]


def reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum or maximum over the group's ranks of each rank's `t`,
    combined in rank order on every rank (the same bits on each)."""
    parts = all_gather(t, group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p if op == "sum" else torch.maximum(out, p)
    return out
