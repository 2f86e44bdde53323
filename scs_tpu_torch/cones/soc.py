"""Second-order cone projection, batched over equal-size cones and
segment-vectorized over heterogeneous cone lists.

Counterpart of `scs_tpu/cones/soc.py` (SCS: src/cones.c:1250-1279). The
tail norms of a mixed-size list are segment sums in a fixed order
(`segments.segment_sum`), so a projection gives the same bits on every
run.
Closed form: given x = (t, z), with s = ||z||_2:
  s <= t   -> x            (inside cone)
  s <= -t  -> 0            (in polar cone)
  else     -> ((t+s)/2) * (1, z/s)
"""

import functools

import numpy as np
import torch

from .segments import segment_sum


def proj_soc_batch(x: torch.Tensor) -> torch.Tensor:
    """Project rows of x (k, q) onto the SOC of dimension q >= 2."""
    t = x[:, 0]
    z = x[:, 1:]
    s = torch.linalg.vector_norm(z, dim=1)
    inside = s <= t
    below = s <= -t
    alpha = 0.5 * (s + t)
    scale = alpha / torch.where(s > 0, s, torch.ones_like(s))
    proj = torch.cat([alpha[:, None], scale[:, None] * z], dim=1)
    return torch.where(inside[:, None], x,
                       torch.where(below[:, None], torch.zeros_like(x), proj))


@functools.lru_cache(maxsize=256)
def _soc_layout_np(sizes: tuple[int, ...]):
    """Per-row cone ids, head mask and head positions of a cone list."""
    seg = np.concatenate([np.full(sz, k) for k, sz in enumerate(sizes)])
    heads = np.cumsum([0] + list(sizes[:-1]))
    is_head = np.zeros(seg.shape[0], bool)
    is_head[heads] = True
    return seg.astype(np.int64), is_head, heads.astype(np.int64)


@functools.lru_cache(maxsize=256)
def _soc_layout(sizes: tuple[int, ...], device: torch.device):
    seg, is_head, heads = _soc_layout_np(sizes)
    return (torch.as_tensor(seg, device=device),
            torch.as_tensor(is_head, device=device),
            torch.as_tensor(heads, device=device))


def proj_soc_hetero(x: torch.Tensor, sizes: tuple[int, ...]) -> torch.Tensor:
    """Project a flat stack of SOC cones of mixed sizes in one pass: the
    tail norms come from one segment sum and the closed form is applied
    row by row. Size-1 cones reduce to max(t, 0) under the same formula."""
    seg, is_head, heads = _soc_layout(sizes, x.device)
    zero = torch.zeros_like(x)
    z = torch.where(is_head, zero, x)
    s = torch.sqrt(segment_sum(z * z, sizes))
    t = x[heads]
    inside = s <= t
    below = s <= -t
    alpha = 0.5 * (s + t)
    scale = alpha / torch.where(s > 0, s, torch.ones_like(s))
    proj = torch.where(is_head, alpha[seg], scale[seg] * x)
    return torch.where(inside[seg], x, torch.where(below[seg], zero, proj))


def proj_soc_hetero_batched(x: torch.Tensor,
                            sizes: tuple[int, ...]) -> torch.Tensor:
    """`proj_soc_hetero` for a batch: each row of x (B, sum(sizes)) holds
    one problem's stack of cones; the tail norms are one segment sum
    along dim 1."""
    seg, is_head, heads = _soc_layout(sizes, x.device)
    zero = torch.zeros_like(x)
    z = torch.where(is_head, zero, x)
    s = torch.sqrt(segment_sum(z * z, sizes))
    t = x[:, heads]
    inside = s <= t
    below = s <= -t
    alpha = 0.5 * (s + t)
    scale = alpha / torch.where(s > 0, s, torch.ones_like(s))
    proj = torch.where(is_head, alpha[:, seg], scale[:, seg] * x)
    return torch.where(inside[:, seg], x,
                       torch.where(below[:, seg], zero, proj))
