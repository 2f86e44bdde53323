"""Cone projection dispatcher and Moreau dual-cone wrapper.

Counterpart of `scs_tpu/cones/project.py` (SCS: src/cones.c:1340-1494 and
the Moreau wrapper at :1552-1596) for the cones ported so far: zero,
nonnegative and second-order. A spec with any other cone raises
`NotImplementedError` (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..types import ConeData, ConeSpec
from . import soc


def _contiguous_runs(sizes):
    """Group a sequence into (size, count) runs of equal consecutive values."""
    runs = []
    for sz in sizes:
        if runs and runs[-1][0] == sz:
            runs[-1][1] += 1
        else:
            runs.append([sz, 1])
    return [(sz, ct) for sz, ct in runs]


def cone_boundaries(spec: ConeSpec) -> list[int]:
    """Per-cone segment lengths for equilibration aggregation: the first
    entry covers z + l + bsize (independently scalable rows), then one
    entry per cone (set_cone_boundaries, src/cones.c:386-424)."""
    b = [spec.z + spec.l + spec.bsize]
    b += list(spec.q)
    b += [si * (si + 1) // 2 for si in spec.s]
    b += [ci * ci for ci in spec.cs]
    b += [3] * (spec.ep + spec.ed)
    b += [3] * spec.psize
    b += [di * (di + 1) // 2 + 2 for di in spec.d]
    b += [mi * ni + 1 for mi, ni in zip(spec.nuc_m, spec.nuc_n)]
    b += [ei + 1 for ei in spec.ell1]
    b += [si * (si + 1) // 2 + 1 for si in spec.sl_n]
    return b


def require_supported(spec: ConeSpec) -> None:
    """Raise unless every cone of `spec` is one this package projects."""
    other = [name for name in ("bsize", "s", "cs", "ep", "ed", "p", "d",
                               "nuc_m", "ell1", "sl_n")
             if getattr(spec, name)]
    if other:
        raise NotImplementedError(
            f"cones {other} are not ported yet (ROADMAP queue 1, item 11); "
            "scs_tpu_torch projects zero, nonnegative and second-order "
            "cones")


@dataclasses.dataclass(frozen=True)
class ConeLayout:
    """Offsets of the ported cone families within the stacked m-vector."""

    spec: ConeSpec
    z_off: int
    l_off: int
    q_off: int
    total: int

    @staticmethod
    def make(spec: ConeSpec) -> "ConeLayout":
        require_supported(spec)
        return ConeLayout(spec, 0, spec.z, spec.z + spec.l, spec.dims())


def proj_cone(x: torch.Tensor, spec: ConeSpec,
              cone_data: Optional[ConeData] = None) -> torch.Tensor:
    """Project x onto the primal cone K."""
    lay = ConeLayout.make(spec)
    if x.shape[0] != lay.total:
        raise ValueError(f"x has {x.shape[0]} rows, the cones {lay.total}")
    parts = []
    if spec.z:
        parts.append(torch.zeros((spec.z,), dtype=x.dtype, device=x.device))
    if spec.l:
        parts.append(torch.clamp_min(x[lay.l_off:lay.l_off + spec.l], 0.0))
    # zero-size cones occupy no rows (cones.c:1252-1253)
    q_sizes = tuple(sz for sz in spec.q if sz > 0)
    if q_sizes:
        runs = _contiguous_runs(q_sizes)
        total_q = sum(q_sizes)
        seg = x[lay.q_off:lay.q_off + total_q]
        if len(runs) == 1:
            sz, ct = runs[0]
            if sz == 1:
                parts.append(torch.clamp_min(seg, 0.0))
            else:
                parts.append(soc.proj_soc_batch(seg.reshape(ct, sz))
                             .reshape(-1))
        else:
            parts.append(soc.proj_soc_hetero(seg, q_sizes))
    return torch.cat(parts) if parts else x


def proj_dual_cone(x: torch.Tensor, spec: ConeSpec,
                   cone_data: Optional[ConeData],
                   r_y: Optional[torch.Tensor]) -> torch.Tensor:
    """Moreau decomposition under the diagonal R metric (cones.c:1552-1596):

        Pi_C^R(x) = x + R^{-1} Pi_{C*}^{R^{-1}}(-R x)
    """
    if r_y is None:
        return proj_cone(-x, spec, cone_data) + x
    return proj_cone(-x * r_y, spec, cone_data) / r_y + x


def proj_cone_batched(x: torch.Tensor, spec: ConeSpec) -> torch.Tensor:
    """`proj_cone` for a batch: project each row of x (B, m) onto K."""
    lay = ConeLayout.make(spec)
    if x.shape[1] != lay.total:
        raise ValueError(f"x has {x.shape[1]} columns, the cones "
                         f"{lay.total}")
    B = x.shape[0]
    parts = []
    if spec.z:
        parts.append(torch.zeros((B, spec.z), dtype=x.dtype,
                                 device=x.device))
    if spec.l:
        parts.append(torch.clamp_min(x[:, lay.l_off:lay.l_off + spec.l],
                                     0.0))
    q_sizes = tuple(sz for sz in spec.q if sz > 0)
    if q_sizes:
        runs = _contiguous_runs(q_sizes)
        seg = x[:, lay.q_off:lay.q_off + sum(q_sizes)]
        if len(runs) == 1:
            sz, ct = runs[0]
            if sz == 1:
                parts.append(torch.clamp_min(seg, 0.0))
            else:
                parts.append(soc.proj_soc_batch(seg.reshape(B * ct, sz))
                             .reshape(B, ct * sz))
        else:
            parts.append(soc.proj_soc_hetero_batched(seg, q_sizes))
    return torch.cat(parts, dim=1) if parts else x


def proj_dual_cone_batched(x: torch.Tensor, spec: ConeSpec,
                           r_y: torch.Tensor) -> torch.Tensor:
    """`proj_dual_cone` for a batch, with each problem's own diagonal
    metric r_y (B, m)."""
    return proj_cone_batched(-x * r_y, spec) / r_y + x
