"""Cone projection dispatcher and Moreau dual-cone wrapper.

Counterpart of `scs_tpu/cones/project.py` (SCS: src/cones.c:1340-1494 and
the Moreau wrapper at :1552-1596) for the cones ported so far: zero,
nonnegative, box, second-order, exponential (primal and dual) and power.
A spec with any other cone raises `NotImplementedError` (ROADMAP queue 1,
item 11).

One function serves one problem (x (m,)) and a batch (x (B, m), each row
one problem with its own metric r_y, box bounds and box warm start): every
family projects along the last axis. The box, exp and power projections
are fixed-count masked loops; on the card each runs as a CUDA graph
(`graphs.run`), on the CPU eagerly. Precision: the box and SOC cones
project in the dtype of x; the exp cones in float64, or in float32 where
`exp_f32` asks for it on a float64 x (`Settings.exp_f32=True`); the
power cones always in float64. The JAX package projects exp and power in
float32 on the mixed fast phase and with float32 state; three of those
float32 projections fail (ROADMAP section 3, R4): its float32 power
Newton lands on wrong roots for some triples; with float32 state its
float32 exp projection leaves lanes of the mixed-cone batch unconverged
at 100000 iterations that converge in 200-525 with the exp rows in
float64; with float64 state, the finishing float64 re-projection moves
the returned (x, y, s) of float32-exp lanes outside SCS's gap test.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..types import ConeData, ConeSpec
from . import box, exp, graphs, power, soc


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
    other = [name for name in ("s", "cs", "d", "nuc_m", "ell1", "sl_n")
             if getattr(spec, name)]
    if other:
        raise NotImplementedError(
            f"cones {other} are not ported yet (ROADMAP queue 1, item 11); "
            "scs_tpu_torch projects zero, nonnegative, box, second-order, "
            "exponential and power cones")


@dataclasses.dataclass(frozen=True)
class ConeLayout:
    """Offsets of the ported cone families within the stacked m-vector
    (the PSD and spectral families, not ported, take no rows)."""

    spec: ConeSpec
    z_off: int
    l_off: int
    box_off: int
    q_off: int
    exp_off: int
    pow_off: int
    total: int

    @staticmethod
    def make(spec: ConeSpec) -> "ConeLayout":
        require_supported(spec)
        box_off = spec.z + spec.l
        q_off = box_off + spec.bsize
        exp_off = q_off + sum(spec.q)
        pow_off = exp_off + 3 * (spec.ep + spec.ed)
        return ConeLayout(spec, 0, spec.z, box_off, q_off, exp_off, pow_off,
                          pow_off + 3 * spec.psize)


@functools.lru_cache(maxsize=64)
def _exp_mask(ep: int, ed: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.arange(ep + ed) < ep, device=device)


@functools.lru_cache(maxsize=64)
def _pow_exponents(p: tuple, dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(p, np.float64), dtype=dtype,
                           device=device)


def proj_cone(x: torch.Tensor, spec: ConeSpec,
              cone_data: Optional[ConeData] = None,
              box_t_warm: Optional[torch.Tensor] = None,
              r_y: Optional[torch.Tensor] = None, exp_f32: bool = False):
    """Project x (m,) or each row of x (B, m) onto the primal cone K (in
    the r_y-inverse metric for the box). Returns (projection, new box
    warm start); box_t_warm (or (B,)) defaults to 1 and passes through
    where there is no box."""
    lay = ConeLayout.make(spec)
    if x.shape[-1] != lay.total:
        raise ValueError(f"x has {x.shape[-1]} rows, the cones {lay.total}")
    lead = x.shape[:-1]
    parts = []
    new_warm = box_t_warm
    if spec.z:
        parts.append(x.new_zeros(lead + (spec.z,)))
    if spec.l:
        parts.append(torch.clamp_min(x[..., lay.l_off:lay.l_off + spec.l],
                                     0.0))
    if spec.bsize:
        seg = x[..., lay.box_off:lay.box_off + spec.bsize]
        r_seg = (None if r_y is None
                 else r_y[..., lay.box_off:lay.box_off + spec.bsize])
        if box_t_warm is None:
            box_t_warm = x.new_ones(lead)
        out, new_warm = graphs.run(box.proj_box_cone,
                                   (seg, cone_data.bl, cone_data.bu,
                                    box_t_warm, r_seg))
        parts.append(out)
    # zero-size cones occupy no rows (cones.c:1252-1253)
    q_sizes = tuple(sz for sz in spec.q if sz > 0)
    if q_sizes:
        runs = _contiguous_runs(q_sizes)
        total_q = sum(q_sizes)
        seg = x[..., lay.q_off:lay.q_off + total_q]
        if len(runs) == 1:
            sz, ct = runs[0]
            if sz == 1:
                parts.append(torch.clamp_min(seg, 0.0))
            else:
                parts.append(soc.proj_soc_batch(seg.reshape(-1, sz))
                             .reshape(lead + (total_q,)))
        elif x.dim() == 1:
            parts.append(soc.proj_soc_hetero(seg, q_sizes))
        else:
            parts.append(soc.proj_soc_hetero_batched(seg, q_sizes))
    # exp in float32 only where exp_f32 asks for it on a float64 x
    n_exp = spec.ep + spec.ed
    if n_exp:
        seg = x[..., lay.exp_off:lay.exp_off + 3 * n_exp]
        seg = seg.reshape(lead + (n_exp, 3)).to(
            torch.float32 if exp_f32 and x.dtype == torch.float64
            else torch.float64)
        out = graphs.run(exp.proj_exp_batch,
                         (seg, _exp_mask(spec.ep, spec.ed, x.device)))
        parts.append(out.to(x.dtype).reshape(lead + (3 * n_exp,)))
    if spec.psize:
        # always in float64 (R4, module docstring)
        seg = x[..., lay.pow_off:lay.pow_off + 3 * spec.psize]
        seg = seg.reshape(lead + (spec.psize, 3)).to(torch.float64)
        a = _pow_exponents(tuple(spec.p), seg.dtype, x.device)
        out = graphs.run(power.proj_power_batch, (seg, a))
        parts.append(out.to(x.dtype).reshape(lead + (3 * spec.psize,)))
    return (torch.cat(parts, dim=-1) if parts else x), new_warm


def proj_dual_cone(x: torch.Tensor, spec: ConeSpec,
                   cone_data: Optional[ConeData],
                   box_t_warm: Optional[torch.Tensor],
                   r_y: Optional[torch.Tensor], exp_f32: bool = False):
    """Moreau decomposition under the diagonal R metric (cones.c:1552-1596):

        Pi_C^R(x) = x + R^{-1} Pi_{C*}^{R^{-1}}(-R x)

    x (m,) with r_y (m,), or x (B, m) with each problem's r_y (B, m).
    Returns (projection, new box warm start).
    """
    xr = -x if r_y is None else -x * r_y
    proj, new_warm = proj_cone(xr, spec, cone_data, box_t_warm, r_y,
                               exp_f32)
    out = proj + x if r_y is None else proj / r_y + x
    return out, new_warm


# the batched names (x (B, m)): the same functions
proj_cone_batched = proj_cone
proj_dual_cone_batched = proj_dual_cone
