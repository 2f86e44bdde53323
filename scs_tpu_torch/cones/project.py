"""Cone projection dispatcher and Moreau dual-cone wrapper.

Counterpart of `scs_tpu/cones/project.py` (SCS: src/cones.c:1340-1494 and
the Moreau wrapper at :1552-1596) for every cone of `ConeSpec`: zero,
nonnegative, box, second-order, PSD, complex PSD, exponential (primal and
dual), power, and the spectral cones (log-determinant, nuclear-norm,
ell1-norm and sum-of-k-largest-eigenvalues, `cones/spectral.py`).

One function serves one problem (x (m,)) and a batch (x (B, m), each row
one problem with its own metric r_y, box bounds and box warm start): every
family projects along the last axis, and each run of equal PSD block sizes
is one batched eigh over every block and lane (`cones/psd.py`), as each
run of equal spectral cones is one batched call over lanes x cones. The
box, exp and power projections are fixed-count masked loops; on the card
each runs as a CUDA graph (`graphs.run`), on the CPU eagerly; eigh and SVD
run outside any graph, and the spectral cones' data-dependent loops are
the kernels of `ops/logdet.py` and `ops/sumlargest.py` on the card and
their plain versions, eager masked loops, on the CPU.

Precision: the box and SOC cones project in the dtype of x; the PSD and
complex-PSD cones too, their eigh in float32 where `psd_f32` asks for it
(the mixed fast phase, as in the JAX package; `ConeSpec.f32_polish_cones`
then forces the float64 polish); the spectral cones in float64, their
eigh or SVD in float32 where `psd_f32` asks for it; the exp cones in
float64, or in float32
where `exp_f32` asks for it on a float64 x (`Settings.exp_f32=True`);
the power cones always in float64. Deviations from the JAX package's
float32 fast phase, which projects exp and power in float32 with mixed
(ROADMAP section 3, R4): its float32 power Newton lands on wrong roots
for some triples; with float32 state its float32 exp projection leaves
lanes of the mixed-cone batch unconverged at 100000 iterations that
converge in 200-525 with the exp rows in float64; with float64 state
and float32 exp, the finishing float64 re-projection lifts some lanes'
gap above SCS's bound in both packages, so the port's polish projects
exp in float64 even where the JAX package's exactness-only polish keeps
it in float32. The PSD cones follow the reference (their float32 eigh
fails on no lane of the PSD configurations). With float32 state the
spectral cones project in float64 (ROADMAP R5): the JAX package's
float32-state phase fails at trace time on every spectral cone (its
while_loop carries mix float32 and float64), and the logdet cascade in
float32 leaves cones at Newton's 100-iteration cap, ~5e-3 from the
float64 projection, some outside SCS's KKT gate.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..types import ConeData, ConeSpec
from . import box, exp, graphs, power, psd, soc, spectral


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


@dataclasses.dataclass(frozen=True)
class ConeLayout:
    """Offsets of each cone family within the stacked m-vector."""

    spec: ConeSpec
    z_off: int
    l_off: int
    box_off: int
    q_off: int
    s_off: int
    cs_off: int
    exp_off: int
    pow_off: int
    d_off: int
    nuc_off: int
    ell1_off: int
    sl_off: int
    total: int

    @staticmethod
    def make(spec: ConeSpec) -> "ConeLayout":
        box_off = spec.z + spec.l
        q_off = box_off + spec.bsize
        s_off = q_off + sum(spec.q)
        cs_off = s_off + sum(si * (si + 1) // 2 for si in spec.s)
        exp_off = cs_off + sum(ci * ci for ci in spec.cs)
        pow_off = exp_off + 3 * (spec.ep + spec.ed)
        d_off = pow_off + 3 * spec.psize
        nuc_off = d_off + sum(di * (di + 1) // 2 + 2 for di in spec.d)
        ell1_off = nuc_off + sum(mi * ni + 1
                                 for mi, ni in zip(spec.nuc_m, spec.nuc_n))
        sl_off = ell1_off + sum(ei + 1 for ei in spec.ell1)
        total = sl_off + sum(si * (si + 1) // 2 + 1 for si in spec.sl_n)
        return ConeLayout(spec, 0, spec.z, box_off, q_off, s_off, cs_off,
                          exp_off, pow_off, d_off, nuc_off, ell1_off, sl_off,
                          total)


@functools.lru_cache(maxsize=64)
def spectral_runs(spec: ConeSpec, f32_eig: bool = False) -> tuple:
    """(family, offset, count, width, fn) for each contiguous run of equal
    spectral cones, in row order; fn projects a (..., count, width)
    segment, the eigh or SVD in float32 with `f32_eig`."""
    lay = ConeLayout.make(spec)
    fams = (
        ("logdet", lay.d_off, spec.d, lambda d: d * (d + 1) // 2 + 2,
         lambda d: functools.partial(spectral.proj_logdet_batch, ns=d,
                                     f32_eig=f32_eig)),
        ("nuclear", lay.nuc_off, tuple(zip(spec.nuc_m, spec.nuc_n)),
         lambda mn: mn[0] * mn[1] + 1,
         lambda mn: functools.partial(spectral.proj_nuclear, m=mn[0],
                                      n=mn[1], f32_eig=f32_eig)),
        ("ell1", lay.ell1_off, spec.ell1, lambda e: e + 1,
         lambda e: spectral.proj_ell1),
        ("sum-largest", lay.sl_off, tuple(zip(spec.sl_n, spec.sl_k)),
         lambda sk: sk[0] * (sk[0] + 1) // 2 + 1,
         lambda sk: functools.partial(spectral.proj_sum_largest_evals,
                                      ns=sk[0], k=sk[1], f32_eig=f32_eig)))
    runs = []
    for family, off, sizes, width_of, fn_of in fams:
        for key, ct in _contiguous_runs(sizes):
            width = width_of(key)
            runs.append((family, off, ct, width, fn_of(key)))
            off += width * ct
    return tuple(runs)


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
              r_y: Optional[torch.Tensor] = None, exp_f32: bool = False,
              psd_f32: bool = False,
              psd_warm: Optional[torch.Tensor] = None, psd_rank: int = 0):
    """Project x (m,) or each row of x (B, m) onto the primal cone K (in
    the r_y-inverse metric for the box). Returns (projection, new box
    warm start); box_t_warm (or (B,)) defaults to 1 and passes through
    where there is no box. `psd_f32`: the PSD and complex-PSD blocks'
    eigh and reconstruction in float32 (the mixed fast phase's).
    `psd_warm` (x's layout) carries the previous iteration's inner
    projection for the tracked-rank PSD path (`psd_rank` > 0,
    `cones/psd.py`)."""
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
    # one batched eigh per run of equal block sizes, over every lane
    for off, sizes, cplx in ((lay.s_off, spec.s, False),
                             (lay.cs_off, spec.cs, True)):
        fn = psd.proj_cpsd_batch if cplx else psd.proj_psd_batch
        for ns, ct in _contiguous_runs(sizes):
            width = ns * ns if cplx else ns * (ns + 1) // 2
            if width:
                seg = x[..., off:off + width * ct].reshape(lead + (ct, width))
                wseg = (None if psd_warm is None else
                        psd_warm[..., off:off + width * ct]
                        .reshape(lead + (ct, width)))
                parts.append(fn(seg, ns, f32_eig=psd_f32, warm=wseg,
                                psd_rank=psd_rank)
                             .reshape(lead + (width * ct,)))
            off += width * ct
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
    # spectral cones: each contiguous run of equal cones is one batched
    # call over lanes x cones, in float64 (R5, module docstring); the
    # logdet runs go last, so that their kernel runs on the card while the
    # host goes on (the other families' eigh and SVD wait for the card)
    runs = spectral_runs(spec, psd_f32)
    first = len(parts)
    parts += [None] * len(runs)
    for i in sorted(range(len(runs)), key=lambda i: runs[i][0] == "logdet"):
        _, off, ct, width, fn = runs[i]
        seg = x[..., off:off + width * ct].reshape(lead + (ct, width))
        parts[first + i] = (fn(seg.to(torch.float64)).to(x.dtype)
                            .reshape(lead + (width * ct,)))
    return (torch.cat(parts, dim=-1) if parts else x), new_warm


def proj_dual_cone(x: torch.Tensor, spec: ConeSpec,
                   cone_data: Optional[ConeData],
                   box_t_warm: Optional[torch.Tensor],
                   r_y: Optional[torch.Tensor], exp_f32: bool = False,
                   psd_f32: bool = False,
                   psd_warm: Optional[torch.Tensor] = None,
                   psd_rank: int = 0):
    """Moreau decomposition under the diagonal R metric (cones.c:1552-1596):

        Pi_C^R(x) = x + R^{-1} Pi_{C*}^{R^{-1}}(-R x)

    x (m,) with r_y (m,), or x (B, m) with each problem's r_y (B, m).
    `psd_warm`: the previous inner projection Pi_{C*}(-R x) (the carried
    rsk rows) for the tracked-rank PSD path. Returns (projection, new box
    warm start).
    """
    xr = -x if r_y is None else -x * r_y
    proj, new_warm = proj_cone(xr, spec, cone_data, box_t_warm, r_y,
                               exp_f32, psd_f32, psd_warm, psd_rank)
    out = proj + x if r_y is None else proj / r_y + x
    return out, new_warm


# the batched names (x (B, m)): the same functions
proj_cone_batched = proj_cone
proj_dual_cone_batched = proj_dual_cone
