"""The PSD and complex-PSD cone projections: batched eigendecompositions.

Counterpart of `scs_tpu/cones/psd.py` (SCS: src/cones.c:999-1156). A real
PSD block of dimension ns packs its lower triangle column by column, the
off-diagonal entries scaled by sqrt(2) (the svec convention, so that
<svec(A), svec(B)> = <A, B>_F). A complex (Hermitian) block packs ns^2
reals: for each column i, the real diagonal entry followed by the (re, im)
pairs of the entries below it, those scaled by sqrt(2) too.

The projection unpacks each block to its matrix, runs one batched
`torch.linalg.eigh` over every block of one size (LAPACK on the CPU,
cuSOLVER on the card; the JAX package's XLA `eigh`), clips the negative
eigenvalues and rebuilds V diag(max(w, 0)) V^H. A complex block takes the
native ns x ns Hermitian eigh in complex128 (complex64 with `f32_eig`),
as the reference's zheevr does. With `f32_eig` the eigh and the
reconstruction both run in float32, and only the rebuilt matrix returns
to the input's dtype, as the JAX package's fast phase does.

Every function takes any leading axes: v (..., tri) for one block or
(..., k, tri) for k blocks of one size (k blocks of B lanes: (B, k, tri)).
Not ported: the TPU's accurate eigh (`eigh_ds`, `ozaki`), which the card
does not need (cuSOLVER's float64 eigh is LAPACK-grade).

Tracked rank (`Settings.psd_rank`, the JAX package's `_tracked_or_exact`):
given the previous iteration's projection as `warm`, the certificate-gated
subspace projection of `ops/subspace.py` replaces the eigh wherever its
gate passes. The gate is decided per problem: over the blocks of one run
for one problem, and lane by lane for a batch (the JAX package's vmap runs
both branches and selects per lane). The host reads the gate once per
call; the exact eigh then runs for the failing lanes only, gathered and
scattered back in ascending lane order, so the card repeats a batch bit
for bit.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from ..ops import subspace

_SQRT2 = math.sqrt(2.0)

# tracked-rank gate decisions since the counts were last set to 0: one a
# problem (a lane of a batch) and run of equal blocks, and those that
# passed the certificate (the rest took the exact eigh)
gate_checks = 0
gate_passes = 0


@functools.lru_cache(maxsize=None)
def _tri_indices(ns: int):
    """svec packing of an ns x ns symmetric matrix, as numpy arrays (the
    JAX package's `_tri_indices`, element for element):
    (unpack_idx (ns, ns): the packed index of entry (r, c); unpack_scale
    (ns, ns); tri_r, tri_c (tri,): row and column of each packed slot,
    r >= c, column by column; pack_scale (tri,))."""
    tri = ns * (ns + 1) // 2
    tri_r = np.zeros(tri, dtype=np.int32)
    tri_c = np.zeros(tri, dtype=np.int32)
    k = 0
    for c in range(ns):
        for r in range(c, ns):
            tri_r[k] = r
            tri_c[k] = c
            k += 1
    packed = np.zeros((ns, ns), dtype=np.int32)
    packed[tri_r, tri_c] = np.arange(tri)
    packed[tri_c, tri_r] = np.arange(tri)
    unpack_scale = np.where(np.eye(ns, dtype=bool), 1.0, 1.0 / _SQRT2)
    pack_scale = np.where(tri_r == tri_c, 1.0, _SQRT2)
    return packed, unpack_scale, tri_r, tri_c, pack_scale


@functools.lru_cache(maxsize=64)
def _tri_tensors(ns: int, device: torch.device):
    """`_tri_indices` as tensors on `device`: (unpack gather (ns, ns),
    unpack scale, pack gather into the flattened matrix (tri,), pack
    scale), the scales in float64."""
    packed, unpack_scale, tri_r, tri_c, pack_scale = _tri_indices(ns)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return (t(packed, torch.int64), t(unpack_scale, torch.float64),
            t(tri_r.astype(np.int64) * ns + tri_c, torch.int64),
            t(pack_scale, torch.float64))


def svec_to_mat(v: torch.Tensor, ns: int) -> torch.Tensor:
    """(..., tri) scaled packed vectors -> (..., ns, ns) symmetric
    matrices."""
    idx, scale, _, _ = _tri_tensors(ns, v.device)
    return v[..., idx] * scale.to(v.dtype)


def mat_to_svec(M: torch.Tensor, ns: int) -> torch.Tensor:
    """(..., ns, ns) symmetric matrices -> (..., tri) scaled packed
    vectors."""
    _, _, flat, scale = _tri_tensors(ns, M.device)
    return M.reshape(M.shape[:-2] + (ns * ns,))[..., flat] * scale.to(M.dtype)


def _clip_rebuild(M: torch.Tensor) -> torch.Tensor:
    """V diag(max(w, 0)) V^H of the Hermitian matrices M (..., n, n), in
    M's dtype."""
    w, V = torch.linalg.eigh(M)
    Vw = V * torch.clamp_min(w, 0.0).to(V.dtype).unsqueeze(-2)
    return Vw @ V.transpose(-1, -2).conj()


def _exact(M: torch.Tensor, f32_eig: bool, dtype) -> torch.Tensor:
    """The exact projection of the symmetric or Hermitian M (..., n, n),
    its eigh and rebuild in float32 with `f32_eig`, the result in dtype."""
    return _clip_rebuild(M.to(torch.float32) if f32_eig else M).to(dtype)


def _tracked_or_exact(M: torch.Tensor, warm: torch.Tensor, rank: int,
                      f32_eig: bool) -> torch.Tensor:
    """Project the symmetric M (..., ct, n, n) from the previous
    projection `warm` (same shape): the subspace projection of rank `rank`
    where every block of a problem passes its certificate, the exact eigh
    for the problems (all leading indices but the block axis) where one
    does not. Gate tolerance: 1e-6 (1 + ||M||_F) with float32 eig (the
    fast phase floors at ~1e-5 true residuals), 1e-9 (1 + ||M||_F)
    otherwise (certificate-grade projections for eps_infeas = 1e-7)."""
    global gate_checks, gate_passes
    dtype = M.dtype
    rel = 1e-6 if f32_eig else 1e-9
    Mw, Pw = ((M.to(torch.float32), warm.to(torch.float32)) if f32_eig
              else (M, warm))
    tol = rel * (1.0 + torch.linalg.matrix_norm(Mw))
    sub, ok = subspace.psd_project_warm(Mw, Pw, rank, tol)
    # the projection's one host read of the gate
    good = ok.all(-1).cpu()
    gate_checks += good.numel()
    gate_passes += int(good.sum())
    if good.dim() == 0:
        return sub.to(dtype) if bool(good) else _exact(M, f32_eig, dtype)
    bad = torch.nonzero(~good).flatten()
    out = sub.to(dtype)
    if bad.numel():
        idx = bad.to(M.device)
        out = out.index_put((idx,), _exact(M.index_select(0, idx), f32_eig,
                                           dtype))
    return out


def proj_psd_batch(v: torch.Tensor, ns: int, f32_eig: bool = False,
                   warm: Optional[torch.Tensor] = None,
                   psd_rank: int = 0) -> torch.Tensor:
    """Project packed vectors v (..., tri) onto the PSD cone of dimension
    ns: one batched eigh over every leading index. `f32_eig`: the eigh and
    the reconstruction in float32, the result in v's dtype. With psd_rank
    > 0, 2 psd_rank < ns and `warm` (the previous projection, packed like
    v, with a block axis: (..., ct, tri)), the tracked-rank projection of
    `_tracked_or_exact` instead."""
    if ns == 1:
        return torch.clamp_min(v, 0.0)
    M = svec_to_mat(v, ns)
    if psd_rank and warm is not None and 2 * psd_rank < ns:
        Mp = _tracked_or_exact(M, svec_to_mat(warm, ns), psd_rank, f32_eig)
    else:
        Mp = _exact(M, f32_eig, v.dtype)
    return mat_to_svec(Mp, ns)


@functools.lru_cache(maxsize=None)
def _cplx_indices(ns: int):
    """The reference's complex-PSD real packing (src/cones.c:1095-1103),
    as numpy arrays (the JAX package's `_cplx_indices`, element for
    element): column i < ns - 1 starts at i (2 ns - i) with its diagonal,
    then the (re, im) pairs of rows i + 1 .. ns - 1; the last diagonal is
    entry ns^2 - 1. Returns (diag_idx (ns,), re_idx, im_idx, lo_r, lo_c
    (nl,)), nl = ns (ns - 1) / 2 the strictly lower entries column by
    column."""
    diag_idx = np.zeros(ns, dtype=np.int32)
    for i in range(ns - 1):
        diag_idx[i] = i * (2 * ns - i)
    diag_idx[ns - 1] = ns * ns - 1
    nl = ns * (ns - 1) // 2
    re_idx = np.zeros(nl, dtype=np.int32)
    im_idx = np.zeros(nl, dtype=np.int32)
    lo_r = np.zeros(nl, dtype=np.int32)
    lo_c = np.zeros(nl, dtype=np.int32)
    k = 0
    for c in range(ns - 1):
        base = c * (2 * ns - c) + 1
        for r in range(c + 1, ns):
            re_idx[k] = base + 2 * (r - c - 1)
            im_idx[k] = re_idx[k] + 1
            lo_r[k] = r
            lo_c[k] = c
            k += 1
    return diag_idx, re_idx, im_idx, lo_r, lo_c


@functools.lru_cache(maxsize=64)
def _cplx_tensors(ns: int, device: torch.device):
    """Gathers between the packed vector and the Hermitian matrix, on
    `device`: (re_idx, re_scale, im_idx, im_scale) (ns, ns) read the real
    and imaginary parts from the packed vector padded with one zero at
    index ns^2; (pack_idx, pack_scale) (ns^2,) read the packed vector, in
    packed order, from the flattened [Re; Im] parts (2 ns^2,)."""
    diag_idx, re_idx, im_idx, lo_r, lo_c = _cplx_indices(ns)
    zero = ns * ns
    r_idx = np.full((ns, ns), zero, np.int64)
    i_idx = np.full((ns, ns), zero, np.int64)
    r_scale = np.zeros((ns, ns))
    i_scale = np.zeros((ns, ns))
    d = np.arange(ns)
    r_idx[d, d] = diag_idx
    r_scale[d, d] = 1.0
    for rows, cols, sign in ((lo_r, lo_c, 1.0), (lo_c, lo_r, -1.0)):
        r_idx[rows, cols] = re_idx
        r_scale[rows, cols] = 1.0 / _SQRT2
        i_idx[rows, cols] = im_idx
        i_scale[rows, cols] = sign / _SQRT2
    # packed slots in the order [diagonal, re of the lower part, im of the
    # lower part] read from the flattened (Re, Im) stack (2 ns^2,)
    lo = lo_r.astype(np.int64) * ns + lo_c
    flat = np.concatenate([d * ns + d, lo, ns * ns + lo])
    scale = np.concatenate([np.ones(ns), np.full(2 * lo.size, _SQRT2)])
    perm = np.argsort(np.concatenate([diag_idx, re_idx, im_idx]))

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return (t(r_idx, torch.int64), t(r_scale, torch.float64),
            t(i_idx, torch.int64), t(i_scale, torch.float64),
            t(flat[perm], torch.int64), t(scale[perm], torch.float64))


def proj_cpsd_batch(v: torch.Tensor, ns: int, f32_eig: bool = False,
                    warm: Optional[torch.Tensor] = None,
                    psd_rank: int = 0) -> torch.Tensor:
    """Project real-packed vectors v (..., ns^2) onto the complex PSD cone
    of dimension ns through the native ns x ns Hermitian eigh (complex128,
    or complex64 with `f32_eig`), on either device; the result in v's
    dtype. With psd_rank > 0, 2 psd_rank < ns and `warm` ((..., ct,
    ns^2)), the tracked-rank projection of the real embedding
    E = [Re, -Im; Im, Re] (2 ns x 2 ns; every Hermitian eigenvalue
    doubles in it, so the tracked rank is 2 psd_rank), its exact fallback
    an eigh of E, as in the JAX package."""
    if ns == 1:
        return torch.clamp_min(v, 0.0)
    r_idx, r_scale, i_idx, i_scale, flat, scale = _cplx_tensors(ns, v.device)

    def parts(t):
        tp = torch.cat([t, t.new_zeros(t.shape[:-1] + (1,))], dim=-1)
        return (tp[..., r_idx] * r_scale.to(t.dtype),
                tp[..., i_idx] * i_scale.to(t.dtype))

    def pack(Re_p, Im_p):
        st = torch.cat([Re_p.reshape(Re_p.shape[:-2] + (ns * ns,)),
                        Im_p.reshape(Im_p.shape[:-2] + (ns * ns,))],
                       dim=-1).to(v.dtype)
        return st[..., flat] * scale.to(v.dtype)

    Re, Im = parts(v)
    if psd_rank and warm is not None and 2 * psd_rank < ns:
        def embed(Re_, Im_):
            return torch.cat([torch.cat([Re_, -Im_], dim=-1),
                              torch.cat([Im_, Re_], dim=-1)], dim=-2)

        Ep = _tracked_or_exact(embed(Re, Im), embed(*parts(warm)),
                               2 * psd_rank, f32_eig)
        return pack(0.5 * (Ep[..., :ns, :ns] + Ep[..., ns:, ns:]),
                    0.5 * (Ep[..., ns:, :ns] - Ep[..., :ns, ns:]))
    if f32_eig:
        Re, Im = Re.to(torch.float32), Im.to(torch.float32)
    Mp = _clip_rebuild(torch.complex(Re, Im))
    return pack(Mp.real, Mp.imag)
