"""Anderson acceleration (type I / type II) as a functional state.

Counterpart of `scs_tpu/accel.py` (SCS: src/aa.c). The weights gamma solve
the regularized least-squares problem through a QR of the augmented matrix
[A_hist; sqrt(r) I] (A_hist = S for type I, Y for type II); ring slots
beyond the current history length are masked and get gamma_j = 0.

Every decision that depends on the data (seed or step, accept or reject,
the safeguard) is a `torch.where` select, so an application never waits for
the device. The state is replaced, not updated in place.

The `*_batched` functions run B independent accelerators at once, every
field with a leading batch axis: each lane seeds, steps, accepts, rejects
and resets on its own. Their least-squares solve is a Householder QR
written in batched tensor operations (`_householder_apply`), a fixed
number of launches whatever B is: on an H100 (700 W) at (1024, 511, 10)
in float32 it takes 4.2 ms against 104 ms for `torch.linalg.qr` and Q'c
on the same stack (`chip_smoke.py`'s `anderson_qr_times`).

Usage pattern (aa.h:72-94):
    if i > 0 and i % interval == 0: state, v, norm = aa_apply(state, f=v, x=v_prev)
    ... v_prev = v; v = F(v) ...
    state, v, v_prev, rejected = aa_safeguard(state, f_new=v, x_new=v_prev)
"""

from __future__ import annotations

import dataclasses

import torch

from . import config


@dataclasses.dataclass(frozen=True)
class AAState:
    x_prev: torch.Tensor   # (l,)
    f_prev: torch.Tensor   # (l,)
    g_prev: torch.Tensor   # (l,)
    norm_g: torch.Tensor   # ||x - f|| at the last update
    S: torch.Tensor        # (mem, l) x differences
    Y: torch.Tensor        # (mem, l) g differences
    D: torch.Tensor        # (mem, l) f differences
    nrm_s: torch.Tensor    # (mem,) cached row norms
    nrm_y: torch.Tensor    # (mem,)
    it: torch.Tensor       # int64 AA iteration
    success: torch.Tensor  # bool: the last apply produced an AA step
    n_accept: torch.Tensor
    n_reject: torch.Tensor
    n_safeguard_reject: torch.Tensor


def aa_init(dim: int, mem: int, dtype, device) -> AAState:
    z = torch.zeros(dim, dtype=dtype, device=device)
    zm = torch.zeros(mem, dim, dtype=dtype, device=device)
    zs = torch.zeros((), dtype=dtype, device=device)
    zi = torch.zeros((), dtype=torch.int64, device=device)
    return AAState(
        x_prev=z, f_prev=z, g_prev=z, norm_g=zs, S=zm, Y=zm, D=zm,
        nrm_s=torch.zeros(mem, dtype=dtype, device=device),
        nrm_y=torch.zeros(mem, dtype=dtype, device=device),
        it=zi, success=torch.zeros((), dtype=torch.bool, device=device),
        n_accept=zi, n_reject=zi, n_safeguard_reject=zi)


def _reset(a: AAState) -> AAState:
    """aa_reset semantics (aa.c:934-964): restart history, keep counters."""
    return dataclasses.replace(
        a, it=torch.zeros_like(a.it), success=torch.zeros_like(a.success),
        norm_g=torch.zeros_like(a.norm_g), nrm_s=torch.zeros_like(a.nrm_s),
        nrm_y=torch.zeros_like(a.nrm_y))


def _select(pred: torch.Tensor, a: AAState, b: AAState) -> AAState:
    """Field-wise `where(pred, a, b)`; fields both sides share are kept."""
    out = {}
    for f in dataclasses.fields(AAState):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        out[f.name] = vb if va is vb else torch.where(pred, va, vb)
    return AAState(**out)


def _small_solve(G, rhs, mem: int):
    """Partial-pivoted Gaussian elimination for the (mem x mem) system, the
    JAX package's unrolled elimination. A singular G gives a non-finite
    gamma, which the caller turns into a rejection."""
    aug = torch.cat([G, rhs[:, None]], dim=1)          # (mem, mem+1)
    rows = torch.arange(mem, device=G.device)
    for k in range(mem):
        col = torch.where(rows < k, -torch.inf, aug[:, k].abs())
        piv = torch.argmax(col)
        perm = rows.clone()
        perm[k] = piv
        perm = torch.where(rows == piv, k, perm)       # swap rows k <-> piv
        aug = aug[perm]
        factor = aug[:, k] / aug[k, k]
        factor = torch.where(rows == k, 0.0, factor)
        aug = aug - factor[:, None] * aug[k][None, :]
    return aug[:, mem] / torch.diagonal(aug[:, :mem])


def _frob_from_cols(nrm):
    m = torch.amax(nrm)
    safe_m = torch.where(m > 0, m, 1.0)
    t = nrm / safe_m
    return torch.where(m > 0, m * torch.sqrt(torch.sum(t * t)), 0.0)


def aa_apply(a: AAState, f, x, *, mem: int, type1: bool,
             regularization: float, relaxation: float,
             max_weight_norm: float = config.AA_MAX_WEIGHT_NORM,
             gamma_f32: bool = False):
    """One AA application. Returns (state, f_out, aa_norm).

    aa_norm > 0: the step was accepted and f_out is the AA point;
    aa_norm <= 0: f_out == f (rejected, or the history is warming up).
    gamma_f32 builds and solves for the weights in float32 (the mixed
    path's choice); the application itself stays in f's dtype."""
    dtype = f.dtype
    dev = f.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    seeding = a.it == 0

    # the seed branch (first call after init or reset)
    seed = dataclasses.replace(
        a, x_prev=x, f_prev=f, g_prev=x - f, it=torch.ones_like(a.it),
        success=torch.zeros_like(a.success))

    # the step branch
    idx = torch.remainder(a.it - 1, mem)
    s_col = x - a.x_prev
    d_col = f - a.f_prev
    g = x - f
    y_col = g - a.g_prev
    slot = (torch.arange(mem, device=dev) == idx)[:, None]
    S = torch.where(slot, s_col[None, :], a.S)
    D = torch.where(slot, d_col[None, :], a.D)
    Y = torch.where(slot, y_col[None, :], a.Y)
    nrm_s = torch.where(slot[:, 0], torch.linalg.vector_norm(s_col), a.nrm_s)
    nrm_y = torch.where(slot[:, 0], torch.linalg.vector_norm(y_col), a.nrm_y)
    norm_g = torch.linalg.vector_norm(g)

    length = torch.clamp_max(a.it, mem)
    mask = (torch.arange(mem, device=dev) < length).to(dtype)

    gdt = torch.float32 if gamma_f32 else dtype
    # regularization modes (aa.c:437-451)
    if regularization > 0:
        nrm_yf = _frob_from_cols(nrm_y)
        nrm_af = _frob_from_cols(nrm_s) if type1 else nrm_yf
        r = regularization * nrm_af * nrm_yf
    elif regularization < 0:
        r = torch.full((), -regularization, dtype=dtype, device=dev)
    else:
        r = zero
    sqrt_r = torch.sqrt(torch.clamp_min(r, 0.0))
    A_hist = ((S if type1 else Y) * mask[:, None]).to(gdt)
    diag_aug = (sqrt_r * mask + (1.0 - mask)).to(gdt)
    A_aug = torch.cat([A_hist.T, torch.diag(diag_aug)], dim=0)  # (l+mem, mem)
    Q, R = torch.linalg.qr(A_aug, mode="reduced")
    qc = Q[: g.shape[0]].T @ g.to(gdt)                          # Q'[g; 0]
    if type1:
        # W gamma = Q'c with W = Q'[Y_hist; sqrt(r) I]: the QR-stabilized
        # form of (S'Y + r I) gamma = S'g
        B_aug = torch.cat([(Y * mask[:, None]).to(gdt).T,
                           torch.diag(diag_aug)], dim=0)
        W = Q.T @ B_aug
        gamma = _small_solve(W, qc, mem).to(dtype) * mask
    else:
        gamma = torch.linalg.solve_triangular(
            R, qc[:, None], upper=True)[:, 0].to(dtype) * mask
    aa_norm = torch.linalg.vector_norm(gamma)

    do_solve = a.it >= mem          # min_len = mem: wait for a full window
    ok = torch.isfinite(aa_norm) & (aa_norm < max_weight_norm)

    f_aa = f - torch.sum(gamma[:, None] * D, dim=0)
    if relaxation != 1.0:
        x_relax = x - torch.sum((gamma * mask)[:, None] * S, dim=0)
        f_aa = relaxation * f_aa + (1.0 - relaxation) * x_relax

    accept = do_solve & ok
    reject = do_solve & ~ok
    f_step = torch.where(accept, f_aa, f)
    safe_norm = torch.where(torch.isfinite(aa_norm), aa_norm, 1.0)
    norm_step = torch.where(accept, aa_norm,
                            torch.where(do_solve, -safe_norm, zero))
    step = AAState(
        x_prev=x, f_prev=f, g_prev=g, norm_g=norm_g, S=S, Y=Y, D=D,
        nrm_s=nrm_s, nrm_y=nrm_y, it=a.it + 1, success=accept,
        n_accept=a.n_accept + accept.to(a.n_accept.dtype),
        n_reject=a.n_reject + reject.to(a.n_reject.dtype),
        n_safeguard_reject=a.n_safeguard_reject)
    # a rejection inside the solve triggers aa_reset (aa.c:612-638)
    step = _select(reject, _reset(step), step)

    st = _select(seeding, seed, step)
    f_out = torch.where(seeding, f, f_step)
    norm_out = torch.where(seeding, zero, norm_step)
    return st, f_out, norm_out


def aa_safeguard(a: AAState, f_new, x_new, *,
                 safeguard_factor: float = config.AA_SAFEGUARD_FACTOR):
    """Safeguard check (aa.c:856-901). Returns (state, f_out, x_out, rejected)."""
    norm_diff = torch.linalg.vector_norm(x_new - f_new)
    rejected = a.success & (norm_diff > safeguard_factor * a.norm_g)
    f_out = torch.where(rejected, a.f_prev, f_new)
    x_out = torch.where(rejected, a.x_prev, x_new)
    st = dataclasses.replace(
        a, success=torch.zeros_like(a.success),
        n_safeguard_reject=a.n_safeguard_reject
        + rejected.to(a.n_safeguard_reject.dtype))
    st = _select(rejected, _reset(st), st)
    return st, f_out, x_out, rejected


# ---- a batch of accelerators (leading batch axis on every field) ----


def aa_init_batched(B: int, dim: int, mem: int, dtype, device) -> AAState:
    z = torch.zeros(B, dim, dtype=dtype, device=device)
    zm = torch.zeros(B, mem, dim, dtype=dtype, device=device)
    zs = torch.zeros(B, dtype=dtype, device=device)
    zi = torch.zeros(B, dtype=torch.int64, device=device)
    return AAState(
        x_prev=z, f_prev=z, g_prev=z, norm_g=zs, S=zm, Y=zm, D=zm,
        nrm_s=torch.zeros(B, mem, dtype=dtype, device=device),
        nrm_y=torch.zeros(B, mem, dtype=dtype, device=device),
        it=zi, success=torch.zeros(B, dtype=torch.bool, device=device),
        n_accept=zi, n_reject=zi, n_safeguard_reject=zi)


def bwhere(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """where(pred, a, b) with pred (B,) broadcast over a's trailing axes."""
    return torch.where(pred.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def select_lanes(pred: torch.Tensor, a: AAState, b: AAState) -> AAState:
    """Lane-wise `_select`: lane i from a where pred[i], else from b."""
    out = {}
    for f in dataclasses.fields(AAState):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        out[f.name] = vb if va is vb else bwhere(pred, va, vb)
    return AAState(**out)


def reset_lanes(pred: torch.Tensor, a: AAState) -> AAState:
    """aa_reset of the lanes where pred holds."""
    return select_lanes(pred, _reset(a), a)


def _householder_apply(A: torch.Tensor, C: torch.Tensor):
    """Householder QR of A (B, L, k) with the same reflections applied to
    C (B, L, p). Returns (R (B, k, k), (Q'C) (B, k, p)) with Q the thin
    (L, k) factor: the reflections are LAPACK's (dlarfg), so R and Q'C
    agree with a library QR up to the signs of R's rows, which no
    least-squares solution depends on. A column that is zero below its
    diagonal and on it is left as it is."""
    k = A.shape[2]
    M = torch.cat([A, C], dim=2)
    for j in range(k):
        x = M[:, j:, j]
        alpha = x[:, 0]
        xnorm = torch.linalg.vector_norm(x[:, 1:], dim=1)
        beta = -torch.copysign(torch.hypot(alpha, xnorm), alpha)
        v = x.clone()
        v[:, 0] = alpha - beta
        vv = (alpha - beta) * (alpha - beta) + xnorm * xnorm
        coef = torch.where(vv > 0, 2.0 / vv, 0.0)
        sub = M[:, j:, j:]
        w = torch.matmul(v.unsqueeze(1), sub)
        M[:, j:, j:] = sub - (coef[:, None, None] * v.unsqueeze(2)) * w
    return torch.triu(M[:, :k, :k]), M[:, :k, k:]


def _small_solve_batched(G, rhs, mem: int):
    """`_small_solve` for a (B, mem, mem) stack, each lane pivoting on its
    own column maxima."""
    B = G.shape[0]
    aug = torch.cat([G, rhs.unsqueeze(2)], dim=2)      # (B, mem, mem+1)
    rows = torch.arange(mem, device=G.device)
    for k in range(mem):
        col = torch.where(rows < k, -torch.inf, aug[:, :, k].abs())
        piv = torch.argmax(col, dim=1)
        perm = rows.expand(B, mem).clone()
        perm[:, k] = piv
        perm = torch.where(rows[None, :] == piv[:, None], k, perm)
        aug = torch.gather(aug, 1, perm.unsqueeze(2).expand_as(aug))
        factor = aug[:, :, k] / aug[:, k:k + 1, k]
        factor = torch.where(rows == k, 0.0, factor)
        aug = aug - factor.unsqueeze(2) * aug[:, k:k + 1, :]
    return aug[:, :, mem] / torch.diagonal(aug[:, :, :mem], dim1=1, dim2=2)


def _frob_from_cols_batched(nrm):
    m = torch.amax(nrm, dim=1)
    safe_m = torch.where(m > 0, m, 1.0)
    t = nrm / safe_m[:, None]
    return torch.where(m > 0, m * torch.sqrt(torch.sum(t * t, dim=1)), 0.0)


def aa_apply_batched(a: AAState, f, x, *, mem: int, type1: bool,
                     regularization: float, relaxation: float,
                     max_weight_norm: float = config.AA_MAX_WEIGHT_NORM,
                     gamma_f32: bool = False):
    """`aa_apply` for B lanes: f, x (B, l). Returns (state, f_out (B, l),
    aa_norm (B,))."""
    dtype = f.dtype
    dev = f.device
    B = f.shape[0]
    zero = torch.zeros(B, dtype=dtype, device=dev)
    seeding = a.it == 0
    slots = torch.arange(mem, device=dev)

    idx = torch.remainder(a.it - 1, mem)
    s_col = x - a.x_prev
    d_col = f - a.f_prev
    g = x - f
    y_col = g - a.g_prev
    write = (slots[None, :] == idx[:, None]) & ~seeding[:, None]
    w3 = write.unsqueeze(2)
    S = torch.where(w3, s_col.unsqueeze(1), a.S)
    D = torch.where(w3, d_col.unsqueeze(1), a.D)
    Y = torch.where(w3, y_col.unsqueeze(1), a.Y)
    nrm_s = torch.where(write, torch.linalg.vector_norm(s_col, dim=1)[:, None],
                        a.nrm_s)
    nrm_y = torch.where(write, torch.linalg.vector_norm(y_col, dim=1)[:, None],
                        a.nrm_y)
    norm_g = torch.linalg.vector_norm(g, dim=1)

    length = torch.clamp_max(a.it, mem)
    mask = (slots[None, :] < length[:, None]).to(dtype)        # (B, mem)

    gdt = torch.float32 if gamma_f32 else dtype
    if regularization > 0:
        nrm_yf = _frob_from_cols_batched(nrm_y)
        nrm_af = _frob_from_cols_batched(nrm_s) if type1 else nrm_yf
        r = regularization * nrm_af * nrm_yf
    elif regularization < 0:
        r = torch.full((B,), -regularization, dtype=dtype, device=dev)
    else:
        r = zero
    sqrt_r = torch.sqrt(torch.clamp_min(r, 0.0))
    A_hist = ((S if type1 else Y) * mask[:, :, None]).to(gdt)
    diag_aug = torch.diag_embed((sqrt_r[:, None] * mask
                                 + (1.0 - mask)).to(gdt))
    A_aug = torch.cat([A_hist.transpose(1, 2), diag_aug], dim=1)
    c_aug = torch.cat([g.to(gdt), torch.zeros(B, mem, dtype=gdt,
                                              device=dev)], dim=1)[:, :, None]
    if type1:
        # W gamma = Q'c with W = Q'[Y_hist; sqrt(r) I]
        B_aug = torch.cat([(Y * mask[:, :, None]).to(gdt).transpose(1, 2),
                           diag_aug], dim=1)
        _, QtC = _householder_apply(A_aug, torch.cat([B_aug, c_aug], dim=2))
        gamma = _small_solve_batched(QtC[:, :, :mem], QtC[:, :, mem], mem)
    else:
        R, qc = _householder_apply(A_aug, c_aug)
        gamma = torch.linalg.solve_triangular(R, qc, upper=True)[:, :, 0]
    gamma = gamma.to(dtype) * mask
    aa_norm = torch.linalg.vector_norm(gamma, dim=1)

    do_solve = a.it >= mem
    ok = torch.isfinite(aa_norm) & (aa_norm < max_weight_norm)

    f_aa = f - torch.sum(gamma[:, :, None] * D, dim=1)
    if relaxation != 1.0:
        x_relax = x - torch.sum((gamma * mask)[:, :, None] * S, dim=1)
        f_aa = relaxation * f_aa + (1.0 - relaxation) * x_relax

    accept = do_solve & ok
    reject = do_solve & ~ok
    f_step = bwhere(accept, f_aa, f)
    safe_norm = torch.where(torch.isfinite(aa_norm), aa_norm, 1.0)
    norm_step = torch.where(accept, aa_norm,
                            torch.where(do_solve, -safe_norm, zero))
    step = AAState(
        x_prev=x, f_prev=f, g_prev=g, norm_g=norm_g, S=S, Y=Y, D=D,
        nrm_s=nrm_s, nrm_y=nrm_y, it=a.it + 1, success=accept,
        n_accept=a.n_accept + accept.to(a.n_accept.dtype),
        n_reject=a.n_reject + reject.to(a.n_reject.dtype),
        n_safeguard_reject=a.n_safeguard_reject)
    step = reset_lanes(reject, step)
    # the seed keeps the ring buffers (not written for seeding lanes)
    seed = dataclasses.replace(
        a, x_prev=x, f_prev=f, g_prev=g, S=S, Y=Y, D=D,
        it=torch.ones_like(a.it), success=torch.zeros_like(a.success))
    st = select_lanes(seeding, seed, step)
    f_out = bwhere(seeding, f, f_step)
    norm_out = torch.where(seeding, zero, norm_step)
    return st, f_out, norm_out


def aa_safeguard_batched(a: AAState, f_new, x_new, *,
                         safeguard_factor: float = config.AA_SAFEGUARD_FACTOR):
    """`aa_safeguard` for B lanes. Returns (state, f_out, x_out,
    rejected (B,))."""
    norm_diff = torch.linalg.vector_norm(x_new - f_new, dim=1)
    rejected = a.success & (norm_diff > safeguard_factor * a.norm_g)
    f_out = bwhere(rejected, a.f_prev, f_new)
    x_out = bwhere(rejected, a.x_prev, x_new)
    st = dataclasses.replace(
        a, success=torch.zeros_like(a.success),
        n_safeguard_reject=a.n_safeguard_reject
        + rejected.to(a.n_safeguard_reject.dtype))
    return reset_lanes(rejected, st), f_out, x_out, rejected
