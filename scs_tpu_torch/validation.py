"""Input validation with the JAX package's checks and messages.

SCS: validate() src/scs.c:376-452, validate_lin_sys
linsys/scs_matrix.c:65-157, validate_cones src/cones.c:583-763.
"""

from __future__ import annotations

import math
import numbers

import torch

from .types import ConeSpec, Problem, Settings


class ValidationError(ValueError):
    pass


def _all_finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all())


def validate(problem: Problem, spec: ConeSpec, cone_data, stg: Settings) -> None:
    m, n = problem.A.shape
    if m <= 0 or n <= 0:
        raise ValidationError(f"m and n must both be > 0; m={m}, n={n}")
    if tuple(problem.b.shape) != (m,):
        raise ValidationError(
            f"b must have shape ({m},), got {tuple(problem.b.shape)}")
    if tuple(problem.c.shape) != (n,):
        raise ValidationError(
            f"c must have shape ({n},), got {tuple(problem.c.shape)}")
    if problem.P is not None:
        if tuple(problem.P.shape) != (n, n):
            raise ValidationError(
                f"P must have shape ({n}, {n}), got {tuple(problem.P.shape)}")
        if not torch.equal(problem.P, problem.P.T):
            raise ValidationError(
                "P must be symmetric (pass the full matrix; "
                "the reference takes upper-triangular CSC)")
        if not _all_finite(problem.P):
            raise ValidationError("P contains non-finite entries")
    if not _all_finite(problem.A):
        raise ValidationError("A contains non-finite entries")
    if not _all_finite(problem.b):
        raise ValidationError("b contains non-finite entries")
    if not _all_finite(problem.c):
        raise ValidationError("c contains non-finite entries")

    validate_cones(spec, cone_data, m)
    validate_settings(stg)


def validate_cones(spec: ConeSpec, cone_data, m: int) -> None:
    for name, val in (("z", spec.z), ("l", spec.l), ("bsize", spec.bsize),
                      ("ep", spec.ep), ("ed", spec.ed)):
        if val < 0:
            raise ValidationError(f"cone {name} must be nonnegative, got {val}")
    if spec.bsize > 1 and cone_data is not None:
        nb = spec.bsize - 1
        if (tuple(cone_data.bu.shape) != (nb,)
                or tuple(cone_data.bl.shape) != (nb,)):
            raise ValidationError(f"box bounds must have length {nb}")
        if bool((cone_data.bl > cone_data.bu).any()):
            raise ValidationError("box cone requires bl <= bu")
    if spec.bsize > 1 and cone_data is None:
        raise ValidationError("box cone requires ConeData with bu/bl")
    for q in spec.q:
        if q < 0:
            raise ValidationError(f"SOC dimension must be nonnegative, got {q}")
    for s in spec.s:
        if s < 0:
            raise ValidationError(f"PSD dimension must be nonnegative, got {s}")
    for cs in spec.cs:
        if cs < 0:
            raise ValidationError(
                f"complex PSD dimension must be nonnegative, got {cs}")
    for a in spec.p:
        if not (-1.0 <= a <= 1.0) or not math.isfinite(a):
            raise ValidationError(f"power cone exponent must be in [-1, 1], got {a}")
    for di in spec.d:
        if di <= 0:
            raise ValidationError(f"logdet cone dim must be positive, got {di}")
    if len(spec.nuc_m) != len(spec.nuc_n):
        raise ValidationError("nuc_m and nuc_n must have equal length")
    for mi, ni in zip(spec.nuc_m, spec.nuc_n):
        if mi < ni or ni <= 0:
            raise ValidationError(
                f"nuclear cone requires m >= n > 0, got ({mi}, {ni})")
    for ei in spec.ell1:
        if ei <= 0:
            raise ValidationError(f"ell1 cone size must be positive, got {ei}")
    if len(spec.sl_n) != len(spec.sl_k):
        raise ValidationError("sl_n and sl_k must have equal length")
    for si, ki in zip(spec.sl_n, spec.sl_k):
        if not (0 < ki < si):
            raise ValidationError(
                f"sum-largest cone requires 0 < k < n, got (n={si}, k={ki})")
    dims = spec.dims()
    if dims != m:
        raise ValidationError(
            f"cone dimensions {dims} do not match rows of A ({m})")


def validate_settings(stg: Settings) -> None:
    if stg.max_iters <= 0:
        raise ValidationError("max_iters must be positive")
    for name in ("eps_abs", "eps_rel", "eps_infeas"):
        v = getattr(stg, name)
        if not math.isfinite(v) or v < 0:
            raise ValidationError(f"{name} must be a nonnegative finite number")
    if not math.isfinite(stg.alpha) or not (0 < stg.alpha < 2):
        raise ValidationError("alpha must be in (0,2)")
    if not math.isfinite(stg.rho_x) or stg.rho_x <= 0:
        raise ValidationError("rho_x must be a positive finite number")
    if not math.isfinite(stg.scale) or stg.scale <= 0:
        raise ValidationError("scale must be a positive finite number")
    if not math.isfinite(stg.time_limit_secs) or stg.time_limit_secs < 0:
        raise ValidationError("time_limit_secs must be a nonnegative finite number")
    if stg.acceleration_interval <= 0:
        raise ValidationError("acceleration_interval must be positive")
    if stg.acceleration_lookback < 0:
        raise ValidationError("acceleration_lookback must be nonnegative")
    if (not math.isfinite(stg.acceleration_regularization)
            or stg.acceleration_regularization < 0):
        raise ValidationError(
            "acceleration_regularization must be a nonnegative finite number")
    if (not math.isfinite(stg.acceleration_relaxation)
            or not (0 <= stg.acceleration_relaxation <= 2)):
        raise ValidationError("acceleration_relaxation must be in [0, 2]")
    if (isinstance(stg.psd_rank, bool)
            or not isinstance(stg.psd_rank, numbers.Integral)
            or stg.psd_rank < 0):
        raise ValidationError("psd_rank must be a nonnegative integer")
