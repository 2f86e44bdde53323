"""Accurate float32 reductions (dot products, norms) for the float32-state
fast phase.

Counterpart of `scs_tpu/ops/dsreduce.py`. The fast phase runs the ADMM
iterate in float32, but the reductions that steer the iteration (the five
R-weighted dots of root_plus, the iterate norm of the normalization, the
objective dots of the residual check) feed decisions whose noise tolerance
is ~1e-6, and a plain float32 dot over ~500 elements carries ~1e-6..1e-5
relative error.

The JAX package forms each product exactly (Dekker's two_prod) and sums
the (hi, lo) pairs with a double-single accumulator, for want of float64
on the TPU. The H100 has float64 units: the product of two float32 values
is exact in float64 (24 + 24 bits of mantissa fit in 53), and a float64
sum of them errs by ~l 2^-53 of the sum of |products|, below the
double-single accumulator's ~2^-48. So here each reduction runs in
float64 on the float32 inputs and rounds once to float32. These are not
TPU kernels (the JAX package reduces with `lax.reduce`), so they stay
torch operations.

The callers choose them with an explicit flag (the float32-state phase),
not by the inputs' dtype: the pure float32 mode (`Settings(dtype=
float32)`) keeps plain float32 reductions.
"""

from __future__ import annotations

import torch


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"the accurate reductions take float32, got "
                        f"{x.dtype}")


def acc_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum(x * y) over the last axis, float32 in and out, with exact
    products and a float64 sum (~1e-7 relative whatever the length)."""
    _check(x)
    _check(y)
    return torch.sum(x.to(torch.float64) * y.to(torch.float64),
                     dim=-1).to(torch.float32)


def acc_norm(x: torch.Tensor) -> torch.Tensor:
    """The L2 norm over the last axis, float32 in and out, from an exact
    sum of squares in float64."""
    _check(x)
    return torch.linalg.vector_norm(x.to(torch.float64),
                                    dim=-1).to(torch.float32)
