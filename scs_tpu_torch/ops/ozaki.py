"""High-precision matmul by Ozaki-style error-free slicing.

Counterpart of `scs_tpu/ops/ozaki.py`, which builds float64-grade
products on the TPU's bf16 matrix unit because the TPU has no float64
hardware. The algorithm, step for step:

1. scale each row of A (column of B) by a power of two so |x| < 1 (exact:
   powers of two only touch the exponent);
2. peel each element into `ns` integer-valued slices of W = 7 bits:
   q_i = round(r 2^W), r <- r 2^W - q_i, so x = sum_i q_i 2^-W(i+1) with
   |q_i| <= 2^W; each slice is exact in bfloat16;
3. multiply slice pairs with float32 accumulation: a product of two
   slices is an integer below 2^14, so a contraction of at most
   2^(24 - 2W) = 1024 terms sums exactly in float32; longer contractions
   are chunked to 1024 and the chunks combined in float64;
4. combine the pair products in float64 with the weights 2^-W(i+j+2) and
   the row and column scales.

Only the pairs with i + j < ns are formed (ns (ns + 1) / 2 products): ns
= 8 leaves ~1e-14 relative to the row and column scales.

On the card the slices are bf16 and each pair product runs on the tensor
cores with a float32 output (`torch.bmm(..., out_dtype=torch.float32)`,
float32 accumulation, with `allow_bf16_reduced_precision_reduction` off
for the call); on the CPU, as in the JAX
package, the slices are float32 and the products float32 matmuls, exact
for the same reason.

`supported()` keeps the JAX package's meaning: worth using where float64
products are emulated. The H100 has native float64 (and float64 tensor
cores), so it is False on the card as on the CPU and no solver path calls
this module; `eigh_ds.py` builds on it.
"""

from __future__ import annotations

import torch

_W = 7                        # bits per slice
_RADIX = float(1 << _W)       # 128.0
_KEXACT = 1 << (24 - 2 * _W)  # 1024: max exact-float32-accumulation length


def _pow2_scale(maxabs: torch.Tensor) -> torch.Tensor:
    """A power of two in (maxabs, 4 maxabs], exact; 1 where maxabs == 0.
    e = floor(log2(maxabs) + safety) + 1, 2^e built by binary
    decomposition with exact power-of-two multiplies, |e| <= 1021 (the
    JAX package's construction, which avoids frexp)."""
    e = torch.floor(torch.log2(torch.clamp_min(maxabs, 1e-300)) + 1e-9) + 1.0
    e = torch.clamp(e, -1021.0, 1021.0).to(torch.int32)
    mag = torch.abs(e)
    s = torch.ones_like(maxabs)
    for j in range(10):                 # bits 1..512 cover |e| <= 1021
        c = float(2.0 ** (1 << j))
        s = torch.where((mag >> j) & 1 == 1, s * c, s)
    s = torch.where(e < 0, 1.0 / s, s)
    return torch.where(maxabs > 0, s, torch.ones_like(s))


def _peel(X: torch.Tensor, ns: int) -> list:
    """X (|X| < 1) as ns integer-valued slices (bf16 on the card, float32
    on the CPU): X = sum_i slice_i 2^-W(i+1) + r, |r| <= 2^(-W ns - 1)."""
    dt = torch.bfloat16 if X.is_cuda else torch.float32
    out = []
    r = X
    for _ in range(ns):
        q = torch.round(r * _RADIX)
        out.append(q.to(dt))
        r = r * _RADIX - q
    return out


def _slice_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two slices with float32 accumulation and output."""
    if not a.is_cuda:
        return torch.matmul(a, b)
    lead = a.shape[:-2]
    a3 = a.reshape((-1,) + a.shape[-2:])
    b3 = b.reshape((-1,) + b.shape[-2:])
    flags = torch.backends.cuda.matmul
    reduced = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        p = torch.bmm(a3, b3, out_dtype=torch.float32)
    finally:
        flags.allow_bf16_reduced_precision_reduction = reduced
    return p.reshape(lead + p.shape[-2:])


def ozaki_matmul(A: torch.Tensor, B: torch.Tensor, ns: int = 8) -> torch.Tensor:
    """C = A @ B to float64 accuracy from low-precision slice products.

    A (..., m, k), B (..., k, n) float64 with equal leading axes; float64
    out. Accuracy ~1e-14 (ns = 8) relative to the product of A's row scale
    and B's column scale, the guarantee a float64 dgemm gives."""
    dtype = A.dtype
    *batch, m, k = A.shape
    n = B.shape[-1]
    sa = _pow2_scale(A.abs().amax(-1, keepdim=True))
    sb = _pow2_scale(B.abs().amax(-2, keepdim=True))
    Xa = A / sa
    Xb = B / sb
    # chunk the contraction so every float32 accumulation stays exact
    nc = -(-k // _KEXACT)
    if nc > 1:
        kp = nc * _KEXACT
        Xa = torch.nn.functional.pad(Xa, (0, kp - k))
        Xb = torch.nn.functional.pad(Xb, (0, 0, 0, kp - k))
        # (..., m, nc, kc) -> (..., nc, m, kc); (..., nc, kc, n)
        Xa = torch.movedim(Xa.reshape(*batch, m, nc, _KEXACT), -2,
                           len(batch))
        Xb = Xb.reshape(*batch, nc, _KEXACT, n)
    Sa = _peel(Xa, ns)
    Sb = _peel(Xb, ns)
    acc = None
    for d in range(ns):
        for i in range(d + 1):
            j = d - i
            term = (_slice_product(Sa[i], Sb[j]).to(dtype)
                    * float(2.0 ** (-_W * (d + 2))))
            acc = term if acc is None else acc + term
    if nc > 1:
        acc = acc.sum(len(batch))
    return acc * sa * sb


def gram(A: torch.Tensor, ns: int = 8) -> torch.Tensor:
    """A' A to float64 accuracy, symmetrized (the slice-pair sum is
    symmetric only up to float64 rounding)."""
    G = ozaki_matmul(A.transpose(-1, -2), A, ns=ns)
    return 0.5 * (G + G.transpose(-1, -2))


def supported() -> bool:
    """Worth using where float64 products are emulated: on no device this
    package runs on (the H100 and the CPU multiply float64 natively)."""
    return False
