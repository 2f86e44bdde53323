"""The spectral configurations: bench.py's two families with part of their
rows moved to the spectral cones (log-determinant, nuclear-norm, ell1-norm
and sum-of-k-largest-eigenvalues).

* `large_spectral_spec`: bench.py's large_socp_leg (n = 2048, m = 8192,
  density 0.3, seed 7) as one large program: zero 819, nonnegative 2165,
  logdet blocks of 60 and 4 x 16 (1832 + 4 x 138 rows, D-optimal design),
  one nuclear-norm block 40 x 30 (1201 rows, matrix completion), two
  ell1 cones of 400 (802 rows, lasso-type sparsity) and one
  sum-of-4-largest-eigenvalues block of 40 (821 rows, eigenvalue
  optimisation).
* `headline_spectral_spec`: bench.py's headline family (n = 100, m = 400)
  as z = 40, l = 136, q = (20, 34, 14, 51, 22), one logdet block of 6,
  one nuclear block 6 x 4, one ell1 cone of 12 and one sum-of-2-largest
  block of 6: many small spectral programs of one shape, as design and
  robust-estimation sweeps solve them (B = 1024, seeds 1000-2023).

The problems are `generators.gen_planted` instances of these specs: the
planted dual y is a random vector projected onto the dual cone.
"""

from __future__ import annotations

from ..types import ConeSpec


def large_spectral_spec() -> ConeSpec:
    return ConeSpec(z=819, l=2165, d=(60, 16, 16, 16, 16), nuc_m=(40,),
                    nuc_n=(30,), ell1=(400, 400), sl_n=(40,), sl_k=(4,))


def headline_spectral_spec() -> ConeSpec:
    return ConeSpec(z=40, l=136, q=(20, 34, 14, 51, 22), d=(6,), nuc_m=(6,),
                    nuc_n=(4,), ell1=(12,), sl_n=(6,), sl_k=(2,))
