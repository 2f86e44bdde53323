"""The PSD configurations: bench.py's two families with part of their rows
moved to PSD and complex-PSD cones.

* `large_psd_spec`: bench.py's large_socp_leg (n = 2048, m = 8192,
  density 0.3, seed 7) as one large SDP relaxation: zero 819,
  nonnegative 1614, one PSD block of 90 (4095 rows), eight PSD blocks of
  16 (8 x 136 rows) and one complex-PSD block of 24 (576 rows).
* `headline_psd_spec`: bench.py's headline family (n = 100, m = 400) as
  z = 40, l = 110, q = (20, 34, 14, 51, 22), s = (8, 8, 6) and cs = (4,):
  many small LMI-constrained problems of one shape, as MPC and
  robust-control sweeps solve them (B = 1024, seeds 1000-2023).

The problems are `generators.gen_planted` instances of these specs: the
planted dual y is a random vector projected onto the dual cone, so each
PSD block of y has about half its eigenvalues at 0.
"""

from __future__ import annotations

from ..types import ConeSpec


def large_psd_spec() -> ConeSpec:
    return ConeSpec(z=819, l=1614, s=(90,) + (16,) * 8, cs=(24,))


def headline_psd_spec() -> ConeSpec:
    return ConeSpec(z=40, l=110, q=(20, 34, 14, 51, 22), s=(8, 8, 6),
                    cs=(4,))
