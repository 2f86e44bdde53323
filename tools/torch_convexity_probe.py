#!/usr/bin/env python3
"""Times the indirect backend's convexity probe for a dense P on the card.

    python tools/torch_convexity_probe.py [--sizes 8192 16384]
                                           [--host-limit 150]

The indirect backend probes a P whose Jacobi diagonal is positive for a
negative eigenvalue (`api.Workspace._check_convexity`). For a dense P the
port runs a float64 eigvalsh on the solve's device at any n; above n =
4096 the JAX package runs ARPACK on a host copy instead
(`scs_tpu/api.py:57-80, 283-306`). For each n and two PSD spectra, made
on the card from a seed:
  * "clustered": P = G G' / n + 0.1 I (G Gaussian n x 64): the smallest
    eigenvalue 0.1 with multiplicity n - 64, the easy case for Lanczos;
  * "spread": P = X X' / n + 0.1 I (X Gaussian n x n): eigenvalues spread
    over [0.1, ~4.1], densest at the lower edge, the hard case;
it prints, each line as soon as it is measured:
  * the port's probe: float64 `torch.linalg.eigvalsh` on the card;
  * the JAX package's: the copy to the host, then float64 ARPACK as
    `scs_tpu/api.py:57-80` runs it (the smallest eigenvalue, tol 1e-10,
    at most 10 n iterations) in a process of its own, stopped after
    --host-limit seconds (then "> limit");
  * the indirect Workspace's setup (Settings(): mixed, indirect, an LP
    part A of n/16 x n), its probe on the card.
Needs a CUDA card; the card's name and power limit come first.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from scs_tpu_torch import Settings, Workspace  # noqa: E402
from scs_tpu_torch.types import ConeSpec, Problem  # noqa: E402

_HOST_PROBE = """
import sys, time
import numpy as np
import scipy.sparse.linalg as spla
P = np.load({path!r})
n = P.shape[0]
t0 = time.perf_counter()
try:
    lam = spla.eigsh(P, k=1, which="SA", return_eigenvectors=False,
                     maxiter=10 * n, tol=1e-10)
except spla.ArpackNoConvergence as e:
    lam = e.eigenvalues
print(repr(float(np.min(lam))), time.perf_counter() - t0)
"""


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _host_probe(P: torch.Tensor, limit: float) -> str:
    """The JAX package's probe of P in a process of its own: 'the copy to
    the host in s, lambda in s', or '> limit s' where ARPACK did not end
    in time."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "P.npy")
        t0 = time.perf_counter()
        host = P.cpu().numpy()
        copy_s = time.perf_counter() - t0
        np.save(path, host)
        del host
        try:
            out = subprocess.run(
                [sys.executable, "-c", _HOST_PROBE.format(path=path)],
                capture_output=True, text=True, timeout=limit)
        except subprocess.TimeoutExpired:
            return f"copy {copy_s:.3f} s, ARPACK > {limit:.0f} s (stopped)"
    if out.returncode != 0:
        return f"failed: {out.stderr.strip()[-300:]}"
    lam, secs = out.stdout.split()
    return (f"copy {copy_s:.3f} s, ARPACK lambda_min {lam} in "
            f"{float(secs):.3f} s")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[8192, 16384])
    ap.add_argument("--host-limit", type=float, default=150.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for n in args.sizes:
        for spectrum, k in (("clustered", 64), ("spread", n)):
            gen = torch.Generator(device="cuda").manual_seed(n + k)
            X = torch.randn(n, k, generator=gen, dtype=torch.float64,
                            device="cuda")
            P = X @ X.T / n + 0.1 * torch.eye(n, dtype=torch.float64,
                                              device="cuda")
            del X
            P = 0.5 * (P + P.T)
            lam, secs = _timed(lambda: float(torch.linalg.eigvalsh(P).min()))
            print(f"n={n} {spectrum}: card eigvalsh lambda_min {lam!r} in "
                  f"{secs:.3f} s", flush=True)
            print(f"n={n} {spectrum}: the JAX package's host probe: "
                  f"{_host_probe(P, args.host_limit)}", flush=True)
            m = n // 16
            A = torch.randn(m, n, generator=gen, dtype=torch.float64,
                            device="cuda")
            one = torch.ones(m, dtype=torch.float64, device="cuda")
            prob = Problem(A=A, b=one, c=torch.ones(
                n, dtype=torch.float64, device="cuda"), P=P)
            ws, secs = _timed(lambda: Workspace(prob, ConeSpec(l=m),
                                                settings=Settings()))
            print(f"n={n} {spectrum}: indirect Workspace setup (the probe on "
                  f"the card) {secs:.3f} s, setup_time_ms "
                  f"{ws.setup_time_ms:.1f}", flush=True)
            del ws, P, A, prob
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
