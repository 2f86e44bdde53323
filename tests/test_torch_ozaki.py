"""The Ozaki-scheme matmul and the refined eigh of scs_tpu_torch
(`ops/ozaki.py`, `ops/eigh_ds.py`) on the CPU: tests/test_ozaki.py's
cases and bounds against numpy longdouble (error below 1e-14 of the row
and column operand scales), the JAX package's results on the same inputs
(within the same bound), and the refined eigh against numpy's float64 eigh as accurately as the
JAX package's (eigenvalue error and residual |A V - V diag(w)| at most
twice its own, or 1e-12 of the spectrum's scale; |V'V - I| below the
quality gate's 1e-8).
Neither module is on a solver path: `supported()` is False on the CPU
and on the H100, as the JAX package's is on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

from scs_tpu.ops import eigh_ds as j_eigh_ds
from scs_tpu.ops import ozaki as j_ozaki
from scs_tpu_torch.ops import eigh_ds, ozaki


def _truth(A, B):
    return np.asarray(
        np.matmul(A.astype(np.longdouble), B.astype(np.longdouble)))


def _relerr(C, T, A, B):
    scale = (np.max(np.abs(A), axis=-1, keepdims=True)
             * np.max(np.abs(B), axis=-2, keepdims=True)
             * A.shape[-1]) + 1e-300
    return float(np.max(np.abs((C - T).astype(np.float64)) / scale))


def _cases():
    """tests/test_ozaki.py's operands: (name, A, B)."""
    rng = np.random.RandomState(0)
    out = [(f"random{m}x{k}x{n}", rng.randn(m, k), rng.randn(k, n))
           for m, k, n in [(37, 53, 29), (64, 128, 64), (16, 1024, 16)]]
    rng = np.random.RandomState(3)
    k = 512
    A = rng.randn(8, k)
    A[:, k // 2:] = -A[:, : k // 2]
    out.append(("cancellation", A, np.ones((k, 4)) + 1e-9 * rng.randn(k, 4)))
    rng = np.random.RandomState(1)
    out.append(("batched", rng.randn(3, 24, 40), rng.randn(3, 40, 17)))
    rng = np.random.RandomState(2)
    out.append(("chunked", rng.randn(8, 3000), rng.randn(3000, 8)))
    rng = np.random.RandomState(4)
    A = rng.randn(6, 32)
    A[0] *= 1e120
    A[1] *= 1e-120
    A[2] = 0.0
    B = rng.randn(32, 6)
    B[:, 3] *= 1e100
    B[:, 4] = 0.0
    out.append(("dynamic_range", A, B))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_ozaki_matmul_bounds_and_jax(case):
    _, A, B = CASES[case]
    C = ozaki.ozaki_matmul(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    T = _truth(A, B)
    assert np.all(np.isfinite(C))
    assert _relerr(C, T, A, B) < 1e-14
    J = np.asarray(j_ozaki.ozaki_matmul(jnp.asarray(A), jnp.asarray(B)))
    assert _relerr(C, J, A, B) < 1e-14
    if A.ndim == 3:
        for b in range(A.shape[0]):
            np.testing.assert_array_equal(
                C[b], ozaki.ozaki_matmul(torch.as_tensor(A[b]),
                                         torch.as_tensor(B[b])).numpy())
    if case == len(CASES) - 1:
        np.testing.assert_array_equal(C[2], 0.0)
        np.testing.assert_array_equal(C[:, 4], 0.0)


def test_gram_symmetric():
    rng = np.random.RandomState(5)
    A = rng.randn(50, 20)
    G = ozaki.gram(torch.as_tensor(A)).numpy()
    np.testing.assert_array_equal(G, G.T)
    assert _relerr(G, _truth(A.T, A), A.T, A) < 1e-14
    assert not ozaki.supported() and not eigh_ds.supported()


@pytest.mark.parametrize("n", [6, 24])
def test_eigh_refined_matches_jax_and_numpy(n):
    """Three spectra, the first with a cluster of width 1e-9: the port's
    eigenvalue error against numpy's float64 eigh and its residual
    |A V - V diag(w)| at most twice the JAX package's (or 1e-12 of the
    spectrum's scale), V orthonormal to the quality gate's 1e-8."""
    rng = np.random.RandomState(n)
    Q, _ = np.linalg.qr(rng.randn(3, n, n))
    w = rng.randn(3, n)
    w[0, : n // 2] = 1.0 + 1e-9 * rng.randn(n // 2)     # a cluster
    A = (Q * w[:, None, :]) @ np.swapaxes(Q, 1, 2)
    A = 0.5 * (A + np.swapaxes(A, 1, 2))
    wr, V = (t.numpy() for t in eigh_ds.eigh_refined(torch.as_tensor(A)))
    jw, jV = (np.asarray(t) for t in
              jax.jit(j_eigh_ds.eigh_refined)(jnp.asarray(A)))
    ref = np.linalg.eigvalsh(A)
    floor = 1e-12 * np.abs(w).max()
    assert np.all(np.diff(wr, axis=-1) >= 0)
    for lane in range(3):
        err, j_err = (np.abs(x[lane] - ref[lane]).max() for x in (wr, jw))
        assert err <= max(2 * j_err, floor), (lane, err, j_err)
        res, j_res = (np.abs(A[lane] @ X[lane] - X[lane] * x[lane]).max()
                      for x, X in ((wr, V), (jw, jV)))
        assert res <= max(2 * j_res, floor), (lane, res, j_res)
        assert np.abs(V[lane].T @ V[lane] - np.eye(n)).max() <= 1e-8
