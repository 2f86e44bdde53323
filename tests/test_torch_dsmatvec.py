"""scs_tpu_torch.ops.dsmatvec (kernel K1) against the JAX package's Pallas
kernel run in interpret mode, and against float64 numpy.

On the CPU the wrapper runs the kernel's plain version; the CUDA kernel
itself is compared with that plain version on the card
(`tests/test_torch_cuda.py` and chip_smoke.py)."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scs_tpu  # noqa: F401  (x64 + matmul precision config)
from scs_tpu.ops import dsmatvec as jax_ds
from scs_tpu_torch.ops import _build
from scs_tpu_torch.ops import dsmatvec

SHAPES = [(400, 100), (100, 400), (7, 3), (130, 257), (16, 3000)]


def _inputs(m, n):
    rng = np.random.RandomState(m + n)
    return rng.randn(m, n), rng.randn(n) * 22.0


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_jax_interpret_kernel(shape):
    m, n = shape
    A, x = _inputs(m, n)
    split = jax_ds.split_operand(jnp.asarray(A))
    ref = np.asarray(jax_ds._ds_matvec_padded(
        split[0], split[1], jnp.asarray(x), m=m, n=n, interpret=True))
    y = dsmatvec.ds_matvec(dsmatvec.split_operand(torch.tensor(A)),
                           torch.tensor(x)).numpy()
    # the JAX test's own bound for its interpret-mode kernel
    assert np.max(np.abs(y - ref)) / (np.max(np.abs(ref)) + 1.0) < 1e-8
    # and float64 numpy: the split keeps ~48 bits of each element
    exact = A @ x
    assert (np.max(np.abs(y - exact))
            <= 1e-12 * np.max(np.abs(A) @ np.abs(x)))


def test_split_is_unpadded_and_exact_to_48_bits():
    rng = np.random.RandomState(2)
    A = torch.tensor(rng.randn(37, 101))
    hi, lo = dsmatvec.split_operand(A)
    assert hi.shape == lo.shape == (37, 101)
    assert hi.dtype == lo.dtype == torch.float32
    back = hi.double() + lo.double()
    assert torch.max(torch.abs(back - A) / torch.abs(A)) < 2.0 ** -47
    jhi, jlo = jax_ds.split_operand(jnp.asarray(A.numpy()))
    np.testing.assert_array_equal(np.asarray(jhi)[:37, :101], hi.numpy())
    np.testing.assert_array_equal(np.asarray(jlo)[:37, :101], lo.numpy())


def test_operator_transpose():
    rng = np.random.RandomState(9)
    A = torch.tensor(rng.randn(60, 33))
    z = torch.tensor(rng.randn(60))
    op = dsmatvec.DsOperator(A)
    ref = A.numpy().T @ z.numpy()
    assert np.max(np.abs(op.rmatvec(z).numpy() - ref)) < 1e-11


def test_cpu_tensors_take_the_plain_version():
    A, x = _inputs(20, 9)
    split = dsmatvec.split_operand(torch.tensor(A))
    before = dsmatvec.launches
    y = dsmatvec.ds_matvec(split, torch.tensor(x))
    assert dsmatvec.launches == before
    torch.testing.assert_close(y, dsmatvec.ds_matvec_plain(
        split, torch.tensor(x)), rtol=0, atol=0)


def test_wrapper_rejects_bad_operands():
    A, x = _inputs(6, 4)
    split = dsmatvec.split_operand(torch.tensor(A))
    with pytest.raises(TypeError):
        dsmatvec.ds_matvec(split, torch.tensor(x, dtype=torch.float32))
    with pytest.raises(TypeError):
        dsmatvec.ds_matvec(dsmatvec.DsSplit(split.hi.double(), split.lo),
                           torch.tensor(x))
    with pytest.raises(ValueError):
        dsmatvec.ds_matvec(split, torch.tensor(np.ones(5)))
    with pytest.raises(ValueError):
        dsmatvec.ds_matvec(split, torch.tensor(x).to("meta"))
    with pytest.raises(ValueError):
        dsmatvec.split_operand(torch.tensor(A, dtype=torch.float32))


def test_kernel_path_raises_without_cuda():
    """A tensor off the CPU goes to the kernel or raises; without the CUDA
    toolkit, building the kernel raises instead of falling back."""
    meta = dsmatvec.split_operand(torch.ones(4, 3, dtype=torch.float64,
                                             device="meta"))
    with pytest.raises(ValueError):
        dsmatvec.ds_matvec(meta, torch.ones(3, dtype=torch.float64,
                                            device="meta"))
    if shutil.which("nvcc") is None and not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            _build.load("dsmatvec")

