"""scs_tpu_torch.ops.dsmatvec (kernels K1 and K2) against the JAX
package's Pallas kernels run in interpret mode, and against float64
numpy.

On the CPU the wrapper runs the kernel's plain version; the CUDA kernel
itself is compared with that plain version on the card
(`tests/test_torch_cuda.py` and chip_smoke.py)."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

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



# ---- K2: the batched matvec ----

BATCHED_SHAPES = [(3, 40, 10), (2, 37, 101), (4, 16, 300)]


def _batched_inputs(B, m, n):
    rng = np.random.RandomState(B + m + n)
    return rng.randn(B, m, n), rng.randn(B, n) * 22.0


@pytest.mark.parametrize("shape", BATCHED_SHAPES)
def test_batched_matches_jax_interpret_kernel(shape):
    B, m, n = shape
    A, x = _batched_inputs(B, m, n)
    splits = [jax_ds.split_operand(jnp.asarray(A[i])) for i in range(B)]
    hi = jnp.stack([s[0] for s in splits])
    lo = jnp.stack([s[1] for s in splits])
    ref = np.asarray(jax_ds._ds_matvec_batched(hi, lo, jnp.asarray(x), m=m,
                                               n=n, interpret=True))
    split = dsmatvec.split_operand(torch.tensor(A))
    before = dsmatvec.batched_launches
    y = dsmatvec.ds_matvec_batched(split, torch.tensor(x)).numpy()
    assert dsmatvec.batched_launches == before    # CPU: the plain version
    assert y.shape == (B, m)
    # the same bounds as K1's, lane by lane
    for i in range(B):
        assert (np.max(np.abs(y[i] - ref[i])) / (np.max(np.abs(ref[i])) + 1.0)
                < 1e-8)
        exact = A[i] @ x[i]
        assert (np.max(np.abs(y[i] - exact))
                <= 1e-12 * np.max(np.abs(A[i]) @ np.abs(x[i])))


@pytest.mark.parametrize("shape", BATCHED_SHAPES)
def test_batched_split_is_the_unpadded_jax_split_lane_by_lane(shape):
    B, m, n = shape
    A, _ = _batched_inputs(B, m, n)
    hi, lo = dsmatvec.split_operand(torch.tensor(A))
    assert hi.shape == lo.shape == (B, m, n)
    assert hi.is_contiguous() and lo.is_contiguous()
    for i in range(B):
        jhi, jlo = jax_ds.split_operand(jnp.asarray(A[i]))
        np.testing.assert_array_equal(np.asarray(jhi)[:m, :n], hi[i].numpy())
        np.testing.assert_array_equal(np.asarray(jlo)[:m, :n], lo[i].numpy())


def test_batched_takes_a_column_slice_of_the_iterate():
    """x as the solver passes it: a column slice of a (B, l) iterate, with
    batch stride l; the same result as a contiguous copy."""
    A, _ = _batched_inputs(3, 9, 5)
    u = torch.tensor(np.random.RandomState(0).randn(3, 17))
    x = u[:, 4:9]
    assert not x.is_contiguous()
    split = dsmatvec.split_operand(torch.tensor(A))
    torch.testing.assert_close(dsmatvec.ds_matvec_batched(split, x),
                               dsmatvec.ds_matvec_batched(split,
                                                          x.contiguous()),
                               rtol=0, atol=0)


def test_batched_operator_and_bad_operands():
    A, x = _batched_inputs(2, 6, 4)
    At = torch.tensor(A)
    op = dsmatvec.DsOperator(At)
    z = torch.tensor(np.random.RandomState(3).randn(2, 6))
    ref = np.einsum("bmn,bm->bn", A, z.numpy())
    assert np.max(np.abs(op.rmatvec(z).numpy() - ref)) < 1e-12
    split = dsmatvec.split_operand(At)
    with pytest.raises(ValueError):
        dsmatvec.ds_matvec_batched(split, torch.tensor(x[:1]))
    with pytest.raises(TypeError):      # float64 and float32 x only
        dsmatvec.ds_matvec_batched(split, torch.tensor(x, dtype=torch.float16))
    with pytest.raises(ValueError):
        dsmatvec.ds_matvec_batched(dsmatvec.DsSplit(split.hi, split.lo[0]),
                                   torch.tensor(x))
    with pytest.raises(ValueError):
        dsmatvec.ds_matvec_batched(
            dsmatvec.split_operand(At.to("meta")), torch.tensor(x).to("meta"))


# ---- the kernel's launch configuration, chosen on the host ----

@pytest.mark.parametrize("case", [
    # (batch, m, n, lda, a_bstride, x_bstride, ptrs, x_itemsize) ->
    # (tpr, threads, vec_a, vec_x)
    # few rows: four 16-byte loads a thread, up to 256 threads a row
    ((1, 8192, 2048, 2048, 0, 0, (0, 256, 512), 8), (128, 256, True, True)),
    ((1, 2048, 8192, 8192, 0, 0, (0, 256, 512), 8), (256, 256, True, True)),
    # a small product: one load a thread
    ((1, 400, 100, 100, 0, 0, (0, 256, 512), 8), (32, 256, True, True)),
    ((1, 64, 200, 200, 0, 0, (0, 256, 512), 8), (64, 256, True, True)),
    # many rows: at most 32 threads a row, 4 loads a thread
    ((1024, 400, 100, 100, 40000, 100, (0, 256, 512), 8),
     (8, 128, True, True)),
    ((1024, 100, 400, 400, 40000, 400, (0, 256, 512), 8),
     (32, 128, True, True)),
    ((1024, 100, 100, 100, 10000, 100, (0, 256, 512), 4),
     (8, 64, True, True)),
    # x a column slice of the (B, l) iterate, l = 501: A keeps its float4
    ((1024, 400, 100, 100, 40000, 501, (0, 256, 512 + 8 * 5), 8),
     (8, 128, True, False)),
    ((1024, 100, 100, 100, 10000, 501, (0, 256, 512 + 4 * 400), 4),
     (8, 64, True, False)),
    # a batch of one reads no batch stride
    ((1, 2048, 2048, 2048, 2048 * 2048, 2061, (0, 256, 512), 8),
     (128, 256, True, True)),
    # A's rows unaligned (n = 101 contiguous, or a base one float in)
    ((3, 37, 101, 101, 3737, 101, (0, 256, 512), 8),
     (128, 128, False, False)),
    ((3, 37, 100, 100, 3700, 100, (4, 260, 512), 8),
     (128, 128, False, False)),
    ((1, 7, 3, 3, 0, 0, (0, 256, 512), 8), (8, 64, False, False)),
    ((1, 128, 129, 129, 0, 0, (0, 256, 512), 8), (256, 256, False, False)),
])
def test_launch_config_picks_the_variant(case):
    args, want = case
    cfg = dsmatvec.launch_config(*args)
    assert tuple(cfg) == want
    assert cfg.tpr in dsmatvec._TPRS and cfg.threads % cfg.tpr == 0
