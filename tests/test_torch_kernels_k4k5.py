"""Kernels K4 (the double-single matmul) and K5 (the pure-read rowsum of
the roofline probe): their plain versions, which the CUDA kernels are
held against on the card, against numpy and the JAX package; the
wrappers' checks; and the probe's `measure` on the CPU.

K4's plain version forms each element exactly as hi + lo in float64 and
multiplies in float64, so it meets the JAX kernel's ~1e-13 contract
against numpy's float64 product. The JAX kernel runs here in interpret
mode, where only float32-grade accuracy holds (tests/test_dsmatmul.py),
so the two are compared at 1e-7. K5's Pallas kernel has no CPU form (its
`pallas_call` is built without `interpret`), so the plain version is held
against numpy's float64 rowsum at 4 ceil(log2 n) 2^-24 sum |a + b|."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

from scs_tpu.ops.dsmatmul import ds_matmul as j_ds_matmul
from scs_tpu_torch.ops import dsmatmul, dsmatvec, roofline


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


K4_SHAPES = ((1, 37, 53), (1, 53, 29))
K4_SCALES = {"unit": (1.0, 1.0), "scaled": (1e6, 1e-6)}


@functools.lru_cache(maxsize=None)
def _k4_case():
    """Both cases' operands, stacked along the batch axis, and the JAX
    kernel's product of the stack: one interpret-mode compile serves
    every case."""
    rng = np.random.RandomState(90)
    ops = {}
    for name, (sa, sb) in K4_SCALES.items():
        ops[name] = (rng.randn(*K4_SHAPES[0]) * sa,
                     rng.randn(*K4_SHAPES[1]) * sb)
    A = np.concatenate([a for a, _ in ops.values()])
    B = np.concatenate([b for _, b in ops.values()])
    J = np.asarray(j_ds_matmul(jnp.asarray(A), jnp.asarray(B),
                               interpret=True))
    k = K4_SHAPES[0][0]
    return {name: (a, b, J[i * k:(i + 1) * k])
            for i, (name, (a, b)) in enumerate(ops.items())}


@pytest.mark.parametrize("case", sorted(K4_SCALES))
def test_ds_matmul_plain_matches_numpy_and_jax(case):
    A, B, J = _k4_case()[case]
    before = dsmatmul.launches
    C = dsmatmul.ds_matmul(torch.tensor(A), torch.tensor(B))
    assert dsmatmul.launches == before          # CPU: the plain version
    assert C.dtype == torch.float64 and C.shape == K4_SHAPES[0][:2] + (
        K4_SHAPES[1][2],)
    ref = A @ B
    assert _rel(C.numpy(), ref) < 1e-13
    assert _rel(C.numpy(), J) < 1e-7


def test_ds_matmul_leading_dims_and_checks():
    rng = np.random.RandomState(4)
    A = rng.randn(2, 3, 5, 7)
    B = rng.randn(2, 3, 7, 4)
    C = dsmatmul.ds_matmul(torch.tensor(A), torch.tensor(B))
    assert C.shape == (2, 3, 5, 4)
    assert _rel(C.numpy(), A @ B) < 1e-13
    with pytest.raises(TypeError, match="float64"):
        dsmatmul.ds_matmul(torch.ones(1, 2, 2), torch.ones(1, 2, 2))
    with pytest.raises(ValueError, match="do not multiply"):
        a = dsmatvec.split_operand(torch.ones(1, 2, 3, dtype=torch.float64))
        dsmatmul.ds_matmul_pairs(a, a)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        a = dsmatvec.split_operand(torch.ones(1, 2, 2, dtype=torch.float64))
        meta = dsmatvec.DsSplit(a.hi.to("meta"), a.lo.to("meta"))
        dsmatmul.ds_matmul_pairs(meta, meta)


@pytest.mark.parametrize("b_scale", [1e-8, 1.0])
@pytest.mark.parametrize("shape", [(64, 256), (37, 101), (5, 3)])
def test_read_rowsum_plain_matches_numpy(shape, b_scale):
    """b as small as the low half of a double-single split, or of a's
    magnitude; each row within 4 ceil(log2 n) 2^-24 sum |a + b| of the
    float64 sum (the float32 rounding of each a + b and of the partial
    sums), a limit that a version dropping b would miss by orders of
    magnitude where b is of a's magnitude."""
    m, n = shape
    rng = np.random.RandomState(m + n)
    a = rng.randn(m, n).astype(np.float32)
    b = (rng.randn(m, n) * b_scale).astype(np.float32)
    before = roofline.launches
    o = roofline.read_rowsum(torch.tensor(a), torch.tensor(b))
    assert roofline.launches == before
    assert o.dtype == torch.float32 and o.shape == (m, 1)
    ab = a.astype(np.float64) + b.astype(np.float64)
    ref = ab.sum(axis=1, keepdims=True)
    tol = (4 * math.ceil(math.log2(n)) * 2.0 ** -24
           * np.abs(ab).sum(axis=1, keepdims=True))
    assert np.all(np.abs(o.numpy() - ref) <= tol)


def test_read_rowsum_checks():
    a = torch.ones(4, 8)
    with pytest.raises(TypeError, match="float32"):
        roofline.read_rowsum(a.double(), a.double())
    with pytest.raises(ValueError, match="one shape"):
        roofline.read_rowsum(a, a[:2])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        roofline.read_rowsum(a.to("meta"), a.to("meta"))


def test_measure_on_the_cpu():
    """The probe's keys and ceiling convention, on the CPU through the
    plain versions (rates of the CPU, no card's)."""
    out = roofline.measure(n=256, iters=4, reps=1, device="cpu")
    for key in ("ds_gbps", "read_peak_gbps", "f32_gbps", "torch_rowsum_gbps",
                "torch_copy_total_gbps", "f64_gbps", "read_ceiling_gbps"):
        assert out[key] > 0, key
    assert out["device"] == "cpu" and out["peak_gbps"] is None
    assert out["frac_spec"] is None
    assert 0 < out["frac"] <= 1
    assert out["read_ceiling_gbps"] == max(out["read_peak_gbps"],
                                           out["ds_gbps"])


def test_peak_table_names_the_h100_parts():
    assert roofline.device_peak_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert roofline.device_peak_gbps("NVIDIA H100 PCIe") == 2000.0
    assert roofline.device_peak_gbps("NVIDIA H100 NVL") == 3900.0
    assert roofline.device_peak_gbps("NVIDIA A100-SXM4-80GB") is None
