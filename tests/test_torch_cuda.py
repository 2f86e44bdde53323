"""scs_tpu_torch's CUDA kernels on the card. Every test carries the `cuda`
marker and skips without a CUDA device. The file imports neither JAX nor
the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest.py configures JAX)."""

import numpy as np
import pytest
import torch

from scs_tpu_torch import ConeSpec, Settings, Workspace
from scs_tpu_torch.models import gen_planted
from scs_tpu_torch.ops import dsmatvec

pytestmark = pytest.mark.cuda

SHAPES = [(400, 100), (100, 400), (7, 3), (130, 257), (16, 3000),
          (37, 101), (2048, 2048)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
def test_ds_matvec_kernel_matches_plain(cuda, shape):
    """Both sides sum the same exact float64 products in another order:
    they agree to 1e-12 of max |A| |x|."""
    m, n = shape
    rng = np.random.RandomState(m + n)
    A = torch.tensor(rng.randn(m, n), device=cuda)
    x = torch.tensor(rng.randn(n) * 22.0, device=cuda)
    split = dsmatvec.split_operand(A)
    before = dsmatvec.launches
    y = dsmatvec.ds_matvec(split, x)
    torch.cuda.synchronize()
    assert dsmatvec.launches == before + 1
    ref = dsmatvec.ds_matvec_plain(split, x)
    assert float((y - ref).abs().max()) <= 1e-12 * float(
        (A.abs() @ x.abs()).max())


def test_ds_matvec_kernel_takes_unaligned_views(cuda):
    """An x that starts 8 bytes into its storage takes the scalar loads."""
    split = dsmatvec.split_operand(torch.randn(64, 96, dtype=torch.float64,
                                               device=cuda))
    x = torch.randn(97, dtype=torch.float64, device=cuda)[1:]
    y = dsmatvec.ds_matvec(split, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, dsmatvec.ds_matvec_plain(split, x),
                               rtol=1e-12, atol=1e-12)


def test_mixed_solve_on_the_card_matches_the_plain_version(cuda):
    """The mixed solve through the kernel against the same solve on the
    CPU through its plain version: the same status and objective, and
    iteration counts within the band the JAX comparison allows."""
    spec = ConeSpec(z=5, l=20, q=(5, 5, 5, 10))
    p = gen_planted(spec, n=30, seed=3, density=0.3)
    stg = Settings(linsys="direct")
    dsmatvec.launches = 0
    ws = Workspace(p.problem, spec, p.cone_data, stg)
    _, info = ws.solve()
    launches = dsmatvec.launches
    cpu = Workspace(p.problem, spec, p.cone_data,
                    Settings(linsys="direct", mixed_precision=True),
                    device="cpu", ds_split=True)
    _, ref = cpu.solve()
    assert info.status == ref.status == "solved"
    assert launches >= 4 * info.iter
    assert abs(info.pobj - ref.pobj) <= 1e-4 * (1 + abs(ref.pobj))
    assert 0.8 <= info.iter / ref.iter <= 1.25
