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
from scs_tpu_torch.parallel import (make_batch_solver,
                                    make_chunked_batch_solver)

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


BATCHED_SHAPES = [(1024, 400, 100), (3, 37, 101), (4, 16, 300), (8, 100, 100)]


@pytest.mark.parametrize("shape", BATCHED_SHAPES)
def test_ds_matvec_batched_kernel_matches_plain(cuda, shape):
    """K2 against its plain version, each lane to 1e-12 of max |A| |x|."""
    B, m, n = shape
    rng = np.random.RandomState(B + m + n)
    A = torch.tensor(rng.randn(B, m, n), device=cuda)
    x = torch.tensor(rng.randn(B, n) * 22.0, device=cuda)
    split = dsmatvec.split_operand(A)
    before = dsmatvec.batched_launches
    y = dsmatvec.ds_matvec_batched(split, x)
    torch.cuda.synchronize()
    assert dsmatvec.batched_launches == before + 1
    ref = dsmatvec.ds_matvec_batched_plain(split, x)
    bound = 1e-12 * torch.matmul(A.abs(), x.abs().unsqueeze(-1)).amax(1)
    assert bool(((y - ref).abs().amax(1, keepdim=True) <= bound).all())


def test_ds_matvec_batched_kernel_takes_strided_and_unaligned_x(cuda):
    """x as a column slice of the (B, l) iterate (odd batch stride: the
    scalar loads), and a gathered stack of splits."""
    A = torch.randn(5, 64, 96, dtype=torch.float64, device=cuda)
    split = dsmatvec.split_operand(A)
    u = torch.randn(5, 101, dtype=torch.float64, device=cuda)
    for x in (u[:, 1:97], u[:, 4:100]):
        y = dsmatvec.ds_matvec_batched(split, x)
        torch.testing.assert_close(
            y, dsmatvec.ds_matvec_batched_plain(split, x), rtol=1e-12,
            atol=1e-12)
    idx = torch.tensor([4, 0, 2], device=cuda)
    sub = dsmatvec.DsSplit(split.hi[idx], split.lo[idx])
    x = u[idx, :96]
    torch.testing.assert_close(dsmatvec.ds_matvec_batched(sub, x),
                               dsmatvec.ds_matvec_batched_plain(sub, x),
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="at most 65535"):
        big = dsmatvec.split_operand(torch.zeros(65536, 1, 4,
                                                 dtype=torch.float64,
                                                 device=cuda))
        dsmatvec.ds_matvec_batched(big, torch.zeros(65536, 4,
                                                    dtype=torch.float64,
                                                    device=cuda))


@pytest.mark.parametrize("shape", [(1024, 100, 100), (3, 37, 101),
                                   (5, 64, 96)])
def test_ds_matvec_pair_kernel_matches_plain(cuda, shape):
    """K3 (float32 x, the float32 pair out) against its plain version: the
    pair's sums agree to 1e-12 of max |A| |x| per lane, also for x a
    column slice of a wider iterate (the scalar loads)."""
    B, m, n = shape
    rng = np.random.RandomState(B + m + n)
    A = torch.tensor(rng.randn(B, m, n), device=cuda)
    u = torch.tensor(rng.randn(B, n + 3) * 22.0, device=cuda,
                     dtype=torch.float32)
    split = dsmatvec.split_operand(A)
    for x in (u[:, :n].contiguous(), u[:, 3:]):
        before = dsmatvec.pair_launches
        hi, lo = dsmatvec.ds_matvec_pair_batched(split, x)
        torch.cuda.synchronize()
        assert dsmatvec.pair_launches == before + 1
        rh, rl = dsmatvec.ds_matvec_pair_batched_plain(split, x)
        got = hi.double() + lo.double()
        ref = rh.double() + rl.double()
        bound = 1e-12 * torch.matmul(A.abs(), x.double().abs().unsqueeze(-1)
                                     ).amax(1)
        assert bool(((got - ref).abs().amax(1, keepdim=True) <= bound).all())
        # and K2 with the same float32 x returns the sum rounded once
        y = dsmatvec.ds_matvec_batched(split, x)
        assert y.dtype == torch.float32
        assert bool(((y.double() - ref).abs()
                     <= 2.0 ** -23 * ref.abs() + bound).all())


def _small_batch(count=6):
    spec = ConeSpec(z=5, l=20, q=(5, 5, 5, 10))
    probs = [gen_planted(spec, n=30, seed=3 + i, density=0.3)
             for i in range(count)]
    A, b, c = (torch.stack([getattr(p.problem, k) for p in probs])
               for k in ("A", "b", "c"))
    bnd = torch.zeros(count, 0, dtype=torch.float64)
    return spec, A, b, c, bnd, np.asarray([p.opt for p in probs])


def test_mixed_batch_on_the_card_matches_the_plain_version(cuda):
    """The mixed batched solve with float64 state through K2 against the
    same solve on the CPU through its plain version: the same statuses,
    objectives within 1e-4 (1 + |pobj|), iteration counts within
    [0.8, 1.25]."""
    spec, A, b, c, bnd, _ = _small_batch()
    stg = Settings(linsys="direct", mixed_precision=True, fast_f32=False)
    dsmatvec.batched_launches = 0
    res = make_batch_solver(spec, stg)(
        A.to(cuda), b.to(cuda), c.to(cuda), bnd.to(cuda), bnd.to(cuda))
    launches = dsmatvec.batched_launches
    ref = make_batch_solver(spec, stg, device="cpu", ds_split=True)(
        A, b, c, bnd, bnd)
    assert torch.equal(res.status.cpu(), ref.status)
    assert bool((ref.status == 1).all())
    assert launches >= 4 * int(res.iters.max())
    assert bool(((res.pobj.cpu() - ref.pobj).abs()
                 <= 1e-4 * (1 + ref.pobj.abs())).all())
    ratio = res.iters.cpu().double() / ref.iters.double()
    assert bool(((0.8 <= ratio) & (ratio <= 1.25)).all())


def test_f32_state_batch_on_the_card_matches_the_plain_version(cuda):
    """The default mixed batched solve on the card (its fast phase with
    float32 state, through K2 and K3) against the same solve on the CPU
    through their plain versions: the same statuses, objectives within
    1e-3 of the planted optimum, iteration counts within [0.5, 2] (float32
    state rounds differently on the two devices, and the JAX package's
    own test of the phase allows 2x)."""
    spec, A, b, c, bnd, opts = _small_batch()
    dsmatvec.batched_launches = 0
    dsmatvec.pair_launches = 0
    res = make_batch_solver(spec, Settings(linsys="direct"))(
        A.to(cuda), b.to(cuda), c.to(cuda), bnd.to(cuda), bnd.to(cuda))
    launches, pair = dsmatvec.batched_launches, dsmatvec.pair_launches
    ref = make_batch_solver(spec, Settings(linsys="direct",
                                           mixed_precision=True),
                            device="cpu", ds_split=True)(A, b, c, bnd, bnd)
    assert torch.equal(res.status.cpu(), ref.status)
    assert bool((ref.status == 1).all())
    assert launches >= 2 * int(res.iters.max())
    assert pair >= 2 * int(res.iters.max())
    err = (res.pobj.cpu().numpy() - opts) / (1 + np.abs(opts))
    assert np.all(np.abs(err) <= 1e-3)
    ratio = res.iters.cpu().double() / ref.iters.double()
    assert bool(((0.5 <= ratio) & (ratio <= 2.0)).all())


def test_f32_state_below_the_floor_polishes_on_the_card(cuda):
    """Targets below the fast floor on the card: the state returns to
    float64 at the phase's end, every lane is repaired and polished
    through K2, and reaches the tight eps."""
    spec, A, b, c, bnd, opts = _small_batch()
    eps = 1e-7
    solver = make_chunked_batch_solver(
        spec, Settings(linsys="direct", eps_abs=eps, eps_rel=eps,
                       chunk_iters=100))
    res = solver(A.to(cuda), b.to(cuda), c.to(cuda), bnd.to(cuda),
                 bnd.to(cuda))
    assert solver.machinery.f32_state
    assert solver.machinery.polished == A.shape[0]
    assert bool((res.status == 1).all())
    assert float(res.res_pri.max()) < 10 * eps
    err = (res.pobj.cpu().numpy() - opts) / (1 + np.abs(opts))
    assert np.all(np.abs(err) <= 1e-5)
