"""scs_tpu_torch's CUDA kernels (K1-K5), its cone graphs and solves on the
card. Every test carries the `cuda` marker and skips without a CUDA
device. The file imports neither JAX nor the JAX package, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest.py configures JAX)."""

import dataclasses
import functools
import math
import types

import numpy as np
import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

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
    # more problems than gridDim.z's 65535: two launches, one a chunk
    big = dsmatvec.split_operand(torch.randn(65536, 1, 4,
                                             dtype=torch.float64,
                                             device=cuda))
    xb = torch.randn(65536, 4, dtype=torch.float64, device=cuda)
    before = dsmatvec.batched_launches
    yb = dsmatvec.ds_matvec_batched(big, xb)
    torch.cuda.synchronize()
    assert dsmatvec.batched_launches == before + 2
    torch.testing.assert_close(yb, dsmatvec.ds_matvec_batched_plain(big, xb),
                               rtol=1e-12, atol=1e-12)


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


VARIANT_NS = [3, 100, 128, 129, 2048]
VARIANTS = ["aligned", "x misaligned", "A misaligned", "x float32", "pair",
            "B = 1"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n", VARIANT_NS)
def test_ds_matvec_variants_match_plain(cuda, n, variant):
    """Every variant the launcher picks (threads per row from n; A's and
    x's 16-byte loads each from its own alignment) against the plain
    version, per lane to 1e-12 of max |A| |x| (K3: the pair's sum; a
    float32 y: plus its one rounding). x misaligned is a column slice of a
    wider iterate; A misaligned starts hi and lo one float into their
    storage."""
    B, m = (1, 300) if variant == "B = 1" else (3, 37)
    rng = np.random.RandomState(n + len(variant))
    full = torch.tensor(rng.randn(B, m, n + 1), device=cuda)
    if variant == "A misaligned":
        s = dsmatvec.split_operand(full)
        split = dsmatvec.DsSplit(s.hi[..., 1:], s.lo[..., 1:])
    else:
        split = dsmatvec.split_operand(full[..., :n].contiguous())
    A = split.hi.double() + split.lo.double()
    u = torch.tensor(rng.randn(B, n + 3) * 22.0, device=cuda)
    x = u[:, 1:1 + n] if variant in ("x misaligned", "pair") else \
        u[:, :n].contiguous()
    if variant in ("x float32", "pair"):
        x = x.to(torch.float32) if variant == "x float32" else \
            u.to(torch.float32)[:, 1:1 + n]
    cfg = dsmatvec.launch_config(
        B, m, n, split.hi.stride(1), split.hi.stride(0), x.stride(0),
        (split.hi.data_ptr(), split.lo.data_ptr(), x.data_ptr()),
        x.element_size())
    assert cfg.vec_a == (n % 4 == 0 and variant != "A misaligned")
    assert cfg.vec_x == (cfg.vec_a and variant not in ("x misaligned",
                                                       "pair"))
    bound = 1e-12 * torch.matmul(A.abs(), x.double().abs().unsqueeze(-1)
                                 ).squeeze(-1)
    if variant == "pair":
        hi, lo = dsmatvec.ds_matvec_pair_batched(split, x)
        rh, rl = dsmatvec.ds_matvec_pair_batched_plain(split, x)
        got, ref = hi.double() + lo.double(), rh.double() + rl.double()
    else:
        got = dsmatvec.ds_matvec_batched(split, x).double()
        ref = dsmatvec.ds_matvec_batched_plain(split, x).double()
        if variant == "x float32":
            bound = bound + 2.0 ** -23 * ref.abs()
    torch.cuda.synchronize()
    lane = bound.amax(1, keepdim=True)
    assert bool(((got - ref).abs() <= lane).all())
    if variant == "B = 1":      # and K1 on the one problem
        y = dsmatvec.ds_matvec(dsmatvec.DsSplit(split.hi[0], split.lo[0]),
                               x[0])
        assert bool(((y - ref[0]).abs() <= lane[0]).all())


def test_ds_matvec_under_graph_capture_matches_eager(cuda):
    """K1 and K2 captured in a CUDA graph (as the indirect backend's CG
    blocks run them) and replayed give the eager launches' results
    bitwise: the same kernel and variant, no allocation or attribute set
    in the launch. K1's capture counts in `captured`, not `launches`."""
    rng = np.random.RandomState(5)
    s1 = dsmatvec.split_operand(torch.tensor(rng.randn(2048, 2048),
                                             device=cuda))
    x1 = torch.tensor(rng.randn(2048), device=cuda)
    s2 = dsmatvec.split_operand(torch.tensor(rng.randn(8, 100, 100),
                                             device=cuda))
    u = torch.tensor(rng.randn(8, 201), device=cuda)
    x2 = u[:, 1:101]
    eager = (dsmatvec.ds_matvec(s1, x1), dsmatvec.ds_matvec_batched(s2, x2))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    launches, captured = dsmatvec.launches, dsmatvec.captured
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            out = (dsmatvec.ds_matvec(s1, x1),
                   dsmatvec.ds_matvec_batched(s2, x2))
    torch.cuda.current_stream().wait_stream(stream)
    assert dsmatvec.launches == launches
    assert dsmatvec.captured == captured + 1
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for g, e in zip(out, eager):
            assert torch.equal(g, e)


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


# ---- K4, K5 and the indirect backend ----

@pytest.mark.parametrize("shape", [((2, 37, 53), (2, 53, 29)),
                                   ((4, 512, 512), (4, 512, 512)),
                                   ((1, 1, 70), (1, 70, 130)),
                                   ((2, 128, 64), (2, 64, 192)),
                                   ((3, 37, 1), (3, 1, 29)),
                                   ((1, 70, 130), (1, 130, 66)),
                                   ((1, 64, 64), (1, 64, 64)),
                                   ((7, 33, 45), (7, 45, 50))])
def test_ds_matmul_kernel_matches_plain(cuda, shape):
    """K4 against its plain version: both sum the same exact float64
    products in another order, so they agree to 1e-13 of max |A| |B|.
    Shapes: full tiles, ragged m, n and k (k = 1), k and n not multiples
    of 4 (4-byte staging), B = 1 and B = 7."""
    from scs_tpu_torch.ops import dsmatmul

    rng = np.random.RandomState(sum(shape[0]))
    A = torch.tensor(rng.randn(*shape[0]), device=cuda)
    B = torch.tensor(rng.randn(*shape[1]), device=cuda)
    a, b = dsmatvec.split_operand(A), dsmatvec.split_operand(B)
    before = dsmatmul.launches
    C = dsmatmul.ds_matmul_pairs(a, b)
    torch.cuda.synchronize()
    assert dsmatmul.launches == before + 1
    ref = dsmatmul.ds_matmul_plain(a, b)
    bound = 1e-13 * float(torch.matmul(A.abs(), B.abs()).max())
    assert float((C - ref).abs().max()) <= bound
    torch.testing.assert_close(dsmatmul.ds_matmul(A, B), ref, rtol=0,
                               atol=bound)


@pytest.mark.parametrize("b_scale", [1e-8, 1.0])
@pytest.mark.parametrize("shape", [(4096, 4096), (37, 101), (130, 257)])
def test_read_rowsum_kernel_matches_plain(cuda, shape, b_scale):
    """K5 against its plain version, b as small as the low half of a
    double-single split (the probe's input) or of a's magnitude. Float32
    sums in two orders agree to 4 ceil(log2 n) 2^-24 sum_j |a + b| per row:
    at these shapes the kernel adds at most 39 terms in sequence (n/128
    per accumulator with 16-byte loads, n/32 without, then 7 combining
    adds), and a kernel that dropped b or read a twice would miss that
    limit by orders of magnitude where b is of a's magnitude."""
    from scs_tpu_torch.ops import roofline

    m, n = shape
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    a = torch.randn(m, n, generator=gen, device=cuda)
    b = torch.randn(m, n, generator=gen, device=cuda) * b_scale
    before = roofline.launches
    o = roofline.read_rowsum(a, b)
    torch.cuda.synchronize()
    assert roofline.launches == before + 1 and o.shape == (m, 1)
    ref = roofline.read_rowsum_plain(a, b)
    tol = (4 * math.ceil(math.log2(n)) * 2.0 ** -24
           * (a + b).abs().sum(1, keepdim=True))
    assert bool(((o - ref).abs() <= tol).all())


def test_indirect_solve_on_the_card_matches_the_plain_version(cuda):
    """The default settings (the indirect backend, mixed on the card)
    through K1 against the same solve on the CPU through its plain
    version, and the pure float64 indirect solve on both devices, over
    the planted instances of seeds 3-9: on every instance the same
    status, SCS's termination test passed by the card's point,
    recomputed in float64 (chip_smoke.termination_failures), and the
    card's objective within eps (eps_abs + eps_rel |opt|) of the planted
    optimum; over the instances, the median of the card's iteration count
    over the CPU's within [0.8, 1.25]. One instance's count is no measure
    of the card: the two devices sum in other orders, CG stops on
    data-dependent tests, and a last-bit change of b moves seed 3's count
    over 175-225 (tools/torch_iteration_spread.py;
    tools/torch_card_trajectory.py shows where the card's trajectory
    leaves the CPU's)."""
    from chip_smoke import termination_failures

    spec = ConeSpec(z=5, l=20, q=(5, 5, 5, 10))
    for stg, cpu_stg in ((Settings(), Settings(mixed_precision=True)),
                         (Settings(mixed_precision=False),
                          Settings(mixed_precision=False))):
        ratios = []
        for seed in range(3, 10):
            p = gen_planted(spec, n=30, seed=seed, density=0.3)
            dsmatvec.launches = 0
            ws = Workspace(p.problem, spec, p.cone_data, stg)
            sol, info = ws.solve()
            launches = dsmatvec.launches
            cpu = Workspace(p.problem, spec, p.cone_data, cpu_stg,
                            device="cpu", ds_split=cpu_stg.mixed_precision)
            _, ref = cpu.solve()
            assert info.status == ref.status == "solved", seed
            assert info.lin_sys_solver == "dense-indirect-jacobi-pcg"
            assert ws.tot_cg_its > info.iter
            if ws._mixed:
                assert launches >= 2 * info.iter
            eps = stg.eps_abs + stg.eps_rel * abs(p.opt)
            assert abs(info.pobj - p.opt) <= eps, (seed, info.pobj, p.opt)
            batch = tuple(getattr(p.problem, k).to(cuda)[None] for k in "Abc")
            res = types.SimpleNamespace(**{
                k: torch.as_tensor(getattr(sol, k), device=cuda)[None]
                for k in "xys"})
            fails = termination_failures(batch, res, stg)
            assert not any(m.any() for m in fails.values()), (seed, fails)
            ratios.append(info.iter / ref.iter)
        assert 0.8 <= float(np.median(ratios)) <= 1.25, ratios


def test_indirect_batch_on_the_card_matches_the_plain_version(cuda):
    """B = 8 through the default settings (indirect, mixed, float32-state
    fast phase, K2) against the same batch on the CPU through the plain
    versions: the same statuses, objectives within 1e-3 of the planted
    optimum, iteration counts within [0.5, 2]."""
    spec, A, b, c, bnd, opts = _small_batch(8)
    dsmatvec.batched_launches = 0
    res = make_chunked_batch_solver(spec, Settings())(
        A.to(cuda), b.to(cuda), c.to(cuda), bnd.to(cuda), bnd.to(cuda))
    launches = dsmatvec.batched_launches
    ref = make_chunked_batch_solver(spec, Settings(mixed_precision=True),
                                    device="cpu", ds_split=True)(
        A, b, c, bnd, bnd)
    assert torch.equal(res.status.cpu(), ref.status)
    assert bool((ref.status == 1).all())
    assert launches >= 2 * int(res.iters.max())
    assert bool((res.tot_cg_its > res.iters).all())
    err = (res.pobj.cpu().numpy() - opts) / (1 + np.abs(opts))
    assert np.all(np.abs(err) <= 1e-3)
    ratio = res.iters.cpu().double() / ref.iters.double()
    assert bool(((0.5 <= ratio) & (ratio <= 2.0)).all())


def test_indirect_cg_graphs_change_nothing(cuda, monkeypatch):
    """The CG blocks replayed as CUDA graphs run the eager loop's
    algorithm: on one batched PCG solve (float64 and float32) the same
    iteration counts and solutions within 1e-12 (float64) or 1e-5
    (float32) of the eager loop's, relative to their norm (the two are
    not bitwise equal; the cause is not isolated); a second solve replays
    the cached graph and gives the first one's result bitwise. A batch
    solve through graphs and eagerly, pure float64 at eps 1e-7, ends with
    the same statuses and objectives within 1e-4 (1 + |pobj|): at that eps
    both runs end far closer to the optimum than the limit, whatever
    rounding separates their trajectories (at the default eps with float32
    state two runs may end 7e-4 apart on a lane, each within SCS's
    tolerance)."""
    from scs_tpu_torch.linsys import indirect

    rng = np.random.RandomState(9)
    B, m, n = 8, 60, 40
    A = torch.tensor(rng.randn(B, m, n), device=cuda)
    dr = torch.tensor(np.concatenate([np.full((B, n), 1e-6),
                                      np.ones((B, m)), np.ones((B, 1))], 1),
                      device=cuda)
    b = torch.tensor(rng.randn(B, n), device=cuda)
    for dt, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        ops = (A.to(dt), None, dr.to(dt))
        M = 1.0 / (dr[:, :n] + (A * A).sum(1)).to(dt)
        tol = torch.full((B,), 1e-10 if dt == torch.float64 else 1e-5,
                         dtype=dt, device=cuda)
        out = {}
        for graphs in (False, True, True):
            x, its = indirect._pcg(ops, M, None, b.to(dt), 10 * n, tol,
                                   eager=not graphs)
            if graphs in out:
                assert torch.equal(x, out[graphs][0])
                assert torch.equal(its, out[graphs][1])
            out[graphs] = (x, its)
        (xe, ie), (xg, ig) = out[False], out[True]
        assert torch.equal(ie, ig), (ie, ig)
        assert float((xg - xe).norm() / xe.norm()) <= rtol

    spec, A, b, c, bnd, _ = _small_batch(8)
    args = (A.to(cuda), b.to(cuda), c.to(cuda), bnd.to(cuda), bnd.to(cuda))
    stg = Settings(mixed_precision=False, eps_abs=1e-7, eps_rel=1e-7)
    runs = [make_batch_solver(spec, stg)(*args)]
    monkeypatch.setattr(indirect, "_pcg",
                        functools.partial(indirect._pcg, eager=True))
    runs.append(make_batch_solver(spec, stg)(*args))
    assert torch.equal(runs[0].status, runs[1].status)
    p0, p1 = runs[0].pobj, runs[1].pobj
    assert bool(((p0 - p1).abs() <= 1e-4 * (1 + p1.abs())).all())


# ---- the box, exp and power cones, and repeatability ----

def _cone_args(fam, lead, dtype, dev):
    gen = torch.Generator(device="cpu").manual_seed(17)

    def rnd(*shape):
        return torch.randn((*lead, *shape), generator=gen,
                           dtype=torch.float64).to(dtype).to(dev)

    if fam == "box":
        from scs_tpu_torch.cones.box import proj_box_cone
        bl, bu = -(0.5 + rnd(8).abs()), 0.5 + rnd(8).abs()
        bu[..., 3] = math.inf
        return proj_box_cone, (2.0 * rnd(9), bl, bu, 0.5 + rnd().abs(),
                               0.01 + rnd(9).abs())
    if fam == "exp":
        from scs_tpu_torch.cones.exp import proj_exp_batch
        return proj_exp_batch, (2.0 * rnd(23, 3),
                                torch.arange(23, device=dev) < 15)
    from scs_tpu_torch.cones.power import proj_power_batch
    a = torch.linspace(-0.9, 0.9, 10, dtype=torch.float64)
    return proj_power_batch, (2.0 * rnd(10, 3),
                              torch.where(a == 0, 0.5, a).to(dtype).to(dev))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("fam", ["box", "exp", "power"])
def test_cone_graph_matches_eager(cuda, fam, dtype):
    """Each cone family replayed as a CUDA graph (`graphs.run`) gives its
    eager run's output bitwise, on one problem and on a batch of 64; the
    eager run on the card agrees with the CPU's within 1e-12 (float64) or
    1e-5 (float32) relative (the two devices' exp, log and pow round in
    other last bits)."""
    from scs_tpu_torch.cones import graphs
    for lead in ((), (64,)):
        fn, args = _cone_args(fam, lead, dtype, cuda)
        eager = fn(*args)
        before = graphs.captures
        for _ in range(2):
            out = graphs.run(fn, args)
        assert graphs.captures <= before + 1
        eager = (eager,) if torch.is_tensor(eager) else eager
        out = (out,) if torch.is_tensor(out) else out
        for g, e in zip(out, eager):
            assert torch.equal(g, e)
        cpu = fn(*(a.cpu() for a in args))
        cpu = (cpu,) if torch.is_tensor(cpu) else cpu
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        for g, c in zip(out, cpu):
            err = (g.cpu().double() - c.double()).abs() / c.double().abs(
                ).clamp_min(1.0)
            assert float(err.max()) <= tol


def _mixed_cone_problem():
    from scs_tpu_torch.models import mixed_cones
    spec = ConeSpec(z=3, l=10, bsize=6, q=(4, 3), ep=3, ed=2,
                    p=(0.4, -0.7, 0.25))
    return spec, mixed_cones.gen_mixed(spec, 15, 21, 0.5)


@pytest.mark.parametrize("exp_f32", [None, True])
@pytest.mark.parametrize("linsys", ["direct", "indirect"])
def test_mixed_cone_solve_on_the_card(cuda, linsys, exp_f32):
    """One box/SOC/exp/power program per backend in the card's default
    mode (mixed, every cone projected in float64) and with the exp cones
    in float32 on the fast phase (`exp_f32=True`), each finished by the
    float64 re-projection: solved, within 1e-3 of the planted optimum,
    and within 1e-4 (1 + |pobj|) of the pure float64 solve on the CPU
    through the direct backend, 1e-3 through the indirect one (its CG
    stops on data-dependent tests, so the two solves end at different
    iterates, each only as accurate as SCS's eps 1e-4 guarantees, as in
    tests/test_torch_indirect.py)."""
    spec, p = _mixed_cone_problem()
    ws = Workspace(p.problem, spec, p.cone_data,
                   Settings(linsys=linsys, exp_f32=exp_f32))
    assert ws._mixed and ws._repolish
    sol, info = ws.solve()
    _, ref = Workspace(p.problem, spec, p.cone_data,
                       Settings(linsys=linsys, mixed_precision=False),
                       device="cpu").solve()
    assert info.status == ref.status == "solved"
    assert abs(info.pobj - p.opt) <= 1e-3 * (1 + abs(p.opt))
    tol = 1e-4 if linsys == "direct" else 1e-3
    assert abs(info.pobj - ref.pobj) <= tol * (1 + abs(ref.pobj))
    assert abs(float(sol.s @ sol.y)) <= 1e-9 * max(
        np.abs(sol.s).max(), np.abs(sol.y).max(), 1.0)


def test_two_solves_repeat_on_the_card(cuda):
    """Two solves of one instance on the card take the same iterations
    and give the same bits (indirect, pure float64; and the mixed default
    with its float32-state batch of 8)."""
    spec, p = _mixed_cone_problem()
    runs = []
    for _ in range(2):
        ws = Workspace(p.problem, spec, p.cone_data,
                       Settings(mixed_precision=False))
        sol, info = ws.solve()
        runs.append((info.iter, ws.tot_cg_its, sol.x, sol.y, sol.s))
    assert runs[0][:2] == runs[1][:2]
    for a, b in zip(runs[0][2:], runs[1][2:]):
        assert np.array_equal(a, b)
    spec, A, b, c, bnd, _ = _small_batch(8)
    args = (A.to(cuda), b.to(cuda), c.to(cuda), bnd.to(cuda), bnd.to(cuda))
    its = [make_chunked_batch_solver(spec, Settings(linsys="direct"))(
        *args).iters.cpu() for _ in range(2)]
    assert torch.equal(its[0], its[1])


def _spectral_segments(family, shape, width, seed):
    rng = np.random.RandomState(seed)
    v = 2.0 * rng.randn(*shape, width)
    if family != "logdet":
        v[..., 0] *= 1.0 + 3.0 * (rng.rand(*shape) < 0.3)
    return v


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32_eig"])
@pytest.mark.parametrize("family", ["logdet", "nuclear", "ell1",
                                    "sum-largest"])
def test_spectral_family_on_the_card_matches_the_plain_version(cuda, family,
                                                               f32):
    """Each spectral family at the spectral headline batch's shape (1024
    lanes, `models/spectral_cones.headline_spectral_spec`), projected on
    the card and by the plain version on the CPU: within 1e-8 (1 + |v|)
    with float64 eig, 1e-4 with float32 eig (the two devices' float32
    eigh and SVD); logdet cones within 1e-6, the distance from the
    projection at which Newton's stopping test (directional derivative
    below 2e-12, Hessian at least the identity) may stop on either
    device; logdet cones whose Newton stops at its cap or that run the
    IPM, on either side, are held to SCS's KKT gate instead (on the
    vector cone, through the kernel and its plain version)."""
    from scs_tpu_torch.cones import project, spectral
    from scs_tpu_torch.models import spectral_cones
    from scs_tpu_torch.ops import logdet
    spec = spectral_cones.headline_spectral_spec()
    (_, _, ct, width, fn), = [r for r in project.spectral_runs(spec, f32)
                              if r[0] == family]
    v = _spectral_segments(family, (1024, ct), width, 40 + len(family))
    keep = torch.ones(1024, dtype=torch.bool)
    if family == "logdet":
        fn = functools.partial(spectral.proj_logdet_batch_info,
                               **fn.keywords)
        (ref, ref_info), (got, got_info) = (
            fn(torch.as_tensor(v, device=dev))
            for dev in (torch.device("cpu"), cuda))
        keep &= (ref_info < 100).reshape(-1) & (got_info.cpu() < 100
                                                ).reshape(-1)
    else:
        ref, got = (fn(torch.as_tensor(v, device=dev))
                    for dev in (torch.device("cpu"), cuda))
    ref = ref.reshape(1024, -1)
    got = got.reshape(1024, -1).cpu()
    if family == "logdet":
        t0 = torch.as_tensor(v[:, 0, 0] * math.sqrt(2.0))
        v0 = torch.as_tensor(v[:, 0, 1] * math.sqrt(2.0))
        ns = fn.keywords["ns"]
        from scs_tpu_torch.cones.psd import svec_to_mat
        w = torch.linalg.eigvalsh(svec_to_mat(
            torch.as_tensor(v[:, 0, 2:]), ns) * math.sqrt(2.0))
        for res in (logdet.logdet_cone(t0.to(cuda), v0.to(cuda), w.to(cuda)),
                    spectral.logdet_cone_plain(t0, v0, w)):
            ok = spectral._logdet_gate(*(r.cpu() for r in res[:3]), t0, v0,
                                       w)
            assert bool(ok.all())
    assert keep.float().mean() >= 0.95
    err = float((got - ref)[keep].abs().max()) / (1 + np.abs(v).max())
    tol = 1e-4 if f32 else 1e-8
    assert err <= (max(tol, 1e-6) if family == "logdet" else tol), err


def test_spectral_kernels_launch_and_match_plain(cuda):
    """The logdet cascade kernel and the sum-of-k-largest loop kernel
    against their plain versions on the CPU, on the eigenvalues of random
    logdet blocks: cones whose Newton
    converged inside its cap on both sides within 1e-6 (1 + |v|), where
    Newton's stopping test may stop on either device; on the
    others (Newton at its cap, or the IPM, where round-off moves the
    capped point) the card's result passes SCS's KKT gate wherever the
    plain version's does. The path-following loop within 1e-12 on every
    cone."""
    from scs_tpu_torch.cones import spectral
    from scs_tpu_torch.cones.psd import svec_to_mat
    from scs_tpu_torch.ops import logdet, sumlargest
    rng = np.random.RandomState(9)
    for n in (3, 6, 16):
        v = 2.0 * rng.randn(256, n * (n + 1) // 2 + 2)
        w = torch.linalg.eigvalsh(svec_to_mat(torch.as_tensor(v[:, 2:]), n)
                                  * math.sqrt(2.0))
        args = [torch.as_tensor(v[:, 0] * math.sqrt(2.0)),
                torch.as_tensor(v[:, 1] * math.sqrt(2.0)), w]
        before = logdet.launches
        got = [a.cpu() for a in logdet.logdet_cone(*(a.to(cuda)
                                                     for a in args))]
        assert logdet.launches == before + 2
        ref = spectral.logdet_cone_plain(*args)
        keep = (got[3] < 100) & (ref[3] < 100)
        assert bool(keep.any())
        scale = 1.0 + float(np.abs(v).max())
        for g, r in zip(got[:3], ref[:3]):
            assert float((g - r)[keep].abs().max()) <= 1e-6 * scale
        ok_card, ok_plain = (spectral._logdet_gate(*res[:3], *args)
                             for res in (got, ref))
        assert bool((ok_card | ~ok_plain)[~keep].all())
    for n in (6, 40):
        x = -torch.sort(-torch.as_tensor(rng.randn(64, n) * 2.0)).values
        t0 = torch.as_tensor(rng.randn(64) * 2.0)
        for k in sorted({1, n // 2, n - 1}):
            before = sumlargest.launches
            got = [a.cpu() for a in sumlargest.sum_largest_sorted(
                t0.to(cuda), x.to(cuda), k)]
            assert sumlargest.launches == before + 1
            ref = spectral._sum_largest_sorted_plain(t0, x, k)
            for g, r in zip(got, ref):
                assert float((g - r).abs().max()) <= 1e-12 * float(
                    x.abs().max() + 1)


# orders crossing every group width (lanes 4, 8, 16, 32), the two register
# layouts, and shared memory with a block of warps a cone, at L = 1, 5,
# 1024; shared memory with three warps a cone (n = 400) and the global
# scratch (n = 1300) at L = 1, 5
LOGDET_NS = [1, 2, 5, 6, 13, 29, 30, 60, 120]
LOGDET_CASES = ([(n, L) for n in LOGDET_NS for L in (1, 5, 1024)]
                + [(n, L) for n in (400, 1300) for L in (1, 5)])


def _logdet_case(n, L):
    """L random logdet blocks of order n (t0, v0, eigenvalues) on the CPU,
    the first of them one that runs the IPM (`chip_smoke.
    _logdet_ipm_blocks`, run from the repo root), and their scale 1 +
    max |v|."""
    import chip_smoke
    args = chip_smoke._logdet_ipm_blocks(n, L, 7 + n)
    return args, 1.0 + float(max(a.abs().max() for a in args))


@pytest.mark.parametrize("n, L", LOGDET_CASES)
def test_logdet_kernel_layouts_match_plain(cuda, n, L):
    """The logdet cascade kernel in every layout of `ops/logdet.
    launch_config` (lanes a group, registers or shared memory, a warp or
    a block of warps a cone, the IPM in its own launch) against its plain
    version on the CPU: cones whose Newton converged inside its cap on
    both sides within 1e-6 (1 + |v|), Newton's stopping tolerance; on the
    others (Newton at its cap or stopped at v's floor of 1e-14, where it
    gives up unconverged, or the IPM) the card's result passes SCS's KKT
    gate wherever the plain version's does. The first cone runs the IPM
    on both sides."""
    from scs_tpu_torch.cones import spectral
    from scs_tpu_torch.ops import logdet
    args, scale = _logdet_case(n, L)
    before = logdet.launches
    got = [a.cpu() for a in logdet.logdet_cone(*(a.to(cuda) for a in args))]
    assert logdet.launches == before + 2
    ref = spectral.logdet_cone_plain(*args)
    assert int(got[3][0]) >= 1000 and int(ref[3][0]) >= 1000
    keep = (got[3] < 100) & (ref[3] < 100) & (got[1] > 1e-14) & (
        ref[1] > 1e-14)
    for g, r in zip(got[:3], ref[:3]):
        assert bool(torch.isfinite(g).all())
        if keep.any():
            assert float((g - r)[keep].abs().max()) <= 1e-6 * scale
    ok_card, ok_plain = (spectral._logdet_gate(*res[:3], *args)
                         for res in (got, ref))
    assert bool((ok_card | ~ok_plain)[~keep].all())


@pytest.mark.parametrize("n", [6, 60, 120])
def test_logdet_kernel_repeats_bit_for_bit(cuda, n):
    """Two launches of the logdet kernel on the same inputs, IPM cones
    among them: the same bits (no sum depends on timing, and a line
    search takes the first passing trial point whatever the groups)."""
    from scs_tpu_torch.ops import logdet
    args, _ = _logdet_case(n, 1024)
    dev = [a.to(cuda) for a in args]
    first, second = (logdet.logdet_cone(*dev) for _ in range(2))
    assert int((first[3] >= 1000).sum()) >= 1
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [2, 6, 13, 14, 40, 300])
def test_sum_largest_kernel_layouts_match_plain(cuda, n):
    """The sum-of-k-largest kernel with its rows read in place (n < 14) or
    staged in shared memory, 128 cones a block or, at n = 300, 96 (231
    KB): within 1e-12 of its plain version for k = 1, n / 2, n - 1, over
    blocks of which the last is partly filled."""
    from scs_tpu_torch.cones import spectral
    from scs_tpu_torch.ops import sumlargest
    rng = np.random.RandomState(n)
    L = 300
    x = -torch.sort(-torch.as_tensor(rng.randn(L, n) * 2.0)).values
    t0 = torch.as_tensor(rng.randn(L) * 2.0)
    for k in sorted({1, n // 2, n - 1}):
        before = sumlargest.launches
        got = [a.cpu() for a in sumlargest.sum_largest_sorted(
            t0.to(cuda), x.to(cuda), k)]
        assert sumlargest.launches == before + 1
        ref = spectral._sum_largest_sorted_plain(t0, x, k)
        for g, r in zip(got, ref):
            assert float((g - r).abs().max()) <= 1e-12 * float(
                x.abs().max() + 1)


@pytest.mark.parametrize("linsys", ["direct", "indirect"])
def test_spectral_solve_on_the_card(cuda, linsys):
    """A small program with all four spectral families in the card's
    default mode (mixed, the forced float64 polish): solved, its
    objective within eps_abs + eps_rel |opt| of the planted optimum."""
    spec = ConeSpec(z=2, l=4, d=(3,), nuc_m=(3,), nuc_n=(2,), ell1=(3,),
                    sl_n=(3,), sl_k=(1,))
    p = gen_planted(spec, n=10, seed=107, density=0.5)
    stg = Settings(linsys=linsys)
    ws = Workspace(p.problem, spec, p.cone_data, stg)
    assert ws._mixed
    sol, info = ws.solve()
    assert info.status == "solved"
    assert abs(info.pobj - p.opt) <= stg.eps_abs + stg.eps_rel * abs(p.opt)


@pytest.mark.parametrize("shape", [((37, 53), (53, 29)),
                                   ((8, 3000), (3000, 8)),
                                   ((3, 24, 2100), (3, 2100, 17))],
                         ids=["one chunk", "chunked", "batched chunked"])
def test_ozaki_matmul_on_the_card(cuda, shape):
    """`ops/ozaki.py` on the card: bf16 slices, their pair products on the
    tensor cores with float32 accumulation and output (contractions over
    1024 chunked), combined in float64: within 1e-14 of A's row scale x
    B's column scale x k of numpy's long-double product, as on the CPU
    (tests/test_torch_ozaki.py); the bf16 reduction flag is as before."""
    from scs_tpu_torch.ops import ozaki
    rng = np.random.RandomState(sum(shape[0]))
    A, B = rng.randn(*shape[0]), rng.randn(*shape[1])
    flags = torch.backends.cuda.matmul
    before = flags.allow_bf16_reduced_precision_reduction
    C = ozaki.ozaki_matmul(torch.as_tensor(A, device=cuda),
                           torch.as_tensor(B, device=cuda)).cpu().numpy()
    assert flags.allow_bf16_reduced_precision_reduction == before
    T = np.matmul(A.astype(np.longdouble), B.astype(np.longdouble))
    scale = (np.abs(A).max(-1, keepdims=True)
             * np.abs(B).max(-2, keepdims=True) * A.shape[-1])
    assert np.all(np.isfinite(C))
    assert float(np.max(np.abs((C - T).astype(np.float64)) / scale)) < 1e-14


def _sparse_tails(m=400, n=300, seed=9):
    """tests/test_sparse.py's tails fixture at a larger size: random
    sparse entries, dense rows 3 and 41 and dense columns 0 and 17 as
    tails; (scipy CSC, SparseA on the CPU)."""
    import scipy.sparse as sp
    from scs_tpu_torch.ops import sparse
    rng = np.random.RandomState(seed)
    A = sp.random(m, n, density=0.05, random_state=rng,
                  data_rvs=rng.randn).tolil()
    for r in (3, 41):
        A[r, :] = rng.randn(n)
    for c in (0, 17):
        A[:, c] = rng.randn(m, 1)
    A = A.tocsc()
    return A, sparse.sparse_from_scipy(A, dense_rows=(3, 41),
                                       dense_cols=(0, 17))


def test_ds_sparse_matvec_on_the_card_matches_the_plain_version(cuda):
    """K2s on the tiles and K1 on the two tails of each direction against
    the plain versions, within 1e-13 (1 + max |A||x|), and one K2s and two
    K1 launches an apply (K2 no longer runs on a sparse operand)."""
    from scs_tpu_torch.ops import ellmatvec, sparse
    A, S = _sparse_tails()
    S = S.to(cuda)
    rng = np.random.RandomState(1)
    for T, M in ((S, A), (S.T, A.T)):
        ds = sparse.ds_split_sparse(T)
        x = torch.tensor(rng.randn(M.shape[1]), device=cuda)
        before = (dsmatvec.launches, dsmatvec.batched_launches,
                  ellmatvec.pair_launches)
        y = sparse.ds_sparse_matvec(ds, x)
        torch.cuda.synchronize()
        assert (dsmatvec.launches - before[0],
                dsmatvec.batched_launches - before[1],
                ellmatvec.pair_launches - before[2]) == (2, 0, 1)
        ref = sparse.ds_sparse_matvec(ds, x, plain=True)
        xh = x.cpu().numpy()
        tol = 1e-13 * (1 + float((abs(M) @ np.abs(xh)).max()))
        assert float((y - ref).abs().max()) <= tol
        assert float(np.abs(y.cpu().numpy() - M @ xh).max()) <= tol


def test_sparse_indirect_mixed_solve_on_the_card_matches_the_cpu(cuda):
    """demo_sparse at its widths and 3 stages (600 x 384; A' re-tiled at
    bn = 32) through the indirect backend, mixed: on the card (K2s on the
    pair, CG graphs on the float32 shadow through K2s) and on the CPU
    through the plain versions; the same status, objectives within 1e-4
    (1 + |pobj|), iteration counts within [0.8, 1.25] (CG stops on
    data-dependent tests, summed in other orders)."""
    from scs_tpu_torch import demo_sparse
    from scs_tpu_torch.ops import ellmatvec
    prob, spec, opt, _ = demo_sparse.build_problem(K=3, seed=3)
    stg = Settings(linsys="indirect", eps_abs=1e-5, eps_rel=1e-5)
    ellmatvec.pair_launches = ellmatvec.f32_launches = 0
    ws = Workspace(prob, spec, None, stg)
    _, info = ws.solve()
    launches = ellmatvec.pair_launches
    assert ellmatvec.f32_launches > 0
    cpu = Workspace(prob, spec, None, Settings(
        linsys="indirect", mixed_precision=True, eps_abs=1e-5,
        eps_rel=1e-5), device="cpu", ds_split=True)
    _, ref = cpu.solve()
    assert info.status == ref.status == "solved"
    assert launches >= 2 * info.iter
    assert abs(info.pobj - ref.pobj) <= 1e-4 * (1 + abs(ref.pobj))
    assert abs(info.pobj - opt) <= 1e-3 * (1 + abs(opt))
    assert 0.8 <= info.iter / ref.iter <= 1.25


def _ell_case(name: str):
    """(BlockedEll on the CPU in float64, scipy CSR) of one K2s layout
    case: the kernel's fast path at each width, the generic path (bm = 4;
    bn = 24), a few block-rows of many tiles (8 warps a block-row), more
    than 32 tiles a block-row on one warp, n not a multiple of 4."""
    import scipy.sparse as sp
    from scs_tpu_torch.ops import sparse
    rng = np.random.RandomState(7)
    if name == "many tiles":        # 16 x 1000 dense: 63 tiles of 16
        M = sp.csr_matrix(rng.randn(16, 1000))
        return sparse.ell_retile(sparse.sparse_from_scipy(
            M, dense_rows=(), dense_cols=()).fwd, 16), M
    if name == "long rows":         # 4400 block-rows of 40 tiles of 16
        nbr, kmax = 4400, 40
        ell = sparse.BlockedEll(
            torch.tensor(rng.randn(nbr, 8, kmax * 16)), torch.arange(
                kmax, dtype=torch.int32).repeat(nbr, 1), nbr * 8,
            kmax * 16, 8, 16, kmax)
        return ell, sp.csr_matrix(sparse.ell_to_dense(ell).numpy())
    m, n = (203, 61) if name == "n % 4" else (700, 500)
    M = sp.random(m, n, density=0.03, random_state=rng,
                  data_rvs=rng.randn, format="csr")
    if name == "generic":
        return sparse.sparse_from_scipy(M, bm=4, bn=24, dense_rows=(),
                                        dense_cols=()).fwd, M
    ell = sparse.sparse_from_scipy(M, dense_rows=(), dense_cols=()).fwd
    w = {"bn 16": 16, "bn 32": 32, "bn 64": 64}.get(name)
    return (ell if w is None else sparse.ell_retile(ell, w)), M


ELL_CASES = ["bn 16", "bn 32", "bn 64", "bn 128", "generic", "many tiles",
             "long rows", "n % 4"]


@pytest.mark.parametrize("name", ELL_CASES)
@pytest.mark.parametrize("kind", ["pair", "f32", "f64"])
def test_ell_matvec_kernel_matches_plain(cuda, kind, name):
    """K2s of each kind against its plain version on the card and scipy's
    float64 product, 1e-13 (1 + max |A||x|) for the pair and float64,
    1e-5 for float32; x aligned and an offset view (scalar loads); one
    launch a call; the same bits twice."""
    from scs_tpu_torch.ops import ellmatvec, sparse
    ell, M = _ell_case(name)
    ell = ell.to(cuda)
    rng = np.random.RandomState(2)
    xs = torch.tensor(rng.randn(M.shape[1] + 1), device=cuda,
                      dtype=torch.float32 if kind == "f32" else torch.float64)
    for x in (xs[:-1], xs[1:]):
        xh = x.cpu().numpy()
        absax = float((abs(M) @ np.abs(xh)).max())
        tol = (1e-5 if kind == "f32" else 1e-13) * (1 + absax)
        before = (ellmatvec.pair_launches, ellmatvec.f32_launches,
                  ellmatvec.f64_launches)
        if kind == "pair":
            ds = sparse.ds_split_ell(ell)
            y = sparse.ds_ell_matvec(ds, x)
            y2 = sparse.ds_ell_matvec(ds, x)
            ref = sparse.ds_ell_matvec(ds, x, plain=True)
        else:
            e = ell.astype(torch.float32) if kind == "f32" else ell
            y = sparse.ell_matvec(e, x)
            y2 = sparse.ell_matvec(e, x)
            ref = sparse.ell_matvec_plain(e, x)
        torch.cuda.synchronize()
        after = (ellmatvec.pair_launches, ellmatvec.f32_launches,
                 ellmatvec.f64_launches)
        k = ["pair", "f32", "f64"].index(kind)
        assert [a - b for a, b in zip(after, before)] == [
            2 * (i == k) for i in range(3)]
        assert torch.equal(y, y2)
        assert float((y.double() - ref.double()).abs().max()) <= tol
        assert float(np.abs(y.double().cpu().numpy() - M @ xh).max()) <= tol


def test_ell_matvec_kernel_reads_no_padded_slot(cuda):
    """NaN written into every padded slot of the tiles leaves the kernel's
    y unchanged, bit for bit, for each kind."""
    import scipy.sparse as sp
    from scs_tpu_torch.ops import sparse
    rng = np.random.RandomState(4)
    M = sp.random(300, 900, density=0.02, random_state=rng,
                  data_rvs=rng.randn, format="csr")
    ell = sparse.sparse_from_scipy(M, dense_rows=(), dense_cols=()).fwd
    assert int(ell.count.min()) < ell.kmax
    d = ell.data.clone().reshape(ell.idx.shape[0], ell.bm, ell.kmax, ell.bn)
    pad = torch.arange(ell.kmax) >= ell.count[:, None]
    d[pad.nonzero(as_tuple=True)[0], :, pad.nonzero(as_tuple=True)[1], :] = \
        float("nan")
    bad = dataclasses.replace(ell, data=d.reshape(ell.data.shape)).to(cuda)
    ell = ell.to(cuda)
    x = torch.tensor(rng.randn(900), device=cuda)
    for e, b in ((ell, bad), (ell.astype(torch.float32),
                              bad.astype(torch.float32))):
        assert torch.equal(sparse.ell_matvec(e, x), sparse.ell_matvec(b, x))
    ds = sparse.DsBlocked(*dsmatvec.split_operand(bad.data), bad.idx,
                          bad.count, bad.m, bad.n, bad.bm, bad.bn, bad.kmax)
    good = sparse.DsBlocked(*dsmatvec.split_operand(ell.data), ell.idx,
                            ell.count, ell.m, ell.n, ell.bm, ell.bn,
                            ell.kmax)
    assert torch.equal(sparse.ds_ell_matvec(ds, x),
                       sparse.ds_ell_matvec(good, x))


def test_ell_matvec_under_graph_capture_matches_eager(cuda):
    """K2s captured in a CUDA graph (as the CG blocks run the float32
    shadow) and replayed gives the eager launch's bits; the capture counts
    in `captured`, not in the launches."""
    from scs_tpu_torch.ops import ellmatvec, sparse
    ell, _ = _ell_case("bn 32")
    e32 = ell.astype(torch.float32).to(cuda)
    x = torch.tensor(np.random.RandomState(3).randn(ell.n),
                     dtype=torch.float32, device=cuda)
    eager = sparse.ell_matvec(e32, x)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    launches, captured = ellmatvec.f32_launches, ellmatvec.captured
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            out = sparse.ell_matvec(e32, x)
    torch.cuda.current_stream().wait_stream(stream)
    assert ellmatvec.f32_launches == launches
    assert ellmatvec.captured == captured + 1
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.parametrize("name", ["box", "exp", "power"])
def test_diff_through_graph_cones_on_the_card_matches_the_cpu(cuda, name):
    """make_diff_solver on the card through the box, exp and power
    projections (eager under autograd, `cones.graphs.eager`) gives the
    CPU's gradients within 1e-6 (1 + max |g|), both solved to eps 1e-11;
    `graphs.run` raises where autograd would record through a replay."""
    from scs_tpu_torch import make_diff_solver
    from scs_tpu_torch.cones import exp, graphs
    from scs_tpu_torch.models import diff_instances
    inst = getattr(diff_instances, f"{name}_instance")()
    spec, prob = inst[:2]
    raw = [prob.A, prob.b, prob.c] + list(inst[2:])
    w = torch.as_tensor(np.random.RandomState(5).randn(prob.A.shape[1]))
    stg = Settings(linsys="direct", eps_abs=1e-11, eps_rel=1e-11)
    grads = {}
    for dev in ("cpu", "cuda"):
        solve = make_diff_solver(spec, stg, device=dev)
        ts = [t.to(dev).clone().requires_grad_() for t in raw]
        (solve(*ts)[0] @ w.to(dev)).backward()
        grads[dev] = [t.grad.cpu() for t in ts]
    for g, c in zip(grads["cuda"], grads["cpu"]):
        assert float((g - c).abs().max()) <= 1e-6 * (
            1 + float(c.abs().max()))
    seg = torch.randn(4, 2, 3, dtype=torch.float64, device=cuda,
                      requires_grad=True)
    mask = torch.tensor([True, False], device=cuda)
    with pytest.raises(RuntimeError, match="autograd"):
        graphs.run(exp.proj_exp_batch, (seg, mask))


@pytest.mark.parametrize("shape", [(4096, 2048), (2048, 4096)])
def test_ds_matvec_kernel_at_the_row_shard_shapes(cuda, shape):
    """K1 on one rank's rows of the large SOCP (8192 x 2048 over two
    ranks) and on their transpose, against its plain version: 1e-12 of
    max |A| |x|."""
    m, n = shape
    rng = np.random.RandomState(m - n)
    A = torch.tensor(rng.randn(m, n), device=cuda)
    x = torch.tensor(rng.randn(n), device=cuda)
    split = dsmatvec.split_operand(A)
    before = dsmatvec.launches
    y = dsmatvec.ds_matvec(split, x)
    torch.cuda.synchronize()
    assert dsmatvec.launches == before + 1
    ref = dsmatvec.ds_matvec_plain(split, x)
    assert float((y - ref).abs().max()) <= 1e-12 * float(
        (A.abs() @ x.abs()).max())


def test_row_shard_k3_pairs_sum_in_float64_on_the_card(cuda):
    """The float32-state A' z of a row-sharded batch: two shards' K3 pairs
    composed in float64 and summed by hand, and the same through a
    one-rank gloo group (`RowShardedSplit.sum64`, CUDA tensors through
    gloo), against the float64 product of the exact hi + lo: 1e-12 of
    max |A'| |z| in every lane."""
    from scs_tpu_torch.ops import rowshard
    from scs_tpu_torch.parallel import multihost
    rng = np.random.RandomState(13)
    A = torch.tensor(rng.randn(16, 201, 100), device=cuda)
    z = torch.tensor(rng.randn(16, 201), device=cuda).to(torch.float32)
    full = dsmatvec.split_operand(A.transpose(1, 2))
    exact = full.hi.double() + full.lo.double()
    z64 = z.double().unsqueeze(-1)
    ref = torch.matmul(exact, z64).squeeze(-1)
    tol = 1e-12 * torch.matmul(exact.abs(), z64.abs()).squeeze(-1).amax(1)
    before = dsmatvec.pair_launches
    halves = [rowshard.shard_rows(A, None, rank=r, size=2).split()[1]
              for r in range(2)]
    got = sum(rowshard._local_ds_partial(h.split, h._rows(z))
              for h in halves)
    torch.cuda.synchronize()
    assert dsmatvec.pair_launches == before + 2
    assert bool(((got - ref).abs().amax(1) <= tol).all())
    multihost._ensure_group()
    try:
        one = rowshard.shard_rows(A, torch.distributed.group.WORLD)
        got1 = one.split()[1].sum64(z)
    finally:
        torch.distributed.destroy_process_group()
    assert got1.is_cuda and got1.dtype == torch.float64
    assert bool(((got1 - ref).abs().amax(1) <= tol).all())
