"""scs_tpu_torch's CUDA kernels (K1-K5), its cone graphs and solves on the
card. Every test carries the `cuda` marker and skips without a CUDA
device. The file imports neither JAX nor the JAX package, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest.py configures JAX)."""

import functools
import math

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
    version, and the pure float64 indirect solve on both devices: the
    same status, objectives within 1e-4 (1 + |pobj|), iteration counts
    within [0.8, 1.25] (CG stops on data-dependent tests, and the two
    devices sum in other orders)."""
    spec = ConeSpec(z=5, l=20, q=(5, 5, 5, 10))
    p = gen_planted(spec, n=30, seed=3, density=0.3)
    for stg, cpu_stg in ((Settings(), Settings(mixed_precision=True)),
                         (Settings(mixed_precision=False),
                          Settings(mixed_precision=False))):
        dsmatvec.launches = 0
        ws = Workspace(p.problem, spec, p.cone_data, stg)
        _, info = ws.solve()
        launches = dsmatvec.launches
        cpu = Workspace(p.problem, spec, p.cone_data, cpu_stg, device="cpu",
                        ds_split=cpu_stg.mixed_precision)
        _, ref = cpu.solve()
        assert info.status == ref.status == "solved"
        assert info.lin_sys_solver == "dense-indirect-jacobi-pcg"
        assert ws.tot_cg_its > info.iter
        if ws._mixed:
            assert launches >= 2 * info.iter
        assert abs(info.pobj - ref.pobj) <= 1e-4 * (1 + abs(ref.pobj))
        assert 0.8 <= info.iter / ref.iter <= 1.25


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
