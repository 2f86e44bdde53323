"""Kernel K2s's plain versions and operands (`scs_tpu_torch/ops/sparse.py`:
the tile counts, the width chooser, the re-tiled double-single split and
float32 shadow) against the JAX package's `scs_tpu/ops/sparse.py` and
float64 numpy on the CPU. The kernel itself runs on the card only
(`tests/test_torch_cuda.py -k ell`).

Instances: `demo_sparse --small`, demo_sparse at its widths and 3 stages
(600 x 384: A keeps bn = 128, A' is re-tiled), the tails fixture of
tests/test_sparse.py and a random sparse matrix, made from seeds with
numpy and scipy. Tolerances: the float64 and pair products sum the same
float64 terms as the JAX package's float64 product in another order
(1e-13 relative); the JAX package's double-single kernel in interpret
mode is itself off by up to 6.0e-9 on two of these operands (ROADMAP
R7), so the pair holds 1e-8 against it; the float32 product holds 1e-5
(1 + max |A||x|) of float64 numpy."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

import scs_tpu
from scs_tpu import demo_sparse as j_demo
from scs_tpu.ops import sparse as jsp
from scs_tpu_torch import Workspace, convert, demo_sparse
from scs_tpu_torch.linsys import indirect
from scs_tpu_torch.ops import ellmatvec
from scs_tpu_torch.ops import sparse as tsp


def rel(a, b) -> float:
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _tails():
    """tests/test_sparse.py:_tails_fixture (two dense rows and columns,
    extracted as tails)."""
    rng = np.random.RandomState(9)
    A = sp.random(70, 60, density=0.08, random_state=rng,
                  data_rvs=rng.randn).tolil()
    for r in (3, 41):
        A[r, :] = rng.randn(60)
    for c in (0, 17):
        A[:, c] = rng.randn(70, 1)
    kw = dict(dense_rows=(3, 41), dense_cols=(0, 17))
    A = A.tocsc()
    return jsp.sparse_from_scipy(A, **kw), tsp.sparse_from_scipy(A, **kw)


def _random():
    rng = np.random.RandomState(5)
    A = sp.random(300, 700, density=0.02, random_state=rng,
                  data_rvs=rng.randn).tocsc()
    return jsp.sparse_from_scipy(A), tsp.sparse_from_scipy(A)


def _demo(**kw):
    return (j_demo.build_problem(**kw)[0].A,
            demo_sparse.build_problem(**kw)[0].A)


CASES = {"demo small": lambda: _demo(**demo_sparse.SMALL),
         "demo 3 stages": lambda: _demo(K=3), "tails": _tails,
         "random": _random}


@pytest.mark.parametrize("case", sorted(CASES))
def test_retiled_products_match_jax(case):
    """Each direction: the pair's plain product on the re-tiled split
    against the JAX package's Pallas kernel K2 in interpret mode on its
    own split, and the float64 plain product on the re-tiled and on the
    own tiles against its `ell_matvec`; float32 on the re-tiled tiles
    against float64 numpy. Nothing launches on the CPU."""
    J, T = CASES[case]()
    rng = np.random.RandomState(3)
    before = (ellmatvec.pair_launches, ellmatvec.f32_launches,
              ellmatvec.f64_launches)
    for je, te in ((J.fwd, T.fwd), (J.bwd, T.bwd)):
        x = rng.randn(te.n)
        xt = torch.tensor(x)
        jy = np.asarray(jsp.ell_matvec(je, jnp.asarray(x)))
        ds = tsp.ds_split_ell(te)
        jds = np.asarray(jsp.ds_ell_matvec(jsp.ds_split_ell(je),
                                           jnp.asarray(x), interpret=True))
        yds = tsp.ds_ell_matvec(ds, xt)
        assert rel(yds, jy) <= 1e-13
        # the JAX package's K2 in interpret mode misses its own ~2^-48
        # on some of these operands (6.0e-9 on the 3-stage demo's A,
        # where its float64 product and numpy agree to 1e-15: ROADMAP R7)
        assert rel(yds, jds) <= 1e-8
        kt = tsp.kernel_tiles(te)
        assert rel(tsp.ell_matvec(kt, xt), jy) <= 1e-13
        assert rel(tsp.ell_matvec(te, xt), jy) <= 1e-13
        D = tsp.ell_to_dense(te).numpy()
        y32 = tsp.ell_matvec(kt.astype(torch.float32), xt.float())
        assert y32.dtype == torch.float32
        tol = 1e-5 * (1 + float((np.abs(D) @ np.abs(x)).max()))
        assert float(np.abs(y32.double().numpy() - D @ x).max()) <= tol
    assert (ellmatvec.pair_launches, ellmatvec.f32_launches,
            ellmatvec.f64_launches) == before


def test_padded_slots_are_never_read():
    """NaN in every padded slot (past a block-row's count) leaves the
    plain products finite and unchanged, bit for bit, and the re-tiled
    operand without it."""
    _, T = _demo(K=3)
    ell = T.bwd             # the first stage's block-rows hold 3 of 5
    assert int(ell.count.min()) < ell.kmax
    d = ell.data.clone().reshape(ell.nbr, ell.bm, ell.kmax, ell.bn)
    r, a = (torch.arange(ell.kmax) >= ell.count[:, None]).nonzero(
        as_tuple=True)
    d[r, :, a, :] = float("nan")
    bad = dataclasses.replace(ell, data=d.reshape(ell.data.shape))
    x = torch.tensor(np.random.RandomState(1).randn(ell.n))
    good = tsp.ell_matvec(ell, x)
    assert bool(torch.isfinite(good).all())
    assert torch.equal(tsp.ell_matvec(bad, x), good)
    assert torch.equal(tsp.ell_matvec(bad.astype(torch.float32), x),
                       tsp.ell_matvec(ell.astype(torch.float32), x))
    pair = [tsp.DsBlocked(*tsp.dsmatvec.split_operand(e.data), e.idx,
                          e.count, e.m, e.n, e.bm, e.bn, e.kmax)
            for e in (bad, ell)]
    assert torch.equal(tsp.ds_ell_matvec(pair[0], x),
                       tsp.ds_ell_matvec(pair[1], x))
    assert torch.equal(tsp.kernel_tiles(bad).data,
                       tsp.kernel_tiles(ell).data)


def test_counts_and_width_chooser():
    """The counts: ell_from_coo's equal those made from the tiles (the
    JAX package's operand converted). The width: bn < 128 for A' of the
    small demo and of the 3-stage demo at the demo's widths (tiles
    straddle its stages), 128 for that A (each stage fills its tiles);
    the re-tiled copy reads at most as many elements as the real tiles
    and stores fewer than the padded split; its dense form is the
    operand's."""
    J, T = _demo(K=3)
    C = convert.sparse_from_numpy(**dataclasses.asdict(J))
    for te, ce in ((T.fwd, C.fwd), (T.bwd, C.bwd)):
        assert te.count.dtype == torch.int32
        assert torch.equal(te.count, ce.count)
    assert tsp.choose_width(T.fwd) == 128
    assert tsp.choose_width(T.bwd) < 128
    assert tsp.choose_width(_demo(**demo_sparse.SMALL)[1].bwd) < 128
    for ell in (T.fwd, T.bwd):
        kt = tsp.kernel_tiles(ell)
        assert torch.equal(tsp.ell_to_dense(kt), tsp.ell_to_dense(ell))
        real = int(ell.count.sum()) * ell.bm * ell.bn
        assert int(kt.count.sum()) * kt.bm * kt.bn <= real
    kt = tsp.kernel_tiles(T.bwd)
    assert kt.data.numel() < T.bwd.data.numel()
    for w in (16, 32, 64):
        assert torch.equal(tsp.ell_to_dense(tsp.ell_retile(T.bwd, w)),
                           tsp.ell_to_dense(T.bwd))


def test_graph_key_names_every_new_tensor():
    """The CG graph key of the float32 shadow lists its re-tiled tiles,
    indices and counts (the graph reads them by address); the shadow is
    re-tiled, its SparseA keeps the JAX package's tiles."""
    J, T = _demo(K=3)
    sh = T.retiled(torch.float32)
    assert sh.dtype == torch.float32 and sh.bwd.bn < T.bwd.bn
    got = indirect._tensors(sh, None, torch.ones(3))
    for t in (sh.fwd.data, sh.fwd.idx, sh.fwd.count, sh.bwd.data,
              sh.bwd.idx, sh.bwd.count):
        assert any(g is t for g in got)
    np.testing.assert_array_equal(np.asarray(J.bwd.data), T.bwd.data.numpy())


def test_wrappers_refuse_other_devices_and_types():
    _, T = _tails()
    x = torch.zeros(T.shape[1], device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tsp.ell_matvec(T.fwd, x)
    ds = tsp.ds_split_ell(T.fwd)
    with pytest.raises(TypeError, match="float64 x"):
        tsp.ds_ell_matvec(ds, torch.zeros(T.shape[1], dtype=torch.float32))


def test_small_demo_direct_mixed_solve_matches_jax():
    """demo_sparse --small through the direct backend, mixed (the port's
    products through the re-tiled split's plain version) on the CPU
    against the JAX package's solve: the same status, objectives within
    1e-5 (1 + |pobj|), iterations within [0.8, 1.25]
    (tests/test_torch_sparse_solve.py's rules; its cases cover the pure
    and the indirect paths)."""
    jprob, jspec, _, _ = j_demo.build_problem(**demo_sparse.SMALL)
    jstg = scs_tpu.Settings(linsys="direct", mixed_precision=True,
                            eps_abs=1e-4, eps_rel=1e-4, max_iters=20_000)
    _, jinfo = scs_tpu.solve(jprob, jspec, settings=jstg)
    prob, spec, opt, _ = demo_sparse.build_problem(**demo_sparse.SMALL)
    ws = Workspace(prob, spec, None, convert.settings_from_dict(
        dataclasses.asdict(jstg)), device="cpu", ds_split=True)
    _, info = ws.solve()
    assert ws.data.lin_cache.ds_bwd.ell.bn < 128
    assert info.status == jinfo.status == "solved"
    assert 0.8 <= info.iter / jinfo.iter <= 1.25
    assert abs(info.pobj - jinfo.pobj) <= 1e-5 * (1 + abs(jinfo.pobj))
    assert abs(info.pobj - opt) <= 1e-3 * (1 + abs(opt))
