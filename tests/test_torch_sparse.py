"""scs_tpu_torch.ops.sparse (blocked-ELL operands) against the JAX
package's `scs_tpu/ops/sparse.py` and dense numpy on the CPU: the
constructors, the conversion of a JAX operand, the operator's products and
reductions, the Grams, the double-single product (its plain version here;
the kernels K2 and K1 on the card in tests/test_torch_cuda.py), the
sparse equilibration and validation. The instances are those of
tests/test_sparse.py, made from seeds with numpy and scipy.

Tolerances: the products and reductions sum the same float64 terms as
the JAX package and numpy in another order, so they agree to 1e-12 of
the largest value (relative); the constructors are the same numpy code, so
their tiles and indices are equal bit for bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

import scs_tpu
from scs_tpu import equilibrate as j_eq
from scs_tpu.ops import sparse as jsp
from scs_tpu.validation import ValidationError as JValidationError
from scs_tpu_torch import Settings, Workspace, convert, demo_sparse, equilibrate
from scs_tpu_torch import problem_from_csc
from scs_tpu_torch import api
from scs_tpu_torch.linsys import indirect
from scs_tpu_torch.ops import dsmatvec
from scs_tpu_torch.ops import sparse as tsp
from scs_tpu_torch.types import ConeSpec, Problem
from scs_tpu_torch.validation import ValidationError


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def rel(a, b) -> float:
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ---- the instances of tests/test_sparse.py ----


def _tails(m=70, n=60, seed=9, dense_rows=(3, 41), dense_cols=(0, 17)):
    """tests/test_sparse.py:_tails_fixture: random sparse with designated
    dense rows and columns, extracted as tails."""
    rng = np.random.RandomState(seed)
    A = sp.random(m, n, density=0.08, random_state=rng,
                  data_rvs=rng.randn).tolil()
    for r in dense_rows:
        A[r, :] = rng.randn(n)
    for c in dense_cols:
        A[:, c] = rng.randn(m, 1)
    return A.tocsc(), dict(dense_rows=dense_rows, dense_cols=dense_cols)


def _gram_case():
    """tests/test_sparse.py:test_sparse_gram_matches_dense."""
    rng = np.random.RandomState(5)
    m, n = 300, 70
    A = sp.random(m, n, density=0.05, random_state=rng,
                  data_rvs=rng.randn).tolil()
    A[7, :] = rng.randn(n)
    A[:, 3] = rng.randn(m, 1)
    return A.tocsc(), dict(dense_rows=[7], dense_cols=[3])


def _auto_case():
    """tests/test_sparse.py:test_tails_auto_extraction_and_storage_win: a
    block-banded 4096 x 4096 matrix with one dense row, found by the
    heuristic."""
    rng = np.random.RandomState(2)
    m = n = 4096
    rows, cols = [], []
    for r in range(0, m, 16):
        cs = rng.randint(max(0, r - 192), min(n, r + 192), size=24)
        rows.extend([r + k % 16 for k in range(24)])
        cols.extend(cs)
    rows, cols = np.asarray(rows) % m, np.asarray(cols)
    A = sp.coo_matrix((rng.randn(rows.size), (rows, cols)),
                      shape=(m, n)).tolil()
    A[100, :] = rng.randn(n)
    return A.tocsc(), {}


def _csc_case():
    """tests/test_sparse.py:test_sparse_to_csc_tails_and_upper."""
    rng = np.random.RandomState(11)
    M = (rng.rand(40, 36) < 0.05) * rng.randn(40, 36)
    M[7, :] = rng.randn(36)
    M[:, 3] = rng.randn(40)
    return sp.csc_matrix(M), {}


CASES = {"tails": _tails, "gram": _gram_case, "auto": _auto_case,
         "csc": _csc_case, "tails_small": lambda: _tails(
             m=40, n=36, dense_rows=(2,), dense_cols=(5,))}


def _both(case):
    A, kw = CASES[case]()
    return A, jsp.sparse_from_scipy(A, **kw), tsp.sparse_from_scipy(A, **kw)


def _same(j, t) -> None:
    """A JAX operand and a port operand hold equal tiles, indices and
    tails."""
    for part in ("fwd", "bwd"):
        je, te = getattr(j, part), getattr(t, part)
        np.testing.assert_array_equal(np.asarray(je.data), te.data.numpy())
        np.testing.assert_array_equal(np.asarray(je.idx), te.idx.numpy())
        assert te.idx.dtype == torch.int32
        assert ((je.m, je.n, je.bm, je.bn, je.kmax)
                == (te.m, te.n, te.bm, te.bn, te.kmax))
    for name in ("rows_val", "cols_val"):
        jv, tv = getattr(j, name), getattr(t, name)
        assert (jv is None) == (tv is None)
        if jv is not None:
            np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert j.rows_idx == t.rows_idx and j.cols_idx == t.cols_idx
    assert t.rows_index.tolist() == list(t.rows_idx)
    assert t.cols_index.tolist() == list(t.cols_idx)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_from_scipy_builds_the_jax_operand(case):
    _, j, t = _both(case)
    _same(j, t)
    if case == "auto":
        off = tsp.sparse_from_scipy(CASES[case]()[0], dense_rows=(),
                                    dense_cols=())
        assert t.rows_idx == (100,)
        assert t.nnz_stored() < off.nnz_stored() / 3


@pytest.mark.parametrize("case", ["tails", "gram"])
def test_sparse_from_numpy_converts_the_jax_operand(case):
    _, j, t = _both(case)
    _same(j, convert.sparse_from_numpy(**dataclasses.asdict(j)))
    jd = jsp.sparse_from_dense(np.asarray(CASES[case]()[0].todense()))
    _same(jd, convert.sparse_from_numpy(**dataclasses.asdict(jd)))


def test_todense_round_trips():
    """tests/test_sparse.py:test_sparse_todense_roundtrip, and the
    operand moved and cast keeps its values and index tensors."""
    rng = np.random.RandomState(9)
    Ad = np.asarray(sp.random(50, 33, density=0.1, random_state=rng,
                              data_rvs=rng.randn).todense())
    Ad[4, :] = rng.randn(33)
    S = tsp.sparse_from_dense(Ad)
    _same(jsp.sparse_from_dense(Ad), S)
    np.testing.assert_array_equal(S.todense().numpy(), Ad)
    St = tsp.sparse_from_scipy(sp.csc_matrix(Ad), dense_rows=[4],
                               dense_cols=[2])
    np.testing.assert_array_equal(St.todense().numpy(), Ad)
    np.testing.assert_array_equal(St.T.todense().numpy(), Ad.T)
    moved = St.to("cpu").astype(torch.float32)
    assert moved.dtype == torch.float32 and moved.device.type == "cpu"
    assert moved.rows_index is St.rows_index
    np.testing.assert_array_equal(moved.todense().numpy(),
                                  Ad.astype(np.float32))
    assert len(moved.tensors()) == 10      # and each direction's count


@pytest.mark.parametrize("upper_only", [False, True])
def test_sparse_to_csc_matches_jax(upper_only):
    M = CASES["csc"]()[0]
    if upper_only:
        M = M[:36, :36]
    j = jsp.sparse_from_scipy(M)
    t = tsp.sparse_from_scipy(M)
    for a, b in zip(jsp.sparse_to_csc(j, upper_only=upper_only),
                    tsp.sparse_to_csc(t, upper_only=upper_only)):
        np.testing.assert_array_equal(a, b)
    colptr, rows, vals = tsp.sparse_to_csc(t, upper_only=upper_only)
    R = sp.csc_matrix((vals, rows, colptr), shape=M.shape).toarray()
    want = np.triu(M.toarray()) if upper_only else M.toarray()
    np.testing.assert_array_equal(R, want)


def test_problem_from_csc_matches_jax():
    rng = np.random.RandomState(4)
    A = sp.random(12, 5, density=0.4, random_state=rng, format="csc")
    Pu = sp.triu(sp.random(5, 5, density=0.5, random_state=rng)).tocsc()
    b, c = rng.randn(12), rng.randn(5)
    jp = scs_tpu.problem_from_csc(A, b, c, Pu)
    tp = problem_from_csc(A, b, c, Pu)
    for name in ("A", "b", "c", "P"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                      getattr(tp, name).numpy())
    assert problem_from_csc(A, b, c).P is None


def _vectors(m, n, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(n), rng.randn(m), rng.randn(n, 4),
            np.abs(rng.randn(m)) + 0.5, np.abs(rng.randn(m)) + 0.5,
            np.abs(rng.randn(n)) + 0.5)


OPS = {
    "matvec": (lambda S, v: S @ v[0], lambda A, v: A @ v[0]),
    "rmatvec": (lambda S, v: S.T @ v[1], lambda A, v: A.T @ v[1]),
    "matmat": (lambda S, v: S @ v[2], lambda A, v: A @ v[2]),
    "row_abs_max": (lambda S, v: S.row_abs_max(),
                    lambda A, v: np.abs(A).max(1)),
    "col_abs_max": (lambda S, v: S.col_abs_max(),
                    lambda A, v: np.abs(A).max(0)),
    "abs_max": (lambda S, v: S.abs_max(), lambda A, v: np.abs(A).max()),
    "row_sumsq": (lambda S, v: S.row_sumsq(), lambda A, v: (A * A).sum(1)),
    "col_sumsq": (lambda S, v: S.col_sumsq(), lambda A, v: (A * A).sum(0)),
    "col_sumsq_weighted": (lambda S, v: S.col_sumsq(v[3]),
                           lambda A, v: (v[3][:, None] * A * A).sum(0)),
    "scale": (lambda S, v: S.scale(v[4], v[5]).todense(),
              lambda A, v: v[4][:, None] * A * v[5][None, :]),
    "scale_rmatvec": (lambda S, v: S.scale(v[4], v[5]).T @ v[1],
                      lambda A, v: (v[4][:, None] * A * v[5]).T @ v[1]),
}


@pytest.mark.parametrize("case", ["tails", "gram"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_operator_matches_jax_and_numpy(case, op):
    A, j, t = _both(case)
    Ad = A.toarray()
    v = _vectors(*Ad.shape)
    fn, ref = OPS[op]
    got = fn(t, [t64(a) for a in v])
    want = ref(Ad, v)
    jax_val = fn(j, [jnp.asarray(a) for a in v])
    assert rel(got, want) <= 1e-12
    assert rel(got, np.asarray(jax_val)) <= 1e-12


def test_diagonal_matches_jax_and_numpy():
    """Square operands: a random sparse P with a dense row tail, and a
    sparse PSD P (tests/test_sparse.py:268 and :301)."""
    rng = np.random.RandomState(4)
    P = sp.random(40, 40, density=0.1, random_state=rng,
                  data_rvs=rng.randn).tolil()
    P[7, :] = rng.randn(40)
    P = P.tocsc()
    for kw in (dict(dense_rows=(7,), dense_cols=()),
               dict(dense_rows=(), dense_cols=(7, 30)), {}):
        j, t = jsp.sparse_from_scipy(P, **kw), tsp.sparse_from_scipy(P, **kw)
        assert rel(t.diagonal(), P.diagonal()) == 0.0
        assert rel(t.diagonal(), np.asarray(j.diagonal())) == 0.0


def test_grams_match_jax_and_numpy():
    """ell_gram (chunks of 2 block-rows) and sparse_gram with tails, with
    and without the zero-cone row weights: the direct backend's K from
    sparse storage."""
    A, j, t = _both("gram")
    Ad = A.toarray()
    w = 1.0 + 2.0 * np.random.RandomState(5).rand(Ad.shape[0])
    for jw, tw, wd in ((jnp.asarray(w), t64(w), w),
                       (None, None, np.ones_like(w))):
        got = tsp.sparse_gram(t, tw)
        assert rel(got, Ad.T @ (wd[:, None] * Ad)) <= 1e-12
        assert rel(got, np.asarray(jsp.sparse_gram(j, jw))) <= 1e-12
    core = Ad[:64]
    jd, td = jsp.sparse_from_dense(core), tsp.sparse_from_dense(core)
    got = tsp.ell_gram(td.fwd, chunk_rows=2)
    assert rel(got, core.T @ core) <= 1e-12
    assert rel(got, np.asarray(jsp.ell_gram(jd.fwd, chunk_rows=2))) <= 1e-12
    assert rel(tsp.ell_gram(td.fwd, chunk_rows=3), core.T @ core) <= 1e-12
    assert rel(tsp.ell_col_sumsq(td.fwd, t64(w[:64])),
               np.asarray(jsp.ell_col_sumsq(jd.fwd, jnp.asarray(w[:64])))
               ) <= 1e-12


def test_ds_sparse_matvec_matches_the_jax_interpret_kernel():
    """tests/test_sparse.py:test_tails_ds_matvec_interpret's operand: the
    port's plain double-single product (K2's and K1's plain versions on
    the CPU) against the JAX package's Pallas kernels in interpret mode
    and float64 numpy, forward and transposed, within 1e-13 relative.
    Nothing launches on the CPU."""
    A, j, t = _both("tails_small")
    Ad = A.toarray()
    rng = np.random.RandomState(3)
    x, z = rng.randn(Ad.shape[1]), rng.randn(Ad.shape[0])
    before = (dsmatvec.launches, dsmatvec.batched_launches)
    for S, T, v, ref in ((j, t, x, Ad @ x), (j.T, t.T, z, Ad.T @ z)):
        y = tsp.ds_sparse_matvec(tsp.ds_split_sparse(T), t64(v))
        jy = jsp.ds_sparse_matvec(jsp.ds_split_sparse(S), jnp.asarray(v),
                                  interpret=True)
        assert rel(y, np.asarray(jy)) <= 1e-13
        assert rel(y, ref) <= 1e-13
    assert (dsmatvec.launches, dsmatvec.batched_launches) == before
    ds = tsp.ds_split_sparse(t)
    # the pair of the re-tiled kernel operand: no larger than the tiles
    assert ds.ell.hi.numel() <= t.fwd.data.numel()
    assert ds.ell.hi.dtype == torch.float32


def test_k2_launches_in_chunks_of_the_grid_limit():
    """A batch above gridDim.z's 65535 launches in chunks."""
    M = dsmatvec.MAX_BATCH
    assert M == 65535
    assert dsmatvec.batch_chunks(0) == []
    assert dsmatvec.batch_chunks(12500) == [(0, 12500)]
    assert dsmatvec.batch_chunks(M) == [(0, M)]
    assert dsmatvec.batch_chunks(M + 1) == [(0, M), (M, M + 1)]
    plan = dsmatvec.batch_chunks(75000 * 3)
    assert plan[0] == (0, M) and plan[-1][1] == 225000
    assert all(b - a <= M for a, b in plan)
    assert all(p[1] == q[0] for p, q in zip(plan, plan[1:]))


EQ_CASES = {
    # tests/test_sparse.py:test_sparse_equilibration_matches_dense
    "A": (scs_tpu.ConeSpec(z=10, l=30, q=(8,)), 16, 23, 0.2, False),
    # a QP: sparse A and sparse P (tests/test_sparse.py:test_sparse_P_qp)
    "A_and_P": (scs_tpu.ConeSpec(z=8, l=40), 24, 31, 0.2, True),
}


@pytest.mark.parametrize("case", sorted(EQ_CASES))
def test_sparse_equilibration_matches_jax(case):
    from scs_tpu.models import gen_planted
    jspec, n, seed, density, with_P = EQ_CASES[case]
    p = gen_planted(jspec, n=n, seed=seed, density=density, with_P=with_P)
    A = np.asarray(p.problem.A)
    jA = jsp.sparse_from_dense(A)
    jP = tA = tP = None
    tA = tsp.sparse_from_dense(A)
    if with_P:
        Pc = sp.csc_matrix(np.asarray(p.problem.P))
        jP, tP = jsp.sparse_from_scipy(Pc), tsp.sparse_from_scipy(Pc)
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    jA_n, jP_n, jscal = j_eq.equilibrate(jA, jP, jspec)
    tA_n, tP_n, scal = equilibrate.equilibrate(tA, tP, spec)
    np.testing.assert_allclose(scal.D.numpy(), np.asarray(jscal.D),
                               rtol=1e-12)
    np.testing.assert_allclose(scal.E.numpy(), np.asarray(jscal.E),
                               rtol=1e-12)
    # and the dense equilibration of the same matrices
    _, _, dscal = equilibrate.equilibrate(
        t64(A), None if not with_P else t64(p.problem.P), spec)
    np.testing.assert_allclose(scal.D.numpy(), dscal.D.numpy(), rtol=1e-12)
    assert rel(tA_n.todense(), np.asarray(jA_n.todense())) <= 1e-12
    if with_P:
        assert rel(tP_n.todense(), np.asarray(jP_n.todense())) <= 1e-12


def _rand_sparse_psd(n, seed, density=0.2):
    """tests/test_sparse.py:_rand_sparse_psd: F F' + 1e-3 I, F sparse."""
    rng = np.random.RandomState(seed)
    F = sp.random(n, max(n // 4, 2), density=density, random_state=rng,
                  data_rvs=rng.randn).tocsc()
    return ((F @ F.T).tocsc() + 1e-3 * sp.eye(n, format="csc")).tocsc()


def _jax_and_port(A, b, c, P, n_rows):
    """The same problem for both packages: A and P sparse operands."""
    jprob = scs_tpu.Problem(A=jsp.sparse_from_scipy(A), b=jnp.asarray(b),
                            c=jnp.asarray(c), P=jsp.sparse_from_scipy(P))
    tprob = Problem(A=tsp.sparse_from_scipy(A), b=t64(b), c=t64(c),
                    P=tsp.sparse_from_scipy(P))
    return jprob, tprob, scs_tpu.ConeSpec(l=n_rows), ConeSpec(l=n_rows)


def test_asymmetric_sparse_P_is_refused_as_in_jax():
    """tests/test_sparse.py:test_sparse_P_diagonal_and_symmetry_validation:
    the three-column product probe catches an asymmetric sparse P."""
    rng = np.random.RandomState(7)
    Q = sp.random(12, 12, density=0.3, random_state=rng,
                  data_rvs=rng.randn).tocsc()
    A = sp.csc_matrix(-np.eye(12))
    jprob, tprob, jspec, spec = _jax_and_port(A, np.zeros(12), np.ones(12),
                                              Q, 12)
    with pytest.raises(JValidationError, match="symmetric"):
        scs_tpu.Workspace(jprob, jspec, settings=scs_tpu.Settings(
            linsys="indirect"))
    with pytest.raises(ValidationError, match="symmetric"):
        Workspace(tprob, spec, settings=Settings(linsys="indirect"),
                  device="cpu")
    # its PSD counterpart passes
    P = _rand_sparse_psd(12, seed=5)
    _, tprob, _, spec = _jax_and_port(A, np.zeros(12), np.ones(12), P, 12)
    Workspace(tprob, spec, settings=Settings(linsys="indirect"),
              device="cpu")


def test_indefinite_sparse_P_is_refused_as_in_jax():
    """tests/test_sparse.py:test_sparse_P_indefinite_rejected (n = 16:
    the densified float64 eigvalsh)."""
    n = 16
    D = sp.diags(np.r_[np.ones(n - 1), -1.0]).tocsc()
    A = sp.csc_matrix(-np.eye(n))
    jprob, tprob, jspec, spec = _jax_and_port(A, np.zeros(n), np.ones(n),
                                              D, n)
    with pytest.raises(JValidationError, match="positive"):
        scs_tpu.Workspace(jprob, jspec, settings=scs_tpu.Settings(
            linsys="indirect"))
    with pytest.raises(ValidationError, match="positive"):
        Workspace(tprob, spec, settings=Settings(linsys="indirect"),
                  device="cpu")


def _diag_problem(d):
    n = d.size
    return Problem(A=tsp.sparse_from_scipy(sp.diags(-np.ones(n)).tocsc()),
                   b=torch.zeros(n, dtype=torch.float64),
                   c=torch.ones(n, dtype=torch.float64),
                   P=tsp.sparse_from_scipy(sp.diags(d).tocsc()))


def test_large_n_tiny_negative_eigenvalue_refused():
    """tests/test_sparse.py:test_large_n_tiny_negative_eigenvalue_rejected:
    at n = 5000 (> 4096) the float64 ARPACK probe on the host refuses an
    eigenvalue of -1e-3 against |P| = 1e3 and passes the PSD twin."""
    n = 5000
    rng = np.random.RandomState(0)
    d = rng.uniform(1.0, 1000.0, n)
    d[1234] = -1e-3
    spec = ConeSpec(l=n)
    stg = Settings(linsys="indirect")
    with pytest.raises(ValidationError, match="positive"):
        Workspace(_diag_problem(d), spec, settings=stg, device="cpu")
    d[1234] = 1e-3
    Workspace(_diag_problem(d), spec, settings=stg, device="cpu")


def test_lobpcg_probe_where_arpack_fails(monkeypatch):
    """Where ARPACK fails the probe is LOBPCG on the device with the JAX
    branch's tolerance 2e-4 max(1, max|P|): a clearly negative eigenvalue
    is refused, the PSD twin passes."""
    def fail(P):
        raise RuntimeError("ARPACK did not converge")

    monkeypatch.setattr(api, "_lam_min_host", fail)
    n = 4500
    d = np.random.RandomState(1).uniform(1.0, 10.0, n)
    d[77] = -5.0
    spec = ConeSpec(l=n)
    stg = Settings(linsys="indirect")
    with pytest.raises(ValidationError, match="positive"):
        Workspace(_diag_problem(d), spec, settings=stg, device="cpu")
    d[77] = 5.0
    Workspace(_diag_problem(d), spec, settings=stg, device="cpu")


def test_nonfinite_sparse_operands_are_refused():
    A = sp.random(6, 4, density=0.5, random_state=np.random.RandomState(0),
                  format="csc")
    A.data[0] = np.nan
    prob = Problem(A=tsp.sparse_from_scipy(A), b=torch.zeros(6,
                   dtype=torch.float64), c=torch.ones(4,
                   dtype=torch.float64))
    with pytest.raises(ValidationError, match="A contains non-finite"):
        Workspace(prob, ConeSpec(l=6), device="cpu")


def test_graph_key_names_every_tensor_of_a_sparse_operand():
    """The CG graph cache's key lists every tensor a sparse apply reads
    (tiles, indices and tile counts of both directions, tails and their
    indices)."""
    _, _, t = _both("tails")
    got = indirect._tensors(t, None, t64(np.ones(3)))
    assert len(got) == 12 and got[-2] is None
    for a, b in zip(got[:10], (t.fwd.data, t.fwd.idx, t.bwd.data, t.bwd.idx,
                               t.rows_val, t.cols_val, t.rows_index,
                               t.cols_index, t.fwd.count, t.bwd.count)):
        assert a is b


def test_demo_sparse_builds_the_jax_instance():
    """demo_sparse.build_problem at the CI size: the JAX package's
    instance from the same seed (tiles bit for bit; b and c formed by
    each package's own product, to 1e-14 relative)."""
    from scs_tpu import demo_sparse as j_demo
    jprob, jspec, jopt, jinfo = j_demo.build_problem(**demo_sparse.SMALL)
    prob, spec, opt, info = demo_sparse.build_problem(**demo_sparse.SMALL)
    _same(jprob.A, prob.A)
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        convert.spec_from_dict(dataclasses.asdict(jspec)))
    assert rel(prob.b, np.asarray(jprob.b)) <= 1e-14
    assert rel(prob.c, np.asarray(jprob.c)) <= 1e-14
    assert abs(opt - jopt) <= 1e-12 * (1 + abs(jopt))
    assert {k: info[k] for k in ("m", "n", "nnz", "stored_bytes")} == {
        k: jinfo[k] for k in ("m", "n", "nnz", "stored_bytes")}


def test_demo_sparse_small_matches_jax():
    """demo_sparse --small: the JAX package's instance solved by both at
    the demo's settings (indirect, eps 1e-4): equal status, objectives
    within 1e-5 (1 + |pobj|), iteration counts within [0.8, 1.25] (CG
    stops on data-dependent tests, tests/test_torch_sparse_solve.py)."""
    from scs_tpu import demo_sparse as j_demo
    jprob, jspec, _, _ = j_demo.build_problem(**demo_sparse.SMALL)
    jstg = scs_tpu.Settings(linsys="indirect", chunk_iters=250,
                            eps_abs=1e-4, eps_rel=1e-4, max_iters=20_000)
    assert convert.settings_from_dict(dataclasses.asdict(jstg)) == \
        demo_sparse.SETTINGS
    _, jinfo = scs_tpu.solve(jprob, jspec, settings=jstg)
    info, opt, _ = demo_sparse.solve_demo(small=True, device="cpu")
    assert info.status == jinfo.status == "solved"
    assert 0.8 <= info.iter / jinfo.iter <= 1.25, (info.iter, jinfo.iter)
    assert abs(info.pobj - jinfo.pobj) <= 1e-5 * (1 + abs(jinfo.pobj))
    assert abs(info.pobj - opt) <= 1e-3 * (1 + abs(opt))
