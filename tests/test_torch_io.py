"""scs_tpu_torch's problem files, native codec and checkpoints against the
JAX package on the CPU.

* The writer (its native path and its Python path) gives bytes identical
  to `scs_tpu.io.write_scs_data` for dense, upper-P, box, spectral and
  sparse problems.
* The reader, native and Python, in dense and in sparse storage, reads a
  file the JAX package wrote into the arrays the JAX reader gives,
  exactly (sparse: the same CSC triplets, never a dense matrix).
* Garbage, truncated files and corrupt CSC structure raise ValueError on
  both paths.
* .npz problems round-trip both ways between the packages.
* A resumed checkpoint ends on the uninterrupted solve's iteration count
  and bits, pure float64 and mixed (from the fast phase and from inside
  the float64 polish); another problem's checkpoint is rejected.
* The native codec builds and loads here (g++ is on this machine), so
  its path is the one exercised.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

import scs_tpu
from scs_tpu import io as j_io
from scs_tpu import models as j_models
from scs_tpu.ops import sparse as j_sparse
from scs_tpu_torch import Problem, Settings, Workspace, config, convert, io
from scs_tpu_torch.ops import sparse
from scs_tpu_torch.utils import native


def _spectral_spec():
    return scs_tpu.ConeSpec(z=2, l=3, bsize=3, q=(3,), s=(2,), cs=(2,),
                            ep=1, ed=1, p=(0.3, -0.6), d=(3,), nuc_m=(3,),
                            nuc_n=(2,), ell1=(4,), sl_n=(3,), sl_k=(2,))


def _problems():
    """name -> (JAX Problem, JAX ConeSpec, JAX ConeData or None, JAX
    Settings)."""
    out = {}
    soc = scs_tpu.ConeSpec(z=3, l=8, q=(4, 5))
    p = j_models.gen_planted(soc, n=9, seed=3, density=0.4)
    out["dense"] = (p.problem, soc, p.cone_data, scs_tpu.Settings())
    p = j_models.gen_planted(soc, n=9, seed=4, density=0.4, with_P=True)
    out["upper P"] = (p.problem, soc, p.cone_data,
                      scs_tpu.Settings(eps_abs=1e-6, max_iters=777,
                                       verbose=True))
    box = scs_tpu.ConeSpec(z=1, l=2, bsize=4)
    rng = np.random.RandomState(5)
    cd = scs_tpu.ConeData.make(box, bu=np.array([1.0, 2.0, 3.0]),
                               bl=np.array([-1.0, 0.0, -3.0]))
    out["box"] = (scs_tpu.Problem(A=jnp.asarray(rng.randn(7, 4)),
                                  b=jnp.asarray(rng.randn(7)),
                                  c=jnp.asarray(rng.randn(4))), box, cd,
                  scs_tpu.Settings(time_limit_secs=2.5, scale=0.3))
    spec = _spectral_spec()
    m = spec.dims()
    A = rng.randn(m, 6) * (rng.rand(m, 6) < 0.5)
    cd = scs_tpu.ConeData.make(spec, bu=np.array([1.0, 2.0]),
                               bl=np.array([0.0, -1.0]))
    out["spectral"] = (scs_tpu.Problem(A=jnp.asarray(A),
                                       b=jnp.asarray(rng.randn(m)),
                                       c=jnp.asarray(rng.randn(6))), spec,
                       cd, scs_tpu.Settings(acceleration_lookback=3))
    As = sp.random(300, 140, density=0.05, random_state=7, format="csc")
    Pu = sp.random(140, 140, density=0.03, random_state=8, format="csc")
    Pf = (Pu + Pu.T).tocsc()
    sspec = scs_tpu.ConeSpec(z=20, l=280)
    out["sparse"] = (scs_tpu.Problem(A=j_sparse.sparse_from_scipy(As),
                                     b=jnp.asarray(rng.randn(300)),
                                     c=jnp.asarray(rng.randn(140)),
                                     P=j_sparse.sparse_from_scipy(Pf)),
                     sspec, None, scs_tpu.Settings())
    return out


PROBLEMS = _problems()


def _port(jprob, jspec, jcd, jstg):
    """The port's objects of the same problem (sparse operands rebuilt from
    the same scipy matrices)."""
    def t(a):
        return torch.tensor(np.asarray(a))

    if j_sparse.is_sparse(jprob.A):
        A = sparse.sparse_from_scipy(_csc(jprob.A))
        P = sparse.sparse_from_scipy(_csc(jprob.P))
    else:
        A, P = t(jprob.A), None if jprob.P is None else t(jprob.P)
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    cd = None if jcd is None else convert.cone_data_from_numpy(
        spec, np.asarray(jcd.bu), np.asarray(jcd.bl))
    stg = convert.settings_from_dict(dataclasses.asdict(jstg))
    return Problem(A=A, b=t(jprob.b), c=t(jprob.c), P=P), spec, cd, stg


def _csc(S):
    colptr, rows, vals = j_sparse.sparse_to_csc(S)
    n = S.shape[1]
    return sp.csc_matrix((vals, rows, colptr), shape=(S.shape[0], n))


def test_native_codec_builds_and_loads():
    # g++ is on this machine, so the native path is the one under test
    assert native.load() is not None
    assert native.library_path().exists()
    assert str(native.library_path()).startswith(
        str(native.BUILD_DIR))


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_writer_bytes_equal_jax(name, path, tmp_path, monkeypatch):
    jargs = PROBLEMS[name]
    fj, ft = tmp_path / "jax.bin", tmp_path / "port.bin"
    j_io.write_scs_data(str(fj), *jargs)
    if path == "python":
        monkeypatch.setattr(native, "load", lambda: None)
    io.write_scs_data(str(ft), *_port(*jargs))
    assert ft.read_bytes() == fj.read_bytes()


def _same_read(port, ref):
    """The port's read equals the JAX package's dense read; a sparse
    operand through its CSC triplets (scipy's CSC of the dense matrix:
    nonzeros column by column, rows ascending)."""
    prob, spec, cd, stg = port
    jprob, jspec, jcd, jstg = ref
    assert spec == convert.spec_from_dict(dataclasses.asdict(jspec))
    for got, want in ((prob.b, jprob.b), (prob.c, jprob.c), (cd.bu, jcd.bu),
                      (cd.bl, jcd.bl)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for got, want in ((prob.A, jprob.A), (prob.P, jprob.P)):
        if want is None:
            assert got is None
        elif sparse.is_sparse(got):
            ref_csc = sp.csc_matrix(np.asarray(want))
            for a, b in zip(sparse.sparse_to_csc(got),
                            (ref_csc.indptr, ref_csc.indices,
                             ref_csc.data)):
                assert np.array_equal(a, b)
        else:
            assert np.array_equal(got.numpy(), np.asarray(want))
    for f in dataclasses.fields(jstg):
        if f.name != "dtype":
            assert getattr(stg, f.name) == getattr(jstg, f.name), f.name


@pytest.mark.parametrize("storage", ["dense", "sparse"])
@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("name", ["upper P", "spectral", "sparse"])
def test_reader_matches_jax(name, path, storage, tmp_path, monkeypatch):
    """Against the JAX package's dense read: its sparse read fails on a
    file with P (`scs_tpu/io.py:298`, jnp.asarray of a SparseA; ROADMAP
    section 3, R6)."""
    f = str(tmp_path / "p.bin")
    j_io.write_scs_data(f, *PROBLEMS[name])
    ref = j_io.read_scs_data(f)
    if path == "python":
        monkeypatch.setattr(native, "load", lambda: None)
    got = io.read_scs_data(f, storage=storage, device="cpu")
    assert sparse.is_sparse(got[0].A) == (storage == "sparse")
    _same_read(got, ref)


def test_reader_raises_without_a_card(tmp_path, monkeypatch):
    f = str(tmp_path / "p.bin")
    j_io.write_scs_data(f, *PROBLEMS["dense"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        io.read_scs_data(f)


def _corrupt_files(tmp_path):
    good = tmp_path / "good.bin"
    j_io.write_scs_data(str(good), *PROBLEMS["dense"])
    raw = good.read_bytes()
    files = {"garbage": b"\x00\x01\x02 not an SCS file",
             "truncated": raw[:len(raw) // 2]}
    # A's first row index far out of range: find the CSC block by the
    # writer's layout (12-byte header, version, cone, m, n, b, c, m, n,
    # colptr (n + 1), vals (nnz), rowidx)
    prob, spec = PROBLEMS["dense"][:2]
    m, n = np.asarray(prob.A).shape
    nnz = int(np.count_nonzero(np.asarray(prob.A)))
    off = 12 + len(b"3.2.11") + 8 * (3 + 1 + len(spec.q) + 1 + len(spec.s)
                                     + 3 + 2) + 8 * (m + n) + 8 * 2
    off += 8 * (n + 1) + 8 * nnz
    bad = bytearray(raw)
    bad[off:off + 8] = np.int64(10 * m).tobytes()
    files["corrupt csc"] = bytes(bad)
    bad = bytearray(raw)
    bad[off:off + 8] = np.int64(-1).tobytes()
    files["negative row"] = bytes(bad)
    out = {}
    for name, data in files.items():
        path = tmp_path / f"{name.replace(' ', '_')}.bin"
        path.write_bytes(data)
        out[name] = str(path)
    return out


@pytest.mark.parametrize("storage", ["dense", "sparse"])
@pytest.mark.parametrize("path", ["native", "python"])
def test_bad_files_are_rejected(path, storage, tmp_path, monkeypatch):
    files = _corrupt_files(tmp_path)
    if path == "python":
        monkeypatch.setattr(native, "load", lambda: None)
    for name, f in files.items():
        with pytest.raises(ValueError):
            io.read_scs_data(f, storage=storage, device="cpu")
        if name.endswith("csc") or name.endswith("row"):
            with pytest.raises(ValueError, match="CSC"):
                io.read_scs_data(f, storage=storage, device="cpu")


@pytest.mark.parametrize("name", ["upper P", "box"])
def test_npz_round_trips_both_ways(name, tmp_path):
    jprob, jspec, jcd, _ = PROBLEMS[name]
    fj, ft = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_io.save_npz(fj, jprob, jspec, jcd)
    prob, spec, cd = io.load_npz(fj, device="cpu")
    io.save_npz(ft, prob, spec, cd)
    jprob2, jspec2, jcd2 = j_io.load_npz(ft)
    assert jspec2 == jspec
    for a, b in ((jprob2.A, jprob.A), (jprob2.b, jprob.b),
                 (jprob2.c, jprob.c), (jcd2.bu, jcd.bu), (jcd2.bl, jcd.bl)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert (jprob2.P is None) == (jprob.P is None)
    if jprob.P is not None:
        assert np.array_equal(np.asarray(jprob2.P), np.asarray(jprob.P))


# ---------------------------------------------------------------------------
# checkpoint / resume

def _planted(n=25, seed=99):
    spec = scs_tpu.ConeSpec(z=10, l=30, q=(8, 12))
    p = j_models.gen_planted(spec, n=n, seed=seed, density=0.3)
    prob = convert.problem_from_numpy(np.asarray(p.problem.A),
                                      np.asarray(p.problem.b),
                                      np.asarray(p.problem.c))
    return prob, convert.spec_from_dict(dataclasses.asdict(spec))


def _solve_keeping_checkpoints(prob, spec, stg, ds_split, tmp_path,
                               monkeypatch, every):
    """The uninterrupted solve with a checkpoint every `every` iterations,
    each checkpoint kept as (path, phase, status, iter); its iterations of
    the linear solver (CG, or the mixed direct backend's refinement)."""
    kept = []
    save = io.save_state

    def keep(filename, state, phase=0):
        save(filename, state, phase)
        path = str(tmp_path / f"ck{len(kept)}.npz")
        os.replace(filename, path)
        kept.append((path, phase, state.status, state.iter))

    monkeypatch.setattr(io, "save_state", keep)
    ws = Workspace(prob, spec, None, stg, device="cpu", ds_split=ds_split)
    sol, info = ws.solve(checkpoint_file=str(tmp_path / "ck.npz"),
                         checkpoint_every=every)
    monkeypatch.setattr(io, "save_state", save)
    return sol, info, kept, ws.tot_cg_its


@pytest.mark.parametrize("linsys", ["direct", "indirect"])
@pytest.mark.parametrize("mode", ["pure", "mixed"])
def test_resume_gives_the_same_bits(mode, linsys, tmp_path, monkeypatch):
    prob, spec = _planted()
    if mode == "pure":
        stg = Settings(linsys=linsys, mixed_precision=False)
        ds = None
    else:
        # below the fast phase's floor: the float64 polish runs
        stg = Settings(linsys=linsys, mixed_precision=True,
                       eps_abs=1e-7, eps_rel=1e-7)
        ds = True
    sol, info, kept, cg_its = _solve_keeping_checkpoints(
        prob, spec, stg, ds, tmp_path, monkeypatch, 25)
    assert cg_its > 0 or linsys == "direct"
    assert info.status_val == config.SOLVED
    running = [k for k in kept if k[2] == config.UNFINISHED]
    picks = [running[len(running) // 2]]
    if mode == "mixed":
        # the last checkpoint of the fast phase and one inside the polish
        polish = [k for k in running if k[1] == 1]
        assert polish, kept
        picks = [[k for k in running if k[1] == 0][-1], polish[0]]
    for path, phase, _, it in picks:
        ws = Workspace(prob, spec, None, stg, device="cpu", ds_split=ds)
        sol2, info2 = ws.solve(resume_from=path)
        assert info2.iter == info.iter, (phase, it)
        assert ws.tot_cg_its == cg_its, (phase, it)
        for a, b in ((sol2.x, sol.x), (sol2.y, sol.y), (sol2.s, sol.s)):
            assert np.array_equal(a, b), (phase, it)


def test_checkpoint_of_another_problem_is_rejected(tmp_path):
    prob, spec = _planted()
    w = Workspace(prob, spec, None, Settings(linsys="direct"), device="cpu")
    f = str(tmp_path / "st.npz")
    io.save_state(f, w._init_state(None))
    prob2, spec2 = _planted(n=20, seed=5)
    w2 = Workspace(prob2, spec2, None, Settings(linsys="direct"),
                   device="cpu")
    with pytest.raises(ValueError, match="shape"):
        io.load_state(f, w2._init_state(None))
    # other settings, other state fields: the indirect factor
    w3 = Workspace(prob, spec, None, Settings(), device="cpu")
    with pytest.raises(ValueError):
        w3.solve(resume_from=f)
