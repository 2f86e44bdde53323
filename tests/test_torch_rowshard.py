"""Row (model-axis) sharding (`scs_tpu_torch.ops.rowshard`,
`parallel.collectives`, `parallel.shard_problem_batch(...,
shard_rows=True)`) on the CPU, against the JAX package's row-sharded
solves.

Two jobs of `tests/rowshard_worker.py` run beside the JAX side: two
ranks joined by gloo on a (1, 2) mesh (tests/test_parallel.py:83's
instance, ConeSpec(z=16, l=40, q=(8, 16)), n = 30, seed 7, one problem
through the indirect backend, 40 rows a rank with shard edges inside the
SOC blocks; the same with z = 15, m = 79, shards of 40 and 39 rows; and
tests/test_parallel.py:66's batched LP, l = 32, n = 12, four problems,
direct and indirect, pure and mixed, and mixed with float32 state
through `make_chunked_batch_solver`), and four ranks on a (2, 2) mesh
(the batched LP, direct pure and indirect mixed). The mixed cases pass
`ds_split=True`, so that the products run the kernels' plain versions.
Each rank's process has a time limit: ranks whose host decisions
diverged would wait in a collective and fail here, not hang.

Each result is held to the JAX package's row-sharded solve of the same
arrays on a mesh of the same shape (conftest's 8 CPU devices); the
uneven case to its unsharded solve (JAX cannot place uneven shards), and
the float32-state case, whose JAX phase fails on the CPU (ROADMAP R2),
to the port's unsharded solve: statuses equal, pobj within 1e-4 (1 +
|pobj|), iterations within [0.8, 1.25]. Where a case also ran at eps
1e-9, x, y and s are held to the port's unsharded solve at that eps
within 1e-6 (1 + max |.|). The ranks of a job return the same bits.

The operand itself is tested in this process: products, the Gram, the
equilibration's statistics and the double-single products (with the
float32-state pair sum) on a one-rank group, and each shard's local part
of them, summed or concatenated by hand, against the dense operand
within 1e-13 relative."""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP  # noqa: E402

from scs_tpu.models import gen_planted as j_gen_planted  # noqa: E402
from scs_tpu.parallel import make_batch_solver as j_make_batch  # noqa: E402
from scs_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from scs_tpu.parallel import make_pure_solver as j_make_pure  # noqa: E402
from scs_tpu.parallel import shard_problem_batch as j_shard  # noqa: E402
from scs_tpu.types import ConeSpec as JConeSpec  # noqa: E402
from scs_tpu.types import Settings as JSettings  # noqa: E402
from scs_tpu_torch import Problem, Settings, Workspace, config  # noqa: E402
from scs_tpu_torch.cones.project import proj_dual_cone  # noqa: E402
from scs_tpu_torch import equilibrate as eq  # noqa: E402
from scs_tpu_torch.ops import dsmatvec, rowshard  # noqa: E402
from scs_tpu_torch.ops.sparse import sparse_from_dense  # noqa: E402
from scs_tpu_torch.parallel import (make_batch_solver,  # noqa: E402
                                    make_chunked_batch_solver, make_mesh,
                                    make_pure_solver, multihost,
                                    shard_problem_batch)
from scs_tpu_torch.types import ConeData, ConeSpec  # noqa: E402
from scs_tpu_torch.validation import ValidationError  # noqa: E402

from helpers import stack_planted_problems  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import rowshard_worker as worker  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 600


def _instances() -> dict:
    out = {}
    for name, spec in (("single", JConeSpec(z=16, l=40, q=(8, 16))),
                       ("uneven", JConeSpec(z=15, l=40, q=(8, 16)))):
        p = j_gen_planted(spec, n=30, seed=7, density=0.4)
        for k in "Abc":
            out[f"{name}_{k}"] = np.array(getattr(p.problem, k))
    A, _, b, c, _, _, _ = stack_planted_problems(JConeSpec(l=32), n=12,
                                                 count=4)
    for k, v in zip("Abc", (A, b, c)):
        out[f"lp_{k}"] = np.array(v)
    return out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start(job: str, cases: str, out_dir: str) -> list:
    world = worker.JOBS[job][0]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
                   [ROOT, os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "rowshard_worker.py"),
         job, cases, out_dir], env=dict(env, RANK=str(r)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _finish(procs: list, out_dir: str) -> list:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    ranks = []
    for r in range(len(procs)):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


# ---- the JAX side ----

def _j_settings(kw: dict, eps=None) -> JSettings:
    kw = dict(kw)
    kw.pop("chunk_iters", None)
    if eps is not None:
        kw.update(eps_abs=eps, eps_rel=eps)
    return JSettings(macro_schedule=False, **kw)


def _jax_single(arrays, name: str, sharded: bool, kw: dict) -> dict:
    spec = worker.SPECS[name]
    jspec = JConeSpec(z=spec.z, l=spec.l, q=spec.q)
    stg = _j_settings(kw)
    fn = jax.jit(lambda A, b, c, bu, bl: j_make_pure(jspec, stg)(
        A, None, b, c, bu, bl))
    A, b, c = (jnp.asarray(arrays[f"{name}_{k}"]) for k in "Abc")
    if sharded:
        mesh = Mesh(np.asarray(jax.devices()[:2]), ("model",))
        A = jax.device_put(A, NamedSharding(mesh, JP("model", None)))
        b = jax.device_put(b, NamedSharding(mesh, JP("model")))
        c = jax.device_put(c, NamedSharding(mesh, JP()))
    e = jnp.zeros((0,))
    r = fn(A, b, c, e, e)
    return {k: np.atleast_1d(np.asarray(getattr(r, k)))
            for k in ("status", "iters", "pobj")}


def _jax_lp(arrays, world: int, kw: dict) -> dict:
    jspec = JConeSpec(l=32)
    A, b, c = (jnp.asarray(arrays[f"lp_{k}"]) for k in "Abc")
    e = jnp.zeros((A.shape[0], 0))
    mesh = j_make_mesh(world, data=world // 2, model=2)
    A, _, b, c, bu, bl = j_shard(mesh, A, None, b, c, e, e, shard_rows=True)
    r = j_make_batch(jspec, _j_settings(kw), has_P=False)(A, b, c, bu, bl)
    return {k: np.asarray(getattr(r, k)) for k in ("status", "iters", "pobj")}


# ---- the port's unsharded solves ----

def _port_unsharded(arrays, inst, kind, kw, ds, eps=None) -> dict:
    spec = worker.SPECS[inst]
    A, b, c = (torch.as_tensor(arrays[f"{inst}_{k}"]) for k in "Abc")
    extra = {} if eps is None else dict(eps_abs=eps, eps_rel=eps)
    stg = Settings(**kw, **extra)
    if kind == "pure":
        e = torch.zeros(0, dtype=A.dtype)
        r = make_pure_solver(spec, stg, device="cpu", ds_split=ds)(
            A, None, b, c, e, e)
    else:
        e = torch.zeros(A.shape[0], 0, dtype=A.dtype)
        make = (make_chunked_batch_solver if kind == "chunked"
                else make_batch_solver)
        r = make(spec, stg, device="cpu", ds_split=ds)(A, b, c, e, e)
    return {k: np.atleast_1d(getattr(r, k).numpy())
            for k in ("status", "iters", "pobj", "x", "y", "s")}


def _reference(arrays, world: int, case) -> dict:
    name, (inst, kind, kw, ds, _) = case
    if name == "single":
        return _jax_single(arrays, inst, True, kw)
    if name == "uneven":
        return _jax_single(arrays, inst, False, kw)
    if kind == "chunked":
        return _port_unsharded(arrays, inst, kind, kw, ds)
    return _jax_lp(arrays, world, kw)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every job started, the references computed while they run, then
    their results: {job: (per-rank results, references, unsharded eps
    1e-9 solves)}."""
    d = tmp_path_factory.mktemp("rowshard")
    arrays = _instances()
    cases = str(d / "cases.npz")
    np.savez(cases, **arrays)
    dirs = {job: d / job for job in worker.JOBS}
    procs = {}
    for job, out in dirs.items():
        out.mkdir()
        procs[job] = _start(job, cases, str(out))
    try:
        refs, tight = {}, {}
        for job, (world, table) in worker.JOBS.items():
            refs[job] = {name: _reference(arrays, world, (name, case))
                         for name, case in table.items()}
            tight[job] = {name: _port_unsharded(arrays, inst, kind, kw, ds,
                                                worker.TIGHT)
                          for name, (inst, kind, kw, ds, t) in table.items()
                          if t}
    finally:
        ranks = {job: _finish(procs[job], str(dirs[job])) for job in procs}
    return {job: (ranks[job], refs[job], tight[job]) for job in procs}


CASE_IDS = [(job, name) for job, (_, table) in worker.JOBS.items()
            for name in table]


@pytest.mark.parametrize("job,name", CASE_IDS,
                         ids=[f"{j}-{n}" for j, n in CASE_IDS])
def test_row_sharded_solve_matches_the_reference(jobs, job, name):
    ranks, refs, _ = jobs[job]
    got, ref = ranks[0][name]["default"], refs[name]
    status = np.atleast_1d(got["status"])
    np.testing.assert_array_equal(status, ref["status"])
    assert np.all(status == config.SOLVED), status
    pobj = np.atleast_1d(got["pobj"])
    assert np.all(np.abs(pobj - ref["pobj"])
                  <= 1e-4 * (1 + np.abs(ref["pobj"]))), (pobj, ref["pobj"])
    ratio = np.atleast_1d(got["iters"]) / ref["iters"]
    assert np.all((ratio >= 0.8) & (ratio <= 1.25)), (got["iters"],
                                                      ref["iters"])


TIGHT_IDS = [(job, name) for job, (_, table) in worker.JOBS.items()
             for name, case in table.items() if case[-1]]


@pytest.mark.parametrize("job,name", TIGHT_IDS,
                         ids=[f"{j}-{n}" for j, n in TIGHT_IDS])
def test_row_sharded_solve_at_eps_1e9_matches_unsharded(jobs, job, name):
    """x, y and s within 1e-6 (1 + max |.|) of the port's unsharded solve.
    The one-problem instances have more active rows at the optimum (34
    and 36) than columns (30), so their y is not unique (the port's own
    direct and indirect solves at eps 1e-9 land 0.1 apart in y): there y
    is held to dual optimality instead, its dual residual A'y + c, its
    distance to the dual cone, s'y and b'y each within 1e-6 (1 + max
    |.|) of zero or of the unsharded solve's."""
    ranks, _, tight = jobs[job]
    got, ref = ranks[0][name]["tight"], tight[name]
    np.testing.assert_array_equal(np.atleast_1d(got["status"]),
                                  ref["status"])
    inst, kind = worker.JOBS[job][1][name][:2]
    for k in ("x", "s") if kind == "pure" else ("x", "y", "s"):
        a, r = np.asarray(got[k]), ref[k]
        tol = 1e-6 * (1 + np.max(np.abs(r), axis=-1, keepdims=True))
        assert np.all(np.abs(a - r) <= tol), (k, np.max(np.abs(a - r)))
    if kind == "pure":
        _dual_optimal(inst, got, ref)


def _dual_optimal(inst: str, got: dict, ref: dict) -> None:
    arrays = _instances()
    A, b, c = (torch.as_tensor(arrays[f"{inst}_{k}"]) for k in "Abc")
    y, s = (torch.as_tensor(got[k], dtype=torch.float64) for k in "ys")
    spec = worker.SPECS[inst]

    def small(v, scale):
        return float(torch.abs(v).max()) <= 1e-6 * (1 + scale)

    assert small(A.T @ y + c, float(c.abs().max()))
    y_proj, _ = proj_dual_cone(y, spec, ConeData.make(spec),
                               torch.ones((), dtype=y.dtype), None)
    assert small(y_proj - y, float(y.abs().max()))
    assert small(torch.dot(s, y), float(s.abs().max() * y.abs().max()))
    bty_ref = float(torch.as_tensor(ref["y"]) @ b)
    assert small(b @ y - bty_ref, abs(bty_ref))


@pytest.mark.parametrize("job", sorted(worker.JOBS))
def test_ranks_return_the_same_bits(jobs, job):
    ranks = jobs[job][0]
    for name, runs in ranks[0].items():
        for label, run in runs.items():
            for r, other in enumerate(ranks[1:], 1):
                assert other[name][label]["digest"] == run["digest"], (
                    name, label, r)


# ---- the operand in this process ----

@pytest.fixture
def one_rank_group():
    multihost._ensure_group()
    try:
        yield torch.distributed.group.WORLD
    finally:
        torch.distributed.destroy_process_group()


def _dense(m=11, n=7, B=None, seed=0):
    rng = np.random.RandomState(seed)
    shape = (m, n) if B is None else (B, m, n)
    return torch.as_tensor(rng.uniform(-1, 1, shape)
                           * (rng.rand(*shape) < 0.7))


def _close(a, b, rtol=1e-13):
    scale = float(torch.abs(b).max()) + 1e-300
    assert float(torch.abs(a - b).max()) <= rtol * scale, (
        float(torch.abs(a - b).max()), scale)


@pytest.mark.parametrize("B", [None, 3])
def test_one_rank_operand_equals_the_dense_one(one_rank_group, B):
    A = _dense(B=B)
    S = rowshard.shard_rows(A, one_rank_group)
    assert S.shape == tuple(A.shape) and S.m_local == A.shape[-2]
    lead = () if B is None else (B,)
    rng = np.random.RandomState(1)
    x = torch.as_tensor(rng.randn(*lead, A.shape[-1]))
    z = torch.as_tensor(rng.randn(*lead, A.shape[-2]))
    r_y = torch.as_tensor(rng.rand(*lead, A.shape[-2]) + 0.5)
    At = A.transpose(-2, -1)
    mv = (lambda M, v: torch.matmul(M, v.unsqueeze(-1)).squeeze(-1))
    _close(S @ x, mv(A, x))
    _close(S.T @ z, mv(At, z))
    _close(S.schur_matvec(x, r_y), mv(At, mv(A, x) / r_y))
    _close(S.gram(4), torch.matmul(At, A)
           + 999.0 * torch.matmul(At[..., :4], A[..., :4, :]))
    _close(S.diag_gram(4), torch.sum(A * A, dim=-2)
           + 999.0 * torch.sum(A[..., :4, :] ** 2, dim=-2))
    _close(S.row_abs_max(), torch.amax(torch.abs(A), -1))
    _close(S.col_abs_max(), torch.amax(torch.abs(A), -2))
    _close(S.row_sumsq(), torch.sum(A * A, -1))
    _close(S.col_sumsq(), torch.sum(A * A, -2))
    D, E = torch.rand(*lead, A.shape[-2]) + 0.5, torch.rand(
        *lead, A.shape[-1]) + 0.5
    _close(S.scale(D.double(), E.double()).local,
           D.double()[..., :, None] * A * E.double()[..., None, :])
    fwd, bwd = S.split()
    _close(fwd.apply(x), mv(A, x))
    _close(bwd.apply(z), mv(At, z))


def test_one_rank_equilibration_equals_the_dense_one(one_rank_group):
    spec = ConeSpec(z=2, l=5, q=(4,))
    A = _dense(m=11, n=7, B=2)
    S = rowshard.shard_rows(A, one_rank_group)
    A_d, _, sc_d = eq.equilibrate_batched(A, None, spec)
    A_s, _, sc_s = eq.equilibrate_batched(S, None, spec)
    assert torch.equal(A_s.local, A_d)
    assert torch.equal(sc_s.D, sc_d.D) and torch.equal(sc_s.E, sc_d.E)


def _by_hand(A, k=2):
    """Every shard of A's rows over k ranks, built without a group (their
    local parts only are read)."""
    return [rowshard.shard_rows(A, None, rank=r, size=k) for r in range(k)]


@pytest.mark.parametrize("m", [11, 12])
def test_shards_summed_by_hand_equal_the_dense_operand(m):
    """Each shard's local parts (products, Gram, statistics), concatenated
    or summed by hand, equal the dense operand's; z = 7 zero-cone rows
    straddle the edge of ceil(m / 2) = 6."""
    A = _dense(m=m, n=5, B=2, seed=3)
    shards = _by_hand(A)
    assert [s.m_local for s in shards] == [6, m - 6]
    assert [s.zero_rows(7) for s in shards] == [6, 1]
    rng = np.random.RandomState(4)
    x = torch.as_tensor(rng.randn(2, 5))
    z = torch.as_tensor(rng.randn(2, m))
    r_y = torch.as_tensor(rng.rand(2, m) + 0.5)
    At = A.transpose(1, 2)
    mv = (lambda M, v: torch.matmul(M, v.unsqueeze(-1)).squeeze(-1))
    _close(torch.cat([s.local_matvec(x) for s in shards], -1), mv(A, x))
    _close(sum(s.local_rmatvec(z) for s in shards), mv(At, z))
    _close(sum(s.local_schur(x, r_y) for s in shards),
           mv(At, mv(A, x) / r_y))
    _close(sum(s.local_gram(7) for s in shards),
           torch.matmul(At, A) + 999.0 * torch.matmul(At[..., :7],
                                                      A[:, :7]))
    _close(sum(s.local_diag_gram(7) for s in shards),
           torch.sum(A * A, 1) + 999.0 * torch.sum(A[:, :7] ** 2, 1))


def test_shard_splits_by_hand_equal_the_plain_products():
    """The double-single products of each shard (the kernels' plain
    versions here): A_r x concatenated, and A_r' z_r summed in float64,
    also from K3's float32 pairs (the float32-state phase), against the
    float64 products of the split's exact hi + lo."""
    A = _dense(m=13, n=6, B=2, seed=5)
    rng = np.random.RandomState(6)
    x = torch.as_tensor(rng.randn(2, 6))
    z = torch.as_tensor(rng.randn(2, 13))
    splits = [s.split() for s in _by_hand(A)]
    full = dsmatvec.split_operand(A)
    exact = full.hi.double() + full.lo.double()
    mv = (lambda M, v: torch.matmul(M, v.unsqueeze(-1)).squeeze(-1))
    _close(torch.cat([rowshard._local_ds(f.split, x) for f, _ in splits],
                     -1), mv(exact, x))
    _close(sum(rowshard._local_ds_partial(b.split, b._rows(z))
               for _, b in splits), mv(exact.transpose(1, 2), z))
    z32 = z.to(torch.float32)
    pairs = sum(rowshard._local_ds_partial(b.split, b._rows(z32))
                for _, b in splits)
    assert pairs.dtype == torch.float64
    _close(pairs, mv(exact.transpose(1, 2), z32.double()))


def test_shard_bounds_and_what_cannot_be_sharded(one_rank_group):
    assert rowshard.shard_bounds(79, 2, 1) == (40, 39, 40)
    assert rowshard.shard_bounds(80, 8, 7) == (70, 10, 10)
    with pytest.raises(ValueError, match="non-empty"):
        rowshard.shard_bounds(5, 4, 0)
    with pytest.raises(TypeError, match="dense"):
        rowshard.shard_rows(sparse_from_dense(_dense().numpy()),
                            one_rank_group)
    S = rowshard.shard_rows(_dense(), one_rank_group)
    spec = ConeSpec(l=11)
    prob = Problem(A=S, b=torch.ones(11), c=torch.ones(7))
    with pytest.raises(TypeError, match="make_pure_solver"):
        Workspace(prob, spec, None, Settings(), device="cpu")
    # b holds every row on every rank: its shard alone is refused
    solve = make_pure_solver(spec, Settings(), device="cpu")
    e = torch.zeros(0, dtype=torch.float64)
    with pytest.raises(ValidationError, match="all 11 rows"):
        solve(S, None, torch.ones(6, dtype=torch.float64),
              torch.ones(7, dtype=torch.float64), e, e)


def test_a_one_rank_model_axis_solves_like_the_dense_batch(one_rank_group):
    """make_batch_solver on a one-rank group's RowShardedA gives the dense
    batch's bits (the collectives of a one-rank group copy)."""
    spec = ConeSpec(l=32)
    a = _instances()
    A, b, c = (torch.as_tensor(a[f"lp_{k}"]) for k in "Abc")
    e = torch.zeros(A.shape[0], 0, dtype=A.dtype)
    stg = Settings(linsys="direct")
    S = rowshard.shard_rows(A, one_rank_group)
    got = make_batch_solver(spec, stg, device="cpu")(S, b, c, e, e)
    ref = make_batch_solver(spec, stg, device="cpu")(A, b, c, e, e)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), \
            f.name


def test_the_time_limit_is_agreed_over_the_group(one_rank_group):
    """`any_rank` is the group's OR of a host flag, which the batched loop
    takes for its time limit (`solver_batched._past`): a row-sharded
    batch with a limit already passed stops at its first macro boundary
    on every rank, unfinished lanes resolved as the dense batch's are."""
    S = rowshard.shard_rows(_dense(), one_rank_group)
    assert S.any_rank(True) and not S.any_rank(False)
    spec = ConeSpec(l=32)
    a = _instances()
    A, b, c = (torch.as_tensor(a[f"lp_{k}"]) for k in "Abc")
    e = torch.zeros(A.shape[0], 0, dtype=A.dtype)
    stg = Settings(linsys="direct", time_limit_secs=1e-9)
    got = make_batch_solver(spec, stg, device="cpu")(
        rowshard.shard_rows(A, one_rank_group), b, c, e, e)
    ref = make_batch_solver(spec, stg, device="cpu")(A, b, c, e, e)
    assert torch.equal(got.iters, ref.iters)
    assert torch.equal(got.status, ref.status)
    assert bool((got.status != config.SOLVED).all())
