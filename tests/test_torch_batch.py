"""The batched slice against the JAX package's batched solvers on the CPU,
with the direct backend, on the shapes of tests/test_parallel.py. Both
packages get the same numpy arrays, stacked from the JAX generators'
seeds (helpers.stack_planted_problems). The JAX side runs
`macro_schedule=False`, which compiles faster and gives the trajectory of
the default body.

Pure float64 follows the JAX trajectory lane by lane: equal statuses and
iteration counts, pobj within 1e-6 (1 + |pobj|) and x within 1e-5 (both
sides run the same float64 arithmetic in another order; round-off
amplified over a few hundred iterations stays far inside these). The
port's batched solves also match its own one-problem Workspace lane by
lane.

Mixed precision is held at eps 1e-7, so that both sides also run the
polish phase and end at float64 accuracy: equal statuses, pobj within
1e-6 (1 + |pobj|), and each lane's iteration count within [0.8, 1.25] of
JAX's. The two sides solve the Anderson least-squares problem in float32
with different QR implementations, whose gammas differ at float32
round-off amplified by the history's conditioning, so their trajectories
part in the last digits."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

from scs_tpu import config as j_config
from scs_tpu.parallel import make_batch_solver as j_make_batch_solver
from scs_tpu.parallel import make_chunked_batch_solver as j_make_chunked
from scs_tpu.types import ConeSpec as JConeSpec
from scs_tpu.types import Settings as JSettings
from scs_tpu_torch import Workspace, config, convert
from scs_tpu_torch.ops import dsmatvec
from scs_tpu_torch.parallel import (make_batch_solver,
                                    make_chunked_batch_solver,
                                    make_pure_solver)
from scs_tpu_torch.types import Problem

from helpers import stack_planted_problems

CASES = {
    "lp": (JConeSpec(l=40), 15, 8, False),
    "socp": (JConeSpec(l=20, q=(6,)), 12, 3, False),
    "qp": (JConeSpec(l=30), 10, 4, True),
}


def _case(name):
    jspec, n, count, with_P = CASES[name]
    A, P, b, c, bu, bl, opts = stack_planted_problems(jspec, n=n,
                                                      count=count,
                                                      with_P=with_P)
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    jargs = (A, P, b, c, bu, bl) if with_P else (A, b, c, bu, bl)
    targs = convert.batch_from_numpy(*(None if a is None else np.asarray(a)
                                       for a in (A, b, c, P, bu, bl)))
    A_, P_, b_, c_, bu_, bl_ = targs
    targs = (A_, P_, b_, c_, bu_, bl_) if with_P else (A_, b_, c_, bu_, bl_)
    return jspec, spec, with_P, jargs, targs, opts


def _port_settings(jstg):
    return convert.settings_from_dict(dataclasses.asdict(jstg))


def _np(res):
    return convert.solve_result_to_numpy(res)


def _same_objectives(got, ref, rtol):
    assert np.all(np.abs(got - ref) <= rtol * (1 + np.abs(ref))), (got, ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_pure_f64_batch_follows_jax(name):
    jspec, spec, with_P, jargs, targs, opts = _case(name)
    jstg = JSettings(linsys="direct", mixed_precision=False,
                     macro_schedule=False)
    jres = j_make_batch_solver(jspec, jstg, has_P=with_P)(*jargs)
    res = _np(make_batch_solver(spec, _port_settings(jstg), has_P=with_P,
                                device="cpu")(*targs))
    np.testing.assert_array_equal(res["status"], np.asarray(jres.status))
    assert np.all(res["status"] == config.SOLVED)
    np.testing.assert_array_equal(res["iters"], np.asarray(jres.iters))
    np.testing.assert_array_equal(res["scale_updates"],
                                  np.asarray(jres.scale_updates))
    _same_objectives(res["pobj"], np.asarray(jres.pobj), 1e-6)
    np.testing.assert_allclose(res["x"], np.asarray(jres.x), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(res["pobj"], opts, atol=1e-3, rtol=1e-3)

    # and lane by lane against the port's own one-problem Workspace
    stg = _port_settings(jstg)
    A, P, b, c = targs[0], (targs[1] if with_P else None), \
        targs[-4], targs[-3]
    for i in range(A.shape[0]):
        prob = Problem(A=A[i], b=b[i], c=c[i],
                       P=None if P is None else P[i])
        _, info = Workspace(prob, spec, None, stg, device="cpu").solve()
        assert info.status_val == res["status"][i]
        assert info.iter == res["iters"][i]
        assert abs(info.pobj - res["pobj"][i]) <= 1e-8 * (1 + abs(info.pobj))


def test_mixed_batch_through_the_plain_k2_follows_jax():
    jspec, spec, with_P, jargs, targs, opts = _case("socp")
    jstg = JSettings(linsys="direct", mixed_precision=True, fast_f32=False,
                     macro_schedule=False, eps_abs=1e-7, eps_rel=1e-7)
    jres = j_make_batch_solver(jspec, jstg, has_P=with_P)(*jargs)
    before = dsmatvec.batched_launches
    solver = make_batch_solver(spec, _port_settings(jstg), has_P=with_P,
                               device="cpu", ds_split=True)
    res = _np(solver(*targs))
    assert dsmatvec.batched_launches == before     # CPU: plain version
    np.testing.assert_array_equal(res["status"], np.asarray(jres.status))
    assert np.all(res["status"] == config.SOLVED)
    _same_objectives(res["pobj"], np.asarray(jres.pobj), 1e-6)
    ratio = res["iters"] / np.asarray(jres.iters)
    assert np.all((0.8 <= ratio) & (ratio <= 1.25)), ratio
    # every lane's targets lie below the fast floor: all of them polished
    assert {lv[0] for lv in solver.levels} == {"fast", "polish"}
    assert np.all(res["res_pri"] < 1e-5) and np.all(res["res_dual"] < 1e-5)


def test_chunked_compaction_matches_the_plain_batch_and_jax():
    """Straggler compaction gathers lanes into smaller buckets and
    scatters them back; every operation acts on each lane alone, so x is
    bitwise the plain batch solver's. The JAX chunked solver gives the
    same statuses and iteration counts."""
    jspec = JConeSpec(l=30, q=(10,))
    A, P, b, c, bu, bl, opts = stack_planted_problems(jspec, n=14, count=16,
                                                      seed0=200)
    jstg = JSettings(linsys="direct", mixed_precision=False,
                     macro_schedule=False, chunk_iters=25)
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    stg = _port_settings(jstg)
    tA, _, tb, tc, tbu, tbl = convert.batch_from_numpy(
        np.asarray(A), np.asarray(b), np.asarray(c))
    chunked = make_chunked_batch_solver(spec, stg, device="cpu")
    res = chunked(tA, tb, tc, tbu, tbl)
    plain = make_batch_solver(spec, stg, device="cpu")(tA, tb, tc, tbu, tbl)
    assert torch.all(res.status == config.SOLVED)
    assert torch.equal(res.x, plain.x)
    assert torch.equal(res.iters, plain.iters)
    buckets = [lv[1] for lv in chunked.levels]
    assert buckets[0] == 16 and min(buckets) < 16, chunked.levels

    jres = j_make_chunked(jspec, jstg)(A, b, c, bu, bl)
    np.testing.assert_array_equal(res.status.numpy(),
                                  np.asarray(jres.status))
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(jres.iters))
    _same_objectives(res.pobj.numpy(), np.asarray(jres.pobj), 1e-6)


def test_pure_solver_is_one_lane_of_the_batch():
    _, spec, _, _, targs, _ = _case("socp")
    stg = convert.settings_from_dict(dataclasses.asdict(
        JSettings(linsys="direct")))
    A, b, c, bu, bl = targs
    batch = make_batch_solver(spec, stg, device="cpu")(A, b, c, bu, bl)
    one = make_pure_solver(spec, stg, device="cpu")(A[1], None, b[1], c[1],
                                                   bu[1], bl[1])
    assert one.x.shape == (A.shape[2],)
    assert int(one.status) == int(batch.status[1]) == j_config.SOLVED
    assert int(one.iters) == int(batch.iters[1])
    torch.testing.assert_close(one.x, batch.x[1], rtol=1e-12, atol=1e-12)


def test_mixed_certificates_polish_in_their_own_bucket():
    """A batch with an infeasible and an unbounded lane among planted
    ones, mixed at the default eps_infeas (below the fast phase's
    certificate floor): the two certificate lanes enter the polish phase
    gathered into a bucket of 8, the others are done after the fast
    phase. Statuses equal the JAX chunked solver's (fast_f32=False)."""
    from scs_tpu.models import gen_infeasible, gen_unbounded

    jspec = JConeSpec(l=20, q=(6,))
    A, _, b, c, bu, bl, _ = stack_planted_problems(jspec, n=12, count=16)
    A, b, c = np.array(A), np.array(b), np.array(c)
    for lane, (prob, _, _) in ((3, gen_infeasible(jspec, n=12, seed=37)),
                               (9, gen_unbounded(jspec, n=12, seed=43))):
        A[lane], b[lane], c[lane] = (np.asarray(prob.A), np.asarray(prob.b),
                                     np.asarray(prob.c))
    jstg = JSettings(linsys="direct", mixed_precision=True, fast_f32=False,
                     macro_schedule=False)
    jres = j_make_chunked(jspec, jstg)(jnp.asarray(A), jnp.asarray(b),
                                       jnp.asarray(c), bu, bl)
    spec = convert.spec_from_dict(dataclasses.asdict(jspec))
    tA, _, tb, tc, tbu, tbl = convert.batch_from_numpy(A, b, c)
    solver = make_chunked_batch_solver(spec, _port_settings(jstg),
                                       device="cpu", ds_split=True)
    res = solver(tA, tb, tc, tbu, tbl)
    np.testing.assert_array_equal(res.status.numpy(),
                                  np.asarray(jres.status))
    assert int(res.status[3]) == config.INFEASIBLE
    assert int(res.status[9]) == config.UNBOUNDED
    assert solver.machinery.polished == 2
    assert [lv[1] for lv in solver.levels if lv[0] == "polish"][0] == 8
    assert torch.isnan(res.x[3]).all() and torch.isnan(res.y[9]).all()
