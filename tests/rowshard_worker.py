"""One rank of the row-sharded solves of tests/test_torch_rowshard.py.

    MASTER_ADDR=127.0.0.1 MASTER_PORT=... WORLD_SIZE=2 RANK=r \
        python tests/rowshard_worker.py JOB CASES.npz OUT_DIR

Joins a gloo group (the environment `torchrun` sets), builds a (1, 2)
mesh for two ranks or a (2, 2) mesh for four, and solves on the CPU every
case of the job JOB (`JOBS`) from the instances in CASES.npz (written by the
test from the JAX package's generators): each at the default eps and
some also at eps 1e-9, A's rows over the mesh's "model" dimension. Writes
OUT_DIR/rank<r>.json: per case the statuses, iterations and objectives,
x, y and s of both solves, and a digest of their bits. Imports the port
only.
"""

import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

torch.set_num_threads(1)

from scs_tpu_torch import Settings  # noqa: E402
from scs_tpu_torch.ops import rowshard  # noqa: E402
from scs_tpu_torch.parallel import (make_chunked_batch_solver,  # noqa: E402
                                    make_mesh, make_pure_solver,
                                    shard_problem_batch)
from scs_tpu_torch.parallel import collectives, multihost  # noqa: E402
from scs_tpu_torch.types import ConeSpec  # noqa: E402

SINGLE = ConeSpec(z=16, l=40, q=(8, 16))       # m = 80
UNEVEN = ConeSpec(z=15, l=40, q=(8, 16))       # m = 79
LP = ConeSpec(l=32)

# job -> (ranks, cases); a case: name -> (instance, solver, Settings
# keywords, ds_split, tight); the
# instances are arrays of CASES.npz, "single" and "uneven" one problem
# each, "lp" a batch of four; `tight` adds the solve at eps 1e-9 (the
# indirect backend's CG takes a collective an iteration, ~1 ms each on a
# loaded CPU, so two of its cases take it)
JOBS = {
    "one-problem": (2, {
        "single": ("single", "pure", dict(linsys="indirect"), False, False),
        "uneven": ("uneven", "pure", dict(linsys="indirect"), False, True),
    }),
    "batch": (2, {
        "lp-direct-pure": ("lp", "batch", dict(linsys="direct"), False,
                           True),
        "lp-direct-mixed": ("lp", "batch", dict(
            linsys="direct", mixed_precision=True, fast_f32=False), True,
            True),
        "lp-indirect-pure": ("lp", "batch", dict(linsys="indirect"), False,
                             False),
        "lp-indirect-mixed": ("lp", "batch", dict(
            linsys="indirect", mixed_precision=True, fast_f32=False), True,
            False),
        "lp-f32-state-chunked": ("lp", "chunked", dict(
            linsys="direct", mixed_precision=True, chunk_iters=25), True,
            True),
    }),
    "mesh-2x2": (4, {
        "lp-direct-pure": ("lp", "batch", dict(linsys="direct"), False,
                           True),
        "lp-indirect-mixed": ("lp", "batch", dict(
            linsys="indirect", mixed_precision=True, fast_f32=False), True,
            True),
    }),
}
SPECS = {"single": SINGLE, "uneven": UNEVEN, "lp": LP}
TIGHT = 1e-9


def _digest(res) -> str:
    h = hashlib.sha256()
    for t in (res.x, res.y, res.s, res.pobj):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _fields(res) -> dict:
    return {k: getattr(res, k).tolist()
            for k in ("status", "iters", "pobj", "x", "y", "s")}


def solve_case(mesh, inst, kind, kw, ds, tight, arrays):
    spec = SPECS[inst]
    A, b, c = (torch.as_tensor(arrays[f"{inst}_{k}"]) for k in "Abc")
    out = {}
    runs = (("default", None), ("tight", TIGHT)) if tight else (
        ("default", None),)
    for label, eps in runs:
        extra = {} if eps is None else dict(eps_abs=eps, eps_rel=eps)
        stg = Settings(**kw, **extra)
        t0 = time.perf_counter()
        if kind == "pure":
            e = torch.zeros(0, dtype=A.dtype)
            A_r = rowshard.shard_rows(A, mesh.get_group("model"))
            res = make_pure_solver(spec, stg, device="cpu", ds_split=ds)(
                A_r, None, b, c, e, e)
        else:
            e = torch.zeros(A.shape[0], 0, dtype=A.dtype)
            A_l, _, b_l, c_l, bu, bl = shard_problem_batch(
                mesh, A, None, b, c, e, e, shard_rows=True)
            if kind == "chunked":
                solve = make_chunked_batch_solver(spec, stg, device="cpu",
                                                  ds_split=ds)
                local = solve(A_l, b_l, c_l, bu, bl)
                res = type(local)(**{
                    k: torch.cat(collectives.all_gather(
                        v, mesh.get_group("data")))
                    for k, v in local.__dict__.items()})
            else:
                res = multihost.make_sharded_batch_solver(
                    spec, stg, mesh, axis_name="data")(A_l, b_l, c_l, bu,
                                                       bl)
        out[label] = dict(_fields(res), digest=_digest(res),
                          seconds=time.perf_counter() - t0,
                          collectives=collectives.calls)
        collectives.calls = 0
    return out


def main() -> int:
    job, cases_file, out_dir = sys.argv[1:4]
    multihost.init_distributed(backend="gloo")
    world = torch.distributed.get_world_size()
    rank = torch.distributed.get_rank()
    mesh = make_mesh(data=world // 2, model=2, device="cpu")
    arrays = dict(np.load(cases_file))
    got = {name: solve_case(mesh, *case, arrays)
           for name, case in JOBS[job][1].items()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(got, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
