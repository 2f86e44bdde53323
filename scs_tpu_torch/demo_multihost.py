"""One rank of a sharded batch solve (`parallel.multihost`).

    MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 WORLD_SIZE=2 RANK=0 \
        python -m scs_tpu_torch.demo_multihost [--device cpu] [--batch 16]

(and RANK=1 in a second process; or under `torchrun --nproc-per-node 2
-m scs_tpu_torch.demo_multihost`). With no such environment it runs one
process. Each rank takes its slice of a batch of planted SOCPs through
`parallel.make_mesh` and `shard_problem_batch` (checked against
`local_batch_slice`), solves it with `make_sharded_batch_solver` on its
device (its card under NCCL, the default; the CPU under gloo with
`--device cpu`), and rank 0 prints one JSON line of the gathered
statuses, iterations and objectives. With an even number of ranks it
also solves the batch on a (world / 2, 2) mesh, as the JAX package's
`dryrun_multichip` does: each rank its slice along "data" and its rows
of A along "model" (`shard_problem_batch(..., shard_rows=True)`), the
results gathered over "data" (`make_sharded_batch_solver(...,
axis_name="data")`), under "rows" in the line.
"""

import torch
import torch.distributed as dist

from .parallel.multihost import (_ensure_group, init_distributed,
                                 local_batch_slice, make_global_mesh,
                                 make_sharded_batch_solver)


def planted_batch(B: int, seed0: int = 0):
    """(spec, A, b, c, bu, bl) of B planted problems of a small SOCP
    family (seeds seed0 ... seed0 + B - 1), stacked on the CPU."""
    from .models import gen_planted
    from .types import ConeSpec
    spec = ConeSpec(z=3, l=12, q=(4, 5))
    probs = [gen_planted(spec, n=10, seed=seed0 + i, density=0.5).problem
             for i in range(B)]
    A, b, c = (torch.stack([getattr(p, k) for p in probs])
               for k in ("A", "b", "c"))
    empty = torch.zeros(B, 0, dtype=A.dtype)
    return spec, A, b, c, empty, empty


def main(argv=None) -> int:
    import argparse
    import json

    from .types import Settings
    from .parallel.sharding import make_mesh, shard_problem_batch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args(argv)
    init_distributed(backend="nccl" if args.device == "cuda" else "gloo")
    _ensure_group()
    world = dist.get_world_size()
    spec, A, b, c, bu, bl = planted_batch(args.batch)
    stg = Settings(linsys="direct", eps_abs=1e-7, eps_rel=1e-7)
    # each rank's shard, through the (data, model) mesh and through the
    # global mesh's slice: the same rows
    A_l, _, b_l, c_l, bu_l, bl_l = shard_problem_batch(
        make_mesh(data=world), A, None, b, c, bu, bl)
    sl = local_batch_slice(args.batch)
    assert torch.equal(A_l.cpu(), A[sl]), "shard_problem_batch's rows"
    res = make_sharded_batch_solver(spec, stg, make_global_mesh())(
        A_l, b_l, c_l, bu_l, bl_l)
    rows = None
    if world % 2 == 0:
        mesh = make_mesh(data=world // 2, model=2)
        A_r, _, b_r, c_r, bu_r, bl_r = shard_problem_batch(
            mesh, A, None, b, c, bu, bl, shard_rows=True)
        out = make_sharded_batch_solver(spec, stg, mesh, axis_name="data")(
            A_r, b_r, c_r, bu_r, bl_r)
        rows = {k: getattr(out, k).tolist()
                for k in ("status", "iters", "pobj")}
    if dist.get_rank() == 0:
        print(json.dumps({
            "world": world, "status": res.status.tolist(),
            "iters": res.iters.tolist(), "pobj": res.pobj.tolist(),
            "device": str(res.pobj.device), "rows": rows}),
            flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
