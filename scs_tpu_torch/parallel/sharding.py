"""Meshes, the batch axis of a problem batch over processes, and the rows
of A over a model group.

Counterpart of `scs_tpu/parallel/sharding.py`. A (data, model) mesh: the
batch axis of independent problems is the data-parallel axis ("data"),
each rank taking its slice of a stacked batch
(`multihost.make_sharded_batch_solver` gathers the results over
"data"); with `shard_rows=True` the rows of A are spread over the ranks
of the "model" dimension (`ops.rowshard.RowShardedA`). The JAX package
places b's entries on "model" too and leaves the reductions that cross
shards to XLA; here only A is sharded, b and every vector of the solve
stay whole on each rank, and the products that cross shards run the
model group's collectives themselves (`ops/rowshard.py` says where).

The mesh's device type follows the process group's backend ("cuda"
under NCCL, "cpu" under gloo); the device the ranks solve on is the
mesh's `solve_device`, which `make_mesh(device=...)` sets, so that a gloo
group can solve on a card (two gloo ranks can share one card, which
NCCL refuses).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import rowshard
from .multihost import (_ensure_group, local_device, mesh_device,
                        mesh_device_type)


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              model: int = 1, device=None) -> DeviceMesh:
    """A (data, model) mesh over the first data * model ranks (one rank
    a card under NCCL), whose ranks solve on `device` (default: the
    rank's card under NCCL, the CPU under gloo; `local_device`)."""
    _ensure_group()
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if data is None:
        data = n_devices // model
    if data < 1 or data * model > world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the group has {world}")
    grid = torch.arange(data * model).reshape(data, model)
    mesh = DeviceMesh(mesh_device_type(), grid,
                      mesh_dim_names=("data", "model"))
    mesh.solve_device = local_device(device)
    return mesh


def shard_problem_batch(mesh: DeviceMesh, A, P_mat, b, c, bu, bl,
                        shard_rows: bool = False):
    """This rank's slice of a stacked problem batch along "data", on the
    mesh's device, in the order (A, P, b, c, bu, bl) (P may be None).

    The batch must divide by the data dimension; ranks that share a data
    coordinate get the same slice. With `shard_rows`, A is returned as
    this rank's rows of the slice (`ops.rowshard.RowShardedA` over the
    "model" dimension's group, ceil(m / model) rows a rank, the last
    rank's fewer where m does not divide); b and every other array stay
    whole. On a model dimension of one rank A stays a tensor. Row
    sharding takes dense operands only."""
    if shard_rows and not isinstance(A, torch.Tensor):
        raise TypeError(f"row sharding takes a dense stack A, got "
                        f"{type(A).__name__}: the JAX package places only "
                        f"dense arrays")
    names = mesh.mesh_dim_names
    n_data = mesh.size(names.index("data"))
    B = A.shape[0]
    if B % n_data:
        raise ValueError(f"batch {B} must be divisible by the data "
                         f"dimension {n_data}")
    per = B // n_data
    k = mesh.get_coordinate()[names.index("data")]
    dev = mesh_device(mesh)

    def part(t):
        if t is None:
            return None
        return torch.as_tensor(t)[k * per:(k + 1) * per].to(dev)

    A_l, P_l, b_l, c_l, bu_l, bl_l = (part(t)
                                      for t in (A, P_mat, b, c, bu, bl))
    if shard_rows and mesh.size(names.index("model")) > 1:
        A_l = rowshard.shard_rows(A_l, mesh.get_group("model"))
    return A_l, P_l, b_l, c_l, bu_l, bl_l
