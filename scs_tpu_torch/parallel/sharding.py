"""Meshes and the batch axis of a problem batch over processes.

Counterpart of `scs_tpu/parallel/sharding.py`. The batch axis of
independent problems is the data-parallel axis ("data"): each rank takes
its slice of a stacked batch and solves it on its own device
(`multihost.make_sharded_batch_solver` gathers the results).

The model axis (rows of A over ranks) is not ported: in the JAX package
XLA inserts the psums that row shards need; here the products, dots and
norms of both linear-system backends, and the cone blocks that straddle
row shards, would need explicit collectives (ROADMAP queue 1, item 16b).
`shard_problem_batch(..., shard_rows=True)` on a mesh whose model
dimension holds more than one rank raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .multihost import _ensure_group, local_device, mesh_device_type


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              model: int = 1) -> DeviceMesh:
    """A (data, model) mesh over the first data * model ranks (one rank
    a card under NCCL)."""
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
    return DeviceMesh(mesh_device_type(), grid,
                      mesh_dim_names=("data", "model"))


def shard_problem_batch(mesh: DeviceMesh, A, P_mat, b, c, bu, bl,
                        shard_rows: bool = False):
    """This rank's slice of a stacked problem batch along "data", on this
    rank's device, in the order (A, P, b, c, bu, bl) (P may be None).

    The batch must divide by the data dimension; ranks that share a data
    coordinate get the same slice. Row sharding (`shard_rows=True` with
    more than one rank on "model") is ROADMAP queue 1 item 16b and
    raises NotImplementedError."""
    n_model = mesh.size(mesh.mesh_dim_names.index("model"))
    if shard_rows and n_model > 1:
        raise NotImplementedError(
            "row (model-axis) sharding is not ported: ROADMAP.md queue 1, "
            "item 16b (the products, dots and norms of both backends and "
            "the cone blocks that straddle row shards need collectives)")
    n_data = mesh.size(mesh.mesh_dim_names.index("data"))
    B = A.shape[0]
    if B % n_data:
        raise ValueError(f"batch {B} must be divisible by the data "
                         f"dimension {n_data}")
    per = B // n_data
    k = mesh.get_coordinate()[mesh.mesh_dim_names.index("data")]
    dev = local_device()

    def part(t):
        if t is None:
            return None
        return torch.as_tensor(t)[k * per:(k + 1) * per].to(dev)

    return tuple(part(t) for t in (A, P_mat, b, c, bu, bl))
