"""Multi-process runtime for batched solves: the batch axis over processes.

Counterpart of `scs_tpu/parallel/multihost.py`, in `torch.distributed`'s
idiom: one process per card (NCCL between cards, gloo on the CPU), each
solving its local shard of the global batch with `make_batch_solver` on
its own device; the results are gathered with `all_gather`, so that
every process reads the whole batch (host-side certificate checks,
result IO).

Usage per process (the environment of `torchrun`, or arguments)::

    from scs_tpu_torch.parallel import multihost
    multihost.init_distributed()             # MASTER_ADDR/PORT, WORLD_SIZE,
                                             # RANK, LOCAL_RANK
    mesh = multihost.make_global_mesh()      # 1-D 'batch' mesh, all ranks
    solver = multihost.make_sharded_batch_solver(spec, stg, mesh)
    res = solver(A_local, b_local, c_local, bu_local, bl_local)
    # every rank passes its LOCAL shard (the same shape on every rank);
    # res holds the global batch, in rank order, on this rank's device

On a (data, model) mesh (`sharding.make_mesh(data=..., model=...)`)
each rank passes its slice along "data" with its rows of A over "model"
(`sharding.shard_problem_batch(..., shard_rows=True)`), and
`make_sharded_batch_solver(..., axis_name="data")` gathers the results
over "data" only: the ranks of one model group solve the same lanes and
return the same bits.

`python -m scs_tpu_torch.demo_multihost` runs one rank of a sharded
solve under that environment.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import collectives
from .batch import SolveResult, _solve_args, make_batch_solver


def _address(addr: str) -> str:
    return addr if "://" in addr else f"tcp://{addr}"


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None else int(v)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None, *,
                     backend: Optional[str] = None) -> None:
    """Join this process to the process group (idempotent).

    The arguments default to the environment `torchrun` sets:
    MASTER_ADDR and MASTER_PORT (coordinator_address "host:port"),
    WORLD_SIZE, RANK and LOCAL_RANK (the card of this process, or
    `local_device_ids`, an int or a one-element list). With no argument
    and no such environment this is a one-process run and nothing is
    initialized. `backend` defaults to NCCL where a card is visible and
    gloo otherwise.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if local_device_ids is None:
        local_device_ids = _env_int("LOCAL_RANK")
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        return      # one process; nothing to initialize
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the number of "
            "processes and this process's id (arguments, or MASTER_ADDR/"
            "MASTER_PORT, WORLD_SIZE and RANK)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    host = _address(coordinator_address).split("://")[1].rsplit(":", 1)[0]
    if backend == "gloo" and host in ("127.0.0.1", "localhost"):
        # every rank is on this host: gloo's pairs over the loopback
        # device, not the interface the host name resolves to (on an
        # H100's host a call took ~40 % less, tools/
        # torch_gloo_cuda_probe.py)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if backend == "nccl":
        local = local_device_ids
        if isinstance(local, (list, tuple)):
            local = local[0]
        torch.cuda.set_device(int(local) if local is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=_address(
        coordinator_address), world_size=int(num_processes),
        rank=int(process_id))


def _ensure_group() -> None:
    """A one-process group on a free local port where none exists (a
    DeviceMesh needs a process group)."""
    if dist.is_initialized():
        return
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    init_distributed(f"127.0.0.1:{port}", 1, 0)


def mesh_device_type() -> str:
    """"cuda" under NCCL, "cpu" under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def local_device(device=None) -> torch.device:
    """This rank's device: `device` where given (a gloo group may solve on
    a card), else its card under NCCL and the CPU under gloo."""
    if device is not None:
        return torch.device(device)
    if mesh_device_type() == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device the mesh's ranks solve on: the one `sharding.make_mesh`
    recorded, else `local_device()`."""
    return getattr(mesh, "solve_device", None) or local_device()


def make_global_mesh(axis_name: str = "batch") -> DeviceMesh:
    """1-D mesh over every rank of every participating process."""
    _ensure_group()
    return DeviceMesh(mesh_device_type(), torch.arange(dist.get_world_size()),
                      mesh_dim_names=(axis_name,))


def make_sharded_batch_solver(spec, stg, mesh: DeviceMesh,
                              has_P: bool = False, max_iters=None,
                              axis_name: str = "batch"):
    """Batch solver whose leading batch axis is split over `mesh`'s
    `axis_name` dimension.

    Each rank passes its LOCAL shard (the same shape on every rank) of
    (A, [P], b, c, bu, bl) (A may be its rows over a "model" dimension,
    `sharding.shard_problem_batch(..., shard_rows=True)`); it is solved
    by `make_batch_solver` on the mesh's device (`mesh_device`),
    and every field of the SolveResult is gathered over the dimension's
    group, so that every rank returns the global batch in rank order
    (`local_batch_slice` gives each rank's part).
    """
    group = mesh.get_group(axis_name)
    dev = mesh_device(mesh)
    solve = make_batch_solver(spec, stg, max_iters, has_P=True, device=dev)

    def gather(t: torch.Tensor) -> torch.Tensor:
        return torch.cat(collectives.all_gather(t, group))

    def solver(*local_arrays) -> SolveResult:
        res = solve(*_solve_args(has_P, local_arrays))
        return SolveResult(**{k: gather(v)
                              for k, v in res.__dict__.items()})

    return solver


def local_batch_slice(global_batch: int) -> slice:
    """The slice of a global batch this process is responsible for."""
    nproc = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % nproc:
        raise ValueError(
            f"global batch {global_batch} must be divisible by the "
            f"process count {nproc}")
    per = global_batch // nproc
    pid = dist.get_rank() if dist.is_initialized() else 0
    return slice(pid * per, (pid + 1) * per)
