"""Batched solves (counterpart of `scs_tpu/parallel`): the batched solvers
of `batch`, and the batch axis over processes, one a card (`multihost`:
`torch.distributed`, NCCL between cards and gloo on the CPU; `sharding`:
the (data, model) mesh, each rank's slice of a batch and, with
`shard_rows=True`, its rows of A over the "model" dimension, whose
products cross ranks through `collectives`)."""

from .batch import (BatchWorkspace, SolveResult, make_batch_solver,
                    make_chunked_batch_solver, make_pure_solver,
                    make_restart_fn, make_solver_parts, make_update_fn)
from .sharding import make_mesh, shard_problem_batch

__all__ = [
    "BatchWorkspace", "SolveResult", "make_batch_solver",
    "make_chunked_batch_solver", "make_pure_solver", "make_restart_fn",
    "make_solver_parts", "make_update_fn", "make_mesh",
    "shard_problem_batch",
]
