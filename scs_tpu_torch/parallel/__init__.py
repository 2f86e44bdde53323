"""Batched solves (counterpart of `scs_tpu/parallel`). Sharding over
several cards is ROADMAP queue 1, item 16."""

from .batch import (BatchWorkspace, SolveResult, make_batch_solver,
                    make_chunked_batch_solver, make_pure_solver,
                    make_restart_fn, make_solver_parts, make_update_fn)

__all__ = [
    "BatchWorkspace", "SolveResult", "make_batch_solver",
    "make_chunked_batch_solver", "make_pure_solver", "make_restart_fn",
    "make_solver_parts", "make_update_fn",
]
