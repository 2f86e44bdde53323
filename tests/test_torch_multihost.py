"""The batch axis over processes (`scs_tpu_torch.parallel.multihost`,
`parallel.sharding`) on the CPU: two ranks joined by `torch.distributed`
with gloo, each started as `python -m scs_tpu_torch.demo_multihost` with
the environment `torchrun` sets, solve their shards of a batch of planted
SOCPs; the gathered statuses, iteration counts and objectives equal
those of one process solving the whole batch (the lanes are independent:
the same bits). Each rank's slice through `make_mesh(data=2)` and
`shard_problem_batch` is checked against `local_batch_slice` inside the
ranks. The ranks also solve the batch on a (1, 2) mesh, the rows of A
over the "model" dimension (`shard_rows=True`): equal statuses, and
objectives within 1e-5 (1 + |pobj|) of one process (row sharding sums
in another order). The counterpart of tests/test_multihost.py
(jax.distributed)."""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

from scs_tpu_torch import Settings
from scs_tpu_torch.demo_multihost import planted_batch
from scs_tpu_torch.parallel import (make_batch_solver, make_mesh,
                                    shard_problem_batch)
from scs_tpu_torch.parallel import multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ranks(world: int) -> dict:
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "scs_tpu_torch.demo_multihost", "--device",
         "cpu", "--batch", str(BATCH)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    line = [ln for ln in outs[0].splitlines() if ln.startswith("{")]
    return json.loads(line[-1])


def test_two_ranks_gloo_equal_one_process():
    got = _ranks(2)
    spec, A, b, c, bu, bl = planted_batch(BATCH)
    stg = Settings(linsys="direct", eps_abs=1e-7, eps_rel=1e-7)
    res = make_batch_solver(spec, stg, device="cpu")(A, b, c, bu, bl)
    assert got["world"] == 2 and got["device"] == "cpu"
    assert got["status"] == res.status.tolist()
    assert got["iters"] == res.iters.tolist()
    assert got["pobj"] == res.pobj.tolist()
    rows = got["rows"]
    assert rows["status"] == res.status.tolist()
    ref = res.pobj.numpy()
    assert all(abs(p - r) <= 1e-5 * (1 + abs(r))
               for p, r in zip(rows["pobj"], ref)), (rows["pobj"], ref)


def test_local_batch_slice_without_a_group():
    """One process with no group: the whole batch is this rank's."""
    assert not torch.distributed.is_initialized()
    assert multihost.local_batch_slice(6) == slice(0, 6)


def test_init_distributed_is_a_no_op_without_environment(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    multihost.init_distributed()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        multihost.init_distributed(num_processes=2)


def test_shard_rows_on_a_one_rank_model_axis_is_plain():
    """In a one-process group the (1, 1) mesh's slice is the batch itself,
    shard_rows included (the model axis holds one rank); a mesh with more
    data ranks than the group holds raises."""
    multihost._ensure_group()
    try:
        spec, A, b, c, bu, bl = planted_batch(2)
        out = shard_problem_batch(make_mesh(data=1), A, None, b, c, bu, bl,
                                  shard_rows=True)
        assert out[1] is None
        assert all(torch.equal(o, t) for o, t in
                   zip(out[:1] + out[2:], (A, b, c, bu, bl)))
        with pytest.raises(ValueError, match="ranks"):
            make_mesh(data=2)
    finally:
        torch.distributed.destroy_process_group()
