"""Scenario MPC: a BATCH of parametric QPs re-solved warm.

The reference's parametric workflow (scs_init once, then scs_update +
scs_solve(warm_start=1) per control step; scs.c:660-679, 1287-1325) on
the batched path, the JAX package's examples/mpc_warm_batch.py step for
step: B double-integrator MPC instances (one per scenario) set up ONCE
in a BatchWorkspace; every control step shifts each lane's b (its
measured state) and warm re-solves the whole batch, with no
re-equilibration and no refactorization.

Run:  python -m scs_tpu_torch.examples.mpc_warm_batch [B] [--device cpu]
      (default B=256)
"""

import time

import numpy as np
import torch

from ..api import _resolve_device
from ..parallel import BatchWorkspace
from ..types import Settings
from .mpc_warm_start import BD, AD, NX, mpc_problem, ui


def main(B: int = 256, steps: int = 5, device="cuda") -> dict:
    dev = _resolve_device(device)
    A1, b1, P1, c1, n_zero, spec = mpc_problem()
    # B scenarios: different initial states per lane
    rng = np.random.RandomState(0)
    x_meas = rng.uniform(-1.0, 1.0, (B, NX))

    def stack(a):
        return torch.as_tensor(a, device=dev).expand((B,) + a.shape)

    bB = np.broadcast_to(b1[None], (B, b1.size)).copy()
    bB[:, n_zero - NX:n_zero] = x_meas

    stg = Settings(eps_abs=1e-5, eps_rel=1e-5)
    print(f"setting up BatchWorkspace: {B} MPC scenarios, n={A1.shape[1]}, "
          f"m={b1.size} ...")
    t0 = time.perf_counter()
    ws = BatchWorkspace(spec, stg, stack(A1), stack(P1),
                        torch.as_tensor(bB, device=dev), stack(c1),
                        device=dev)
    cold = ws.solve()
    cold_s = time.perf_counter() - t0
    cold_iters = cold.iters.cpu().numpy()
    print(f"cold solve: {cold_s:.1f}s, iters/lane mean "
          f"{cold_iters.mean():.0f} max {cold_iters.max()}")
    assert np.all(cold.status.cpu().numpy() == 1)

    walls, warm_means = [], []
    for step in range(steps):
        # plant step per lane with each lane's first control input
        u0 = ws.last_result.x[:, ui(0)].cpu().numpy()
        x_meas = x_meas @ AD.T + u0[:, None] * BD[:, 0]
        bB[:, n_zero - NX:n_zero] = x_meas
        t0 = time.perf_counter()
        ws.update(b=torch.as_tensor(bB, device=dev))
        res = ws.solve(warm_start=True)
        wall = time.perf_counter() - t0
        it = res.iters.cpu().numpy()
        assert np.all(res.status.cpu().numpy() == 1)
        walls.append(wall)
        warm_means.append(float(it.mean()))
        print(f"step {step}: warm iters/lane mean {it.mean():5.0f} "
              f"max {it.max():4d} (cold mean {cold_iters.mean():.0f}) "
              f"wall {wall:.2f}s = {wall / B * 1e3:.2f} ms/scenario")
    print(f"\nsteady state: warm {warm_means[-1]:.0f} iters/lane vs cold "
          f"{cold_iters.mean():.0f} (iteration counts quantize at the "
          f"25-iteration convergence-check cadence)")
    return {"cold_iters_mean": float(cold_iters.mean()), "cold_s": cold_s,
            "warm_iters_mean": warm_means, "step_s": walls}


if __name__ == "__main__":
    from ._cli import parse
    a = parse(__doc__, "B", 256)
    main(a.B, device=a.device)
