"""Parametric QP sequence with workspace reuse and warm starts (MPC).

The reference solver's incremental b/c update workflow (scs_update +
scs_solve(warm_start=1), scs.c:1287-1325), the JAX package's
examples/mpc_warm_start.py step for step: factor once, then re-solve a
sequence of problems that differ only in b, seeding each solve from the
previous solution. A receding-horizon double-integrator MPC loop: b
carries the measured state, which changes every step.

Run:  python -m scs_tpu_torch.examples.mpc_warm_start [STEPS]
      [--device cpu]
"""

import time

import numpy as np

from ..api import Workspace
from ..convert import problem_from_numpy
from ..types import ConeSpec, Settings

# double integrator x+ = Ad x + Bd u, horizon T, |u| <= 1
T, NX, NU = 20, 2, 1
AD = np.array([[1.0, 0.1], [0.0, 1.0]])
BD = np.array([[0.005], [0.1]])
N = NX * (T + 1) + NU * T


def xi(t, j):
    return NX * t + j


def ui(t):
    return NX * (T + 1) + t


def mpc_problem():
    """(A, b, P, c, n_zero, spec) of one MPC instance (dense A)."""
    rows, b = [], []

    def row(cols_vals):
        r = np.zeros(N)
        for col, v in cols_vals:
            r[col] = v
        rows.append(r)

    # dynamics: x_{t+1} - Ad x_t - Bd u_t = 0  (zero cone)
    for t in range(T):
        for j in range(NX):
            cv = [(xi(t + 1, j), 1.0)]
            cv += [(xi(t, k), -AD[j, k]) for k in range(NX)]
            cv += [(ui(t), -BD[j, 0])]
            row(cv)
            b.append(0.0)
    # initial state: x_0 = x_meas  (zero cone; b updated every MPC step)
    for j in range(NX):
        row([(xi(0, j), 1.0)])
        b.append(0.0)
    n_zero = len(rows)
    # input bounds |u_t| <= 1  (nonneg cone: 1 - u >= 0, 1 + u >= 0)
    for t in range(T):
        row([(ui(t), 1.0)])
        b.append(1.0)
        row([(ui(t), -1.0)])
        b.append(1.0)
    # objective (1/2) z'Pz: state and input tracking cost
    P = np.zeros((N, N))
    for t in range(T + 1):
        P[xi(t, 0), xi(t, 0)] = 1.0
        P[xi(t, 1), xi(t, 1)] = 0.1
    for t in range(T):
        P[ui(t), ui(t)] = 0.1
    return (np.stack(rows), np.asarray(b), P, np.zeros(N), n_zero,
            ConeSpec(z=n_zero, l=2 * T))


def main(steps: int = 10, device="cuda") -> dict:
    A, b, P, c, n_zero, spec = mpc_problem()
    w = Workspace(problem_from_numpy(A, b, c, P), spec,
                  settings=Settings(eps_abs=1e-5, eps_rel=1e-5),
                  device=device)
    x_meas = np.array([1.0, 0.0])
    sol = None
    step_times, iters = [], []
    for step in range(steps):
        b_step = b.copy()
        b_step[n_zero - NX:n_zero] = x_meas          # x_0 = measured state
        t0 = time.perf_counter()
        w.update(b=b_step)        # swaps b only: no re-equilibration, no
        #                           refactorization
        sol, info = w.solve(warm_start=sol is not None, sol=sol)
        step_times.append(time.perf_counter() - t0)
        assert "solved" in info.status, info.status
        u0 = float(sol.x[ui(0)])
        x_meas = AD @ x_meas + BD[:, 0] * u0          # plant step
        iters.append(info.iter)
        print(f"step {step}: u0={u0:+.4f}  x={x_meas.round(4)}  "
              f"iters={info.iter}  {step_times[-1] * 1e3:.0f} ms")
    print(f"\nfirst step {step_times[0]:.2f}s, steady-state median "
          f"{np.median(step_times[1:]) * 1e3:.0f} ms/step")
    return {"iters": iters, "step_s": step_times,
            "x_final": x_meas.tolist()}


if __name__ == "__main__":
    from ._cli import parse
    a = parse(__doc__, "steps", 10)
    main(a.steps, a.device)
