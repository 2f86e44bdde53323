"""Gradient descent THROUGH a conic solve (convex optimization layer).

The diffcp workflow, on the port's `make_diff_solver` (the JAX package's
examples/learned_risk_budget.py step for step): a portfolio QP is the
forward pass, and `loss.backward()` differentiates a loss on its
SOLUTION with respect to the problem data. An "expert" allocation was
produced under unknown sector budgets; projected gradient descent on
|| x*(budgets) - x_expert ||^2 recovers them (inverse optimization).

Run:  python -m scs_tpu_torch.examples.learned_risk_budget [STEPS]
      [--device cpu]
"""

import time

import numpy as np
import torch

from ..diff import make_diff_solver
from ..types import ConeSpec, Settings


def main(steps: int = 200, device="cuda") -> dict:
    rng = np.random.RandomState(0)
    n = 8                      # assets
    k = 3                      # sector budget constraints

    # min (1/2) x'Px + c'x  s.t.  sum x = 1, x >= 0, S x <= budgets
    spec = ConeSpec(z=1, l=n + k)
    S = rng.rand(k, n) * 0.5
    A = np.vstack([np.ones((1, n)), -np.eye(n), S])
    F = rng.randn(n, n)
    P = F @ F.T / n + np.eye(n)          # risk model
    c = -rng.rand(n) * 0.3               # expected returns

    solve = make_diff_solver(spec, Settings(eps_abs=1e-10, eps_rel=1e-10),
                             has_P=True, device=device)
    dev = solve.core.dev
    A_t, P_t, c_t = (torch.as_tensor(a, device=dev) for a in (A, P, c))
    head = torch.cat([torch.ones(1, dtype=torch.float64, device=dev),
                      torch.zeros(n, dtype=torch.float64, device=dev)])

    def portfolio(budgets):
        x, _, _ = solve(A_t, torch.cat([head, budgets]), c_t, P_t)
        return x

    # the "expert" allocation: produced under hidden budgets (all binding)
    budgets_true = torch.tensor([0.27, 0.30, 0.28], dtype=torch.float64,
                                device=dev)
    with torch.no_grad():
        x_expert = portfolio(budgets_true)

    def loss(budgets):
        return torch.sum((portfolio(budgets) - x_expert) ** 2)

    budgets = torch.full((k,), 0.33, dtype=torch.float64, device=dev)
    with torch.no_grad():
        l0 = float(loss(budgets))
    print(f"initial loss {l0:.6f}  (budgets {budgets.tolist()})")
    t0 = time.perf_counter()
    for _ in range(steps):
        # projected gradient step; the floor keeps the QP feasible
        bgt = budgets.clone().requires_grad_()
        loss(bgt).backward()
        budgets = torch.clamp(budgets - 0.02 * bgt.grad, 0.255, 1.0)
    seconds = time.perf_counter() - t0
    with torch.no_grad():
        l1 = float(loss(budgets))
    print(f"after {steps} projected-gradient steps: loss {l1:.2e}"
          f"  budgets {np.round(budgets.cpu().numpy(), 4)}"
          f"  (true {budgets_true.tolist()}), {seconds:.1f} s")
    # budgets whose constraint stays slack along the path carry zero
    # gradient (the solution map is locally constant in them) and keep
    # the guess: the correct subgradient behavior, as in diffcp
    assert l1 < 1e-2 * l0, "descent through the solver should recover budgets"
    print("ok: loss.backward() flowed through the conic solve")
    return {"l0": l0, "l1": l1, "budgets": budgets.tolist(),
            "seconds": seconds}


if __name__ == "__main__":
    from ._cli import parse
    a = parse(__doc__, "steps", 200)
    main(a.steps, a.device)
