"""The examples of `scs_tpu_torch.examples` (the JAX package's
examples/*.py on the port) run on the CPU at small counts, each with its
own asserts: learned_risk_budget's descent through `make_diff_solver`
reaches loss < 1e-2 of the initial loss in 10 projected-gradient steps
(200 in the example); the MPC loop's warm re-solves solve; the batched
MPC (B = 16) and the portfolio batch (B = 8) solve every lane; robust
PCA recovers L + S = M."""

import numpy as np
import torch

# xdist workers share the cores: one torch thread each, not one per core
torch.set_num_threads(1)

from scs_tpu_torch.examples import (learned_risk_budget, mpc_warm_batch,
                                    mpc_warm_start, portfolio_batch,
                                    robust_pca)


def test_learned_risk_budget():
    out = learned_risk_budget.main(steps=10, device="cpu")
    assert out["l1"] < 1e-2 * out["l0"]
    # the two binding budgets are recovered; the slack one keeps its guess
    np.testing.assert_allclose(np.asarray(out["budgets"])[[0, 2]],
                               [0.27, 0.28], atol=2e-3)


def test_mpc_warm_start():
    out = mpc_warm_start.main(steps=4, device="cpu")
    assert len(out["iters"]) == 4
    # the warm re-solves take no more iterations than the cold first one
    assert max(out["iters"][1:]) <= out["iters"][0]


def test_mpc_warm_batch():
    out = mpc_warm_batch.main(B=16, steps=2, device="cpu")
    # every lane solved cold and at each warm step (the example's asserts)
    assert len(out["warm_iters_mean"]) == 2 and out["cold_iters_mean"] > 0


def test_portfolio_batch():
    out = portfolio_batch.main(B=8, device="cpu")
    assert out["solved"] == 8


def test_robust_pca():
    out = robust_pca.main(device="cpu")
    assert out["resid"] < 1e-3 and out["rank"] >= 2
