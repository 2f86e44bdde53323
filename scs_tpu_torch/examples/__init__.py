"""The JAX package's examples (`examples/*.py`) on the port, each a module
with a `main(...)` that takes its size and `device` (the card unless
"cpu" is passed) and returns its numbers:

    python -m scs_tpu_torch.examples.learned_risk_budget [--device cpu]
    python -m scs_tpu_torch.examples.mpc_warm_start
    python -m scs_tpu_torch.examples.mpc_warm_batch [B]
    python -m scs_tpu_torch.examples.portfolio_batch [B]
    python -m scs_tpu_torch.examples.robust_pca
"""
