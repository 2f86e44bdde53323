"""Solver-wide tuning constants.

These mirror SCS's compile-time tuning parameters (include/glbopts.h:
184-257) under the same names and values as the JAX package's
`config.py`, so both packages take the same decisions at the same points.
Runtime-configurable options live in `scs_tpu_torch.types.Settings`.
"""

VERSION = "0.1.0"

# -- default runtime settings (glbopts.h:35-52) --
MAX_ITERS = 100_000
EPS_ABS = 1e-4
EPS_REL = 1e-4
EPS_INFEAS = 1e-7
ALPHA = 1.5
RHO_X = 1e-6
SCALE = 0.1
NORMALIZE = True
ADAPTIVE_SCALE = True
ACCELERATION_LOOKBACK = 10
ACCELERATION_INTERVAL = 10
TIME_LIMIT_SECS = 0.0

# -- internal algorithm constants (glbopts.h:184-257) --
# Iterations during which tau is pinned to 1 / kappa to 0 (feasibility bias).
FEASIBLE_ITERS = 1
# Minimum iterations between adaptive-scale updates.
RESCALING_MIN_ITERS = 100
# Guard for divisions by (near-)zero nonnegative quantities.
DIV_EPS_TOL = 1e-18
# Tolerance on b'y < 0 / c'x < 0 before computing certificates.
INFEAS_NEGATIVITY_TOL = 1e-9
# Convergence is checked every this many iterations.
CONVERGED_INTERVAL = 25
# Progress is printed every this many iterations (verbose mode).
PRINT_INTERVAL = 250
# Iterates are renormalized to L2 norm ITERATE_NORM * sqrt(l).
ITERATE_NORM = 1.0
# Diagonal R entry for the homogeneous tau variable.
TAU_FACTOR = 10.0
# Adaptive scale clamp range.
MAX_SCALE_VALUE = 1e6
MIN_SCALE_VALUE = 1e-6

# -- Anderson acceleration (glbopts.h:221-239) --
ACCELERATION_TYPE_1 = True
AA_REGULARIZATION = 1e-8
AA_RELAXATION = 1.0
AA_SAFEGUARD_FACTOR = 1.0
AA_MAX_WEIGHT_NORM = 1e10

# -- mixed precision (TPU-specific; no reference analog) --
# True-residual floor of the f32-fast phase; targets below it trigger the
# f64-accuracy polish phase (see api.Workspace.solve).
MIXED_FAST_FLOOR = 1e-5
# Certificate (infeasible/unbounded) threshold floor for the fast phase.
# Residuals are COMPUTED in double-single f64 accuracy even in the fast
# phase, so the certificate test can gate much tighter than the iterate's
# achievable residual floor. A loose cert floor (the 1e-5 fast floor)
# fired spuriously on ~solved lanes — eps_infeas floored up 100x from the
# default 1e-7 — freezing them mid-convergence and finishing their solve
# in the expensive polish phase (measured: most of a warm batched
# re-solve's wall). Truly infeasible lanes drive the ds-f64 certificate
# residual below 1e-6 in the fast phase without difficulty.
MIXED_CERT_FLOOR = 1e-6

# -- conjugate gradient (indirect linear solver; glbopts.h:246-257) --
CG_BEST_TOL = 1e-12
CG_TOL_FACTOR = 0.2
CG_RATE = 1.5

# -- equilibration (linsys/scs_matrix.c:14-16) --
NUM_RUIZ_PASSES = 25
NUM_L2_PASSES = 1
MIN_NORMALIZATION_FACTOR = 1e-4
MAX_NORMALIZATION_FACTOR = 1e4

# -- cone projection internals (src/cones.c:49-54) --
BOX_CONE_MAX_ITERS = 25
POW_CONE_TOL = 1e-9
POW_CONE_MAX_ITERS = 20
MAX_BOX_VAL = 1e15
EXP_CONE_INFINITY = 1e15

# -- exit flags (include/scs.h:33-42) --
INFEASIBLE_INACCURATE = -7
UNBOUNDED_INACCURATE = -6
SIGINT = -5
FAILED = -4
INDETERMINATE = -3
INFEASIBLE = -2
UNBOUNDED = -1
UNFINISHED = 0
SOLVED = 1
SOLVED_INACCURATE = 2

STATUS_STRINGS = {
    INFEASIBLE_INACCURATE: "infeasible (inaccurate)",
    UNBOUNDED_INACCURATE: "unbounded (inaccurate)",
    SIGINT: "interrupted",
    FAILED: "failure",
    INDETERMINATE: "indeterminate",
    INFEASIBLE: "infeasible",
    UNBOUNDED: "unbounded",
    UNFINISHED: "unfinished",
    SOLVED: "solved",
    SOLVED_INACCURATE: "solved (inaccurate)",
}
