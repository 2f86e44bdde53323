"""Solve a problem stored in SCS's binary format.

The command-line counterpart of SCS's test/run_from_file.c (and of
`scs_tpu/run_from_file.py`):

    python -m scs_tpu_torch.run_from_file FILE [SETTING VALUE]...

Settings are overridden by SCS's names (test/run_from_file.c:9-42), e.g.

    python -m scs_tpu_torch.run_from_file prob.dat eps_abs 1e-6 verbose 1

Two more pairs: `storage sparse` keeps A (and P) as blocked-ELL operands
(never dense), and `device cpu` solves on the CPU; the default device is
the card ("cuda"), and without one the command fails.
"""

from __future__ import annotations

import dataclasses
import sys

from .api import solve
from .io import read_scs_data

_INT_SETTINGS = {"max_iters", "acceleration_lookback",
                 "acceleration_interval", "chunk_iters"}
_BOOL_SETTINGS = {"normalize", "verbose", "warm_start", "adaptive_scale",
                  "acceleration_type_1", "mixed_precision"}
_FLOAT_SETTINGS = {"scale", "rho_x", "eps_abs", "eps_rel", "eps_infeas",
                   "alpha", "time_limit_secs", "acceleration_regularization",
                   "acceleration_relaxation"}
_STR_SETTINGS = {"linsys", "write_data_filename", "log_csv_filename"}


def override_setting(stgs, name: str, value: str):
    """Parse one name/value pair (override_setting, run_from_file.c:9-42)."""
    if name in _INT_SETTINGS:
        val = int(value)
    elif name in _BOOL_SETTINGS:
        val = bool(int(value))
    elif name in _FLOAT_SETTINGS:
        val = float(value)
    elif name in _STR_SETTINGS:
        val = value
    else:
        raise SystemExit(f"unrecognized setting {name!r}")
    return dataclasses.replace(stgs, **{name: val})


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or len(argv) % 2 == 0:
        print(__doc__)
        return 1
    filename = argv[0]
    where = {"storage": "dense", "device": "cuda"}
    overrides = []
    for name, value in zip(argv[1::2], argv[2::2]):
        if name in where:
            where[name] = value
        else:
            overrides.append((name, value))
    print(f"Reading data from {filename}")
    problem, spec, cone_data, stgs = read_scs_data(
        filename, storage=where["storage"], device=where["device"])
    print("Finished reading data.")
    for name, value in overrides:
        stgs = override_setting(stgs, name, value)
    if not stgs.verbose:
        print("File data set `verbose` to 0; add `verbose 1` to override.")
    print("Solving problem.")
    sol, info = solve(problem, spec, cone_data, stgs,
                      device=where["device"])
    if not stgs.verbose:
        print(f"status:  {info.status}")
        if info.status_val > 0:
            print(f"objective = {info.pobj:.6f}")
    return 0 if info.status_val > 0 else int(abs(info.status_val))


if __name__ == "__main__":
    raise SystemExit(main())
