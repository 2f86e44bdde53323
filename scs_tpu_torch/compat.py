"""The scs-python interface, on this package.

Counterpart of `scs_tpu/compat.py`: scs-python (the Python binding of
SCS, include/scs.h:271-338) is how most SCS users call the solver,

    from scs_tpu_torch import compat as scs
    solver = scs.SCS(data, cone, eps_abs=1e-5)        # on the card
    sol = solver.solve()                               # {'x','y','s','info'}
    solver.update(b=new_b)
    sol = solver.solve(warm_start=True, x=sol['x'], y=sol['y'], s=sol['s'])

``data`` holds 'A' (scipy.sparse, any format, or dense), 'b', 'c' and an
optional 'P' (upper-triangular or full symmetric); ``cone`` takes SCS's
keys (include/scs.h:121-172): 'z' (legacy alias 'f'), 'l', 'bu'/'bl',
'q', 's', 'cs', 'ep', 'ed', 'p', and the spectral cones' 'd', 'nuc_m',
'nuc_n', 'ell1', 'sl_n', 'sl_k'. Unknown cone keys and settings raise.

Beside SCS's settings and the JAX package's extras, two keywords choose
where and how the problem is held:
  * ``device``: "cuda" (the default) or "cpu", passed to the Workspace;
    without a card "cuda" raises, as every entry point of this package.
  * ``gpu``: scs-python's flag that selects its GPU build. Here the solve
    runs on the card already, so ``gpu=True`` asks for what the default
    device gives, and raises with device="cpu"; ``gpu=False`` (scs-python's
    default value) changes nothing.
  * ``storage``: "dense" (default) or "sparse" (A and P as blocked-ELL
    operands, `ops.sparse`).
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

import numpy as np
import torch

from . import config
from .api import Workspace
from .ops.sparse import sparse_from_scipy
from .types import ConeData, ConeSpec, Problem, Settings, Solution

__version__ = config.VERSION

# exit-flag constants (scs-python module attributes / include/scs.h:33-42)
INFEASIBLE_INACCURATE = config.INFEASIBLE_INACCURATE
UNBOUNDED_INACCURATE = config.UNBOUNDED_INACCURATE
SIGINT = config.SIGINT
FAILED = config.FAILED
INDETERMINATE = config.INDETERMINATE
INFEASIBLE = config.INFEASIBLE
UNBOUNDED = config.UNBOUNDED
UNFINISHED = config.UNFINISHED
SOLVED = config.SOLVED
SOLVED_INACCURATE = config.SOLVED_INACCURATE


def _to_dense(M) -> np.ndarray:
    if hasattr(M, "todense"):  # scipy sparse
        return np.asarray(M.todense(), dtype=np.float64)
    return np.asarray(M, dtype=np.float64)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _parse_data(data: dict, storage: str = "dense") -> Problem:
    """A Problem on the CPU from scs-python's data dict (the Workspace
    moves it to its device)."""
    if "A" not in data or "b" not in data or "c" not in data:
        raise ValueError("data must contain 'A', 'b' and 'c'")
    b, c = _t(data["b"]), _t(data["c"])
    if storage == "sparse":
        import scipy.sparse as sp
        A_in = data["A"]
        A_sp = A_in if sp.issparse(A_in) else sp.csc_matrix(
            np.asarray(A_in, dtype=np.float64))
        P = None
        if data.get("P") is not None:
            P_in = data["P"]
            P_sp = (P_in if sp.issparse(P_in) else sp.csc_matrix(
                np.asarray(P_in, dtype=np.float64))).tocsr()
            # scs-python passes the upper triangle; a full P is taken too
            if (sp.tril(P_sp, k=-1).count_nonzero() == 0
                    and sp.triu(P_sp, k=1).count_nonzero() > 0):
                P_sp = P_sp + P_sp.T - sp.diags(P_sp.diagonal())
            P = sparse_from_scipy(P_sp.tocsc())
        return Problem(A=sparse_from_scipy(A_sp), b=b, c=c, P=P)
    if storage != "dense":
        raise ValueError(f"unknown storage {storage!r}; "
                         "expected 'dense' or 'sparse'")
    P = None
    if data.get("P") is not None:
        Pd = _to_dense(data["P"])
        upper = np.triu(Pd)
        if np.allclose(Pd, Pd.T):
            P = Pd  # a full symmetric P is accepted too
        elif np.allclose(Pd, upper):
            P = upper + upper.T - np.diag(np.diag(upper))
        else:
            raise ValueError(
                "P must be symmetric or upper-triangular (scs.h:111-114)")
        P = _t(P)
    return Problem(A=_t(_to_dense(data["A"])), b=b, c=c, P=P)


def _parse_cone(cone: dict) -> tuple[ConeSpec, Optional[ConeData]]:
    cone = dict(cone)
    if "f" in cone:  # legacy name of the zero cone (scs-python)
        warnings.warn("cone key 'f' is deprecated; use 'z'", DeprecationWarning)
        cone["z"] = cone.get("z", 0) + cone.pop("f")
    bu = np.atleast_1d(np.asarray(cone.get("bu", []), dtype=np.float64))
    bl = np.atleast_1d(np.asarray(cone.get("bl", []), dtype=np.float64))
    if bu.size != bl.size:
        raise ValueError("'bu' and 'bl' must have equal length")
    bsize = bu.size + 1 if bu.size else 0

    def ituple(key):
        v = cone.get(key, ())
        if np.isscalar(v):
            v = (v,)
        return tuple(int(x) for x in v)

    p = cone.get("p", ())
    if np.isscalar(p):
        p = (p,)
    spec = ConeSpec(
        z=int(cone.get("z", 0)), l=int(cone.get("l", 0)), bsize=bsize,
        q=ituple("q"), s=ituple("s"), cs=ituple("cs"),
        ep=int(cone.get("ep", 0)), ed=int(cone.get("ed", 0)),
        p=tuple(float(x) for x in p),
        d=ituple("d"), nuc_m=ituple("nuc_m"), nuc_n=ituple("nuc_n"),
        ell1=ituple("ell1"), sl_n=ituple("sl_n"), sl_k=ituple("sl_k"))
    known = {"z", "l", "bu", "bl", "q", "s", "cs", "ep", "ed", "p",
             "d", "nuc_m", "nuc_n", "ell1", "sl_n", "sl_k"}
    unknown = set(cone) - known
    if unknown:
        raise ValueError(f"unrecognized cone keys: {sorted(unknown)}")
    cone_data = ConeData.make(spec, bu=bu, bl=bl) if bsize else None
    return spec, cone_data


_SETTING_NAMES = {
    "normalize", "scale", "adaptive_scale", "rho_x", "max_iters",
    "eps_abs", "eps_rel", "eps_infeas", "alpha", "time_limit_secs",
    "verbose", "warm_start", "acceleration_lookback",
    "acceleration_interval", "write_data_filename", "log_csv_filename",
    # extras of the JAX package (no scs-python analog)
    "linsys", "dtype", "chunk_iters", "acceleration_type_1",
    "acceleration_regularization", "acceleration_relaxation",
    "mixed_precision", "profile_phases", "psd_rank", "macro_schedule",
    "cone_f32", "exp_f32", "fast_f32",
}


def _parse_settings(kwargs: dict) -> tuple[Settings, str]:
    """(Settings, device) from scs-python's keyword settings; `gpu`,
    `use_indirect` and `device` as the module docstring says."""
    kw = dict(kwargs)
    use_indirect = kw.pop("use_indirect", None)
    device = kw.pop("device", "cuda")
    if kw.pop("gpu", False) and torch.device(device).type != "cuda":
        raise ValueError(f"gpu=True asks for the card, but device="
                         f"{device!r}")
    unknown = set(kw) - _SETTING_NAMES
    if unknown:
        raise ValueError(f"unrecognized settings: {sorted(unknown)}")
    if use_indirect is not None and "linsys" not in kw:
        kw["linsys"] = "indirect" if use_indirect else "direct"
    # scs-python defaults verbose=True; Settings defaults False: take theirs
    kw.setdefault("verbose", True)
    return Settings(**kw), device


def _info_dict(info) -> dict:
    return {
        "status": info.status,
        "status_val": info.status_val,
        "iter": info.iter,
        "pobj": info.pobj,
        "dobj": info.dobj,
        "res_pri": info.res_pri,
        "res_dual": info.res_dual,
        "gap": info.gap,
        "res_infeas": info.res_infeas,
        "res_unbdd_a": info.res_unbdd_a,
        "res_unbdd_p": info.res_unbdd_p,
        "comp_slack": info.comp_slack,
        "setup_time": info.setup_time,
        "solve_time": info.solve_time,
        # per-phase ms (scs.h:230-236; NaN unless profile_phases=True)
        "lin_sys_time": info.lin_sys_time,
        "cone_time": info.cone_time,
        "accel_time": info.accel_time,
        "scale": info.scale,
        "scale_updates": info.scale_updates,
        "rejected_accel_steps": info.rejected_accel_steps,
        "accepted_accel_steps": info.accepted_accel_steps,
        "lin_sys_solver": info.lin_sys_solver,
    }


class SCS:
    """scs-python's solver object (scs.SCS)."""

    def __init__(self, data: dict, cone: dict, **settings: Any):
        storage = settings.pop("storage", "dense")
        self._problem = _parse_data(data, storage=storage)
        self._spec, self._cone_data = _parse_cone(cone)
        self._stg, device = _parse_settings(settings)
        self._work = Workspace(self._problem, self._spec, self._cone_data,
                               self._stg, device=device)
        self._last_sol: Optional[Solution] = None

    def solve(self, warm_start: bool = True, x=None, y=None, s=None) -> dict:
        """Solve, warm-started from (x, y, s) where given.

        As scs-python's SCS.solve: with warm_start=True (the default) and
        no guess, the solve starts from the previous solve's iterate, so
        update() then solve() keeps its warm start; NaN entries of that
        iterate (a certificate's) are scrubbed to 0 by the workspace."""
        sol = None
        if warm_start:
            if x is not None and y is not None and s is not None:
                sol = Solution(x=np.asarray(x), y=np.asarray(y),
                               s=np.asarray(s))
            else:
                sol = self._last_sol
        solution, info = self._work.solve(warm_start=sol is not None, sol=sol)
        self._last_sol = solution
        return {"x": solution.x, "y": solution.y, "s": solution.s,
                "info": _info_dict(info)}

    def update(self, b=None, c=None) -> None:
        """Swap b and/or c without re-equilibrating (scs_update)."""
        self._work.update(b=b, c=c)


def solve(data: dict, cone: dict, **settings: Any) -> dict:
    """One-shot solve (scs.solve)."""
    return SCS(data, cone, **settings).solve(warm_start=False)


def version() -> str:
    """scs.version() (src/scs_version.c)."""
    return __version__
