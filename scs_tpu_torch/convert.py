"""Conversion of the JAX package's objects into this package's.

The JAX package's problems, specs, settings and warm starts are handed over
as numpy arrays and plain dicts (`np.asarray(...)`,
`dataclasses.asdict(...)`), so this module needs neither JAX nor the JAX
package. Tensors are made on the CPU; a workspace moves them to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import ConeSpec, Problem, Settings, Solution

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def _tensor(a, dtype=torch.float64):
    return None if a is None else torch.tensor(np.asarray(a), dtype=dtype)


def problem_from_numpy(A, b, c, P=None, dtype=torch.float64) -> Problem:
    return Problem(A=_tensor(A, dtype), b=_tensor(b, dtype),
                   c=_tensor(c, dtype), P=_tensor(P, dtype))


def spec_from_dict(d: dict) -> ConeSpec:
    """ConeSpec from `dataclasses.asdict` of the JAX package's ConeSpec;
    list-valued fields become tuples, so the spec stays hashable."""
    kw = {k: tuple(v) if isinstance(v, (list, tuple)) else v
          for k, v in d.items()}
    return ConeSpec(**kw)


def settings_from_dict(d: dict) -> Settings:
    """Settings from `dataclasses.asdict` of the JAX package's Settings;
    `dtype` (a numpy or JAX scalar type) maps to the torch dtype."""
    names = {f.name for f in dataclasses.fields(Settings)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown settings: {sorted(unknown)}")
    kw = dict(d)
    if "dtype" in kw:
        kw["dtype"] = _DTYPES[np.dtype(kw["dtype"]).name]
    return Settings(**kw)


def solution_from_numpy(x, y, s) -> Solution:
    """A warm start from the JAX package's solution vectors."""
    return Solution(x=_tensor(x), y=_tensor(y), s=_tensor(s))


def batch_from_numpy(A, b, c, P=None, bu=None, bl=None,
                     dtype=torch.float64):
    """The JAX package's stacked batch arrays (A (B, m, n), b (B, m),
    c (B, n), P (B, n, n) or None, bu/bl (B, k) or None) as this
    package's tensors, in the order of a batched solve's arguments:
    (A, P, b, c, bu, bl); absent bounds become (B, 0)."""
    A, b, c, P = (_tensor(a, dtype) for a in (A, b, c, P))
    B = A.shape[0]
    bu = torch.zeros(B, 0, dtype=dtype) if bu is None else _tensor(bu, dtype)
    bl = torch.zeros(B, 0, dtype=dtype) if bl is None else _tensor(bl, dtype)
    return A, P, b, c, bu, bl


def solve_result_to_numpy(res) -> dict:
    """A batched SolveResult as a dict of numpy arrays, field by field."""
    return {f.name: getattr(res, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(res)}
