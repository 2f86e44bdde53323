"""Problem files and solver checkpoints.

Counterpart of `scs_tpu/io.py`:
  * SCS's binary problem format (read and write; SCS src/rw.c:574-684:
    header, cone, data, settings and the "SCSE" extension block with the
    complex-PSD and spectral cones), so that files written by SCS
    (`write_data_filename`), by the JAX package and by this package are
    read the same by each of them: the writer's bytes equal the JAX
    package's;
  * `.npz` problems (`save_npz`, `load_npz`), in the JAX package's keys;
  * `save_state` / `load_state`, the checkpoint of a solve in progress
    (`Workspace.solve(checkpoint_file=..., resume_from=...)`).

The readers return this package's types with tensors on `device` (default
"cuda"; without a card that raises, as every entry point does). They use
the native codec (`utils/native.py`) where it builds, else the Python
reader, which is also the native codec's reference. Storage "sparse" keeps
A and P as blocked-ELL `ops.sparse.SparseA` operands built from the file's
CSC arrays, never as dense matrices.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import tempfile
from typing import Optional

import numpy as np
import torch

from . import config
from .ops.sparse import is_sparse, sparse_from_scipy, sparse_to_csc
from .types import ConeData, ConeSpec, Problem, Settings

_SCS_VERSION = "3.2.11"  # the file version read and written natively
_EXT_MAGIC = 0x53435345  # "SCSE"
_EXT_VERSION = 1
_STATE_VERSION = 1


def _device(device) -> torch.device:
    from .api import _resolve_device
    return _resolve_device(device)


class _Cursor:
    def __init__(self, buf: bytes, int_sz: int):
        self.buf = buf
        self.off = 0
        self.int_dtype = np.int32 if int_sz == 4 else np.int64

    def raw(self, nbytes: int) -> bytes:
        out = self.buf[self.off:self.off + nbytes]
        if nbytes < 0 or len(out) != nbytes:
            raise ValueError("unexpected end of SCS data file")
        self.off += nbytes
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.raw(4))[0]

    def ints(self, n: int) -> np.ndarray:
        a = np.frombuffer(self.raw(n * self.int_dtype().nbytes),
                          dtype=self.int_dtype)
        return a.astype(np.int64)

    def int1(self) -> int:
        return int(self.ints(1)[0])

    def floats(self, n: int) -> np.ndarray:
        return np.frombuffer(self.raw(n * 8), dtype=np.float64).copy()

    def float1(self) -> float:
        return float(self.floats(1)[0])

    def eof(self) -> bool:
        return self.off >= len(self.buf)


def _csc_to_dense(m, n, colptr, rowidx, vals) -> np.ndarray:
    A = np.zeros((m, n))
    for j in range(n):
        lo, hi = colptr[j], colptr[j + 1]
        A[rowidx[lo:hi], j] = vals[lo:hi]
    return A


def _read_amatrix_csc(c: _Cursor):
    m = c.int1()
    n = c.int1()
    colptr = c.ints(n + 1)
    nnz = int(colptr[-1])
    vals = c.floats(nnz)
    rowidx = c.ints(nnz)
    return m, n, colptr, rowidx, vals


def _check_csc(name: str, m: int, n: int, colptr, rowidx, vals) -> None:
    """The file's CSC structure is untrusted: reject what would index out
    of range (the native codec's valid_csc) or is not finite."""
    if (m <= 0 or n <= 0 or colptr.shape != (n + 1,) or colptr[0] != 0
            or np.any(np.diff(colptr) < 0) or colptr[-1] != len(vals)
            or len(rowidx) != len(vals)
            or (len(rowidx) and (rowidx.min() < 0 or rowidx.max() >= m))
            or not np.all(np.isfinite(vals))):
        raise ValueError(f"corrupt CSC structure for {name} in SCS data "
                         f"file")


def _sparse_pair(m: int, n: int, A_csc, P_csc, dtype, dev):
    """(A, P) as SparseA operands on `dev` from CSC triplets (colptr,
    rowidx, vals); P's stored upper triangle is symmetrized. Never
    densified."""
    import scipy.sparse as sp

    _check_csc("A", m, n, *A_csc)
    colptr, rowidx, vals = A_csc
    A = sparse_from_scipy(sp.csc_matrix((vals, rowidx, colptr), shape=(m, n)),
                          dtype=dtype, device=dev)
    P = None
    if P_csc is not None:
        _check_csc("P", n, n, *P_csc)
        colptr, rowidx, vals = P_csc
        Pu = sp.csc_matrix((vals, rowidx, colptr), shape=(n, n))
        P = sparse_from_scipy((Pu + Pu.T - sp.diags(Pu.diagonal())).tocsc(),
                              dtype=dtype, device=dev)
    return A, P


def read_scs_data(filename: str, dtype=torch.float64, storage: str = "dense",
                  device="cuda"):
    """Read an SCS binary problem file: (Problem, ConeSpec, ConeData,
    Settings), the tensors on `device`; the Settings carry the file's
    values (tolerances, scale, Anderson parameters, ...) and `dtype`.

    storage "dense" (A and P dense tensors) or "sparse" (blocked-ELL
    SparseA operands from the file's CSC arrays, without densifying). The
    native codec parses where it builds; otherwise the Python reader."""
    if storage not in ("dense", "sparse"):
        raise ValueError(f"unknown storage {storage!r}; expected 'dense' or "
                         f"'sparse'")
    dev = _device(device)
    from .utils import native
    parsed = native.read_file(os.fspath(filename), storage)
    if parsed is None:
        parsed = _read_scs_data_py(filename, storage)
    return _assemble(parsed, dtype, storage, dev)


def _assemble(v: dict, dtype, storage: str, dev: torch.device):
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    spec = ConeSpec(
        z=int(v["z"]), l=int(v["l"]), bsize=int(v["bsize"]),
        q=tuple(int(x) for x in v["q"]), s=tuple(int(x) for x in v["s"]),
        cs=tuple(int(x) for x in v["cs"]), ep=int(v["ep"]), ed=int(v["ed"]),
        p=tuple(float(x) for x in v["p"]),
        d=tuple(int(x) for x in v["d"]),
        nuc_m=tuple(int(x) for x in v["nuc_m"]),
        nuc_n=tuple(int(x) for x in v["nuc_n"]),
        ell1=tuple(int(x) for x in v["ell1"]),
        sl_n=tuple(int(x) for x in v["sl_n"]),
        sl_k=tuple(int(x) for x in v["sl_k"]))
    m, n = int(v["m"]), int(v["n"])
    if storage == "sparse":
        A, P = _sparse_pair(m, n, v["A"], v["P"], dtype, dev)
    else:
        A, P = t(v["A"]), None if v["P"] is None else t(v["P"])
    problem = Problem(A=A, b=t(v["b"]), c=t(v["c"]), P=P)
    cone_data = ConeData(bu=t(v["bu"]), bl=t(v["bl"]))
    if v["legacy"]:
        accel_type_1 = config.ACCELERATION_TYPE_1
        accel_reg = config.AA_REGULARIZATION
        accel_relax = config.AA_RELAXATION
    else:
        accel_type_1 = bool(v["accel_type1"])
        accel_reg = float(v["accel_reg"])
        accel_relax = float(v["accel_relax"])
    stgs = Settings(
        normalize=bool(v["normalize"]), scale=float(v["scale"]),
        rho_x=float(v["rho_x"]), max_iters=int(v["max_iters"]),
        eps_abs=float(v["eps_abs"]), eps_rel=float(v["eps_rel"]),
        eps_infeas=float(v["eps_infeas"]), alpha=float(v["alpha"]),
        verbose=bool(v["verbose"]), warm_start=bool(v["warm_start"]),
        acceleration_lookback=int(v["accel_lookback"]),
        acceleration_interval=int(v["accel_interval"]),
        acceleration_type_1=accel_type_1,
        acceleration_regularization=accel_reg,
        acceleration_relaxation=accel_relax,
        adaptive_scale=bool(v["adaptive_scale"]),
        time_limit_secs=float(v["time_limit"]), dtype=dtype)
    return problem, spec, cone_data, stgs


def _read_scs_data_py(filename: str, storage: str = "dense") -> dict:
    """The Python reader (where the native codec is absent, and its
    reference): the native reader's dict, A and P dense or, with storage
    "sparse", as CSC triplets."""
    with open(filename, "rb") as f:
        buf = f.read()
    if len(buf) < 12:
        raise ValueError("file too small for SCS header")
    int_sz, float_sz, version_sz = struct.unpack("<III", buf[:12])
    if int_sz not in (4, 8):
        raise ValueError(f"unsupported file integer size {int_sz}")
    if float_sz != 8:
        raise ValueError(f"unsupported file float size {float_sz} (need f64)")
    if 12 + version_sz > len(buf):
        raise ValueError("corrupt version field")
    version = buf[12:12 + version_sz].decode(errors="replace")
    v = {"legacy": int(version != _SCS_VERSION), "warm_start": 0}

    c = _Cursor(buf, int_sz)
    c.off = 12 + version_sz

    # ---- cone (rw.c:261-289) ----
    v["z"], v["l"], v["bsize"] = c.int1(), c.int1(), c.int1()
    box_len = max(v["bsize"] - 1, 0)
    v["bl"] = c.floats(box_len)
    v["bu"] = c.floats(box_len)
    v["q"] = c.ints(c.int1())
    v["s"] = c.ints(c.int1())
    v["ep"], v["ed"] = c.int1(), c.int1()
    v["p"] = c.floats(c.int1())

    # ---- data (rw.c:424-457) ----
    m, n = c.int1(), c.int1()
    v["m"], v["n"] = m, n
    v["b"] = c.floats(m)
    v["c"] = c.floats(n)
    am, an, colptr, rowidx, vals = _read_amatrix_csc(c)
    if (am, an) != (m, n):
        raise ValueError("corrupt CSC structure for A in SCS data file")
    if storage != "sparse":         # sparse: checked where it is built
        _check_csc("A", m, n, colptr, rowidx, vals)
    v["A"] = ((colptr, rowidx, vals) if storage == "sparse"
              else _csc_to_dense(m, n, colptr, rowidx, vals))
    v["P"] = None
    if c.int1():
        pm, pn, colptr, rowidx, vals = _read_amatrix_csc(c)
        if (pm, pn) != (n, n):
            raise ValueError("corrupt CSC structure for P in SCS data file")
        if storage == "sparse":
            v["P"] = (colptr, rowidx, vals)
        else:
            _check_csc("P", n, n, colptr, rowidx, vals)
            Pu = _csc_to_dense(n, n, colptr, rowidx, vals)
            v["P"] = Pu + Pu.T - np.diag(np.diag(Pu))

    # ---- settings (rw.c:322-355) ----
    v["normalize"] = c.int1()
    v["scale"], v["rho_x"] = c.float1(), c.float1()
    v["max_iters"] = c.int1()
    for k in ("eps_abs", "eps_rel", "eps_infeas", "alpha"):
        v[k] = c.float1()
    v["verbose"], v["warm_start"] = c.int1(), c.int1()
    v["accel_lookback"], v["accel_interval"] = c.int1(), c.int1()
    v["accel_type1"], v["accel_reg"], v["accel_relax"] = 1, 0.0, 0.0
    if not v["legacy"]:
        v["accel_type1"] = c.int1()
        v["accel_reg"], v["accel_relax"] = c.float1(), c.float1()
    v["adaptive_scale"] = c.int1()

    # ---- extensions (rw.c:510-572) ----
    for k in ("cs", "d", "nuc_m", "nuc_n", "ell1", "sl_n", "sl_k"):
        v[k] = np.zeros(0, np.int64)
    v["time_limit"] = 0.0
    if not c.eof() and c.u32() == _EXT_MAGIC:
        ext_version = c.u32()
        if ext_version != _EXT_VERSION:
            raise ValueError(f"unsupported extension version {ext_version}")
        v["cs"] = c.ints(c.int1())
        v["d"] = c.ints(c.int1())
        k = c.int1()
        v["nuc_m"], v["nuc_n"] = c.ints(k), c.ints(k)
        v["ell1"] = c.ints(c.int1())
        k = c.int1()
        v["sl_n"], v["sl_k"] = c.ints(k), c.ints(k)
        v["time_limit"] = c.float1()
    return v


def _host(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _dense_to_csc(M: np.ndarray, upper_only: bool = False):
    """CSC triplets of M's nonzeros, column by column, rows ascending
    (the native codec's w_amatrix)."""
    if upper_only:
        M = np.triu(M)
    rows, cols = np.nonzero(M.T)[::-1]
    vals = M[rows, cols]
    colptr = np.zeros(M.shape[1] + 1, np.int64)
    colptr[1:] = np.cumsum(np.bincount(cols, minlength=M.shape[1]))
    return colptr, rows.astype(np.int64), np.asarray(vals, np.float64)


def write_scs_data(filename: str, problem: Problem, spec: ConeSpec,
                   cone_data: Optional[ConeData] = None,
                   stgs: Settings = Settings()) -> None:
    """Write SCS's binary format (readable by SCS and the JAX package;
    its bytes equal the JAX package's writer's). Dense operands go through
    the native codec where it builds; sparse (SparseA) A or P are written
    from their CSC triplets (`ops.sparse.sparse_to_csc`) at O(nnz), never
    densified. Tensors may lie on any device."""
    if not (is_sparse(problem.A) or is_sparse(problem.P)):
        from .utils import native
        if native.load() is not None:
            box_len = max(spec.bsize - 1, 0)
            bl = (np.zeros(box_len) if cone_data is None
                  else _host(cone_data.bl))
            bu = (np.zeros(box_len) if cone_data is None
                  else _host(cone_data.bu))
            native.write_file(
                os.fspath(filename), z=spec.z, l=spec.l, bsize=spec.bsize,
                bl=bl, bu=bu, q=spec.q, s=spec.s, ep=spec.ep, ed=spec.ed,
                p=spec.p, cs=spec.cs, d=spec.d, nuc_m=spec.nuc_m,
                nuc_n=spec.nuc_n, ell1=spec.ell1, sl_n=spec.sl_n,
                sl_k=spec.sl_k, b=_host(problem.b), c=_host(problem.c),
                A=_host(problem.A),
                P=None if problem.P is None else _host(problem.P),
                normalize=stgs.normalize, scale=stgs.scale,
                rho_x=stgs.rho_x, max_iters=stgs.max_iters,
                eps_abs=stgs.eps_abs, eps_rel=stgs.eps_rel,
                eps_infeas=stgs.eps_infeas, alpha=stgs.alpha,
                verbose=stgs.verbose,
                accel_lookback=stgs.acceleration_lookback,
                accel_interval=stgs.acceleration_interval,
                accel_type1=stgs.acceleration_type_1,
                accel_reg=stgs.acceleration_regularization,
                accel_relax=stgs.acceleration_relaxation,
                adaptive_scale=stgs.adaptive_scale,
                time_limit=stgs.time_limit_secs)
            return
    _write_scs_data_py(filename, problem, spec, cone_data, stgs)


def _write_scs_data_py(filename: str, problem: Problem, spec: ConeSpec,
                       cone_data: Optional[ConeData] = None,
                       stgs: Settings = Settings()) -> None:
    """The Python writer (sparse operands, no native codec, and the
    native writer's reference)."""
    out = bytearray()

    def w_u32(v):
        out.extend(struct.pack("<I", v))

    def w_ints(a):
        out.extend(np.asarray(a, np.int64).tobytes())

    def w_int(*vs):
        w_ints(vs)

    def w_floats(a):
        out.extend(np.asarray(a, np.float64).tobytes())

    def w_amatrix(M, upper_only=False):
        if is_sparse(M):
            colptr, rowidx, vals = sparse_to_csc(M, upper_only)
        else:
            colptr, rowidx, vals = _dense_to_csc(_host(M), upper_only)
        w_int(M.shape[0], M.shape[1])
        w_ints(colptr)
        w_floats(vals)
        w_ints(rowidx)

    w_u32(8)  # int size (DLONG layout)
    w_u32(8)  # float size
    version = _SCS_VERSION.encode()
    w_u32(len(version))
    out.extend(version)

    box_len = max(spec.bsize - 1, 0)
    bl = np.zeros(box_len) if cone_data is None else _host(cone_data.bl)
    bu = np.zeros(box_len) if cone_data is None else _host(cone_data.bu)
    w_int(spec.z, spec.l, spec.bsize)
    w_floats(bl)
    w_floats(bu)
    w_int(len(spec.q))
    w_ints(spec.q)
    w_int(len(spec.s))
    w_ints(spec.s)
    w_int(spec.ep, spec.ed, len(spec.p))
    w_floats(spec.p)

    m, n = problem.A.shape
    w_int(m, n)
    w_floats(_host(problem.b))
    w_floats(_host(problem.c))
    w_amatrix(problem.A)
    w_int(1 if problem.P is not None else 0)
    if problem.P is not None:
        w_amatrix(problem.P, upper_only=True)

    w_int(int(stgs.normalize))
    w_floats([stgs.scale, stgs.rho_x])
    w_int(stgs.max_iters)
    w_floats([stgs.eps_abs, stgs.eps_rel, stgs.eps_infeas, stgs.alpha])
    w_int(int(stgs.verbose), 0,  # warm_start written as 0 (rw.c:293)
          stgs.acceleration_lookback, stgs.acceleration_interval,
          int(stgs.acceleration_type_1))
    w_floats([stgs.acceleration_regularization, stgs.acceleration_relaxation])
    w_int(int(stgs.adaptive_scale))

    w_u32(_EXT_MAGIC)
    w_u32(_EXT_VERSION)
    w_int(len(spec.cs))
    w_ints(spec.cs)
    w_int(len(spec.d))
    w_ints(spec.d)
    w_int(len(spec.nuc_m))
    w_ints(spec.nuc_m)
    w_ints(spec.nuc_n)
    w_int(len(spec.ell1))
    w_ints(spec.ell1)
    w_int(len(spec.sl_n))
    w_ints(spec.sl_n)
    w_ints(spec.sl_k)
    w_floats([stgs.time_limit_secs])

    with open(filename, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# checkpoints of a solve in progress


def _leaves(obj, prefix: str, out: dict) -> dict:
    """Flatten a state into {dotted field path: leaf}: dataclasses by
    field name, tuples (NamedTuples included) by position; the leaves are
    tensors, Python numbers and None."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _leaves(getattr(obj, f.name), f"{prefix}{f.name}.", out)
    elif isinstance(obj, tuple):
        for i, item in enumerate(obj):
            _leaves(item, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = obj
    return out


def _rebuild(template, prefix: str, stored: dict):
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), f"{prefix}{f.name}.",
                             stored) for f in dataclasses.fields(template)})
    if isinstance(template, tuple):
        items = [_rebuild(t, f"{prefix}{i}.", stored)
                 for i, t in enumerate(template)]
        return (type(template)(*items) if hasattr(template, "_fields")
                else tuple(items))
    return stored[prefix[:-1]]


def save_state(filename: str, state, phase: int = 0) -> None:
    """Checkpoint a solve in progress: every field of the port's LoopState
    (iterate, scale, linear-system factor, Anderson history, residuals,
    counters), keyed by its field path, with a version tag and the solve's
    phase (0 the first, 1 the mixed path's float64 polish). The file is
    written under a temporary name and renamed into place, so a solve
    stopped while writing leaves the previous checkpoint whole. The format
    is this package's own; the JAX package's checkpoints are its pytrees'
    leaves."""
    arrays = {"__scs_tpu_torch_state_version__": np.asarray(_STATE_VERSION),
              "__phase__": np.asarray(phase)}
    for key, leaf in _leaves(state, "", {}).items():
        if leaf is None:
            continue
        arrays[key] = (leaf.detach().cpu().numpy() if torch.is_tensor(leaf)
                       else np.asarray(leaf))
    target = os.fspath(filename)
    fd, tmp = tempfile.mkstemp(suffix=".npz",
                               dir=os.path.dirname(os.path.abspath(target)))
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_state(filename: str, template):
    """Restore a checkpoint written by `save_state`: (state, phase).
    `template` is a fresh state of the same workspace (its structure, the
    shapes, dtypes and device of its tensors); a checkpoint of another
    problem or of other settings (other fields, shapes or dtypes) raises
    ValueError."""
    with np.load(filename) as z:
        if int(z.get("__scs_tpu_torch_state_version__", -1)) != \
                _STATE_VERSION:
            raise ValueError("not a scs_tpu_torch checkpoint, or of an "
                             "unsupported version")
        phase = int(z["__phase__"])
        want = _leaves(template, "", {})
        have = set(z.files) - {"__scs_tpu_torch_state_version__",
                               "__phase__"}
        keys = {k for k, v in want.items() if v is not None}
        if have != keys:
            raise ValueError(
                f"checkpoint fields differ from this workspace's state "
                f"(different settings?): {sorted(have ^ keys)}")
        stored = {}
        for key, leaf in want.items():
            if leaf is None:
                stored[key] = None
                continue
            arr = z[key]
            if torch.is_tensor(leaf):
                if arr.shape != tuple(leaf.shape) or str(arr.dtype) != \
                        str(leaf.dtype).replace("torch.", ""):
                    raise ValueError(
                        f"checkpoint field {key}: dtype {arr.dtype}, shape "
                        f"{arr.shape}, expected dtype {leaf.dtype}, shape "
                        f"{tuple(leaf.shape)} (different problem or "
                        f"settings?)")
                stored[key] = torch.as_tensor(arr).to(leaf.device)
            else:
                if arr.shape != ():
                    raise ValueError(f"checkpoint field {key} is not a "
                                     f"scalar")
                stored[key] = type(leaf)(arr.item())
    return _rebuild(template, "", stored), phase


# ---------------------------------------------------------------------------
# .npz problems


def save_npz(filename: str, problem: Problem, spec: ConeSpec,
             cone_data: Optional[ConeData] = None) -> None:
    """A dense problem as .npz, in the JAX package's keys (each package
    reads the other's files)."""
    kw = dict(A=_host(problem.A), b=_host(problem.b), c=_host(problem.c),
              z=spec.z, l=spec.l, bsize=spec.bsize,
              q=np.asarray(spec.q, np.int64),
              s=np.asarray(spec.s, np.int64),
              cs=np.asarray(spec.cs, np.int64),
              ep=spec.ep, ed=spec.ed, p=np.asarray(spec.p, np.float64))
    if problem.P is not None:
        kw["P"] = _host(problem.P)
    if cone_data is not None and spec.bsize > 1:
        kw["bu"] = _host(cone_data.bu)
        kw["bl"] = _host(cone_data.bl)
    np.savez_compressed(filename, **kw)


def load_npz(filename: str, dtype=torch.float64, device="cuda"):
    """(Problem, ConeSpec, ConeData) from a `save_npz` file, the tensors
    on `device`."""
    dev = _device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    with np.load(filename) as z:
        spec = ConeSpec(z=int(z["z"]), l=int(z["l"]), bsize=int(z["bsize"]),
                        q=tuple(int(x) for x in z["q"]),
                        s=tuple(int(x) for x in z["s"]),
                        cs=tuple(int(x) for x in z["cs"]),
                        ep=int(z["ep"]), ed=int(z["ed"]),
                        p=tuple(float(x) for x in z["p"]))
        problem = Problem(A=t(z["A"]), b=t(z["b"]), c=t(z["c"]),
                          P=t(z["P"]) if "P" in z else None)
        if "bu" in z:
            cone_data = ConeData(bu=t(z["bu"]), bl=t(z["bl"]))
        else:
            cone_data = ConeData(bu=t(np.zeros(0)), bl=t(np.zeros(0)))
    return problem, spec, cone_data
