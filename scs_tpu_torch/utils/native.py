"""ctypes bindings of the native (C++) codec of SCS's binary problem format.

Counterpart of `scs_tpu/utils/native.py`. The codec is this package's own
copy, `scs_tpu_torch/native/scs_io.cc`; it is built at first use with

    g++ -O3 -std=c++17 -fPIC -shared

into `scs_tpu_torch/_build/libscs_io_<hash of source and flags>.so`, under
a file lock and through an atomic rename, so processes that start together
build it once and never load a half-written library. It is host I/O, not a
kernel. Where no C++ compiler is found or the build fails, `load()`
returns None and `io` uses its Python reader and writer; a library that
loads and then fails to parse a file raises.

    lib = load()          # None if unavailable or unbuildable
    d = read_file(path)   # dict of numpy arrays and scalars
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "scs_io.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


class _Meta(ctypes.Structure):
    _fields_ = (
        [(name, ctypes.c_int64) for name in (
            "z", "l", "bsize", "qsize", "ssize", "ep", "ed", "psize",
            "cssize", "dsize", "nucsize", "ell1size", "slsize",
            "m", "n", "has_p", "a_nnz", "p_nnz",
            "normalize", "max_iters", "verbose", "warm_start",
            "accel_lookback", "accel_interval", "accel_type1",
            "adaptive_scale", "legacy")]
        + [(name, ctypes.c_double) for name in (
            "scale", "rho_x", "eps_abs", "eps_rel", "eps_infeas", "alpha",
            "accel_reg", "accel_relax", "time_limit")])


_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libscs_io_{key[:16]}.so"


def build() -> Optional[Path]:
    """The codec's library, compiled first if it is not built yet; None
    where no C++ compiler is found or the compile fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "scs_io.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():           # another process built it meanwhile
            return path
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                                  capture_output=True, timeout=300)
            if proc.returncode != 0:
                return None
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return path


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native codec; None where it cannot be
    built or loaded."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = build()
        if path is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _load_failed = True
            return None

        lib.scs_file_open.restype = ctypes.c_void_p
        lib.scs_file_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_int64]
        lib.scs_file_meta.restype = None
        lib.scs_file_meta.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Meta)]
        lib.scs_file_get_ints.restype = ctypes.c_int64
        lib.scs_file_get_ints.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          _I64P]
        lib.scs_file_get_floats.restype = ctypes.c_int64
        lib.scs_file_get_floats.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            _F64P]
        lib.scs_file_get_dense.restype = ctypes.c_int64
        lib.scs_file_get_dense.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           _F64P]
        lib.scs_file_get_csc.restype = ctypes.c_int64
        lib.scs_file_get_csc.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         _I64P, _I64P, _F64P]
        lib.scs_file_close.restype = None
        lib.scs_file_close.argtypes = [ctypes.c_void_p]
        lib.scs_file_write.restype = ctypes.c_int64
        lib.scs_file_write.argtypes = (
            [ctypes.c_char_p, ctypes.POINTER(_Meta)]
            + [_F64P, _F64P, _I64P, _I64P, _F64P]   # bl, bu, q, s, p
            + [_I64P] * 7   # cs, d, nuc_m, nuc_n, ell1, sl_n, sl_k
            + [_F64P, _F64P, _F64P, ctypes.c_void_p]  # b, c, A, P
            + [ctypes.c_char_p, ctypes.c_int64])
        _lib = lib
        return _lib


_INT_FIELDS = ("q", "s", "cs", "d", "nuc_m", "nuc_n", "ell1", "sl_n", "sl_k")
_INT_SIZES = ("qsize", "ssize", "cssize", "dsize", "nucsize", "nucsize",
              "ell1size", "slsize", "slsize")


def read_file(path: str, storage: str = "dense") -> Optional[dict]:
    """Parse an SCS binary problem file natively; None if the library is
    unavailable. storage "dense": A and P as dense arrays (P symmetrized
    from its stored upper triangle); "sparse": A and P as CSC triplets
    (colptr, rowidx, vals), P's upper triangle as stored."""
    lib = load()
    if lib is None:
        return None
    err = ctypes.create_string_buffer(256)
    h = lib.scs_file_open(os.fsencode(path), err, 256)
    if not h:
        raise ValueError(err.value.decode() or "failed to parse SCS file")
    try:
        meta = _Meta()
        lib.scs_file_meta(h, ctypes.byref(meta))
        out = {name: getattr(meta, name) for name, _ in _Meta._fields_}

        for which, (field, size) in enumerate(zip(_INT_FIELDS, _INT_SIZES)):
            arr = np.zeros(getattr(meta, size), np.int64)
            lib.scs_file_get_ints(h, which, arr)
            out[field] = arr
        box_len = max(meta.bsize - 1, 0)
        for which, (field, size) in enumerate(
                (("b", meta.m), ("c", meta.n), ("bl", box_len),
                 ("bu", box_len), ("p", meta.psize))):
            arr = np.zeros(size, np.float64)
            lib.scs_file_get_floats(h, which, arr)
            out[field] = arr

        out["P"] = None
        for which, key, rows, nnz, present in (
                (0, "A", meta.m, meta.a_nnz, True),
                (1, "P", meta.n, meta.p_nnz, meta.has_p)):
            if not present:
                continue
            if storage == "sparse":
                trip = (np.zeros(meta.n + 1, np.int64),
                        np.zeros(nnz, np.int64), np.zeros(nnz, np.float64))
                lib.scs_file_get_csc(h, which, *trip)
                out[key] = trip
            else:
                M = np.zeros((rows, meta.n), np.float64)
                lib.scs_file_get_dense(h, which, M)
                out[key] = M
        return out
    finally:
        lib.scs_file_close(h)


def write_file(path: str, *, z, l, bsize, bl, bu, q, s, ep, ed, p,
               cs, d, nuc_m, nuc_n, ell1, sl_n, sl_k,
               b, c, A, P,
               normalize, scale, rho_x, max_iters, eps_abs, eps_rel,
               eps_infeas, alpha, verbose, accel_lookback, accel_interval,
               accel_type1, accel_reg, accel_relax, adaptive_scale,
               time_limit) -> Optional[int]:
    """Write SCS's binary format natively from dense A and P (the CSC of
    their nonzeros; P's upper triangle); None if the library is
    unavailable, else the bytes written."""
    lib = load()
    if lib is None:
        return None
    meta = _Meta(
        z=z, l=l, bsize=bsize, qsize=len(q), ssize=len(s), ep=ep, ed=ed,
        psize=len(p), cssize=len(cs), dsize=len(d), nucsize=len(nuc_m),
        ell1size=len(ell1), slsize=len(sl_n),
        m=A.shape[0], n=A.shape[1], has_p=int(P is not None),
        a_nnz=0, p_nnz=0,
        normalize=int(normalize), max_iters=max_iters, verbose=int(verbose),
        warm_start=0, accel_lookback=accel_lookback,
        accel_interval=accel_interval, accel_type1=int(accel_type1),
        adaptive_scale=int(adaptive_scale), legacy=0,
        scale=scale, rho_x=rho_x, eps_abs=eps_abs, eps_rel=eps_rel,
        eps_infeas=eps_infeas, alpha=alpha, accel_reg=accel_reg,
        accel_relax=accel_relax, time_limit=time_limit)

    def f64(x):
        return np.ascontiguousarray(np.asarray(x, np.float64).ravel())

    def i64(x):
        return np.ascontiguousarray(np.asarray(x, np.int64).ravel())

    err = ctypes.create_string_buffer(256)
    A_c = f64(A)
    P_arr = None if P is None else f64(P)     # kept alive over the call
    P_ptr = None if P is None else P_arr.ctypes.data_as(ctypes.c_void_p)
    rc = lib.scs_file_write(
        os.fsencode(path), ctypes.byref(meta), f64(bl), f64(bu), i64(q),
        i64(s), f64(p), i64(cs), i64(d), i64(nuc_m), i64(nuc_n), i64(ell1),
        i64(sl_n), i64(sl_k), f64(b), f64(c), A_c, P_ptr, err, 256)
    if rc < 0:
        raise OSError(err.value.decode() or "native SCS write failed")
    return int(rc)
