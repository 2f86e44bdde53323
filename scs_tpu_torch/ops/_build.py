"""Builds the package's CUDA kernels with nvcc and loads them with ctypes.

Each source under `csrc/` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The
library lands in `scs_tpu_torch/_build/`, named by a hash of its source and
flags, so an edited source builds anew and an unchanged one is reused.
Builds run at first use; `build()` starts one nvcc per missing library,
all at once, and waits for all of them.

    python -m scs_tpu_torch.ops._build      # build every kernel, print
                                            # each variant's registers,
                                            # shared memory and spills
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# kernel name -> source file under csrc/
SOURCES = {"dsmatvec": "dsmatvec.cu", "readpeak": "readpeak.cu",
           "dsmatmul": "dsmatmul.cu", "logdet": "logdet.cu",
           "sumlargest": "sumlargest.cu", "ellmatvec": "ellmatvec.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of scs_tpu_torch "
                       "build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{key[:16]}.so"


def build(names=None) -> dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet.

    Returns {name: {"path", "seconds", "log"}}; `log` holds nvcc's output
    (register and spill counts from ptxas), `seconds` is 0.0 for a library
    that was already there. Raises if any compile fails."""
    names = list(SOURCES) if names is None else list(names)
    out, procs = {}, {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"path": path, "seconds": 0.0, "log": ""}
            continue
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: a concurrent build
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"path": path, "seconds": secs, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]["path"]
        lib = _loaded.setdefault(name, ctypes.CDLL(str(path)))
    return lib


def resources(log: str) -> list[str]:
    """One line per kernel variant from ptxas' -v output in an nvcc log:
    its name (demangled where the toolkit's cu++filt is found), then its
    registers, static shared memory, barriers and spill bytes."""
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            rows.append((name, line.split(":", 1)[-1].strip(), spill))
            name = None
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if rows and os.path.exists(filt):
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, check=True)
        names = out.stdout.splitlines()
        if len(names) == len(rows):
            rows = [(n, u, sp) for n, (_, u, sp) in zip(names, rows)]
    return [f"{n}: {u}; {sp}" for n, u, sp in rows]


if __name__ == "__main__":
    for kname, res in build().items():
        print(f"{kname}: {res['path']} ({res['seconds']:.1f} s)")
        for line in resources(res["log"]) or res["log"].splitlines():
            print(f"  {line}")
        if kname == "dsmatmul":
            lib = ctypes.CDLL(str(res["path"]))
            tile = [ctypes.c_int() for _ in range(4)]
            lib.scs_ds_matmul_tile(*[ctypes.byref(t) for t in tile])
            bm, bn, threads, smem = (t.value for t in tile)
            print(f"  tile {bm} x {bn} of C, {threads} threads, {smem} "
                  f"bytes of dynamic shared memory a block")
