#!/usr/bin/env python3
"""Where one cone's chain goes inside the logdet cascade kernel (K6,
`scs_tpu_torch/csrc/logdet.cu`): SM cycles (clock64) of each stage of
Newton and of the IPM, summed over the cone's iterations, and the line
searches' rounds of trial points.

The script copies the kernel's source into scs_tpu_torch/_build/ with
clock64 marks added at fixed places (it stops if a place is missing),
builds the copy with nvcc and runs it on cones of phase 13's inputs
(`chip_smoke.logdet_kernel_inputs`), one cone a call, timed alone besides
(`chip_smoke.median_ms`). The marks are read by lane 0 of the cone's
first group, after the values it waits for: a stage's cycles include its
waits on the stages before.

    python tools/torch_logdet_profile.py [--cones 321 524 40]

`--cones` picks cones of the 1024-cone case of order 6 (default: its IPM
cones); the 16 x 4 case's slowest cone (1) is always added.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from scs_tpu_torch.models import spectral_cones  # noqa: E402
from scs_tpu_torch.ops import _build, logdet  # noqa: E402

# (text in csrc/logdet.cu, text that replaces it)
_MARKS = [
    ('#include <math.h>\n', '''#include <math.h>
__device__ long long g_prof[64];
#define PMARK(k) do { if (g.pon) { long long t_ = clock64(); \\
  g_prof[k] += t_ - g.pt; g.pt = t_; } } while (0)
'''),
    ('  int parity;\n', '  int parity;\n  bool pon;\n  long long pt;\n  int sid;\n'),
    ('    for (int k0 = 0;; k0 += Q) {',
     '    for (int k0 = 0;; k0 += Q) {\n      if (pon) g_prof[40 + sid] += 1;'),
    ('  while (it < kLcMaxIter && !done && !failed) {',
     '  PMARK(0);\n  while (it < kLcMaxIter && !done && !failed) {\n    PMARK(1);'),
    ('    const bool done_now = -dir_der <= 2.0 * kLcTol;',
     '    const bool done_now = -dir_der <= 2.0 * kLcTol;\n    PMARK(2);\n'
     '    g.sid = 0;'),
    ('    done |= done_now;\n    ++it;',
     '    done |= done_now;\n    ++it;\n    PMARK(3);'),
    ('    for (int it = 0; it < kIpmMaxIter; ++it) {',
     '    PMARK(10);\n    for (int it = 0; it < kIpmMaxIter; ++it) {\n'
     '      PMARK(11);\n      if (g.pon) g_prof[50] += 1;'),
    ('      for (int j = 0; j < 3; ++j) {\n        w[j] = sqrt(s[j] / z[j]);',
     '      PMARK(12);\n      for (int j = 0; j < 3; ++j) {\n'
     '        w[j] = sqrt(s[j] / z[j]);'),
    ('      kkt_solve(1.0, rznl, rhs2_aff, Dua, dz_a, ds_a);',
     '      PMARK(13);\n      kkt_solve(1.0, rznl, rhs2_aff, Dua, dz_a, ds_a);\n'
     '      PMARK(14);\n      g.sid = 1;'),
    ('      double sigma = gap_a / gap;',
     '      PMARK(15);\n      double sigma = gap_a / gap;'),
    ('      double step = max_step(Duc, dz_c, ds_c);\n',
     '      PMARK(16);\n      double step = max_step(Duc, dz_c, ds_c);\n'
     '      g.sid = 2;\n'),
    ('      if (restored) {', '      PMARK(17);\n      if (restored) {'),
    ('  g.parity = 0;\n', '  g.parity = 0;\n'
     '  g.pon = threadIdx.x == 0 && blockIdx.x == 0;\n  g.pt = clock64();\n'
     '  g.sid = 0;\n'),
    ('const char* scs_logdet_error_string(int code) {',
     '''void scs_logdet_profile(long long* out) {
  long long zero[64] = {0};
  cudaMemcpyFromSymbol(out, g_prof, sizeof(zero));
  cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
}

const char* scs_logdet_error_string(int code) {'''),
]

STAGES = {2: "Newton: step direction (gradient .. directional derivative)",
          3: "Newton: step bound, line search, update",
          12: "IPM: oracle and residuals",
          13: "IPM: scaling, KKT factor, two G^-1 solves, R",
          14: "IPM: affine KKT solve (3 refinement passes)",
          15: "IPM: affine step bound and line search",
          16: "IPM: centering and corrector KKT solve",
          17: "IPM: step bound and nonmonotone line search",
          40: "rounds of trial points, Newton",
          41: "rounds of trial points, IPM affine",
          42: "rounds of trial points, IPM backtracking",
          50: "IPM iterations"}


def build() -> ctypes.CDLL:
    src = open(os.path.join(_build.CSRC, "logdet.cu")).read()
    for old, new in _MARKS:
        if src.count(old) != 1:
            raise SystemExit(f"torch_logdet_profile: csrc/logdet.cu no "
                             f"longer has one {old!r}; update _MARKS")
        src = src.replace(old, new)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, "logdet_profile.cu")
    so = os.path.join(_build.BUILD_DIR, "liblogdet_profile.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    vp = ctypes.c_void_p
    lib.scs_logdet_cone.argtypes = [vp] * 9 + [ctypes.c_longlong] + [
        ctypes.c_int] * 7 + [vp]
    lib.scs_logdet_cone.restype = ctypes.c_int
    lib.scs_logdet_profile.argtypes = [vp]
    return lib


def run(lib, dev):
    t0, v0, x0 = dev
    L, n = x0.shape
    lay = logdet.launch_config(n)
    out = [torch.empty_like(t0), torch.empty_like(v0), torch.empty_like(x0),
           torch.empty(L, dtype=torch.int32, device="cuda")]
    listed = torch.zeros(L + 1, dtype=torch.int32, device="cuda")
    err = lib.scs_logdet_cone(
        *(a.data_ptr() for a in dev + out[:3]), out[3].data_ptr(), None,
        listed.data_ptr(), L, n, lay.entries, lay.lanes, lay.warps,
        lay.cones_per_block, lay.shared_bytes, lay.ipm_warps,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"logdet profile launch failed ({err})")
    return out[3]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cones", type=int, nargs="*")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_logdet_profile: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line())
    lib = build()
    cases = (chip_smoke.logdet_kernel_inputs(
        spectral_cones.headline_spectral_spec(), (1024,), 300)
        + chip_smoke.logdet_kernel_inputs(
            spectral_cones.large_spectral_spec(), (), 310))
    buf = (ctypes.c_longlong * 64)()
    for ns, count, args in cases:
        if ns == 6:
            picks = a.cones
            if picks is None:
                info = run(lib, [x.cuda() for x in args]).cpu()
                picks = torch.nonzero(info >= 1000).squeeze(-1).tolist()
        elif ns == 16:
            picks = [1]
        else:
            continue
        for i in picks:
            dev = [x[i:i + 1].cuda() for x in args]
            run(lib, dev)
            torch.cuda.synchronize()
            lib.scs_logdet_profile(buf)
            info = int(run(lib, dev)[0])
            torch.cuda.synchronize()
            lib.scs_logdet_profile(buf)
            ms = chip_smoke.median_ms(lambda: run(lib, dev))
            its, ipm_its = info % 1000, buf[50]
            print(f"order {ns}, cone {i}: info {info}, alone {ms:.4f} ms "
                  f"(with the marks)")
            for k, name in STAGES.items():
                per = (its if k < 10 else ipm_its) or 1
                if buf[k]:
                    print(f"  {name}: {buf[k]}"
                          + (f" ({buf[k] / per:.0f} an iteration)"
                             if k < 40 else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
