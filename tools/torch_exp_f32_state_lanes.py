"""Iterations of single lanes of the mixed-cone headline batch
(`models/mixed_cones.headline_mixed_spec`) under the exp projection's
precision choices of the float32-state fast phase:

  * "exp float32 under float32 state": the exp rows projected in float32
    when the state is float32, as the JAX package does (emulated here by
    patching `cones.project.proj_cone`);
  * "the port's rule": the exp rows in float64 under float32 state
    (`cones/project.py`);
  * "all cones float64 under float32 state": every cone projected in
    float64, the state in float32;
  * "float64 state": `Settings(fast_f32=False)`.

    python tools/torch_exp_f32_state_lanes.py --seeds 1021 1099 1914 1000

Each line gives the lanes' iteration counts, statuses and the wall time of
one `make_chunked_batch_solver` call (direct backend, mixed, capped at
--max-iters). On "cuda" (the default) the cones run as CUDA graphs; on
"cpu" the mixed path runs the kernels' plain versions (ds_split).
`tools/jax_mixed_cone_f32.py lanes` solves the same lanes with the JAX
package on the CPU.

    python tools/torch_exp_f32_state_lanes.py --f64-state --device cpu \
        --seeds 1011 1616 1702 1843 1852 [--raw]

solves the lanes with float64 state and `exp_f32=True` (ROADMAP R4's
open item) and prints, per lane, the iterations, the status, which of
SCS's termination tests the returned point fails recomputed in float64
(as `tools/jax_mixed_cone_f32.py`), and the gap over its bound; with
--raw the finishing float64 Moreau re-projection
(`solver.moreau_repolish`) is replaced by the identity, so the returned
point is the one the in-loop termination test read.

    python tools/torch_exp_f32_state_lanes.py --power [--n 200000] \
        [--device cpu]

projects the random triples of `tools/jax_mixed_cone_f32.py power`
(entries U(-1, 1) times 10^U(-3, 3), exponents +-U(0.1, 0.9), numpy seed
0) with the port's proj_power_batch in float32 and in float64 and counts
the triples whose float32 result lies more than 1e-5 ... 1e-1 from the
float64 one, relative to max(1, |v|), as that tool does for the JAX
package.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from scs_tpu_torch import Settings  # noqa: E402
from scs_tpu_torch.cones import power as power_cone  # noqa: E402
from scs_tpu_torch.cones import project  # noqa: E402
from scs_tpu_torch.models import mixed_cones  # noqa: E402
from scs_tpu_torch.parallel import make_chunked_batch_solver  # noqa: E402
from scs_tpu_torch.types import ConeData  # noqa: E402


def _cast(cone_data, box_t_warm, r_y, dtype):
    cd = None if cone_data is None else ConeData(
        bu=cone_data.bu.to(dtype), bl=cone_data.bl.to(dtype))
    return (cd, None if box_t_warm is None else box_t_warm.to(dtype),
            None if r_y is None else r_y.to(dtype))


def power_roots(n: int, device: str) -> None:
    """The port's float32 power projection against its float64 one."""
    rng = np.random.RandomState(0)
    v = rng.uniform(-1, 1, (n, 3)) * 10.0 ** rng.uniform(-3, 3, (n, 1))
    a = rng.uniform(0.1, 0.9, n) * np.where(rng.rand(n) < 0.5, -1.0, 1.0)
    r = {dt: power_cone.proj_power_batch(
        torch.as_tensor(v, dtype=dt, device=device),
        torch.as_tensor(a, dtype=dt, device=device)).double().cpu().numpy()
        for dt in (torch.float64, torch.float32)}
    err = (np.abs(r[torch.float32] - r[torch.float64]).max(1)
           / np.maximum(1.0, np.abs(v).max(1)))
    line = ", ".join(
        f"> {t:.0e}: {int((err > t).sum())} ({int((err[a > 0] > t).sum())}"
        f" primal, {int((err[a < 0] > t).sum())} dual)"
        for t in (1e-5, 1e-4, 1e-3, 1e-2, 1e-1))
    print(f"scs_tpu_torch on {device}, proj_power_batch float32 against "
          f"float64 on {n} triples, error / max(1, |v|): {line}; max "
          f"{err.max():.3e}")


def termination_ratios(A, b, c, res, stg) -> dict:
    """SCS's termination tests on the returned points, recomputed in
    float64: {test: (B,) value over its bound eps_abs + eps_rel scale}."""
    x, y, s = res.x, res.y, res.s
    ax = torch.einsum("bmn,bn->bm", A, x)
    aty = torch.einsum("bmn,bm->bn", A, y)
    ctx, bty = (c * x).sum(1), (b * y).sum(1)

    def inf(t):
        return t.abs().amax(1)

    tests = {
        "res_pri": (inf(ax + s - b),
                    torch.maximum(torch.maximum(inf(b), inf(s)), inf(ax))),
        "res_dual": (inf(aty + c), torch.maximum(inf(c), inf(aty))),
        "gap": ((ctx + bty).abs(), torch.maximum(ctx.abs(), bty.abs())),
    }
    return {k: (v / (stg.eps_abs + stg.eps_rel * scl)).cpu().numpy()
            for k, (v, scl) in tests.items()}


def f64_state_exp32(arrays, seeds, args, kw) -> None:
    """The lanes with float64 state and exp_f32=True (module docstring)."""
    from scs_tpu_torch.parallel import batch as batch_mod
    stg = Settings(linsys="direct", mixed_precision=True, chunk_iters=250,
                   max_iters=args.max_iters, fast_f32=False, exp_f32=True)
    repolish = batch_mod.moreau_repolish
    if args.raw:
        batch_mod.moreau_repolish = lambda data, spec, st: st
    try:
        res = make_chunked_batch_solver(mixed_cones.headline_mixed_spec(),
                                        stg, **kw)(*arrays)
    finally:
        batch_mod.moreau_repolish = repolish
    ratios = termination_ratios(*arrays[:3], res, stg)
    failed = [",".join(k for k, v in ratios.items() if not v[i] <= 1.01)
              or "-" for i in range(len(seeds))]
    print(f"float64 state, exp_f32=True"
          f"{' (no finishing re-projection)' if args.raw else ''}: seeds "
          f"{seeds} iterations {res.iters.tolist()} statuses "
          f"{res.status.tolist()} termination tests failed {failed} gap / "
          f"its bound {[float(f'{g:.3f}') for g in ratios['gap']]}",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[1021, 1099, 1914, 1000])
    ap.add_argument("--max-iters", type=int, default=25000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--power", action="store_true")
    ap.add_argument("--n", type=int, default=200000)
    ap.add_argument("--f64-state", action="store_true")
    ap.add_argument("--raw", action="store_true")
    args = ap.parse_args()
    if args.power:
        power_roots(args.n, args.device)
        return 0
    spec = mixed_cones.headline_mixed_spec()
    probs = [mixed_cones.gen_mixed(spec, 100, s, 0.1) for s in args.seeds]
    arrays = [torch.stack([getattr(p.problem, k) for p in probs])
              for k in ("A", "b", "c")]
    arrays += [torch.stack([getattr(p.cone_data, k) for p in probs])
               for k in ("bu", "bl")]
    arrays = [a.to(args.device) for a in arrays]
    lay = project.ConeLayout.make(spec)
    rule = project.proj_cone

    def exp_f32_state(x, spec, cone_data=None, box_t_warm=None, r_y=None,
                      exp_f32=False, psd_f32=False):
        out, t = rule(x, spec, cone_data, box_t_warm, r_y, exp_f32, psd_f32)
        if x.dtype != torch.float32:
            return out, t
        # the exp rows projected in float32, as the JAX package does
        x64 = x.to(torch.float64)
        f32, _ = rule(x64, spec, *_cast(cone_data, box_t_warm, r_y,
                                         torch.float64), True)
        out = out.clone()
        rows = slice(lay.exp_off, lay.pow_off)
        out[..., rows] = f32[..., rows].to(x.dtype)
        return out, t

    def all_f64(x, spec, cone_data=None, box_t_warm=None, r_y=None,
                exp_f32=False, psd_f32=False):
        if x.dtype != torch.float32:
            return rule(x, spec, cone_data, box_t_warm, r_y, exp_f32,
                        psd_f32)
        out, t = rule(x.to(torch.float64), spec,
                      *_cast(cone_data, box_t_warm, r_y, torch.float64))
        return out.to(x.dtype), t.to(x.dtype) if t is not None else t

    kw = {} if args.device == "cuda" else dict(device="cpu", ds_split=True)
    if args.f64_state:
        f64_state_exp32(arrays, args.seeds, args, kw)
        return 0
    runs = (("exp float32 under float32 state", exp_f32_state, {}),
            ("the port's rule", rule, {}),
            ("all cones float64 under float32 state", all_f64, {}),
            ("float64 state", rule, dict(fast_f32=False)))
    try:
        for name, proj, skw in runs:
            project.proj_cone = proj
            stg = Settings(linsys="direct", mixed_precision=True,
                           chunk_iters=250, max_iters=args.max_iters, **skw)
            t0 = time.perf_counter()
            res = make_chunked_batch_solver(spec, stg, **kw)(*arrays)
            print(f"{name}: seeds {args.seeds} iterations "
                  f"{res.iters.tolist()} statuses {res.status.tolist()} wall "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        project.proj_cone = rule
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
