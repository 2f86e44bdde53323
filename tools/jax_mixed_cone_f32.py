#!/usr/bin/env python3
"""The JAX package's float32 exp and power projections on the port's
mixed-cone headline family (`scs_tpu_torch/models/mixed_cones.py`,
rebuilt here with the JAX package's generator from the same numpy seeds):

    python tools/jax_mixed_cone_f32.py lanes --seeds 1021 1099 1914 1000
    python tools/jax_mixed_cone_f32.py lanes --range 1000 1128 --modes 1
    python tools/jax_mixed_cone_f32.py power [--n 200000]

`lanes` solves the given lanes with scs_tpu.parallel's
make_chunked_batch_solver, direct backend, mixed precision, chunk_iters
250, in three modes (--modes picks some, by number): 0, the package's
default for mixed ("float32 state", the exp and power cones then in
float32); 1, "float64 state" (fast_f32=False; exp and power still
float32, as `exp_f32` follows mixed); 2, "float64 state, exp/power
float64" (exp_f32=False). The lanes are --seeds, or the seeds from the
first to the last but one of --range, solved in batches of 128. For each
mode: the lanes' iterations and statuses, their distance |pobj - opt| /
(1 + |opt|) to the planted optimum, and which of SCS's termination tests
(primal and dual residuals, gap; eps_abs + eps_rel times the scale, 1 %
slack, as chip_smoke.termination_failures) each lane fails, recomputed
in float64 from the original data; with --range, a count of the lanes
failing each test instead of the per-lane lists.

`power` projects --n random triples (entries U(-1, 1) times 10^U(-3, 3),
exponents +-U(0.1, 0.9), numpy seed 0) with proj_power_batch in float32
and in float64, and counts the triples whose float32 result lies more
than 1e-5 ... 1e-1 from the float64 one, relative to max(1, |v|), for
primal and dual cones; the five worst are printed.

Runs on the CPU (JAX_PLATFORMS is set to cpu unless --platform says
otherwise), with float64 enabled.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _jax(platform: str):
    import jax
    jax.config.update("jax_platforms", platform)
    jax.config.update("jax_enable_x64", True)
    return jax


def mixed_spec(scs_tpu):
    """`headline_mixed_spec` of scs_tpu_torch/models/mixed_cones.py."""
    return scs_tpu.ConeSpec(z=40, l=100, bsize=21, q=(20, 34, 14, 51, 21),
                            ep=15, ed=8, p=(0.3, -0.4, 0.5, -0.6, 0.7, -0.2,
                                            0.8, -0.75, 0.25, -0.35))


def box_bounds(scs_tpu, spec, seed):
    """`box_bounds` of scs_tpu_torch/models/mixed_cones.py."""
    import numpy as np
    from scs_tpu import config
    rng = np.random.RandomState(seed)
    nb = spec.bsize - 1
    bl = -rng.uniform(0.5, 2.0, nb)
    bu = rng.uniform(0.5, 2.0, nb)
    bl[::10] = -config.MAX_BOX_VAL
    bu[5::10] = config.MAX_BOX_VAL
    return scs_tpu.ConeData.make(spec, bu=bu, bl=bl)


def termination_failures(A, b, c, x, y, s, eps_abs, eps_rel):
    import numpy as np
    ax = np.einsum("bmn,bn->bm", A, x)
    aty = np.einsum("bmn,bm->bn", A, y)
    ctx, bty = (c * x).sum(1), (b * y).sum(1)

    def inf(t):
        return np.abs(t).max(1)

    tests = {
        "res_pri": (inf(ax + s - b),
                    np.maximum(np.maximum(inf(b), inf(s)), inf(ax))),
        "res_dual": (inf(aty + c), np.maximum(inf(c), inf(aty))),
        "gap": (np.abs(ctx + bty), np.maximum(np.abs(ctx), np.abs(bty))),
    }
    return {k: ~(v <= 1.01 * (eps_abs + eps_rel * scl))
            for k, (v, scl) in tests.items()}


def lanes(args) -> None:
    _jax(args.platform)
    import numpy as np
    import scs_tpu
    from scs_tpu.models.generators import gen_planted
    from scs_tpu.parallel import make_chunked_batch_solver

    spec = mixed_spec(scs_tpu)
    seeds = (list(range(*args.range)) if args.range else args.seeds)
    modes = (("float32 state (the default for mixed)", {}),
             ("float64 state, exp/power float32", dict(fast_f32=False)),
             ("float64 state, exp/power float64",
              dict(fast_f32=False, exp_f32=False)))
    for lo in range(0, len(seeds), 128):
        chunk = seeds[lo:lo + 128]
        probs = [gen_planted(spec, n=100, seed=s, density=0.1,
                             cone_data=box_bounds(scs_tpu, spec, s + 1))
                 for s in chunk]
        arrays = [np.stack([np.asarray(getattr(p.problem, k))
                            for p in probs]) for k in ("A", "b", "c")]
        arrays += [np.stack([np.asarray(getattr(p.cone_data, k))
                             for p in probs]) for k in ("bu", "bl")]
        opts = np.asarray([float(p.opt) for p in probs])
        for mode in args.modes:
            label, kw = modes[mode]
            stg = scs_tpu.Settings(linsys="direct", mixed_precision=True,
                                   chunk_iters=250,
                                   max_iters=args.max_iters, **kw)
            t0 = time.perf_counter()
            res = make_chunked_batch_solver(spec, stg)(*arrays)
            x, y, s = (np.asarray(getattr(res, k), np.float64)
                       for k in ("x", "y", "s"))
            wall = time.perf_counter() - t0
            iters = np.asarray(res.iters)
            err = np.abs(np.asarray(res.pobj) - opts) / (1 + np.abs(opts))
            fails = termination_failures(*arrays[:3], x, y, s, stg.eps_abs,
                                         stg.eps_rel)
            if args.range:
                print(f"{label}: seeds {chunk[0]}-{chunk[-1]}: "
                      f"{int(iters.sum())} lane-iterations (max "
                      f"{int(iters.max())}), statuses "
                      f"{np.unique(np.asarray(res.status)).tolist()}, planted"
                      f" error max {err.max():.3e}, seeds failing "
                      + ", ".join(f"{k} {[chunk[i] for i in np.flatnonzero(v)]}"
                                  for k, v in fails.items())
                      + f", wall {wall:.1f} s", flush=True)
                continue
            failed = [",".join(k for k, v in fails.items() if v[i]) or "-"
                      for i in range(len(chunk))]
            print(f"{label}: seeds {chunk} iterations {iters.tolist()} "
                  f"statuses {np.asarray(res.status).tolist()} planted "
                  f"error {[float(f'{e:.3e}') for e in err]} termination "
                  f"tests failed {failed} wall {wall:.1f} s", flush=True)


def triples(n: int):
    import numpy as np
    rng = np.random.RandomState(0)
    v = rng.uniform(-1, 1, (n, 3)) * 10.0 ** rng.uniform(-3, 3, (n, 1))
    a = rng.uniform(0.1, 0.9, n) * np.where(rng.rand(n) < 0.5, -1.0, 1.0)
    return v, a


def power(args) -> None:
    jax = _jax(args.platform)
    import jax.numpy as jnp
    import numpy as np
    from scs_tpu.cones.power import proj_power_batch

    v, a = triples(args.n)
    fn = jax.jit(proj_power_batch)
    r64 = np.asarray(fn(jnp.asarray(v), jnp.asarray(a)))
    r32 = np.asarray(fn(jnp.asarray(v, jnp.float32),
                        jnp.asarray(a, jnp.float32)), np.float64)
    report(v, a, r64, r32, "JAX package")


def report(v, a, r64, r32, who: str) -> None:
    import numpy as np
    err = np.abs(r32 - r64).max(1) / np.maximum(1.0, np.abs(v).max(1))
    line = ", ".join(
        f"> {t:.0e}: {int((err > t).sum())} ({int((err[a > 0] > t).sum())}"
        f" primal, {int((err[a < 0] > t).sum())} dual)"
        for t in (1e-5, 1e-4, 1e-3, 1e-2, 1e-1))
    print(f"{who}, proj_power_batch float32 against float64 on {len(v)} "
          f"triples, error / max(1, |v|): {line}; max {err.max():.3e}")
    for i in np.argsort(-err, kind="stable")[:5]:
        print(f"  a {a[i]:+.4f} v {v[i].tolist()} float64 "
              f"{r64[i].tolist()} float32 {r32[i].tolist()} "
              f"error {err[i]:.3e}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("lanes", "power"))
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[1021, 1099, 1914, 1000])
    ap.add_argument("--range", type=int, nargs=2, default=None)
    ap.add_argument("--modes", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--max-iters", type=int, default=25000)
    ap.add_argument("--n", type=int, default=200000)
    ap.add_argument("--platform", default="cpu")
    args = ap.parse_args()
    (lanes if args.what == "lanes" else power)(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
