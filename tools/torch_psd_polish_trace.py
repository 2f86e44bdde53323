"""Trace one lane of the PSD batch through the float32-state fast phase
and the forced float64 polish of `make_chunked_batch_solver` on the CPU:
the state at the fast phase's end and every few hundred polish iterations
(residuals, gap, tau, the adaptive scale, the objective against the
planted optimum). Shows why a few lanes' polish crawls after float32
state (PERF.md section 7).

    python3 tools/torch_psd_polish_trace.py [--seed 1296] [--legs 12]
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from scs_tpu_torch import Settings, config  # noqa: E402
from scs_tpu_torch.models import gen_planted, psd_cones  # noqa: E402
from scs_tpu_torch.parallel import batch as bm  # noqa: E402
from scs_tpu_torch.parallel import make_chunked_batch_solver  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1296)
    ap.add_argument("--legs", type=int, default=12,
                    help="polish legs: 4 of 25 iterations, then 500 each")
    args = ap.parse_args()
    torch.set_num_threads(4)
    spec = psd_cones.headline_psd_spec()
    p = gen_planted(spec, n=100, seed=args.seed, density=0.1)
    A, b, c = (getattr(p.problem, k)[None] for k in "Abc")
    bnd = torch.zeros(1, 0, dtype=torch.float64)
    solver = make_chunked_batch_solver(
        spec, Settings(linsys="direct", chunk_iters=250,
                       mixed_precision=True, max_iters=40000),
        device="cpu", ds_split=True)
    mach = solver.machinery
    data, st = mach.init_fn(A, None, b, c, bnd, bnd)
    fdata, fst = bm.f32_view(bm._floored_data(data), st, mach.it.backend)
    st, _, _ = mach.run_phase("fast", mach.it32, fdata, fst, 40000)
    st = bm.f64_state(st, mach.it.backend)

    def show(tag, st):
        r = st.res
        print(f"{tag}: iteration {int(st.iter[0])}, status "
              f"{int(st.status[0])}, res_pri {float(r.res_pri[0]):.3e}, "
              f"res_dual {float(r.res_dual[0]):.3e}, gap "
              f"{float(r.gap[0]):.3e}, tau {float(r.tau[0]):.3e}, scale "
              f"{float(st.scale[0]):.3e}, pobj {float(r.pobj[0]):.6f} "
              f"(planted {p.opt:.6f})", flush=True)

    show("fast phase end", st)
    st = mach.repair(data, st)
    for k in range(args.legs):
        cap = int(st.iter[0]) + (25 if k < 4 else 500)
        st, _, _ = mach.it_polish.run(data, st, cap)
        show(f"polish leg {k}", st)
        if int(st.status[0]) != config.UNFINISHED:
            break


if __name__ == "__main__":
    main()
