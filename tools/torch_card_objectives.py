"""How far the card's and the CPU's objectives lie from the planted optimum
on the instances of tests/test_torch_cuda.py's
test_indirect_solve_on_the_card_matches_the_plain_version (seeds 3-9, the
indirect backend, mixed and pure float64), in units of the test's eps
(eps_abs + eps_rel |opt|), with both iteration counts and the card's
distance to the CPU's objective in units of 1e-4 (1 + |pobj|).

    python3 tools/torch_card_objectives.py     # needs a CUDA device
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from scs_tpu_torch import ConeSpec, Settings, Workspace  # noqa: E402
from scs_tpu_torch.models import gen_planted  # noqa: E402


def main() -> None:
    spec = ConeSpec(z=5, l=20, q=(5, 5, 5, 10))
    for stg, cpu_stg in ((Settings(), Settings(mixed_precision=True)),
                         (Settings(mixed_precision=False),
                          Settings(mixed_precision=False))):
        for seed in range(3, 10):
            p = gen_planted(spec, n=30, seed=seed, density=0.3)
            _, info = Workspace(p.problem, spec, p.cone_data, stg).solve()
            _, ref = Workspace(p.problem, spec, p.cone_data, cpu_stg,
                               device="cpu",
                               ds_split=cpu_stg.mixed_precision).solve()
            eps = stg.eps_abs + stg.eps_rel * abs(p.opt)
            apart = abs(info.pobj - ref.pobj) / (1e-4 * (1 + abs(ref.pobj)))
            print("mixed" if cpu_stg.mixed_precision else "pure", seed,
                  "card", info.iter, round(abs(info.pobj - p.opt) / eps, 4),
                  "cpu", ref.iter, round(abs(ref.pobj - p.opt) / eps, 4),
                  "card-cpu", round(apart, 4), flush=True)


if __name__ == "__main__":
    main()
