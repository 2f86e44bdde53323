from .generators import (PlantedProblem, gen_infeasible, gen_planted,
                         gen_unbounded)
from .diff_instances import planted_complementary
from .lowrank_sdp import planted_lowrank_sdp

__all__ = ["PlantedProblem", "gen_planted", "gen_infeasible",
           "gen_unbounded", "planted_lowrank_sdp",
           "planted_complementary"]
