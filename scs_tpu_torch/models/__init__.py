from .generators import (PlantedProblem, gen_infeasible, gen_planted,
                         gen_unbounded)

__all__ = ["PlantedProblem", "gen_planted", "gen_infeasible",
           "gen_unbounded"]
