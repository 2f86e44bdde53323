from .project import ConeLayout, cone_boundaries, proj_cone, proj_dual_cone

__all__ = ["ConeLayout", "cone_boundaries", "proj_cone", "proj_dual_cone"]
