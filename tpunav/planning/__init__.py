"""Global planners: PRM + Theta*, D* Lite, potential fields (JAX
planner/ equivalent). Geometry/collision primitives are batched JAX; the
inherently sequential graph searches (A*/LPA* open-list loops) run on the
host exactly as SURVEY.md §7.5 prescribes."""

from .utilities import min_dist_segment_point, signed_min_dist  # noqa: F401
from .grid_map import PlanningGrid, FREE, OBSTACLE, INFLATED  # noqa: F401
from .potential_field import PotentialField, PotentialFieldConfig  # noqa: F401
from .prm import RoadMap, theta_star  # noqa: F401
from .dstar import DStarLite  # noqa: F401
from .world import load_obstacle_map, REFERENCE_MAP  # noqa: F401
