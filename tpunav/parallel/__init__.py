"""Multi-device scale-out: meshes, sharded MPPI/particle axes."""

from .mesh import rollout_mesh  # noqa: F401
from .mppi_sharded import mppi_solve_sharded  # noqa: F401
from .rbpf_sharded import (  # noqa: F401
    pf_init_sharded,
    pf_slam_step_sharded,
)
