"""Core SE(2) / diff-drive kinematics (JAX rigid2d equivalent)."""

from . import angles, se2, diff_drive, waypoints, randoms  # noqa: F401
from .angles import (  # noqa: F401
    almost_equal,
    deg2rad,
    normalize_angle_2pi,
    normalize_angle_pi,
    rad2deg,
)
from .diff_drive import (  # noqa: F401
    DiffDriveParams,
    DiffDriveState,
    TURTLEBOT3,
)
