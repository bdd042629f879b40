"""Device-mesh construction helpers.

Replaces the reference's multi-machine roslaunch scale-out
(ref: nuturtle_robot/launch/basic_remote.launch:1-40 — ssh + ROS master)
with a ``jax.sharding.Mesh``: the rollout axis of MPPI and the particle
axis of the RBPF shard across devices, and ``jax.distributed`` handles
multi-host initialization. The mesh is 1-D because the algorithms need
one axis; the GPUs of one host are joined all to all by NVLink, so no
device order is better than another.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def rollout_mesh(devices=None, axis_name: str = "k") -> Mesh:
    """1-D mesh over all (or given) devices for data-parallel rollouts
    (SURVEY.md §2.7: DP over the K rollout axis / P particle axis)."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))
