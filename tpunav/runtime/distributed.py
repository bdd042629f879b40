"""Multi-host initialization + host-role helpers.

Data-parallel replacement for the reference's multi-machine deployment
(ref: nuturtle_robot/launch/basic_remote.launch:1-40 — roslaunch
``<machine>`` tags ssh-spawning nodes on the robot vs the laptop, all
talking to one ROS master). Here the cluster story is JAX's: every host
runs the same program, ``jax.distributed.initialize`` wires the hosts,
and the device mesh (tpunav.parallel.mesh) spans all devices, so
collectives run over NVLink within a host and the network across hosts.

Single-host (or CI) use is a no-op: ``initialize()`` only contacts a
coordinator when multi-process settings are present, so the same launch
script runs unchanged from one chip to a pod.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed when running multi-host; return True
    iff a multi-process runtime was brought up.

    Resolution order mirrors jax's own: explicit args, then the standard
    env vars (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID or a recognised cluster environment). With neither,
    this is a single-host run and nothing is contacted — the equivalent
    of launching the reference stack without machine tags.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        return False
    # Reject partial specification up front: jax.distributed.initialize
    # would otherwise fail opaquely (or hang contacting a coordinator)
    # outside auto-detected cluster environments.
    missing = [name for name, val in (
        ("coordinator_address", coordinator_address),
        ("num_processes", num_processes),
        ("process_id", process_id)) if val is None]
    if missing:
        raise ValueError(
            "partial multi-process configuration: missing "
            f"{missing}; set all of JAX_COORDINATOR_ADDRESS / "
            "JAX_NUM_PROCESSES / JAX_PROCESS_ID (or pass all three "
            "arguments), or none for a single-host run.")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    return True


def is_leader() -> bool:
    """True on the host that owns logging/viz/checkpoint writes (the
    reference's 'laptop' role vs the robot's headless role)."""
    return jax.process_index() == 0


def process_info() -> dict:
    """Cluster topology summary for startup logging (the reference
    echoes its params at startup; we echo the mesh)."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
