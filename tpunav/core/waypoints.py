"""Waypoint-following twist generators (functional, scannable).

Data-parallel re-design of ``rigid2d::Waypoints``
(ref: rigid2d/include/rigid2d/waypoints.hpp:16-66,
rigid2d/src/rigid2d/waypoints.cpp). The C++ class mutates (idx, ctr,
cycle_complete); here that bookkeeping is a ``WaypointState`` pytree and the
controllers are pure functions usable inside ``lax.scan`` closed loops.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .angles import normalize_angle_pi


class WaypointParams(NamedTuple):
    pts: jnp.ndarray        # (M, 2) waypoint coordinates
    rot_vel: jnp.ndarray    # max |w|
    trans_vel: jnp.ndarray  # forward speed
    k_rot: jnp.ndarray      # P gain for closed-loop heading control
    htol: jnp.ndarray       # heading tolerance (ref: waypoints.cpp:18 → 0.02)
    ptol: jnp.ndarray       # position tolerance (ref: waypoints.cpp:19 → 0.025)


def make_params(pts, rot_vel, trans_vel, k_rot=0.0, htol=0.02, ptol=0.025,
                dtype=jnp.float32) -> WaypointParams:
    f = lambda v: jnp.asarray(v, dtype=dtype)
    return WaypointParams(f(pts), f(rot_vel), f(trans_vel), f(k_rot),
                          f(htol), f(ptol))


class WaypointState(NamedTuple):
    idx: jnp.ndarray             # current goal index
    ctr: jnp.ndarray             # waypoints visited this cycle
    cycle_complete: jnp.ndarray  # bool


def init_state() -> WaypointState:
    return WaypointState(idx=jnp.int32(0), ctr=jnp.int32(0),
                         cycle_complete=jnp.asarray(False))


def _advance_if_reached(params: WaypointParams, state: WaypointState, pose):
    """Goal-reached check + cyclic increment
    (ref: Waypoints::waypointReached/incrementWaypoint waypoints.cpp:112-142).
    """
    n = params.pts.shape[0]
    goal = params.pts[state.idx]
    d = jnp.linalg.norm(goal - pose[..., 1:3], axis=-1)
    reached = d < params.ptol
    idx = jnp.where(reached, (state.idx + 1) % n, state.idx)
    ctr = jnp.where(reached, state.ctr + 1, state.ctr)
    done = jnp.logical_or(state.cycle_complete, ctr == n + 1)
    return WaypointState(idx=idx, ctr=ctr, cycle_complete=done)


def _heading_error(params: WaypointParams, state: WaypointState, pose):
    goal = params.pts[state.idx]
    bearing = jnp.arctan2(goal[1] - pose[..., 2], goal[0] - pose[..., 1])
    return normalize_angle_pi(bearing - pose[..., 0])


def next_waypoint(params: WaypointParams, state: WaypointState, pose):
    """Bang-bang turn-then-drive controller
    (ref: Waypoints::nextWaypoint waypoints.cpp:35-67).

    Returns (cmd twist [w, vx, 0], new_state).
    """
    state = _advance_if_reached(params, state, pose)
    h_err = _heading_error(params, state, pose)
    aligned = jnp.abs(h_err) < params.htol
    w = jnp.where(aligned, 0.0,
                  jnp.where(h_err > 0, params.rot_vel, -params.rot_vel))
    vx = jnp.where(aligned, params.trans_vel, 0.0)
    cmd = jnp.stack([w, vx, jnp.zeros_like(vx)], axis=-1)
    return cmd, state


def next_waypoint_closed_loop(params: WaypointParams, state: WaypointState,
                              pose):
    """P-controlled heading, stop after one full cycle
    (ref: Waypoints::nextWaypointClosedLoop waypoints.cpp:70-108)."""
    state = _advance_if_reached(params, state, pose)
    h_err = _heading_error(params, state, pose)
    aligned = jnp.abs(h_err) < params.htol
    w = jnp.where(aligned, 0.0,
                  jnp.clip(params.k_rot * h_err,
                           -params.rot_vel, params.rot_vel))
    vx = jnp.where(aligned, params.trans_vel, 0.0)
    stop = state.cycle_complete
    w = jnp.where(stop, 0.0, w)
    vx = jnp.where(stop, 0.0, vx)
    cmd = jnp.stack([w, vx, jnp.zeros_like(vx)], axis=-1)
    return cmd, state
