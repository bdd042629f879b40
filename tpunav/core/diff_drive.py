"""Differential-drive kinematics as pure functions over a pytree state.

Data-parallel re-design of ``rigid2d::DiffDrive``
(ref: rigid2d/include/rigid2d/diff_drive.hpp:37-104,
rigid2d/src/rigid2d/diff_drive.cpp). The C++ class carries mutable pose +
encoder state; here state is an immutable ``DiffDriveState`` pytree and
every method is a pure function ``(params, state, ...) -> new_state`` so it
vmaps over robots/particles and scans over time.

Semantics preserved exactly, including the reference's quirks:
- ``update_odometry`` wraps encoder *deltas* and stored encoder angles to
  (-pi, pi] (diff_drive.cpp:97-150).
- ``feedforward`` wraps the wheel *velocities* through normalize_angle_PI
  as the reference does (diff_drive.cpp:153-195) — needed for the
  feedforward/updateOdometry consistency invariant tested in
  rigid2d/test/test_diff_drive.cpp:391-475.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from . import se2
from .angles import normalize_angle_pi


class DiffDriveParams(NamedTuple):
    """Fixed geometry (ref: diff_params.yaml — TurtleBot3 Burger)."""

    wheel_radius: jnp.ndarray  # 0.033 m
    wheel_base: jnp.ndarray    # 0.160 m


# Canonical robot constants (ref: nuturtle_description/config/diff_params.yaml:1-28).
# Plain floats: params weak-type so they adopt the state's dtype, and module
# import never touches the device backend.
TURTLEBOT3 = DiffDriveParams(wheel_radius=0.033, wheel_base=0.160)
MAX_TRANS_VEL = 0.22       # m/s
MAX_ROT_VEL = 2.84         # rad/s
MAX_WHEEL_VEL = 6.35495    # rad/s (max_rot_motor)
MAX_MOTOR_POWER = 265      # integer command full-scale
ENCODER_TICKS_PER_REV = 4096


class DiffDriveState(NamedTuple):
    """Robot pose + encoder state. All leaves are scalars (or batched)."""

    pose: jnp.ndarray        # (..., 3) [theta, x, y]
    left: jnp.ndarray        # left wheel encoder angle (rad)
    right: jnp.ndarray       # right wheel encoder angle (rad)
    ul: jnp.ndarray          # last left wheel velocity (rad / time-unit)
    ur: jnp.ndarray          # last right wheel velocity


def init_state(theta=0.0, x=0.0, y=0.0, dtype=jnp.float32) -> DiffDriveState:
    z = jnp.asarray(0.0, dtype=dtype)
    return DiffDriveState(
        pose=se2.make(jnp.asarray(theta, dtype), jnp.asarray(x, dtype),
                      jnp.asarray(y, dtype)),
        left=z, right=z, ul=z, ur=z,
    )


def twist_to_wheels(params: DiffDriveParams, twist):
    """Body twist [w, vx, vy] → wheel velocities (ul, ur)
    (ref: DiffDrive::twistToWheels diff_drive.cpp:56-76; vy must be 0 —
    the reference throws, we ignore vy which is equivalent for valid input).
    """
    d = params.wheel_base / 2.0
    w, vx = twist[..., 0], twist[..., 1]
    ul = (-d * w + vx) / params.wheel_radius
    ur = (d * w + vx) / params.wheel_radius
    return jnp.stack([ul, ur], axis=-1)


def wheels_to_twist(params: DiffDriveParams, wheel_vel):
    """Wheel velocities (ul, ur) → body twist [w, vx, 0]
    (ref: DiffDrive::wheelsToTwist diff_drive.cpp:79-94)."""
    ul, ur = wheel_vel[..., 0], wheel_vel[..., 1]
    w = params.wheel_radius / params.wheel_base * (ur - ul)
    vx = params.wheel_radius * 0.5 * (ul + ur)
    return jnp.stack([w, vx, jnp.zeros_like(vx)], axis=-1)


def update_odometry(params: DiffDriveParams, state: DiffDriveState,
                    left, right):
    """Advance pose from new absolute encoder angles.

    Returns (new_state, wheel_vel) where wheel_vel is the wrapped encoder
    delta (ref: DiffDrive::updateOdometry diff_drive.cpp:97-150).
    """
    dul = normalize_angle_pi(left - state.left)
    dur = normalize_angle_pi(right - state.right)
    wheel_vel = jnp.stack([dul, dur], axis=-1)
    vb = wheels_to_twist(params, wheel_vel)
    new_pose = se2.integrate_twist(state.pose, vb)
    new_pose = new_pose.at[..., 0].set(normalize_angle_pi(new_pose[..., 0]))
    new_state = DiffDriveState(
        pose=new_pose,
        left=normalize_angle_pi(left),
        right=normalize_angle_pi(right),
        ul=dul, ur=dur,
    )
    return new_state, wheel_vel


def feedforward(params: DiffDriveParams, state: DiffDriveState, cmd):
    """Propagate a commanded body twist for one time-unit, advancing the
    simulated encoders (ref: DiffDrive::feedforward diff_drive.cpp:153-195).

    ``cmd`` is [w, vx, vy=0] already scaled by the caller's dt (the
    reference's fake_diff_encoders node scales by 1/frequency,
    fake_diff_encoders_node.cpp:107-110).
    """
    wheel_vel = twist_to_wheels(params, cmd)
    ul, ur = wheel_vel[..., 0], wheel_vel[..., 1]
    new_pose = se2.integrate_twist(state.pose, cmd)
    new_pose = new_pose.at[..., 0].set(normalize_angle_pi(new_pose[..., 0]))
    return DiffDriveState(
        pose=new_pose,
        left=normalize_angle_pi(state.left + ul),
        right=normalize_angle_pi(state.right + ur),
        ul=normalize_angle_pi(ul),
        ur=normalize_angle_pi(ur),
    )


def pose(state: DiffDriveState):
    """Current pose with wrapped heading (ref: DiffDrive::pose
    diff_drive.cpp:198-206)."""
    p = state.pose
    return p.at[..., 0].set(normalize_angle_pi(p[..., 0]))


def reset(state: DiffDriveState, theta, x, y) -> DiffDriveState:
    """Reset pose, keep encoders (ref: DiffDrive::reset diff_drive.cpp:221-234
    — note the reference deliberately does NOT clear encoders)."""
    return state._replace(pose=se2.make(theta, x, y))
