"""SLAM-in-the-loop MPPI: the full estimate→plan→act stack as ONE device
program.

Equivalent of the reference's flagship multi-node deployment —
`roslaunch nuslam slam.launch` feeding `mppi_waypoints`
(ref: nuslam/src/slam_node.cpp + nuturtle_robot/src/mppi_waypoints_node.cpp)
— where the EKF pose estimate, not ground truth, closes the control loop.
In the reference this is five OS processes exchanging ROS messages; here
every tick (MPPI solve → plant step → odometry → EKF SLAM update) is
traced state inside a single `lax.scan`, so an entire closed-loop course
costs one host↔device round trip.

The EKF runs at the control rate: off-schedule ticks simply carry all-NaN
measurements, which the filter's validity masking skips (the same
mechanism the reference uses for out-of-visibility landmarks,
nuslam/src/analysis_node.cpp:140-166) — "state estimation feeding the
controller at loop rate" with zero special-casing.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..estimation.ekf import filter as ekff
from ..estimation.ekf.filter import (EKFConfig, EKFState, ekf_init,
                                     known_correspondence_slam, robot_pose,
                                     slam_unknown_da)
from ..models.cart import CartParams, kinematic_cart
from ..ops.pallas_mppi import mppi_solve_fused
from ..ops.rk4 import rk4_step
from .mppi import MPPIConfig, init_controls, mppi_solve


@dataclasses.dataclass(frozen=True)
class SlamLoopConfig:
    """Closed-loop wiring (sensor schedule, noise injection, course
    semantics). Noise values mirror the reference's analysis-node fault
    injection (nuslam/launch/landmarks.launch:43-50)."""

    goal_thresh: float = 0.1
    cycles: int = 1
    tick_dt: float = 1.0 / 60.0
    sensor_every: int = 6             # landmark frames every k-th tick
    visibility: float = 1.2           # sensor range gate (NaN outside)
    meas_noise_std: float = 1e-4
    odom_bias: Tuple[float, float] = (1e-3, 5e-4)   # per-tick (w, vx) bias
    known_da: bool = True
    # Solver, mirroring CourseConfig: False = XLA mppi_solve; True = the
    # fused Pallas kernel. Both draw the same noise from k_solve.
    use_fused: bool = False


class SlamLoopState(NamedTuple):
    true_pose: jnp.ndarray   # (3,) [x, y, theta] — plant ground truth
    odom: jnp.ndarray        # (3,) [theta, x, y] — dead-reckoning path
    ekf: EKFState            # the filter (pose estimate feeds MPPI)
    u: jnp.ndarray           # (N, 2) nominal controls
    key: jnp.ndarray
    wpt_idx: jnp.ndarray
    visits: jnp.ndarray
    ticks: jnp.ndarray
    done: jnp.ndarray


def slam_loop_init(mppi_cfg: MPPIConfig, ekf_cfg: EKFConfig, pose_xyt=None,
                   seed: int = 0) -> SlamLoopState:
    pose = (jnp.zeros(3, jnp.float32) if pose_xyt is None
            else jnp.asarray(pose_xyt, jnp.float32))
    odom = jnp.stack([pose[2], pose[0], pose[1]])
    ekf = ekf_init(ekf_cfg, dtype=jnp.float32)
    ekf = ekf._replace(state=ekf.state.at[:3].set(odom))
    return SlamLoopState(
        true_pose=pose, odom=odom, ekf=ekf,
        u=init_controls(mppi_cfg), key=jax.random.PRNGKey(seed),
        wpt_idx=jnp.asarray(0, jnp.int32),
        visits=jnp.asarray(0, jnp.int32),
        ticks=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False))


def slam_loop_tick(mppi_cfg: MPPIConfig, ekf_cfg: EKFConfig,
                   cfg: SlamLoopConfig, model: CartParams, waypoints,
                   landmarks, st: SlamLoopState,
                   meas_fn=None) -> SlamLoopState:
    """One fused tick: EKF pose → waypoint advance → MPPI solve → plant →
    noisy odometry → EKF SLAM update.

    ``meas_fn(true_pose_txy, key) -> (M, 2)`` overrides the measurement
    source (default: the oracle landmark sensor). The dense-world demo
    passes the full lidar → circle-detector chain here, making the same
    fused tick run the reference's non-debug perception pipeline
    (ref: nuslam/src/landmarks_node.cpp feeding slam_node.cpp)."""
    from ..sim.landmark_sensor import landmark_measurements

    slam_step = (known_correspondence_slam if cfg.known_da
                 else slam_unknown_da)
    n_wpts = waypoints.shape[0]

    # Controller sees the FILTER's pose (ref: mppi_waypoints consumes the
    # odometer/slam estimate, never gazebo truth).
    est_txy = robot_pose(st.ekf)                       # [theta, x, y]
    est_xyt = jnp.stack([est_txy[1], est_txy[2], est_txy[0]])

    wpt = waypoints[st.wpt_idx]
    d2g = jnp.hypot(est_xyt[0] - wpt[0], est_xyt[1] - wpt[1])
    arrived = d2g < cfg.goal_thresh
    visits = st.visits + arrived.astype(jnp.int32)
    wpt_idx = jnp.where(arrived, (st.wpt_idx + 1) % n_wpts, st.wpt_idx)
    done = jnp.logical_or(st.done, visits >= cfg.cycles * n_wpts)
    wpt = waypoints[wpt_idx]

    key, k_solve, k_meas, k_sense = jax.random.split(st.key, 4)
    solve = mppi_solve_fused if cfg.use_fused else mppi_solve
    cmd, u = solve(mppi_cfg, model, st.u, k_solve, est_xyt, wpt)
    cmd = jnp.where(done, jnp.zeros_like(cmd), cmd)

    # True plant (ref: fake encoders + odometer chain).
    f = lambda x, uu: kinematic_cart(model, x, uu)
    true_pose = rk4_step(f, st.true_pose, cmd, cfg.tick_dt)
    true_pose = jnp.where(done, st.true_pose, true_pose)

    # Biased body displacement over the tick — what odometry reports.
    w_body = (model.wheel_radius / model.wheel_base) * (cmd[1] - cmd[0])
    v_body = 0.5 * model.wheel_radius * (cmd[0] + cmd[1])
    u_odom = jnp.stack([w_body * cfg.tick_dt + cfg.odom_bias[0],
                        v_body * cfg.tick_dt + cfg.odom_bias[1]])
    u_odom = jnp.where(done, jnp.zeros_like(u_odom), u_odom)

    odom = ekff.motion_update(
        ekf_cfg, jnp.concatenate([st.odom, jnp.zeros_like(st.ekf.state[3:])]),
        u_odom, jnp.zeros(3, st.odom.dtype))[:3]

    # Landmark frame on schedule; NaN rows off-schedule (filter skips).
    true_txy = jnp.stack([true_pose[2], true_pose[0], true_pose[1]])
    if meas_fn is None:
        meas = landmark_measurements(landmarks, true_txy, cfg.visibility,
                                     key=k_meas, noise_std=cfg.meas_noise_std)
    else:
        meas = meas_fn(true_txy, k_meas)
    sense = (st.ticks % cfg.sensor_every) == 0
    meas = jnp.where(sense, meas, jnp.nan)
    ekf = slam_step(ekf_cfg, st.ekf, meas, u_odom)

    return SlamLoopState(true_pose=true_pose, odom=odom, ekf=ekf, u=u,
                         key=key, wpt_idx=wpt_idx, visits=visits,
                         ticks=st.ticks + 1, done=done)


def run_slam_loop(mppi_cfg: MPPIConfig, ekf_cfg: EKFConfig,
                  cfg: SlamLoopConfig, model: CartParams, waypoints,
                  landmarks, st: SlamLoopState,
                  max_ticks: int) -> SlamLoopState:
    """Run the closed loop to completion (or ``max_ticks``) as one device
    program."""
    waypoints = jnp.asarray(waypoints, jnp.float32)
    landmarks = jnp.asarray(landmarks, jnp.float32)

    def cond(s):
        return jnp.logical_and(~s.done, s.ticks < max_ticks)

    def body(s):
        return slam_loop_tick(mppi_cfg, ekf_cfg, cfg, model, waypoints,
                              landmarks, s)

    return jax.lax.while_loop(cond, body, st)
