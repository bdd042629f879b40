"""Device-resident waypoint-following control loop.

The reference's mppi_waypoints node checks distance-to-goal and advances
the waypoint index on the HOST every tick
(ref: nuturtle_robot/src/mppi_waypoints_node.cpp:231-258), which is free
on a CPU process but costs a host↔device round trip per tick on an
accelerator. Here the waypoint manager is itself traced state — index,
cycle counter, done flag — advanced with ``lax`` ops inside the jitted
tick, so an entire waypoint course runs as ONE device program
(`run_course`: lax.while_loop over fused solve→plant→advance ticks) with
a single host sync at the end.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..models.cart import CartParams, kinematic_cart
from ..ops.pallas_mppi import mppi_solve_fused
from ..ops.rk4 import rk4_step
from ..sim.motor import MotorParams, track
from .mppi import MPPIConfig, init_controls, mppi_solve


@dataclasses.dataclass(frozen=True)
class CourseConfig:
    """Waypoint-cycling semantics (ref: mppi_waypoints_node.cpp:137-170,
    231-258)."""

    goal_thresh: float = 0.1
    cycles: int = 1              # full passes through the list, then stop
    tick_dt: float = 1.0 / 60.0  # plant update rate (fake encoders, 60 Hz)
    max_ticks: int = 100_000
    # Solver: False = XLA mppi_solve; True = the fused Pallas kernel
    # (ops/pallas_mppi.py). Both draw the same noise from the course key.
    use_fused: bool = False
    # Plant motor dynamics (ref: the Gazebo plugin's torque-capped
    # velocity targets, turtle_drive_plugin.cpp:226-232). Default τ=0 =
    # ideal tracking, the pure-kinematic legacy plant.
    motor: MotorParams = MotorParams()


class CourseState(NamedTuple):
    pose: jnp.ndarray       # (3,) [x, y, theta]
    u: jnp.ndarray          # (N, 2) nominal controls
    key: jnp.ndarray
    wpt_idx: jnp.ndarray    # int32
    visits: jnp.ndarray     # int32 — waypoints reached so far
    ticks: jnp.ndarray      # int32
    done: jnp.ndarray       # bool
    wheel_vel: jnp.ndarray  # (2,) actual wheel velocities (motor state)


def course_init(cfg: MPPIConfig, pose, seed: int = 0) -> CourseState:
    pose = jnp.asarray(pose, jnp.float32)
    return CourseState(
        pose=pose, u=init_controls(cfg), key=jax.random.PRNGKey(seed),
        wpt_idx=jnp.asarray(0, jnp.int32),
        visits=jnp.asarray(0, jnp.int32),
        ticks=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
        wheel_vel=jnp.zeros(2, jnp.float32))


def course_tick(cfg: MPPIConfig, course: CourseConfig, model: CartParams,
                waypoints, st: CourseState, extra_cost=None,
                obstacles=None, obs_cfg=None) -> CourseState:
    """One fused control tick: waypoint advance → MPPI solve → plant step.

    ``waypoints``: (W, 3) device array of [x, y, theta] targets.
    All branching is lax — no host sync. With ``course.use_fused`` the
    solve is the single Pallas kernel; ``obstacles``/``obs_cfg`` add the
    in-kernel primitive obstacle cost (fused path) — on the XLA path pass
    ``extra_cost`` instead.
    """
    if course.use_fused and extra_cost is not None:
        raise ValueError(
            "extra_cost is XLA-path only; with use_fused=True pass the "
            "in-kernel obstacles/obs_cfg instead (advisor r2 fix: the "
            "flag must not silently drop a cost term)")
    if not course.use_fused and (obstacles is not None or
                                 obs_cfg is not None):
        raise ValueError(
            "obstacles/obs_cfg are fused-kernel only; with "
            "use_fused=False pass extra_cost "
            "(control/obstacle_cost.py:make_segment_obstacle_cost)")
    n_wpts = waypoints.shape[0]
    wpt = waypoints[st.wpt_idx]
    d2g = jnp.hypot(st.pose[0] - wpt[0], st.pose[1] - wpt[1])

    # Advance on arrival; cyclic with a total-visit stop
    # (ref: :231-258 — one full cycle then halt).
    arrived = d2g < course.goal_thresh
    visits = st.visits + arrived.astype(jnp.int32)
    wpt_idx = jnp.where(arrived, (st.wpt_idx + 1) % n_wpts, st.wpt_idx)
    done = jnp.logical_or(st.done, visits >= course.cycles * n_wpts)
    wpt = waypoints[wpt_idx]

    key, sub = jax.random.split(st.key)
    if course.use_fused:
        cmd, u = mppi_solve_fused(cfg, model, st.u, sub, st.pose, wpt,
                                  obstacles=obstacles, obs_cfg=obs_cfg)
    else:
        cmd, u = mppi_solve(cfg, model, st.u, sub, st.pose, wpt, extra_cost)
    cmd = jnp.where(done, jnp.zeros_like(cmd), cmd)

    # Motor dynamics between command and plant (τ=0 → wheel_vel == cmd).
    wheel_vel = track(course.motor, st.wheel_vel, cmd, course.tick_dt)
    f = lambda x, uu: kinematic_cart(model, x, uu)
    pose = rk4_step(f, st.pose, wheel_vel, course.tick_dt)
    pose = jnp.where(done, st.pose, pose)

    return CourseState(pose=pose, u=u, key=key, wpt_idx=wpt_idx,
                       visits=visits, ticks=st.ticks + 1, done=done,
                       wheel_vel=jnp.where(done, st.wheel_vel, wheel_vel))


def run_course(cfg: MPPIConfig, course: CourseConfig, model: CartParams,
               waypoints, st: CourseState, extra_cost=None,
               obstacles=None, obs_cfg=None) -> CourseState:
    """Run ticks until the course completes (or max_ticks) as ONE device
    program — zero host round-trips mid-course."""
    waypoints = jnp.asarray(waypoints, jnp.float32)

    def cond(st):
        return jnp.logical_and(~st.done, st.ticks < course.max_ticks)

    def body(st):
        return course_tick(cfg, course, model, waypoints, st, extra_cost,
                           obstacles, obs_cfg)

    return jax.lax.while_loop(cond, body, st)


def run_course_chunked(cfg: MPPIConfig, course: CourseConfig,
                      model: CartParams, waypoints, st: CourseState,
                      chunk: int = 120, extra_cost=None,
                      obstacles=None, obs_cfg=None,
                      on_chunk=None) -> CourseState:
    """Like :func:`run_course` but syncs to the host every ``chunk`` ticks
    (for progress reporting / trajectory logging) — the closed-loop analog
    of the reference's rviz path + PoseError publishing.
    ``on_chunk(state, telemetry)`` is called with each synced state;
    ``telemetry`` is a dict of per-tick device arrays {"pose": (chunk,3),
    "wpt_idx": (chunk,), "d2g": (chunk,)} — the metrics stream the
    reference pushes over topics into rqt_plot
    (tsim/launch/trect.launch:18-21). Telemetry rows are PRE-tick
    samples: row i is the state course_tick i saw, so the stream starts
    at the initial state and the final post-tick pose is only in the
    returned ``st.pose``, never in a chunk."""
    waypoints = jnp.asarray(waypoints, jnp.float32)

    @jax.jit
    def run_chunk(st):
        def body(st, _):
            wpt = waypoints[st.wpt_idx]
            d2g = jnp.hypot(st.pose[0] - wpt[0], st.pose[1] - wpt[1])
            tel = {"pose": st.pose, "wpt_idx": st.wpt_idx, "d2g": d2g}
            return course_tick(cfg, course, model, waypoints, st,
                               extra_cost, obstacles, obs_cfg), tel
        return jax.lax.scan(body, st, None, length=chunk)

    while True:
        st, tel = run_chunk(st)
        if on_chunk is not None:
            on_chunk(st, tel)
        if bool(st.done) or int(st.ticks) >= course.max_ticks:
            return st
