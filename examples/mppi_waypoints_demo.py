"""End-to-end demo: MPPI waypoint following with a simulated diff-drive plant.

Equivalent of `roslaunch nuturtle_robot mppi_waypoints.launch`
(ref: nuturtle_robot/src/mppi_waypoints_node.cpp): controller, fake-encoder
plant, odometer, AND the waypoint manager collapse into one device program
(tpunav.control.waypoint_loop) — the host syncs once per chunk of 240
ticks for progress reporting, not once per tick. Runs the course twice:
with the XLA solve at K=1,024 and with the fused Pallas kernel at
K=4,096 (the kernel needs a GPU).
"""

import os
import time

import jax

from tpunav.runtime import cache as _cache
_cache.enable()
import jax.numpy as jnp
import numpy as np

from tpunav.control.waypoint_loop import (
    CourseConfig,
    course_init,
    run_course_chunked,
)
from tpunav.models.cart import CartParams
from tpunav.runtime.config import (
    load_mppi_config,
    load_robot_config,
    load_waypoints,
)

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def run(use_fused: bool, rollouts: int):
    # Reference-schema yaml configs (same keys as the C++ stack's files;
    # overrides play the role of per-node <param> tags). Accelerator-scale
    # overrides: H=0.5 s, K=1024+ instead of the CPU reference's K=5.
    cfg = load_mppi_config(os.path.join(CONFIGS, "mppi_params.yaml"),
                           horizon=0.5, rollouts=rollouts)
    robot = load_robot_config(os.path.join(CONFIGS, "diff_params.yaml"))
    cart = CartParams(robot.wheel_radius, robot.wheel_base)
    course = CourseConfig(goal_thresh=0.1, tick_dt=1.0 / 60.0,
                          max_ticks=20_000, use_fused=use_fused)
    waypoints = jnp.asarray(
        load_waypoints(os.path.join(CONFIGS, "real_waypoints.yaml")),
        jnp.float32)

    name = "fused-kernel" if use_fused else "xla"
    print(f"--- solver={name} K={rollouts} ---")
    st = course_init(cfg, jnp.zeros(3), seed=0)

    last = {"visits": 0, "t_first": None}
    stream = []        # per-tick telemetry chunks (the PoseError stream)
    t0 = time.time()

    def report(st, tel):
        if last["t_first"] is None:
            last["t_first"] = time.time()   # first chunk done → compiled
        stream.append(jax.device_get(tel))
        v = int(st.visits)
        if v != last["visits"]:
            pose = np.asarray(st.pose)
            print(f"  visited {v}/{len(waypoints)} waypoints "
                  f"(tick {int(st.ticks)}, pose [{pose[0]:.3f} "
                  f"{pose[1]:.3f} {pose[2]:.3f}])")
            last["visits"] = v

    st = run_course_chunked(cfg, course, cart, waypoints, st,
                            chunk=240, on_chunk=report)
    wall = time.time() - t0
    steady = time.time() - last["t_first"]
    ticks = int(st.ticks)
    sim_t = ticks / 60.0
    steady_ticks = max(ticks - 240, 1)
    print(f"course {'done' if bool(st.done) else 'INCOMPLETE'}: "
          f"{ticks} ticks ({sim_t:.1f} s of 60 Hz control), K={cfg.rollouts}")
    print(f"  total {wall:.1f} s wall (first chunk incl. compile "
          f"{wall - steady:.1f} s); steady state "
          f"{steady_ticks / steady:.0f} solves/s = "
          f"{steady_ticks / 60.0 / steady:.1f}x real time")

    # Per-tick observability stream → time-series plot (the reference's
    # rqt_plot of PoseError, tsim/launch/trect.launch:18-21).
    from tpunav.viz import plot_series
    d2g = np.concatenate([c["d2g"] for c in stream])[:ticks]
    widx = np.concatenate([c["wpt_idx"] for c in stream])[:ticks]
    out = plot_series(
        {"distance to active waypoint [m]": d2g,
         "active waypoint index": widx},
        [("m", ["distance to active waypoint [m]"]),
         ("idx", ["active waypoint index"])],
        os.path.join(os.path.dirname(__file__), "out",
                     f"mppi_waypoints_{name}_timeseries.png"),
        title=f"MPPI waypoint course ({name}, K={cfg.rollouts})")
    if out:
        print(f"  wrote {out}")


def main():
    print(f"devices: {jax.devices()}")
    run(use_fused=False, rollouts=1024)
    # The flagship config: the fused Pallas kernel in the loop.
    run(use_fused=True, rollouts=4096)


if __name__ == "__main__":
    main()
