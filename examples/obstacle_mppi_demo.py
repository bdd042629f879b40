"""BASELINE config 2 on the FUSED path: obstacle-aware MPPI at K=4096,
H=50, with the obstacle cost evaluated inside the Pallas kernel.

Architecture mirrors the reference stack (global planner feeds the local
controller): Theta* on a PRM routes around a wall
(ref: planner/src/prm_planner.cpp Theta* shortcut :110-143), and the MPPI
rollouts price clearance against the same obstacle primitives in-register
(ops/pallas_mppi.py) — no grid ESDF, no gathers; rollouts and costs in
one kernel.
The whole course runs device-resident (control/waypoint_loop.py).
"""

import time

import jax

from tpunav.runtime import cache as _cache
_cache.enable()
import jax.numpy as jnp
import numpy as np

from tpunav.control.mppi import MPPIConfig
from tpunav.control.obstacle_cost import (SegmentCostParams,
                                          segments_from_polygons)
from tpunav.control.waypoint_loop import (CourseConfig, course_init,
                                          run_course_chunked)
from tpunav.models.cart import CartParams
from tpunav.planning import RoadMap, load_obstacle_map, theta_star

MODEL = CartParams(0.033, 0.160)
WALL = [[[0.95, 0.7], [1.05, 0.7], [1.05, 1.3], [0.95, 1.3]]]
START, GOAL = [0.2, 1.0], [1.8, 1.0]


def main():
    print("devices:", jax.devices())
    world = load_obstacle_map(WALL, bounds=[[0.0, 2.0], [0.0, 2.0]],
                              resolution=0.05)
    rm = RoadMap(world, n_nodes=80, k_neighbors=10, clearance=0.18, seed=2)
    s_idx, g_idx = rm.add_node(START), rm.add_node(GOAL)
    route = theta_star(rm, s_idx, g_idx)   # (M, 2) node positions
    assert route is not None
    wpts = np.asarray(route, np.float32)[1:]   # skip the start node
    waypoints = jnp.asarray(np.concatenate(
        [wpts, np.zeros((len(wpts), 1), np.float32)], axis=1))
    print(f"theta* route: {[f'({p[0]:.2f},{p[1]:.2f})' for p in wpts]}")

    segs = segments_from_polygons(WALL)
    # Sharp field (sigma=0.05): strong inside ~15 cm of the wall, negligible
    # at the Theta* route's 0.2 m clearance — otherwise the field gradient
    # balances the LQR pull and the course stalls short of waypoints.
    obs_cfg = SegmentCostParams(r_safe=0.1, w_hit=1e7, w_field=2e3,
                                sigma=0.05)
    cfg = MPPIConfig(horizon=0.5, dt=0.01, rollouts=4096)  # H=50 steps
    course = CourseConfig(goal_thresh=0.1, tick_dt=1.0 / 60.0,
                          max_ticks=20_000, use_fused=True)

    st = course_init(cfg, jnp.asarray([START[0], START[1], 0.0]), seed=0)
    min_clear = {"d": np.inf}
    t0 = time.time()

    def report(st, tel):
        # Closest approach of the executed trajectory to the wall.
        p = np.asarray(tel["pose"])
        dx = np.clip(p[:, 0], 0.95, 1.05) - p[:, 0]
        dy = np.clip(p[:, 1], 0.7, 1.3) - p[:, 1]
        d = np.hypot(dx, dy)
        inside = (np.abs(p[:, 0] - 1.0) < 0.05) & \
            (np.abs(p[:, 1] - 1.0) < 0.3)
        d[inside] = 0.0
        min_clear["d"] = min(min_clear["d"], float(d.min()))

    st = run_course_chunked(cfg, course, MODEL, waypoints, st, chunk=240,
                            obstacles=segs, obs_cfg=obs_cfg,
                            on_chunk=report)
    wall_t = time.time() - t0
    pose = np.asarray(st.pose)
    ticks = int(st.ticks)
    print(f"course {'done' if bool(st.done) else 'INCOMPLETE'} in {ticks} "
          f"ticks ({wall_t:.1f}s wall, K={cfg.rollouts}, H={cfg.steps}, "
          f"in-kernel obstacle cost, {len(np.asarray(segs))} primitives)")
    print(f"final pose [{pose[0]:.3f} {pose[1]:.3f}], goal {GOAL}; "
          f"min wall clearance {min_clear['d'] * 100:.1f} cm")
    assert bool(st.done), "goal not reached"
    assert min_clear["d"] > 0.05, "trajectory scraped the wall"


if __name__ == "__main__":
    main()
