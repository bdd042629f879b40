"""Flagship full-stack run: RBPF mapping → D* Lite replanning → fused
MPPI control, one closed loop through initially-unknown obstacles.

The reference runs these as SEPARATE launches (mapping:
bmapping/launch/slam.launch; global planning on a static yaml world:
planner/src/grid_planner_node.cpp:217-264 with a SIMULATED truth reveal;
local control: nuturtle_robot mppi_waypoints.launch). Here they are one
integrated stack: every scan interval the particle filter refines
pose+map from lidar on drifting odometry, the best particle's occupancy
grid (inflated) feeds D* Lite's belief — the planner's "sensor" is the
live SLAM map, not a scripted reveal — and the fused-kernel MPPI
controller chases a lookahead point on the replanned path. The robot
must discover a barrier blocking the straight route and drive around it
through a gap it has never seen on any prior map.

Run: python examples/full_stack_demo.py  (GPU; ~150 scan intervals)
"""

from __future__ import annotations

import os
import time

import jax

try:
    from tpunav.runtime import cache as _cache
    _cache.enable()
except ImportError:  # pragma: no cover - direct script execution
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tpunav.runtime import cache as _cache
    _cache.enable()

import jax.numpy as jnp
import numpy as np

from tpunav.control.mppi import MPPIConfig, init_controls
from tpunav.core.angles import normalize_angle_pi
from tpunav.estimation.rbpf import (GridConfig, PFConfig, best_particle,
                                    pf_init, pf_slam_step)
from tpunav.estimation.rbpf.icp import ICPConfig
from tpunav.models.cart import CartParams, kinematic_cart
from tpunav.ops.pallas_mppi import mppi_solve_fused
from tpunav.control.mppi import mppi_solve
from tpunav.ops.rk4 import rk4_step
from tpunav.planning.grid_map import FREE, OBSTACLE
from tpunav.planning.dstar import dstar_from_labels
from tpunav.sim.lidar import scan_segments

MODEL = CartParams(0.033, 0.160)


def make_world(dtype=jnp.float32):
    """Box arena with an unknown interior barrier: a wall across the
    middle with one gap near the top — the direct start→goal line is
    blocked."""
    segs = [
        [-1.8, -1.8, 1.8, -1.8], [1.8, -1.8, 1.8, 1.8],
        [1.8, 1.8, -1.8, 1.8], [-1.8, 1.8, -1.8, -1.8],
        # Barrier x=0 from y=-1.8 up to y=0.9 (gap 0.9..1.8).
        [0.0, -1.8, 0.0, 0.9],
    ]
    return jnp.asarray(segs, dtype)


def occupancy_to_labels(grid_cfg: GridConfig, log_odds: np.ndarray,
                        inflate_cells: int = 3) -> np.ndarray:
    """Best-particle log-odds → D* planning labels: occupied cells become
    OBSTACLE, dilated by the robot radius (the reference's C-space
    inflation, planner/src/planner/grid_map.cpp:225-437)."""
    occ = np.asarray(log_odds >= grid_cfg.l_occ)
    if inflate_cells > 0:
        h, w = occ.shape
        pad = np.zeros((h + 2 * inflate_cells, w + 2 * inflate_cells),
                       bool)
        pad[inflate_cells:-inflate_cells, inflate_cells:-inflate_cells] = occ
        acc = np.zeros_like(occ)
        for dy in range(2 * inflate_cells + 1):
            for dx in range(2 * inflate_cells + 1):
                acc |= pad[dy:dy + h, dx:dx + w]
        occ = acc
    labels = np.full(occ.shape, FREE, np.int8)
    labels[occ] = OBSTACLE
    return labels


def run(num_particles=500, max_scans=220, ticks_per_scan=12,
        use_fused=True, seed=5, verbose=True):
    """``use_fused`` picks the Pallas kernel solve (a GPU's compiled
    Triton kernel) over the XLA ``mppi_solve``; both draw the same
    noise."""
    grid_cfg = GridConfig()
    # Wider proposal spread than the exploration demo: the course crosses
    # the full arena on drifting odometry, so the Gaussian proposal needs
    # cm-scale sample diversity for the scan/pose likelihoods to pull the
    # particle cloud back toward the map.
    pf_cfg = PFConfig(num_particles=num_particles, k_samples=50,
                      sample_range=(3e-5, 3e-4, 3e-4),
                      motion_noise=(1e-5, 1e-4, 1e-4),
                      grid=grid_cfg, icp=ICPConfig(max_iter=25))
    mppi_cfg = MPPIConfig(horizon=0.5, dt=0.01,
                          rollouts=2048 if use_fused else 256)
    segs = make_world()
    tick_dt = 1.0 / 60.0
    wheel_bias = jnp.asarray([1.03, 1.0], jnp.float32)   # odometry drift

    start_xy = (-1.2, -1.2)
    goal_xy = (1.2, -0.9)        # straight line crosses the barrier

    @jax.jit
    def control_chunk(true_pose, odom_pose, slam_pose, u, target, tick):
        """ticks_per_scan MPPI ticks chasing `target`, controller fed the
        SLAM pose corrected by the odometry increment since the last
        update (the reference's map->odom * odom->base chain,
        slam_node.cpp:306-339)."""

        def one(t, c):
            true_pose, odom_pose, slam_pose, u = c
            pose_xyt = jnp.stack([slam_pose[1], slam_pose[2], slam_pose[0]])
            key = jax.random.fold_in(
                jax.random.fold_in(jax.random.PRNGKey(seed), tick), t)
            solve = mppi_solve_fused if use_fused else mppi_solve
            cmd, u = solve(mppi_cfg, MODEL, u, key, pose_xyt, target)
            f = lambda x, uu: kinematic_cart(MODEL, x, uu)

            def step_pose(p, c_):
                xyt = jnp.stack([p[1], p[2], p[0]])
                xyt = rk4_step(f, xyt, c_, tick_dt)
                return jnp.stack([xyt[2], xyt[0], xyt[1]])

            true_pose = step_pose(true_pose, cmd)
            odom_pose = step_pose(odom_pose, cmd * wheel_bias)
            slam_pose = step_pose(slam_pose, cmd * wheel_bias)
            return true_pose, odom_pose, slam_pose, u

        return jax.lax.fori_loop(0, ticks_per_scan, one,
                                 (true_pose, odom_pose, slam_pose, u))

    @jax.jit
    def sense(true_pose, tick):
        key = jax.random.fold_in(jax.random.PRNGKey(97), tick)
        return scan_segments(true_pose, segs, num_beams=grid_cfg.num_beams,
                             max_range=grid_cfg.range_max, key=key,
                             noise_std=0.002)

    @jax.jit
    def slam_update(pf, scan, cur_odom, prev_odom):
        dth = normalize_angle_pi(cur_odom[0] - prev_odom[0])
        c, s = jnp.cos(prev_odom[0]), jnp.sin(prev_odom[0])
        dx = cur_odom[1] - prev_odom[1]
        dy = cur_odom[2] - prev_odom[2]
        u_body = jnp.stack([dth, c * dx + s * dy])
        pf = pf_slam_step(pf_cfg, pf, scan, u_body, cur_odom, prev_odom)
        pose, grid = best_particle(pf)
        return pf, pose, grid

    # ── Init ──
    pose0 = jnp.asarray([0.8, start_xy[0], start_xy[1]], jnp.float32)
    true_pose = pose0
    odom_pose = pose0
    slam_pose = pose0
    pf = pf_init(pf_cfg, pose=pose0, seed=seed)
    u = init_controls(mppi_cfg)

    h, w = grid_cfg.height, grid_cfg.width

    def cell_of(xy):
        ix = int(np.clip((xy[0] - grid_cfg.xmin) / grid_cfg.resolution,
                         0, w - 1))
        iy = int(np.clip((xy[1] - grid_cfg.ymin) / grid_cfg.resolution,
                         0, h - 1))
        return (iy, ix)

    planner = dstar_from_labels(np.full((h, w), FREE, np.int8),
                                cell_of(start_xy), cell_of(goal_xy))
    planner.compute_shortest_path()

    lookahead = 8     # cells (~0.4 m) ahead on the D* path
    trail_true, trail_slam, trail_plan = [], [], []
    stream = []       # per-scan metrics (goal dist, SLAM err, plan len)
    t0 = time.time()
    reached = False
    for tick_i in range(max_scans):
        tick = jnp.asarray(tick_i, jnp.int32)
        slam_np = np.asarray(slam_pose)

        # D* belief ← live SLAM map; replan; lookahead target.
        planner.pos = cell_of((slam_np[1], slam_np[2]))
        if planner.pos == planner.goal or (
                np.hypot(slam_np[1] - goal_xy[0],
                         slam_np[2] - goal_xy[1]) < 0.15):
            reached = True
            break
        path = planner.path_to_goal()
        if len(path) > 1:
            tgt_cell = path[min(lookahead, len(path) - 1)]
            tx = grid_cfg.xmin + (tgt_cell[1] + 0.5) * grid_cfg.resolution
            ty = grid_cfg.ymin + (tgt_cell[0] + 0.5) * grid_cfg.resolution
        else:
            tx, ty = goal_xy
        target = jnp.asarray([tx, ty, 0.0], jnp.float32)
        trail_plan.append((tx, ty))

        prev_odom = odom_pose
        true_pose, odom_pose, slam_pose, u = control_chunk(
            true_pose, odom_pose, slam_pose, u, target, tick)
        scan = sense(true_pose, tick)
        pf, slam_pose, grid_best = slam_update(pf, scan, odom_pose,
                                               prev_odom)

        # Feed the planner the fresh map (host-side labels diff).
        labels = occupancy_to_labels(grid_cfg, np.asarray(grid_best))
        labels[planner.goal] = FREE   # goal itself never inflated shut
        planner.observe(labels)

        trail_true.append(np.asarray(true_pose))
        trail_slam.append(np.asarray(slam_pose))
        tp, sp = np.asarray(true_pose), np.asarray(slam_pose)
        stream.append((np.hypot(tp[1] - goal_xy[0], tp[2] - goal_xy[1]),
                       np.hypot(*(sp[1:] - tp[1:])),
                       len(path)))
        if verbose and tick_i % 20 == 0:
            print(f"scan {tick_i:3d}: slam=({slam_np[1]:+.2f},"
                  f"{slam_np[2]:+.2f}) target=({tx:+.2f},{ty:+.2f})",
                  flush=True)

    wall = time.time() - t0
    true_np = np.asarray(true_pose)
    final_err = np.hypot(true_np[1] - goal_xy[0], true_np[2] - goal_xy[1])
    out = {
        "reached": reached, "scans": tick_i + 1, "wall_s": wall,
        "final_goal_err_m": float(final_err),
        "slam_vs_true_m": float(np.hypot(
            *(np.asarray(slam_pose)[1:] - true_np[1:]))),
        "trail_true": np.asarray(trail_true),
        "trail_slam": np.asarray(trail_slam),
        "grid": np.asarray(best_particle(pf)[1]),
        "planner": planner,
        "stream": np.asarray(stream),
    }
    return out


def plot(out, grid_cfg=GridConfig(), path=None):
    path = path or os.path.join(os.path.dirname(__file__), "out",
                                "full_stack_demo.png")
    from tpunav.viz import pyplot

    plt = pyplot()
    if plt is None:
        print(f"matplotlib is not installed; {path} not written")
        return
    fig, ax = plt.subplots(figsize=(6, 6))
    occ = out["grid"] >= grid_cfg.l_occ
    ax.imshow(occ, origin="lower", cmap="Greys",
              extent=[grid_cfg.xmin, grid_cfg.xmax, grid_cfg.ymin,
                      grid_cfg.ymax], alpha=0.8)
    tt = out["trail_true"]
    ts = out["trail_slam"]
    ax.plot(tt[:, 1], tt[:, 2], "g-", lw=1.5, label="true path")
    ax.plot(ts[:, 1], ts[:, 2], "b--", lw=1.0, label="SLAM estimate")
    # Robot model at the final pose (rviz RobotModel replacement —
    # tpunav/robot_model.py mirrors the reference URDF).
    from tpunav.viz import draw_robot
    draw_robot(tt[-1], ax=ax)
    ax.plot([-1.2], [-1.2], "go", ms=8)
    ax.plot([1.2], [-0.9], "r*", ms=14, label="goal")
    ax.legend(loc="upper left", fontsize=8)
    ax.set_title("RBPF map -> D* Lite replanning -> MPPI (one loop)")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    print(f"wrote {path}")


def main():
    print("devices:", jax.devices(), flush=True)
    out = run()
    print(f"reached={out['reached']} in {out['scans']} scans "
          f"({out['wall_s']:.1f}s wall); final goal error "
          f"{out['final_goal_err_m'] * 100:.1f} cm; SLAM-vs-true "
          f"{out['slam_vs_true_m'] * 100:.1f} cm", flush=True)
    plot(out)
    # Per-scan observability stream (rqt_plot analog).
    from tpunav.viz import plot_series
    s = out["stream"]
    ts = plot_series(
        {"distance to goal [m]": s[:, 0],
         "SLAM-vs-true |xy| err [cm]": s[:, 1] * 100,
         "D* path length [cells]": s[:, 2]},
        [("m", ["distance to goal [m]"]),
         ("cm", ["SLAM-vs-true |xy| err [cm]"]),
         ("cells", ["D* path length [cells]"])],
        os.path.join(os.path.dirname(__file__), "out",
                     "full_stack_timeseries.png"),
        title="full stack: RBPF map → D* Lite → MPPI", xlabel="scan")
    if ts:
        print(f"wrote {ts}", flush=True)
    assert out["reached"], "goal not reached"
    assert out["final_goal_err_m"] < 0.3


if __name__ == "__main__":
    main()
