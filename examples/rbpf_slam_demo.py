"""End-to-end demo: RBPF FastSLAM grid mapping in a simulated box world.

JAX equivalent of `roslaunch bmapping slam.launch`
(ref: bmapping/src/turtle_mapping_node.cpp): the robot drives an arc
inside a walled box; every particle carries its own occupancy grid; ICP
scan matching proposes poses; final pose error vs ground truth and map
quality are reported (the reference's README experiment,
bmapping/README.md:33-47)."""

import time

import jax

from tpunav.runtime import cache as _cache
_cache.enable()
import jax.numpy as jnp
import numpy as np

from tpunav.estimation.rbpf import (
    GridConfig, PFConfig, best_particle, pf_init, pf_slam_step)
from tpunav.estimation.rbpf.grid import occupancy_grid
from tpunav.estimation.rbpf.icp import ICPConfig
from tpunav.sim.lidar import box_segments, scan_segments


def main():
    print("devices:", jax.devices())
    grid = GridConfig(resolution=0.05, xmin=-2.0, xmax=2.0, ymin=-2.0,
                      ymax=2.0, num_beams=360)
    cfg = PFConfig(num_particles=40, k_samples=50,
                   sample_range=(1e-6, 1e-5, 1e-5),
                   motion_noise=(1e-6, 1e-5, 1e-5),
                   grid=grid, icp=ICPConfig(max_iter=25))
    segs = box_segments(-1.8, -1.8, 1.8, 1.8, jnp.float32)
    u = jnp.array([0.03, 0.02], jnp.float32)

    def true_step(pose):
        th = pose[0] + u[0]
        return jnp.stack([th, pose[1] + u[1] * jnp.cos(th),
                          pose[2] + u[1] * jnp.sin(th)])

    n_steps = 120

    # The WHOLE experiment — simulated drive, lidar raycast, and the RBPF
    # update — runs as one device program (a lax.scan over steps): per-tick
    # eager dispatch would pay a host↔device round trip per update.
    @jax.jit
    def run(st, true_pose):
        def body(carry, i):
            st, true_pose, prev_odom = carry
            new_pose = true_step(true_pose)
            key = jax.random.fold_in(jax.random.PRNGKey(99), i)
            scan = scan_segments(new_pose, segs, num_beams=grid.num_beams,
                                 max_range=grid.range_max, key=key,
                                 noise_std=0.002)
            st = pf_slam_step(cfg, st, scan, u, new_pose, prev_odom)
            return (st, new_pose, new_pose), None

        (st, true_pose, _), _ = jax.lax.scan(
            body, (st, true_pose, true_pose), jnp.arange(n_steps))
        return st, true_pose

    st = pf_init(cfg, seed=2)
    st, true_pose = run(st, jnp.zeros(3, jnp.float32))  # warmup+compile
    jax.block_until_ready(st.poses)
    st = pf_init(cfg, seed=2)
    t0 = time.time()
    st, true_pose = run(st, jnp.zeros(3, jnp.float32))
    pose, grid_best = jax.block_until_ready(best_particle(st))
    wall = time.time() - t0

    err = np.asarray(pose) - np.asarray(true_pose)
    err[0] = (err[0] + np.pi) % (2 * np.pi) - np.pi  # wrap heading error
    occ = np.asarray(grid_best >= cfg.grid.l_occ)
    omap = np.asarray(occupancy_grid(cfg.grid, grid_best))
    print(f"pose error (theta,x,y) = {err[0]:+.4f} {err[1]:+.4f} "
          f"{err[2]:+.4f}  (|xy| = {np.hypot(err[1], err[2]) * 100:.2f} cm)")
    print(f"occupied cells: {occ.sum()}  map free cells: {(omap == 0).sum()}")
    print(f"{n_steps} SLAM updates, 40 particles, 360 beams in {wall:.1f}s "
          f"= {n_steps / wall:.1f} updates/s")
    assert np.hypot(err[1], err[2]) < 0.2, "pose diverged"


if __name__ == "__main__":
    main()
