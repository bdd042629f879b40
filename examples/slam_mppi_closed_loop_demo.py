"""End-to-end demo: EKF SLAM closing the MPPI control loop (one device
program per course).

JAX equivalent of running the reference's full stack —
`roslaunch nuslam slam.launch` + `mppi_waypoints` — where the controller
consumes the FILTER's pose, odometry is biased (the failure mode SLAM
exists to fix), and landmark frames arrive at a fraction of the control
rate. Two configurations from BASELINE.json:

  3. known data association, the 12-cylinder block world
  4. unknown data association (Mahalanobis gating), 50 random landmarks

Reports: course completion, EKF vs dead-reckoning final error, control
ticks/s (the whole loop — solve + plant + filter — is one lax.while_loop
on device)."""

import time

import jax

from tpunav.runtime import cache as _cache
_cache.enable()
import jax.numpy as jnp
import numpy as np

from tpunav.control.mppi import MPPIConfig
from tpunav.control.slam_loop import (SlamLoopConfig, run_slam_loop,
                                      slam_loop_init)
from tpunav.estimation.ekf import EKFConfig
from tpunav.models.cart import CartParams
from tpunav.runtime.config import load_landmarks

MODEL = CartParams(0.033, 0.160)
# In-world square course threading the block world's cylinders.
WAYPOINTS = jnp.array([[0.5, 0.0, 0.0], [0.4, 0.5, 1.57],
                       [-0.3, 0.45, 3.0], [-0.5, -0.2, -1.8],
                       [0.2, -0.5, -0.4]])


def run(name, landmarks, known_da, num_slots):
    mppi_cfg = MPPIConfig(horizon=0.4, dt=0.05, rollouts=1024,
                          ul_var=4.0, ur_var=4.0)
    ekf_cfg = EKFConfig(num_landmarks=num_slots, dmin=5e1, dmax=1e4,
                        spd_repair=False,
                        motion_noise=(1e-6, 1e-6, 1e-6),
                        measurement_noise=(1e-6, 1e-6))
    cfg = SlamLoopConfig(goal_thresh=0.12, known_da=known_da,
                         sensor_every=6, visibility=1.2)

    st = slam_loop_init(mppi_cfg, ekf_cfg, seed=1)
    runner = jax.jit(lambda s: run_slam_loop(
        mppi_cfg, ekf_cfg, cfg, MODEL, WAYPOINTS, landmarks, s,
        max_ticks=6000))
    st = jax.block_until_ready(runner(slam_loop_init(mppi_cfg, ekf_cfg,
                                                     seed=1)))  # compile
    t0 = time.time()
    st = jax.block_until_ready(runner(slam_loop_init(mppi_cfg, ekf_cfg,
                                                     seed=1)))
    wall = time.time() - t0

    est = np.asarray(st.ekf.state[:3])       # [theta, x, y]
    tru = np.asarray(st.true_pose)           # [x, y, theta]
    odo = np.asarray(st.odom)                # [theta, x, y]
    ekf_err = np.hypot(est[1] - tru[0], est[2] - tru[1])
    odo_err = np.hypot(odo[1] - tru[0], odo[2] - tru[1])
    ticks = int(st.ticks)
    print(f"{name}: done={bool(st.done)} visits={int(st.visits)}/"
          f"{len(WAYPOINTS)} ticks={ticks} "
          f"ekf_err={ekf_err * 100:.2f}cm odom_err={odo_err * 100:.2f}cm "
          f"landmarks={int(st.ekf.count)} "
          f"({ticks / wall:.0f} closed-loop ticks/s)")
    assert bool(st.done), "course incomplete"
    assert ekf_err < odo_err, "filter worse than dead reckoning"


def main():
    print("devices:", jax.devices())
    centers, _ids = load_landmarks("configs/block_world_landmarks.yaml")
    block_world = jnp.asarray(centers, jnp.float32)
    run("config3 known-DA 12 cylinders ", block_world, True, 12)

    key = jax.random.PRNGKey(7)
    lm50 = jax.random.uniform(key, (50, 2), jnp.float32, -0.9, 0.9)
    run("config4 unknownDA 50 landmarks", lm50, False, 60)


if __name__ == "__main__":
    main()
