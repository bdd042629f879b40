"""End-to-end demo: EKF SLAM (known + unknown DA) vs odometry dead-reckoning.

JAX equivalent of `roslaunch nuslam slam.launch debug:=true`
(ref: nuslam/src/slam_node.cpp + analysis_node.cpp): a simulated robot
drives an arc through the 12-cylinder block world; the filter receives
noisy odometry and gated landmark measurements; final pose error vs ground
truth is reported next to dead-reckoned odometry error (the reference's
README tables, nuslam/README.md:24-50)."""

import time

import jax

from tpunav.runtime import cache as _cache
_cache.enable()
import jax.numpy as jnp

from tpunav.estimation.ekf import (
    EKFConfig, ekf_init, known_correspondence_slam, robot_pose,
    slam_unknown_da)
from tpunav.estimation.ekf import filter as ekff
from tpunav.sim import landmark_measurements

LANDMARKS = jnp.array([
    [0.75, 0.1], [0.95, 0.6], [0.5, 0.8], [0.1, 0.75],
    [-0.4, 0.9], [-0.8, 0.5], [-0.9, 0.0], [-0.7, -0.55],
    [-0.2, -0.8], [0.3, -0.9], [0.8, -0.6], [1.0, -0.1]])


def run(slam_step, cfg, steps=400, seed=0):
    u_true = jnp.asarray([0.03, 0.015], jnp.float32)
    bias = jnp.asarray([0.001, 0.0005], jnp.float32)

    @jax.jit
    def sim(key):
        def body(carry, _):
            key, true_pose, odom, st = carry
            key, k1 = jax.random.split(key)
            true_pose = ekff.motion_update(
                cfg, jnp.concatenate([true_pose,
                                      jnp.zeros(2 * cfg.num_landmarks)]),
                u_true, jnp.zeros(3))[:3]
            odom = ekff.motion_update(cfg, odom, u_true + bias, jnp.zeros(3))
            meas = landmark_measurements(LANDMARKS, true_pose, 1.0,
                                         key=k1, noise_std=1e-4)
            st = slam_step(cfg, st, meas, u_true + bias)
            return (key, true_pose, odom, st), None

        init = (key, jnp.zeros(3, jnp.float32),
                ekf_init(cfg, dtype=jnp.float32).state,
                ekf_init(cfg, dtype=jnp.float32))
        (key, true_pose, odom, st), _ = jax.lax.scan(
            body, init, None, length=steps)
        return true_pose, odom, st

    t0 = time.time()
    true_pose, odom, st = jax.block_until_ready(sim(jax.random.PRNGKey(seed)))
    wall = time.time() - t0
    est = robot_pose(st)
    ekf_err = est - true_pose
    odo_err = odom[:3] - true_pose
    return ekf_err, odo_err, int(st.count), wall, steps


def main():
    # f32 on the device; x64 is reserved for the CPU parity test suite.
    print("devices:", jax.devices())
    for name, step_fn, cfg in [
        # Process noise at the odometry bias's actual scale (the
        # reference's 1e-10 makes the filter ignore its measurements once
        # dead-reckoning drifts).
        ("known-DA ", known_correspondence_slam,
         EKFConfig(num_landmarks=12, spd_repair=False,
                   motion_noise=(1e-6, 1e-6, 1e-6),
                   measurement_noise=(1e-6, 1e-6))),
        # Unknown DA needs an honest process/measurement noise balance:
        # the reference's 1e-10 motion noise makes the filter so
        # overconfident that odometry bias inflates the Mahalanobis
        # distances past the gates (measurements get ignored, then
        # spuriously re-added). With Q/R at the sensor's actual scale the
        # filter associates all 12 landmarks correctly.
        ("unknownDA", slam_unknown_da,
         EKFConfig(num_landmarks=20, dmin=5e1, dmax=1e4, spd_repair=False,
                   motion_noise=(1e-5, 1e-5, 1e-5),
                   measurement_noise=(1e-5, 1e-5))),
    ]:
        ekf_err, odo_err, n_lm, wall, steps = run(step_fn, cfg)
        print(f"{name}: slam_err(theta,x,y)="
              f"{[f'{float(v):+.4f}' for v in ekf_err]} "
              f"odom_err={[f'{float(v):+.4f}' for v in odo_err]} "
              f"landmarks={n_lm} ({steps} steps in {wall:.1f}s)")


if __name__ == "__main__":
    main()
