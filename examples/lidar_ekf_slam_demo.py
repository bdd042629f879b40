"""End-to-end PERCEPTION demo: lidar raycast → circle detector → EKF SLAM.

The reference's non-debug SLAM pipeline — scan → featureDetection →
TurtleMap (ref: nuslam/src/landmarks_node.cpp:84-104) feeding the EKF
node (ref: nuslam/src/slam_node.cpp:109-123) — closed end to end with NO
ground-truth landmark sensor anywhere: the robot drives a loop through
the 12-cylinder block world, every measurement the filter ever sees comes
from ``scan_cylinders`` raycasts passed through the clustering +
algebraic-circle-fit detector. The whole course (sim + lidar + detector +
filter) is ONE fused ``lax.scan`` device program.

Reported exactly like the reference README tables
(nuslam/README.md:24-50): final SLAM pose error vs dead-reckoned odometry
error, for both known-DA (via the sim-side correspondence oracle) and
unknown-DA (Mahalanobis gating on raw detections).
"""

import os
import time

import jax

from tpunav.runtime import cache as _cache
_cache.enable()
import jax.numpy as jnp

from tpunav.estimation.ekf import (
    EKFConfig, ekf_init, known_correspondence_slam, robot_pose,
    slam_unknown_da)
from tpunav.estimation.ekf import filter as ekff
from tpunav.estimation.landmarks import (
    LandmarkConfig, circles_to_measurements, feature_detection)
from tpunav.sim import associate_known, scan_cylinders

# Block-world cylinders (ref: nuslam/config/block_world_landmarks.yaml).
LANDMARKS = jnp.array([
    [0.75, 0.1], [0.95, 0.6], [0.5, 0.8], [0.1, 0.75],
    [-0.4, 0.9], [-0.8, 0.5], [-0.9, 0.0], [-0.7, -0.55],
    [-0.2, -0.8], [0.3, -0.9], [0.8, -0.6], [1.0, -0.1]])
CYL_RADIUS = 0.04          # under the detector's radius_thresh=0.05 gate
SCAN_NOISE = 1e-3          # lidar range noise [m]


def make_sim(slam_step, cfg, known: bool, steps=400):
    """Build the jittable per-seed closed-loop course ``sim(key) →
    (true_pose, odom, ekf_state, telemetry)`` (vmapped over seeds by
    :func:`run_many` for the statistical RESULTS table)."""
    lm_cfg = LandmarkConfig(max_clusters=16)
    radii = jnp.full((LANDMARKS.shape[0],), CYL_RADIUS, LANDMARKS.dtype)
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
            ranges = scan_cylinders(true_pose, LANDMARKS, radii,
                                    key=k1, noise_std=SCAN_NOISE)
            circles = feature_detection(lm_cfg, ranges)
            meas = circles_to_measurements(circles)
            if known:
                meas = associate_known(meas, LANDMARKS, true_pose)
            st = slam_step(cfg, st, meas, u_true + bias)
            # Per-step observability stream (scan output → host plot):
            # SLAM + odometry error vs truth, tracked landmark count.
            from tpunav.core.angles import normalize_angle_pi
            e_s = robot_pose(st) - true_pose
            e_o = odom[:3] - true_pose
            tel = jnp.stack([jnp.hypot(e_s[1], e_s[2]),
                             normalize_angle_pi(e_s[0]),
                             jnp.hypot(e_o[1], e_o[2]),
                             normalize_angle_pi(e_o[0]),
                             st.count.astype(jnp.float32)])
            return (key, true_pose, odom, st), tel

        init = (key, jnp.zeros(3, jnp.float32),
                ekf_init(cfg, dtype=jnp.float32).state,
                ekf_init(cfg, dtype=jnp.float32))
        (key, true_pose, odom, st), tel = jax.lax.scan(
            body, init, None, length=steps)
        return true_pose, odom, st, tel

    return sim


def run(slam_step, cfg, known: bool, steps=400, seed=0):
    sim = jax.jit(make_sim(slam_step, cfg, known, steps))
    t0 = time.time()
    true_pose, odom, st, tel = jax.block_until_ready(
        sim(jax.random.PRNGKey(seed)))
    wall = time.time() - t0
    ekf_err = robot_pose(st) - true_pose
    odo_err = odom[:3] - true_pose
    return ekf_err, odo_err, int(st.count), wall, steps, tel


def run_many(slam_step, cfg, known: bool, seeds, steps=400):
    """vmap the whole course over seeds; returns per-seed
    (ekf_err (S, 3) [θ,x,y], odo_err (S, 3), counts (S,)) + wall."""
    from tpunav.core.angles import normalize_angle_pi

    sim = make_sim(slam_step, cfg, known, steps)

    def one(seed):
        true_pose, odom, st, _ = sim(jax.random.PRNGKey(seed))
        e = robot_pose(st) - true_pose
        eo = odom[:3] - true_pose
        e = e.at[0].set(normalize_angle_pi(e[0]))
        eo = eo.at[0].set(normalize_angle_pi(eo[0]))
        return e, eo, st.count

    t0 = time.time()
    out = jax.block_until_ready(
        jax.jit(jax.vmap(one))(jnp.asarray(seeds)))
    return (*out, time.time() - t0)


def main():
    print("devices:", jax.devices())
    for name, step_fn, cfg, known in [
        ("lidar known-DA ", known_correspondence_slam,
         EKFConfig(num_landmarks=12, spd_repair=False,
                   motion_noise=(1e-6, 1e-6, 1e-6),
                   measurement_noise=(1e-5, 1e-5)), True),
        # BASELINE config 4: unknown DA at 50-landmark capacity.
        ("lidar unknownDA", slam_unknown_da,
         EKFConfig(num_landmarks=50, dmin=5e1, dmax=1e4, spd_repair=False,
                   motion_noise=(1e-5, 1e-5, 1e-5),
                   measurement_noise=(1e-5, 1e-5)), False),
    ]:
        ekf_err, odo_err, n_lm, wall, steps, tel = run(step_fn, cfg, known)
        print(f"{name}: slam_err(theta,x,y)="
              f"{[f'{float(v):+.4f}' for v in ekf_err]} "
              f"odom_err={[f'{float(v):+.4f}' for v in odo_err]} "
              f"landmarks={n_lm} ({steps} steps in {wall:.1f}s)")

        # Per-step stream → rqt_plot-style panel.
        import numpy as np

        from tpunav.viz import plot_series
        t = np.asarray(tel)
        tag = "known" if known else "unknown"
        out = plot_series(
            {"SLAM |xy| err [cm]": t[:, 0] * 100,
             "odometry |xy| err [cm]": t[:, 2] * 100,
             "SLAM yaw err [deg]": np.degrees(t[:, 1]),
             "odometry yaw err [deg]": np.degrees(t[:, 3]),
             "tracked landmarks": t[:, 4]},
            [("cm", ["SLAM |xy| err [cm]", "odometry |xy| err [cm]"]),
             ("deg", ["SLAM yaw err [deg]", "odometry yaw err [deg]"]),
             ("count", ["tracked landmarks"])],
            os.path.join(os.path.dirname(__file__), "out",
                         f"lidar_ekf_{tag}_timeseries.png"),
            title=f"lidar → detector → EKF SLAM ({tag} DA)",
            xlabel="step")
        if out:
            print(f"  wrote {out}")


if __name__ == "__main__":
    main()
