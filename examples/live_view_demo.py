"""Live visualization of a running node graph — the rviz replacement.

Runs the EKF SLAM node graph under the WALL-CLOCK Scheduler (plant +
fake landmark sensor + odometer-equivalent + EKF + waypoint driver) with
a :class:`~tpunav.runtime.live.LiveViewNode` refreshing
``examples/out/live_view.png`` at 4 Hz while the robot drives — open the
file in any auto-refreshing viewer (VS Code image tab, ``watch``-driven
terminal viewer, a browser) to watch the run, exactly as the reference
streams paths + markers into rviz
(ref: nuslam/src/slam_node.cpp:396-432, nuslam/launch/slam.launch rviz
node).

Run:  python -m examples.live_view_demo --seconds 8
"""

import argparse
import os

import jax

jax.config.update("jax_platforms", "cpu")   # host-loop demo; no GPU needed
import jax.numpy as jnp
import numpy as np

from tpunav.core import diff_drive as dd
from tpunav.estimation.ekf import EKFConfig
from tpunav.runtime.channels import Channel, Node, Scheduler
from tpunav.runtime.live import LiveViewNode
from tpunav.runtime.nodes import FakeDiffEncodersNode, WaypointDriverNode
from tpunav.runtime.slam_nodes import EkfSlamNode
from tpunav.sim.landmark_sensor import landmark_measurements

LANDMARKS = np.array([[0.6, 0.1], [0.4, 0.5], [-0.2, 0.6], [-0.5, -0.1],
                      [0.0, -0.6], [0.5, -0.4], [0.8, 0.6], [-0.6, 0.5]])
WAYPOINTS = np.array([[0.4, 0.0, 0.0], [0.3, 0.4, 1.57],
                      [-0.3, 0.3, 3.0], [-0.3, -0.3, -2.0],
                      [0.3, -0.3, -0.7]])


def build(out_png, realtime=True, view_hz=4.0):
    params = dd.DiffDriveParams(wheel_radius=0.033, wheel_base=0.16)
    ch = {n: Channel(n) for n in
          ("cmd_vel", "joints", "landmarks", "slam_pose", "odom_pose",
           "truth", "lm_est")}

    encoders = FakeDiffEncodersNode(params, ch["cmd_vel"], ch["joints"])
    ekf = EkfSlamNode(
        EKFConfig(num_landmarks=LANDMARKS.shape[0], spd_repair=False,
                  motion_noise=(1e-8, 1e-8, 1e-8),
                  measurement_noise=(1e-6, 1e-6)),
        params, ch["joints"], ch["landmarks"], ch["slam_pose"],
        ch["odom_pose"], landmark_est=ch["lm_est"], known_da=True)

    def p_law(pose_xyt, wpt):
        """P-controlled heading, constant drive when aligned (the
        reference's closed-loop waypoint law, waypoints.cpp:70-108)."""
        x, y, th = pose_xyt
        bearing = np.arctan2(wpt[1] - y, wpt[0] - x)
        err = (bearing - th + np.pi) % (2 * np.pi) - np.pi
        if abs(err) > 0.1:
            return np.array([np.clip(2.0 * err, -1.2, 1.2), 0.0, 0.0])
        return np.array([0.0, 0.15, 0.0])

    driver = WaypointDriverNode(ch["slam_pose"], ch["cmd_vel"], WAYPOINTS,
                                p_law, goal_thresh=0.08)
    driver.start()

    def sense(t):
        # Ground truth = the fake-encoder model's own pose (this demo's
        # plant); the sensor is the analysis-node equivalent.
        pose = np.asarray(dd.pose(encoders.state))
        ch["truth"].publish(pose)
        meas = landmark_measurements(jnp.asarray(LANDMARKS),
                                     jnp.asarray(pose), 1.5)
        ch["landmarks"].publish(np.asarray(meas))

    view = LiveViewNode(out_png,
                        slam_pose=ch["slam_pose"],
                        odom_pose=ch["odom_pose"],
                        truth_pose=ch["truth"],
                        landmark_est=ch["lm_est"],
                        landmarks_true=LANDMARKS, waypoints=WAYPOINTS,
                        bounds=(-1.0, 1.0, -1.0, 1.0),
                        title="EKF SLAM + waypoint driver (live)")

    sched = Scheduler(realtime=realtime)
    sched.add(Node("fake_encoders", 60.0, encoders.tick))
    sched.add(Node("landmark_sensor", 10.0, sense))
    sched.add(Node("ekf_slam", 30.0, ekf.tick))
    sched.add(Node("waypoint_driver", 30.0, driver.tick))
    sched.add(Node("live_view", view_hz, view.tick))
    return sched, view, ch


def build_rbpf(out_png, realtime=True, view_hz=2.0, num_particles=8):
    """RBPF variant: the live view shows the best particle's occupancy
    grid growing as the robot drives a box world (the rviz
    OccupancyGrid display, ref: turtle_mapping_node's map publishing)."""
    from tpunav.estimation.rbpf import GridConfig, PFConfig
    from tpunav.estimation.rbpf.icp import ICPConfig
    from tpunav.runtime.slam_nodes import RbpfMappingNode
    from tpunav.sim.lidar import box_segments, scan_segments

    params = dd.DiffDriveParams(wheel_radius=0.033, wheel_base=0.16)
    # Full LDS-01 sensor (360 beams @ 0.05 m cells): the RBPF needs the
    # real beam density — at 90-180 beams the per-scan-match bias
    # (~mm) compounds through the proposal into meter-scale drift
    # (measured; 360 beams tracks at ~3 cm over the same course).
    grid_cfg = GridConfig(resolution=0.05, xmin=-1.5, xmax=1.5,
                          ymin=-1.5, ymax=1.5)
    pf_cfg = PFConfig(num_particles=num_particles, k_samples=10,
                      sample_range=(1e-6, 1e-5, 1e-5),
                      motion_noise=(1e-6, 1e-5, 1e-5),
                      grid=grid_cfg, icp=ICPConfig(max_iter=15))
    segs = box_segments(-1.2, -1.2, 1.2, 1.2, jnp.float32)
    ch = {n: Channel(n) for n in
          ("cmd_vel", "joints", "scan", "slam_pose", "grid", "truth")}

    encoders = FakeDiffEncodersNode(params, ch["cmd_vel"],
                                    ch["joints"], rate_hz=20.0)
    rbpf = RbpfMappingNode(pf_cfg, params, ch["joints"], ch["scan"],
                           ch["slam_pose"], ch["grid"])

    def sense(t):
        pose = np.asarray(dd.pose(encoders.state))
        ch["truth"].publish(pose)
        ch["scan"].publish(np.asarray(scan_segments(
            jnp.asarray(pose, jnp.float32), segs,
            num_beams=grid_cfg.num_beams, max_range=grid_cfg.range_max)))

    def drive(t):
        # Slow arc — enough motion for the map to grow.
        ch["cmd_vel"].publish(np.array([0.25, 0.12, 0.0]))

    view = LiveViewNode(out_png, slam_pose=ch["slam_pose"],
                        truth_pose=ch["truth"], grid=ch["grid"],
                        grid_cfg=grid_cfg,
                        bounds=(-1.5, 1.5, -1.5, 1.5),
                        title="RBPF grid SLAM (live)")
    sched = Scheduler(realtime=realtime)
    sched.add(Node("driver", 20.0, drive))
    sched.add(Node("fake_encoders", 20.0, encoders.tick))
    sched.add(Node("lidar", 5.0, sense))
    sched.add(Node("rbpf", 5.0, rbpf.tick))
    sched.add(Node("live_view", view_hz, view.tick))
    return sched, view, ch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rbpf", action="store_true",
                    help="RBPF grid-mapping variant (live occupancy map)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = args.out or os.path.join(
        os.path.dirname(__file__), "out",
        "live_view_rbpf.png" if args.rbpf else "live_view.png")
    sched, view, ch = (build_rbpf if args.rbpf else build)(out)
    print(f"driving for {args.seconds:.0f}s — watch {out}")
    sched.run(args.seconds)
    print(f"rendered {view.frames} live frames; final slam pose "
          f"{np.round(np.asarray(ch['slam_pose'].latest()), 3)}")


if __name__ == "__main__":
    main()
