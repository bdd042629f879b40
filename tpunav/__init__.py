"""tpunav — a navigation, SLAM, and sampling-based MPC framework in JAX.

Built from scratch in JAX/XLA/Pallas/pjit with the capabilities of the
bostoncleek/ROS-Turtlebot-Navigation C++/ROS1 stack (see SURVEY.md):

- ``tpunav.core``       SE(2) kinematics / diff-drive / waypoints (ref: rigid2d/)
- ``tpunav.models``     robot + sensor models (ref: nuturtle_description configs)
- ``tpunav.ops``        batched device kernels (RK4, scans, raycast, ESDF, ...)
- ``tpunav.control``    MPPI path-integral MPC (ref: controller/)
- ``tpunav.estimation`` EKF SLAM + RBPF grid SLAM (ref: nuslam/, bmapping/)
- ``tpunav.planning``   PRM/Theta*, D* Lite, potential fields (ref: planner/)
- ``tpunav.sim``        diff-drive plant, lidar, landmark sensors (ref: gazebo/tsim)
- ``tpunav.parallel``   mesh / shard_map scale-out over rollout & particle axes
- ``tpunav.runtime``    host node loops, channels, config, metrics, checkpoints
"""

__version__ = "0.1.0"
