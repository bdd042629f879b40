"""Simulated landmark sensor: ground-truth cylinders → robot-frame
measurements with visibility gating and optional Gaussian noise.

Data-parallel re-design of the reference's fake-sensor ``analysis`` node
(ref: nuslam/src/nuslam/analysis_node.cpp:56-182): it transforms world
landmarks into the robot frame (:106-137), NaNs out landmarks beyond the
visibility radius (:140-166), and optionally corrupts them with Gaussian
noise (:142-151). Pure function — vmappable over particles/robots and
usable inside ``lax.scan`` closed loops.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def landmark_measurements(landmarks_world, pose, visibility_radius,
                          key: Optional[jax.Array] = None,
                          noise_std: float = 0.0,
                          pose_noise_std: float = 0.0):
    """Return (M, 2) robot-frame landmark positions; NaN rows are outside
    the visibility radius.

    landmarks_world: (M, 2) world coordinates (ref config:
    nuslam/config/block_world_landmarks.yaml).
    pose: (3,) [theta, x, y] ground-truth robot pose.
    pose_noise_std: Gaussian noise added to the robot pose BEFORE the
    world→robot transform, like the reference's fake sensor corrupting
    the gazebo pose (ref: analysis_node.cpp:169-178).
    """
    if key is not None and pose_noise_std > 0.0:
        key, k_pose = jax.random.split(key)
        pose = pose + pose_noise_std * jax.random.normal(
            k_pose, pose.shape, pose.dtype)
    theta, x, y = pose[0], pose[1], pose[2]
    d = landmarks_world - jnp.stack([x, y])
    c, s = jnp.cos(theta), jnp.sin(theta)
    # World → robot frame: R(-theta) @ d.
    local = jnp.stack(
        [c * d[..., 0] + s * d[..., 1], -s * d[..., 0] + c * d[..., 1]],
        axis=-1)
    if key is not None and noise_std > 0.0:
        local = local + noise_std * jax.random.normal(
            key, local.shape, local.dtype)
    dist = jnp.linalg.norm(d, axis=-1)
    visible = dist <= visibility_radius
    return jnp.where(visible[..., None], local, jnp.nan)


def associate_known(detections, landmarks_world, true_pose,
                    max_dist: float = 0.2):
    """Known-correspondence oracle: robot-frame detections → an (M, 2)
    measurement array indexed by ground-truth landmark id.

    The reference's known-DA path works because its fake sensor (the
    analysis node) publishes landmarks in ground-truth order
    (ref: nuslam/src/analysis_node.cpp:106-137) so measurement index i IS
    landmark id i (ref: ekf_filter.cpp:327-345). When the measurements
    come from the lidar circle detector instead, slot order is cluster
    order — this sim-side oracle restores the id labeling by matching each
    ground-truth landmark to its nearest detection (in the world frame via
    the TRUE pose) within ``max_dist``; unmatched ids become NaN rows.

    detections: (C, 2) robot-frame circle centers, NaN rows empty.
    landmarks_world: (M, 2); true_pose: (3,) [theta, x, y].
    Returns (M, 2) robot-frame measurements.
    """
    theta, x, y = true_pose[0], true_pose[1], true_pose[2]
    c, s = jnp.cos(theta), jnp.sin(theta)
    ok = jnp.all(jnp.isfinite(detections), axis=-1)
    det = jnp.nan_to_num(detections)
    # Robot → world frame: R(theta) @ p + t.
    world = jnp.stack(
        [c * det[:, 0] - s * det[:, 1] + x,
         s * det[:, 0] + c * det[:, 1] + y], axis=-1)       # (C, 2)
    d2 = jnp.sum(
        (landmarks_world[:, None, :] - world[None, :, :]) ** 2, axis=-1)
    d2 = jnp.where(ok[None, :], d2, jnp.inf)                # (M, C)
    best = jnp.argmin(d2, axis=-1)
    matched = jnp.min(d2, axis=-1) <= max_dist * max_dist
    return jnp.where(matched[:, None], detections[best], jnp.nan)
