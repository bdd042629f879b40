"""Simulated 2D lidar: batched analytic raycasting.

Replaces the Gazebo laser plugin (ref: nuturtle_gazebo/urdf/
diff_drive.gazebo.xacro lidar block; LDS-01 constants in
bmapping/config/LDS_01_lidar.yaml) with closed-form ray intersections —
every beam evaluated in parallel, vmappable over robots.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def scan_cylinders(pose, centers, radii, num_beams: int = 360,
                   beam_min: float = 0.0,
                   beam_delta: float = jnp.pi / 180.0,
                   max_range: float = 3.5,
                   key: Optional[jax.Array] = None,
                   noise_std: float = 0.0):
    """Ranges (num_beams,) from ray-circle intersections.

    pose: (3,) [theta, x, y]; centers: (M, 2); radii: (M,).
    Beams with no hit return ``max_range`` (which the landmark detector's
    ``range < range_max`` gate treats as invalid, matching the plugin's
    out-of-range behavior).
    """
    theta, x, y = pose[0], pose[1], pose[2]
    angles = theta + beam_min + beam_delta * jnp.arange(
        num_beams, dtype=centers.dtype)
    d = jnp.stack([jnp.cos(angles), jnp.sin(angles)], axis=-1)  # (B, 2)
    o = jnp.stack([x, y])

    oc = centers - o                                   # (M, 2)
    # HIGHEST: f32 products may otherwise run in TF32 on a GPU, a
    # millimetre-scale range error at lidar distances.
    tc = jnp.matmul(d, oc.T, precision=jax.lax.Precision.HIGHEST)           # (B, M) along-ray
    # Squared perpendicular distance from each center to each ray.
    d2 = jnp.sum(oc * oc, axis=-1)[None, :] - tc * tc  # (B, M)
    disc = radii[None, :] ** 2 - d2
    hit = jnp.logical_and(disc >= 0.0, tc > 0.0)
    t = tc - jnp.sqrt(jnp.maximum(disc, 0.0))
    t = jnp.where(jnp.logical_and(hit, t > 0.0), t, jnp.inf)
    ranges = jnp.min(t, axis=-1)
    if key is not None and noise_std > 0.0:
        ranges = ranges + noise_std * jax.random.normal(
            key, ranges.shape, ranges.dtype)
    return jnp.minimum(ranges, max_range)


def scan_segments(pose, segments, num_beams: int = 360,
                  beam_min: float = 0.0,
                  beam_delta: float = jnp.pi / 180.0,
                  max_range: float = 3.5,
                  key: Optional[jax.Array] = None,
                  noise_std: float = 0.0):
    """Ranges (num_beams,) from ray-segment intersections — walls and
    polygonal obstacles (the environments the Gazebo worlds model).

    pose: (3,) [theta, x, y]; segments: (S, 4) rows [ax, ay, bx, by].
    """
    theta, x, y = pose[0], pose[1], pose[2]
    angles = theta + beam_min + beam_delta * jnp.arange(
        num_beams, dtype=segments.dtype)
    d = jnp.stack([jnp.cos(angles), jnp.sin(angles)], axis=-1)  # (B, 2)
    o = jnp.stack([x, y])

    a = segments[:, 0:2]                                # (S, 2)
    ab = segments[:, 2:4] - a                           # (S, 2)
    ao = a - o                                          # (S, 2)
    # Solve o + t·d = a + s·ab per (beam, segment) with 2D cross products.
    denom = d[:, None, 0] * (-ab[None, :, 1]) - \
        d[:, None, 1] * (-ab[None, :, 0])               # (B, S)
    safe = jnp.where(jnp.abs(denom) < 1e-12, 1.0, denom)
    t = (ao[None, :, 0] * (-ab[None, :, 1]) -
         ao[None, :, 1] * (-ab[None, :, 0])) / safe
    s = (d[:, None, 0] * ao[None, :, 1] -
         d[:, None, 1] * ao[None, :, 0]) / safe
    hit = (jnp.abs(denom) >= 1e-12) & (t > 0.0) & (s >= 0.0) & (s <= 1.0)
    t = jnp.where(hit, t, jnp.inf)
    ranges = jnp.min(t, axis=-1)
    if key is not None and noise_std > 0.0:
        ranges = ranges + noise_std * jax.random.normal(
            key, ranges.shape, ranges.dtype)
    return jnp.minimum(ranges, max_range)


def box_segments(xmin, ymin, xmax, ymax, dtype=jnp.float32):
    """Four wall segments of an axis-aligned box."""
    return jnp.asarray([
        [xmin, ymin, xmax, ymin],
        [xmax, ymin, xmax, ymax],
        [xmax, ymax, xmin, ymax],
        [xmin, ymax, xmin, ymin],
    ], dtype=dtype)
