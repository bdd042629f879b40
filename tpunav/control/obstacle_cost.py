"""Obstacle-avoidance cost fields for MPPI (BASELINE config 2).

The reference controller only tracks waypoints (its LQR loss,
controller/include/controller/mppi.hpp:57-111); obstacle awareness lives
in the global planners. For MPPI-with-obstacles the data-parallel design
evaluates a distance-field cost at EVERY rollout state in the same fused
solve: the planning grid's polygons (or a SLAM occupancy grid) become an
ESDF once, and each of the K×N trajectory points pays

    cost(p) = w_hit·[d(p) ≤ r_safe] · BIG + w_field·exp(−(d(p)−r_safe)/σ)

via a bilinear ESDF lookup — pure gathers + elementwise math, so K=10k rollouts
price obstacles with no extra passes.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ..ops.distance_transform import euclidean_distance_field


@dataclasses.dataclass(frozen=True)
class ObstacleCostConfig:
    xmin: float
    ymin: float
    resolution: float
    r_safe: float = 0.12          # robot bounding radius
    w_hit: float = 1e6            # collision penalty
    w_field: float = 1e3          # decay-field weight
    sigma: float = 0.2            # decay length (meters)


def distance_field_from_labels(labels, resolution: float,
                               max_dist: float = 10.0):
    """ESDF of a planning grid's labels (OBSTACLE==1 cells are seeds;
    inflated cells are handled by r_safe instead)."""
    occ = jnp.asarray(labels) == 1
    return euclidean_distance_field(occ, resolution, max_dist,
                                    dtype=jnp.float32)


@dataclasses.dataclass(frozen=True)
class SegmentCostParams:
    """Weights for the analytic primitive-set obstacle cost (same cost
    law as :class:`ObstacleCostConfig`, but d(p) is computed in closed
    form against segment/circle primitives instead of a grid ESDF lookup
    — exact, grid-free, and computable inside the fused Pallas kernel
    where dynamic gathers don't lower)."""

    r_safe: float = 0.12
    w_hit: float = 1e6
    w_field: float = 1e3
    sigma: float = 0.2


def segments_from_circles(centers, radii):
    """Circle obstacles as degenerate (a == b) offset segments: rows
    [ax, ay, bx, by, r]."""
    c = jnp.asarray(centers, jnp.float32)
    r = jnp.asarray(radii, jnp.float32).reshape(-1, 1)
    return jnp.concatenate([c, c, r], axis=1)


def segments_from_polygons(polygons):
    """CCW polygon obstacles (the planner's obstacle_map format,
    ref: planner/include/planner/planner_utilities.hpp:18-19) as edge
    segments with zero offset radius."""
    rows = []
    for poly in polygons:
        n = len(poly)
        for i in range(n):
            a, b = poly[i], poly[(i + 1) % n]
            rows.append([a[0], a[1], b[0], b[1], 0.0])
    return jnp.asarray(rows, jnp.float32)


def make_segment_obstacle_cost(params: SegmentCostParams, segments):
    """Returns ``cost_fn(xy) -> cost`` for (..., 2) positions against
    (O, 5) segment primitives [ax, ay, bx, by, r]: d(p) = min over
    primitives of (point-to-segment distance − r). Same math the fused
    kernel evaluates in-register (ops/pallas_mppi.py), so the two paths
    parity-test against each other."""
    segments = jnp.asarray(segments, jnp.float32)

    def cost_fn(xy):
        # Op-for-op identical to the in-kernel evaluation (the MPPI
        # softmax at λ=0.01 amplifies cost rounding differences by e^100Δ,
        # so parity needs bitwise-equal cost arithmetic, not just the same
        # formula).
        a = segments[:, 0:2]                        # (O, 2)
        ab = segments[:, 2:4] - a                   # (O, 2)
        rr = segments[:, 4]                         # (O,)
        inv = 1.0 / jnp.maximum(jnp.sum(ab * ab, axis=-1), 1e-12)
        ap = xy[..., None, :] - a                   # (..., O, 2)
        t = jnp.clip(jnp.sum(ap * ab, axis=-1) * inv, 0.0, 1.0)
        proj = a + t[..., None] * ab
        diff = xy[..., None, :] - proj
        d = jnp.sqrt(jnp.sum(diff * diff, axis=-1)) - rr
        d = jnp.min(d, axis=-1)
        hit = (d <= params.r_safe).astype(d.dtype)
        inv_sigma = jnp.float32(1.0 / params.sigma)   # kernel-identical
        return params.w_hit * hit + params.w_field * jnp.exp(
            -(d - params.r_safe) * inv_sigma)

    return cost_fn


def make_obstacle_cost(cfg: ObstacleCostConfig, dist_field):
    """Returns ``cost_fn(xy) -> cost`` for (..., 2) world positions,
    suitable as ``mppi_solve``'s extra running cost."""
    h, w = dist_field.shape

    def cost_fn(xy):
        fx = (xy[..., 0] - cfg.xmin) / cfg.resolution - 0.5
        fy = (xy[..., 1] - cfg.ymin) / cfg.resolution - 0.5
        x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, w - 2)
        y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, h - 2)
        tx = jnp.clip(fx - x0, 0.0, 1.0)
        ty = jnp.clip(fy - y0, 0.0, 1.0)
        d00 = dist_field[y0, x0]
        d01 = dist_field[y0, x0 + 1]
        d10 = dist_field[y0 + 1, x0]
        d11 = dist_field[y0 + 1, x0 + 1]
        d = (d00 * (1 - tx) * (1 - ty) + d01 * tx * (1 - ty) +
             d10 * (1 - tx) * ty + d11 * tx * ty)
        hit = (d <= cfg.r_safe).astype(d.dtype)
        return cfg.w_hit * hit + cfg.w_field * jnp.exp(
            -(d - cfg.r_safe) / cfg.sigma)

    return cost_fn
