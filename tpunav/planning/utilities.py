"""Line-segment / point geometry primitives (batched JAX).

Data-parallel re-design of planner/src/planner/planner_utilities.cpp. All
functions broadcast over leading axes so one call evaluates every
(cell × polygon-edge) pair at once.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class ClosePoint(NamedTuple):
    t: jnp.ndarray        # line parameter (unclamped)
    sign_d: jnp.ndarray   # signed distance (positive = left of p1→p2)
    point: jnp.ndarray    # (..., 2) closest point on the infinite line
    on_seg: jnp.ndarray   # bool: 0 <= t <= 1


def min_dist_segment_point(p1, p2, p3):
    """Distance from point(s) p3 to SEGMENT p1→p2 (clamped at endpoints).
    The reference splits this across minDistLineSegPt + endpoint branches
    (planner_utilities.cpp:9-44, grid_map.cpp:269-311); clamping the
    parameter is the equivalent closed form."""
    d = p2 - p1
    denom = jnp.maximum(jnp.sum(d * d, axis=-1), 1e-12)
    u = jnp.sum((p3 - p1) * d, axis=-1) / denom
    u = jnp.clip(u, 0.0, 1.0)
    closest = p1 + u[..., None] * d
    return jnp.linalg.norm(p3 - closest, axis=-1)


def signed_min_dist(p1, p2, p3) -> ClosePoint:
    """Signed perpendicular distance of p3 from the line p1→p2, with the
    leftward normal convention (ref: signMinDist2Line
    planner_utilities.cpp:76-128): positive sign = p3 left of the edge —
    for a CCW polygon, inside."""
    v = p2 - p1
    n = jnp.stack([-v[..., 1], v[..., 0]], axis=-1)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    d = p3 - p1
    denom = jnp.maximum(jnp.sum(v * v, axis=-1), 1e-12)
    t = jnp.sum(d * v, axis=-1) / denom
    sign_d = jnp.sum(d * n, axis=-1)
    point = p1 + t[..., None] * v
    on_seg = jnp.logical_and(t >= -1e-12, t <= 1.0 + 1e-12)
    return ClosePoint(t=t, sign_d=sign_d, point=point, on_seg=on_seg)


def polygon_edges(poly, n_vertices):
    """Edges of a padded polygon (V, 2) with ``n_vertices`` real rows:
    returns (V, 2) start points, (V, 2) end points, and a (V,) validity
    mask. The closing edge wraps last→first like the reference's loops
    (grid_map.cpp:231-245)."""
    v = poly.shape[0]
    idx = jnp.arange(v)
    nxt = jnp.where(idx + 1 >= n_vertices, 0, idx + 1)
    valid = idx < n_vertices
    return poly, poly[nxt], valid


def point_in_polygon(poly, n_vertices, p):
    """True if p is inside (or on the border of) the CCW polygon — all
    edge signed distances >= 0 (ref: RoadMap::ptInsidePolygon
    road_map.cpp:378-462 reduces to this for CCW input)."""
    a, b, valid = polygon_edges(poly, n_vertices)
    cp = signed_min_dist(a, b, p[None, :])
    inside_each = jnp.logical_or(cp.sign_d >= -1e-12,
                                 jnp.logical_not(valid))
    return jnp.all(inside_each)


def dist_to_polygon(poly, n_vertices, p):
    """Min distance from p to the polygon boundary (segments, endpoint-
    clamped)."""
    a, b, valid = polygon_edges(poly, n_vertices)
    d = min_dist_segment_point(a, b, p[None, :])
    return jnp.min(jnp.where(valid, d, jnp.inf))


def segments_intersect(a0, a1, b0, b1):
    """Proper/improper segment intersection test via orientation signs
    (ref: lnSegIntersectPolygon's parametric clipping road_map.cpp:16-119
    — same decision, branch-free form). Broadcasts over leading axes."""
    def cross(o, p, q):
        return ((p[..., 0] - o[..., 0]) * (q[..., 1] - o[..., 1]) -
                (p[..., 1] - o[..., 1]) * (q[..., 0] - o[..., 0]))

    d1 = cross(b0, b1, a0)
    d2 = cross(b0, b1, a1)
    d3 = cross(a0, a1, b0)
    d4 = cross(a0, a1, b1)
    proper = jnp.logical_and((d1 * d2) < 0.0, (d3 * d4) < 0.0)

    def on(o, p, q, d):
        within = jnp.logical_and(
            jnp.minimum(o[..., 0], p[..., 0]) - 1e-12 <= q[..., 0],
            q[..., 0] <= jnp.maximum(o[..., 0], p[..., 0]) + 1e-12)
        within = jnp.logical_and(within, jnp.logical_and(
            jnp.minimum(o[..., 1], p[..., 1]) - 1e-12 <= q[..., 1],
            q[..., 1] <= jnp.maximum(o[..., 1], p[..., 1]) + 1e-12))
        return jnp.logical_and(jnp.abs(d) < 1e-12, within)

    touch = on(b0, b1, a0, d1) | on(b0, b1, a1, d2) | \
        on(a0, a1, b0, d3) | on(a0, a1, b1, d4)
    return jnp.logical_or(proper, touch)
