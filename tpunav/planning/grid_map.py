"""C-space planning grid with obstacle inflation (batched JAX labeling).

Data-parallel re-design of ``planner::GridMap``
(ref: planner/include/planner/grid_map.hpp:93-172,
planner/src/planner/grid_map.cpp). The reference labels every cell with a
triple loop (cells × polygons × edges) of branchy signed-distance tests
(labelCells/collisionCells/collideWalls, grid_map.cpp:91-437); here the
same decision reduces to two vectorized predicates evaluated for ALL
cells × polygons at once:

- state 1 (obstacle): the cell center is inside (or on the border of) a
  CCW polygon — every edge's signed distance >= 0;
- state 2 (inflated): within ``bnd_rad`` of any polygon boundary or the
  world walls, where bnd_rad = inflation + resolution/2
  (ref: boundingRad grid_map.cpp:16-20);
- state 0: free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .utilities import min_dist_segment_point, signed_min_dist
from .world import ObstacleMap

FREE = 0
OBSTACLE = 1
INFLATED = 2


class PlanningGrid:
    """Labeled occupancy grid over a polygonal world."""

    def __init__(self, obs_map: ObstacleMap, inflation: float = 0.1):
        self.obs = obs_map
        self.resolution = float(obs_map.resolution)
        (self.xmin, self.xmax), (self.ymin, self.ymax) = obs_map.bounds
        self.bnd_rad = inflation + 0.5 * self.resolution
        # The 1e-9 guard keeps e.g. 4.8/0.1 = 48.000000000000007 from
        # ceiling to 49 cells (the reference computes 48 x 34).
        self.width = int(np.ceil(
            (self.xmax - self.xmin) / self.resolution - 1e-9))
        self.height = int(np.ceil(
            (self.ymax - self.ymin) / self.resolution - 1e-9))
        self.labels = np.asarray(self._label_all())

    def world_to_grid(self, xy):
        ix = np.clip(((np.asarray(xy)[..., 0] - self.xmin) //
                      self.resolution).astype(int), 0, self.width - 1)
        iy = np.clip(((np.asarray(xy)[..., 1] - self.ymin) //
                      self.resolution).astype(int), 0, self.height - 1)
        return iy, ix

    def grid_to_world(self, iy, ix):
        """Cell center (ref: grid2World grid_map.cpp:160-189)."""
        x = self.xmin + (np.asarray(ix) + 0.5) * self.resolution
        y = self.ymin + (np.asarray(iy) + 0.5) * self.resolution
        return np.stack([x, y], axis=-1)

    def _label_all(self):
        res = self.resolution
        xs = self.xmin + (jnp.arange(self.width) + 0.5) * res
        ys = self.ymin + (jnp.arange(self.height) + 0.5) * res
        px, py = jnp.meshgrid(xs, ys)                    # (H, W)
        pts = jnp.stack([px, py], axis=-1).reshape(-1, 2)

        polys = jnp.asarray(self.obs.polygons)           # (P, V, 2)
        counts = jnp.asarray(self.obs.n_vertices)

        def per_poly(poly, n):
            v = poly.shape[0]
            idx = jnp.arange(v)
            nxt = jnp.where(idx + 1 >= n, 0, idx + 1)
            valid = idx < n
            a, b = poly, poly[nxt]                        # (V, 2)

            cp = signed_min_dist(a[None], b[None], pts[:, None, :])
            inside = jnp.all(
                jnp.logical_or(cp.sign_d >= -1e-12, ~valid[None]), axis=1)
            d = min_dist_segment_point(a[None], b[None], pts[:, None, :])
            near = jnp.min(jnp.where(valid[None], d, jnp.inf), axis=1)
            return inside, near

        inside_all, near_all = jax.vmap(per_poly)(polys, counts)
        inside = jnp.any(inside_all, axis=0)              # (N,)
        near = jnp.min(near_all, axis=0)

        # World walls (ref: collideWalls grid_map.cpp:403-437).
        wall_d = jnp.minimum(
            jnp.minimum(pts[:, 0] - self.xmin, self.xmax - pts[:, 0]),
            jnp.minimum(pts[:, 1] - self.ymin, self.ymax - pts[:, 1]))

        labels = jnp.where(
            inside, OBSTACLE,
            jnp.where(jnp.logical_or(near <= self.bnd_rad,
                                     wall_d <= self.bnd_rad),
                      INFLATED, FREE))
        return labels.reshape(self.height, self.width).astype(jnp.int8)

    def passable(self, iy, ix):
        return self.labels[iy, ix] == FREE

    def occupancy(self):
        """int8 export: 0 free, 100 obstacle, 50 inflated (rviz-style)."""
        out = np.zeros_like(self.labels, np.int8)
        out[self.labels == OBSTACLE] = 100
        out[self.labels == INFLATED] = 50
        return out
