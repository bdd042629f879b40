"""Potential-field gradient-descent planner (pure JAX, scannable).

Data-parallel re-design of ``planner::PotentialField``
(ref: planner/include/planner/potential_field.hpp:28-97,
planner/src/planner/potential_field.cpp). Semantics preserved exactly:

- attractive gradient: quadratic w_att·(q − qg), switched to the conic
  form (scaled by dthresh/d) beyond dthresh (ref: :202-220);
- repulsive gradient per polygon: from the closest boundary point within
  qthresh, with the reference's weight w_rep/(qthresh − d) — note the C++
  writes ``(1.0 / d*d)`` which by precedence is (1/d)·d = 1, so the
  nominal 1/d² factor is unity; we reproduce the shipped behavior
  (ref: :320-341);
- one normalized gradient-descent step per plan() call (ref: :57-84).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .utilities import min_dist_segment_point
from .world import ObstacleMap


@dataclasses.dataclass(frozen=True)
class PotentialFieldConfig:
    """(ref: planner/launch/plan.launch potential-field params.)"""

    eps: float = 0.05        # goal tolerance
    step: float = 0.05       # gradient-descent step size
    dthresh: float = 0.5     # attractive conic/quadratic switch
    qthresh: float = 0.3     # repulsive influence range
    w_att: float = 1.0
    w_rep: float = 0.1


class PotentialField:
    """Functional core + a thin stateful wrapper mirroring the node loop
    (ref: potential_field_planner_node.cpp:193-214)."""

    def __init__(self, cfg: PotentialFieldConfig, obs_map: ObstacleMap):
        self.cfg = cfg
        self.polys = jnp.asarray(obs_map.polygons)
        self.counts = jnp.asarray(obs_map.n_vertices)
        self._step = jax.jit(self._one_step)

    def _one_step(self, q, goal):
        cfg = self.cfg

        def per_poly(poly, n):
            v = poly.shape[0]
            idx = jnp.arange(v)
            nxt = jnp.where(idx + 1 >= n, 0, idx + 1)
            valid = idx < n
            a, b = poly, poly[nxt]
            d_edge = min_dist_segment_point(a, b, q[None, :])
            d_edge = jnp.where(valid, d_edge, jnp.inf)
            j = jnp.argmin(d_edge)
            dmin = d_edge[j]
            # Closest boundary point (clamped projection on edge j).
            e = b[j] - a[j]
            u = jnp.clip(jnp.dot(q - a[j], e) /
                         jnp.maximum(jnp.dot(e, e), 1e-12), 0.0, 1.0)
            q0 = a[j] + u * e
            # Repulsive gradient (ref: repulsiveGradient :320-341; the
            # shipped 1/d² factor reduces to 1 — see module docstring).
            active = dmin <= cfg.qthresh
            denom = jnp.maximum(dmin, 1e-9)
            g = (q0 - q) / denom * (cfg.w_rep /
                                    jnp.maximum(cfg.qthresh - dmin, 1e-9))
            return jnp.where(active, g, jnp.zeros(2, q.dtype))

        u_rep = jnp.sum(jax.vmap(per_poly)(self.polys, self.counts), axis=0)

        dg = jnp.linalg.norm(q - goal)
        u_att = cfg.w_att * (q - goal)
        u_att = jnp.where(dg > cfg.dthresh, u_att * cfg.dthresh /
                          jnp.maximum(dg, 1e-12), u_att)

        grad = u_rep + u_att
        dn = grad / jnp.maximum(jnp.linalg.norm(grad), 1e-12)
        return q - cfg.step * dn

    def plan(self, start, goal, max_steps: int = 2000):
        """Run gradient descent until the goal tolerance or max_steps;
        returns the path (list of (2,) arrays)."""
        q = jnp.asarray(start, jnp.float32)
        goal = jnp.asarray(goal, jnp.float32)
        path = [q]
        for _ in range(max_steps):
            if float(jnp.linalg.norm(q - goal)) < self.cfg.eps:
                break
            q = self._step(q, goal)
            path.append(q)
        return path
