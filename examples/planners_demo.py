"""End-to-end demo: all three global planners on the reference world.

JAX equivalent of `roslaunch planner plan.launch plan_type:={0,1,2}`
(ref: planner/src/{prm_planner,grid_planner,potential_field_planner}_node
.cpp, world planner/config/map_boundaries.yaml at the launch files' 0.1
scale). Runs PRM + Theta*, D* Lite with simulated incremental discovery,
and potential-field gradient descent on the same 3.4 x 4.8 m world and
renders each result to a PNG (replacing the rviz MarkerArrays).
"""

import os
import time

import jax

# Global planning is host-side graph search over tiny arrays: eager
# per-op dispatch, which the CPU backend serves best.
jax.config.update("jax_platforms", "cpu")

import numpy as np

from tpunav import viz
from tpunav.planning import (
    DStarLite,
    PlanningGrid,
    PotentialField,
    PotentialFieldConfig,
    REFERENCE_MAP,
    RoadMap,
    theta_star,
)

START = (0.6, 0.3)
GOAL = (2.0, 4.3)
OUT = os.path.join(os.path.dirname(__file__), "out")


def polys():
    return [np.asarray(p[:n]) for p, n in
            zip(REFERENCE_MAP.polygons, REFERENCE_MAP.n_vertices)]


def world_ax():
    return viz.draw_world(
        polys(), bounds=[tuple(REFERENCE_MAP.bounds[0]),
                         tuple(REFERENCE_MAP.bounds[1])])


def run_prm():
    t0 = time.time()
    rm = RoadMap(REFERENCE_MAP, n_nodes=200, k_neighbors=10,
                 clearance=0.12, seed=42)
    s = rm.add_node(START)
    g = rm.add_node(GOAL)
    path = theta_star(rm, s, g)
    dt = time.time() - t0
    assert path is not None, "PRM found no path"
    ax = world_ax()
    ax.plot(rm.nodes[:, 0], rm.nodes[:, 1], ".", ms=2, color="tab:cyan")
    viz.draw_path(np.asarray(path), ax=ax, color="tab:blue",
                  label="Theta* path")
    length = float(np.sum(np.linalg.norm(np.diff(path, axis=0), axis=1)))
    print(f"PRM+Theta*: {len(rm.nodes)} nodes, path {len(path)} vertices, "
          f"length {length:.2f} m, {dt:.2f}s")
    viz.save(ax, os.path.join(OUT, "prm_theta_star.png"),
             f"PRM + Theta* ({length:.2f} m)")


def run_dstar():
    t0 = time.time()
    grid = PlanningGrid(REFERENCE_MAP, inflation=0.12)
    s = grid.world_to_grid(START)
    g = grid.world_to_grid(GOAL)
    d = DStarLite(grid, tuple(int(v) for v in s),
                  tuple(int(v) for v in g), vis_radius=5)
    traj = d.traverse()
    dt = time.time() - t0
    assert traj is not None, "D* Lite failed to reach the goal"
    world = np.asarray([grid.grid_to_world(iy, ix) for iy, ix in traj])
    ax = world_ax()
    viz.draw_path(world, ax=ax, color="tab:orange", label="D* Lite")
    print(f"D* Lite: {len(traj)} cells traversed with incremental "
          f"discovery, {dt:.2f}s")
    viz.save(ax, os.path.join(OUT, "dstar_lite.png"),
             "D* Lite (incremental replanning)")


def run_potential_field():
    # Gradient descent has no global view: give it a goal it can reach
    # without crossing the big central wall (local-minimum-free corridor
    # along the bottom of the world).
    pf_start, pf_goal = (0.5, 0.15), (3.2, 0.2)
    t0 = time.time()
    pf = PotentialField(
        PotentialFieldConfig(w_att=1.2, w_rep=0.02, dthresh=0.4,
                             qthresh=0.25, step=0.02, eps=0.08),
        REFERENCE_MAP)
    path = pf.plan(np.asarray(pf_start), np.asarray(pf_goal),
                   max_steps=5000)
    dt = time.time() - t0
    assert path is not None and len(path) > 1, "potential field stalled"
    ax = world_ax()
    viz.draw_path(np.asarray(path), ax=ax, color="tab:green",
                  label="potential field")
    end = np.asarray(path)[-1]
    print(f"potential field: {len(path)} GD steps, final dist to goal "
          f"{np.hypot(*(end - np.asarray(pf_goal))):.3f} m, {dt:.2f}s")
    viz.save(ax, os.path.join(OUT, "potential_field.png"),
             "Potential-field gradient descent")


def main():
    os.makedirs(OUT, exist_ok=True)
    run_prm()
    run_dstar()
    run_potential_field()
    print(f"PNGs in {OUT}/")


if __name__ == "__main__":
    main()
