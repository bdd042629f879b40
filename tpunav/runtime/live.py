"""Live visualization node: a continuously-refreshed rendering of the
RUNNING node graph — the framework's rviz.

The reference streams paths, occupancy maps, and landmark markers into
rviz while its nodes run (ref: nuslam/src/slam_node.cpp:396-432,
planner/src/grid_planner_node.cpp:217-261, bmapping's OccupancyGrid
publishing). Headless accelerator hosts have no display server, so the live
view renders to an ATOMICALLY-REPLACED image file at its node rate —
watchable with any auto-refreshing viewer (``watch -n1``, VS Code's
image tab, a browser) — which is the same pub-rate/latest-wins contract
as an rviz topic, with the filesystem as the transport.

:class:`LiveViewNode` is an ordinary runtime node: give it channels (in-
process or NetChannels — it works across the TCP bus too) and add it to
a Scheduler. It re-renders only when something it subscribes to
actually published (seq-gated, like every other node).
"""

from __future__ import annotations

import collections
import os
import tempfile
from typing import Optional

import numpy as np

from .channels import Channel


class LiveViewNode:
    """Render subscribed state to ``path`` at the node rate.

    Channels (all optional; pass what the graph has):
      slam_pose / odom_pose / truth_pose — (3,) [theta, x, y] poses;
        each accumulates a trail.
      grid — (H, W) int8 occupancy export (rviz-style, see
        tpunav.estimation.rbpf.grid.occupancy_grid) — drawn as the
        background when ``grid_cfg`` is given.
      landmark_est — (centers (n, 2), active (n,)) tuple.
    Static scene: ``landmarks_true`` (M, 2), ``waypoints`` (W, ≥2),
    ``obstacles`` (polygon list for viz.draw_world), ``bounds``
    (xmin, xmax, ymin, ymax) for the axes window.
    """

    def __init__(self, path: str,
                 slam_pose: Optional[Channel] = None,
                 odom_pose: Optional[Channel] = None,
                 truth_pose: Optional[Channel] = None,
                 grid: Optional[Channel] = None,
                 landmark_est: Optional[Channel] = None,
                 grid_cfg=None, landmarks_true=None, waypoints=None,
                 obstacles=None, bounds=None, title: str = "tpunav live",
                 max_trail: int = 5000):
        self.path = path
        self.ch = {"slam": slam_pose, "odom": odom_pose,
                   "truth": truth_pose, "grid": grid,
                   "lms": landmark_est}
        self._seen = {k: 0 for k in self.ch}
        self.grid_cfg = grid_cfg
        self.landmarks_true = None if landmarks_true is None else \
            np.asarray(landmarks_true)
        self.waypoints = None if waypoints is None else np.asarray(waypoints)
        self.obstacles = obstacles
        self.bounds = bounds
        self.title = title
        # Bounded trails (reviewer r5): an unbounded list leaks memory
        # and makes every frame re-plot the node's whole history — a
        # long-running graph would slowly fall behind its view rate.
        self.trails = {k: collections.deque(maxlen=max_trail)
                       for k in ("slam", "odom", "truth")}
        self._latest = {}
        self.frames = 0

    def _poll(self) -> bool:
        fresh = False
        for name, ch in self.ch.items():
            if ch is None:
                continue
            val, seq = ch.take_new(self._seen[name])
            if val is not None:
                self._seen[name] = seq
                self._latest[name] = val
                if name in self.trails:
                    self.trails[name].append(
                        np.asarray(val, float).copy())
                fresh = True
        return fresh

    def tick(self, t: float) -> None:
        if not self._poll():
            return            # nothing new published — no re-render
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from .. import viz

        fig, ax = plt.subplots(figsize=(6, 6))
        if self._latest.get("grid") is not None and \
                self.grid_cfg is not None:
            g = np.asarray(self._latest["grid"], float)
            prob = np.where(g < 0, 0.5, g / 100.0)
            viz.draw_occupancy(self.grid_cfg, prob, ax=ax)
        if self.obstacles is not None:
            viz.draw_world(self.obstacles, ax=ax)
        if self.landmarks_true is not None:
            ax.plot(self.landmarks_true[:, 0], self.landmarks_true[:, 1],
                    "o", ms=5, mfc="none", mec="tab:gray",
                    label="true landmarks")
        if self.waypoints is not None:
            ax.plot(self.waypoints[:, 0], self.waypoints[:, 1], "x",
                    ms=8, color="tab:purple", label="waypoints")
        lms = self._latest.get("lms")
        if lms is not None:
            centers, active = np.asarray(lms[0]), np.asarray(lms[1])
            if active.any():
                ax.plot(centers[active, 0], centers[active, 1], "+",
                        ms=7, color="tab:red", label="landmark est")
        colors = {"truth": "tab:green", "odom": "tab:orange",
                  "slam": "tab:blue"}
        for name, trail in self.trails.items():
            if not trail:
                continue
            tr = np.asarray(trail)          # rows [theta, x, y]
            ax.plot(tr[:, 1], tr[:, 2], "-", lw=1.2, color=colors[name],
                    label=name)
            viz.draw_robot(tr[-1], ax=ax, color=colors[name])
        if self.bounds is not None:
            ax.set_xlim(self.bounds[0], self.bounds[1])
            ax.set_ylim(self.bounds[2], self.bounds[3])
        ax.set_aspect("equal")
        ax.grid(alpha=0.2, lw=0.5)
        ax.legend(loc="upper right", fontsize=7)
        ax.set_title(f"{self.title} — frame {self.frames}", fontsize=9)

        # Atomic replace: viewers never see a half-written file (the
        # latest-wins contract of an rviz topic, on the filesystem).
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".png",
                                   dir=os.path.dirname(self.path) or ".")
        os.close(fd)
        fig.savefig(tmp, dpi=100)
        plt.close(fig)
        os.replace(tmp, self.path)
        self.frames += 1
