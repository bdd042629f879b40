"""MPPI — model-predictive path-integral control, fully batched.

Data-parallel re-design of ``controller::MPPI``
(ref: controller/include/controller/mppi.hpp:121-185,
controller/src/controller/mppi.cpp:28-186). The reference iterates K
rollouts in a Python-style for-loop, integrating one trajectory at a time
with per-step scalar RNG draws. Here the whole solve is one traced program:

- perturbations: a single ``jax.random.normal`` draw of shape (K, N, 2)
  (counter-based keys replace the global Mersenne twister);
- rollouts: ``lax.scan`` over the horizon N carrying all K states (K, 3)
  at once — K is the wide, data-parallel axis;
- cost-to-go: reverse cumulative sum down the (N, K) loss matrix
  (ref: cumSumCost mppi.cpp:15-25);
- update: per-step softmax over K (min-subtracted, +1e-8 floored, exactly
  as mppi.cpp:112-121), importance-weighted perturbation average, clamp,
  receding-horizon shift (mppi.cpp:124-137).

Semantics match the reference step-for-step at equal (K, N) when fed equal
noise; throughput comes from K being a batch axis instead of a loop.
``tpunav.ops.pallas_mppi.mppi_solve_fused`` is the same solve as one
Pallas kernel per block of rollouts.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..models.cart import CartParams, kinematic_cart
from ..ops.rk4 import rk4_solve

# MPPI state convention matches the reference: x = (x, y, theta)
# (ref: MPPI::newControls mppi.cpp:74-76), unlike se2's (theta, x, y).


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    """Solver configuration (ref: controller/config/mppi_params.yaml:1-26).

    Static under jit — changing it retraces the solve.
    """

    lambda_: float = 0.01        # temperature (yaml: lambda)
    max_wheel_vel: float = 6.35495  # clamp (diff_params.yaml max_rot_motor)
    ul_var: float = 0.9          # left-wheel perturbation variance
    ur_var: float = 0.9          # right-wheel perturbation variance
    horizon: float = 1.0         # seconds
    dt: float = 0.01             # integration step
    rollouts: int = 5            # K
    q_diag: Tuple[float, float, float] = (1e4, 1e4, 1.0)
    r_diag: Tuple[float, float] = (0.1, 0.1)
    p1_diag: Tuple[float, float, float] = (1e3, 1e3, 1e3)
    u_init: Tuple[float, float] = (0.0, 0.0)

    @property
    def steps(self) -> int:
        """N = horizon/dt (ref: mppi.hpp ctor, `steps(horizon/dt)`)."""
        return int(self.horizon / self.dt)


def init_controls(cfg: MPPIConfig, dtype=jnp.float32):
    """Nominal control sequence u ∈ (N, 2), initialized to u_init
    (ref: MPPI::initController/setInitialControls mppi.cpp:56-62,157-170)."""
    u0 = jnp.asarray(cfg.u_init, dtype=dtype)
    return jnp.broadcast_to(u0, (cfg.steps, 2)).copy()


def rollout_losses(cfg: MPPIConfig, model: CartParams, x0, u_pert, xd,
                   extra_cost=None):
    """Simulate all K rollouts and evaluate the (N, K) loss matrix.

    x0: (3,) state (x, y, theta); u_pert: (K, N, 2); xd: (3,) waypoint.
    Running loss is the LQR form xᵀQx + uᵀRu with diagonal Q/R
    (ref: LossFunc::loss mppi.hpp:87-93); the last row is OVERWRITTEN by
    the terminal loss xᵀP1x (ref: mppi.cpp:105 — it replaces, not adds).
    Returns (loss (N, K), traj (N, K, 3)).
    """
    k = u_pert.shape[0]
    us = jnp.swapaxes(u_pert, 0, 1)  # (N, K, 2) time-major for the scan
    f = lambda x, u: kinematic_cart(model, x, u)
    x0_b = jnp.broadcast_to(x0, (k, 3))
    traj = rk4_solve(f, x0_b, us, cfg.dt)  # (N, K, 3)

    q = jnp.asarray(cfg.q_diag, dtype=traj.dtype)
    r = jnp.asarray(cfg.r_diag, dtype=traj.dtype)
    p1 = jnp.asarray(cfg.p1_diag, dtype=traj.dtype)

    err = traj - xd
    running = jnp.sum(err * err * q, axis=-1) + jnp.sum(us * us * r, axis=-1)
    terminal = jnp.sum(err[-1] * err[-1] * p1, axis=-1)
    loss = running.at[-1].set(terminal)
    if extra_cost is not None:
        # State-dependent extra running cost (e.g. the obstacle ESDF
        # field, control/obstacle_cost.py) applied at every step,
        # including the terminal row.
        loss = loss + extra_cost(traj[..., :2])
    return loss, traj


def cost_to_go(loss):
    """Reverse cumulative sum down the rows of the (N, K) loss matrix
    (ref: cumSumCost mppi.cpp:15-25)."""
    return jnp.cumsum(loss[::-1], axis=0)[::-1]


def sample_perturbations(cfg: MPPIConfig, key, dtype=jnp.float32):
    """(K, N, 2) Gaussian control perturbations with per-wheel std
    (ref: MPPI::pertubations mppi.cpp:173-184)."""
    sig = jnp.sqrt(jnp.asarray([cfg.ul_var, cfg.ur_var], dtype=dtype))
    return jax.random.normal(key, (cfg.rollouts, cfg.steps, 2), dtype) * sig


def update_controls(cfg: MPPIConfig, u, noise, j):
    """Softmax-weighted control update + clamp (ref: mppi.cpp:112-126).

    u: (N, 2) nominal; noise: (K, N, 2) perturbations; j: (N, K) cost-to-go.
    The per-step weights are independent across time, so the reference's
    sequential i-loop becomes one einsum.
    """
    j = j - jnp.min(j, axis=1, keepdims=True)
    w = jnp.exp(-j / cfg.lambda_) + 1e-8
    w = w / jnp.sum(w, axis=1, keepdims=True)          # (N, K)
    # HIGHEST: a float32 contraction may otherwise run in TF32 on a GPU
    # (~10 mantissa bits), several hundred times coarser than f32.
    u_new = u + jnp.einsum("nk,knc->nc", w, noise,
                           precision=jax.lax.Precision.HIGHEST)
    return jnp.clip(u_new, -cfg.max_wheel_vel, cfg.max_wheel_vel)


def shift_controls(cfg: MPPIConfig, u):
    """Receding-horizon shift: drop the executed first column, refill the
    tail with u_init (ref: mppi.cpp:128-137)."""
    u_init = jnp.asarray(cfg.u_init, dtype=u.dtype)
    return jnp.concatenate([u[1:], u_init[None]], axis=0)


def mppi_solve(cfg: MPPIConfig, model: CartParams, u, key, pose_xyt, xd,
               extra_cost=None):
    """One full MPPI solve (ref: MPPI::newControls mppi.cpp:72-140).

    u: (N, 2) nominal controls; pose_xyt: (3,) current state (x, y, theta);
    xd: (3,) waypoint; extra_cost: optional (..., 2) positions → cost
    (e.g. an obstacle distance field). Returns (wheel_cmd (2,),
    u_next (N, 2)).
    """
    noise = sample_perturbations(cfg, key, dtype=u.dtype)
    loss, _ = rollout_losses(cfg, model, pose_xyt, u[None] + noise, xd,
                             extra_cost)
    j = cost_to_go(loss)
    u_new = update_controls(cfg, u, noise, j)
    return u_new[0], shift_controls(cfg, u_new)


class MPPIController:
    """Thin host-side wrapper holding (u, key) state around the jitted solve.

    Mirrors the role of the C++ ``MPPI`` object inside mppi_waypoints_node
    (ref: nuturtle_robot/src/mppi_waypoints_node.cpp:265-287) without any
    host↔device round-trips mid-solve: the control buffer is donated.
    """

    def __init__(self, cfg: MPPIConfig, model: CartParams, seed: int = 0,
                 dtype=jnp.float32):
        self.cfg = cfg
        self.model = model
        self.u = init_controls(cfg, dtype=dtype)
        self.key = jax.random.PRNGKey(seed)
        self.xd = jnp.zeros((3,), dtype=dtype)
        self._solve = jax.jit(
            lambda u, key, pose, xd: mppi_solve(cfg, model, u, key, pose, xd),
            donate_argnums=(0,),
        )

    def set_waypoint(self, xd):
        """(ref: MPPI::setWaypoint mppi.cpp:64-69)."""
        self.xd = jnp.asarray(xd, dtype=self.u.dtype)

    def set_initial_controls(self, ul: float, ur: float):
        """(ref: MPPI::setInitialControls mppi.cpp:54-61)."""
        self.u = jnp.broadcast_to(
            jnp.asarray([ul, ur], dtype=self.u.dtype), self.u.shape
        ).copy()

    def new_controls(self, pose_xyt):
        """Solve and advance internal state; returns wheel velocities (2,)."""
        self.key, sub = jax.random.split(self.key)
        cmd, self.u = self._solve(
            self.u, sub, jnp.asarray(pose_xyt, dtype=self.cfg_dtype), self.xd
        )
        return cmd

    @property
    def cfg_dtype(self):
        return self.u.dtype
