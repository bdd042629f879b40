"""Fixed-step RK4 integration as batched scans.

Data-parallel re-design of ``controller::RK4``
(ref: controller/include/controller/rk4.hpp:19-60,
controller/src/controller/rk4.cpp). The C++ class integrates one state
vector with a per-step control column inside nested for-loops; here the
state carries arbitrary leading batch axes (all K rollouts at once) and the
horizon is a single ``lax.scan``, keeping the whole batch resident on-chip.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def rk4_step(f, x, u, dt):
    """One classical RK4 step with zero-order-hold control
    (ref: RK4::integrate(x, u) rk4.cpp:95-115)."""
    k1 = f(x, u)
    k2 = f(x + dt * 0.5 * k1, u)
    k3 = f(x + dt * 0.5 * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rk4_solve(f, x0, us, dt):
    """Integrate ``steps = us.shape[0]`` RK4 steps, returning the trajectory
    of post-step states (x_1..x_N, excluding x_0) — matching
    ``RK4::solve(x0, u, horizon)`` (ref: rk4.cpp:49-69).

    x0: (..., S) initial state; us: (N, ..., C) time-major controls.
    Returns (N, ..., S).
    """

    def body(x, u_t):
        x_next = rk4_step(f, x, u_t, dt)
        return x_next, x_next

    _, traj = jax.lax.scan(body, x0, us)
    return traj


def rk4_solve_autonomous(f, x0, steps, dt):
    """Uncontrolled variant (ref: RK4::solve(x0, horizon) rk4.cpp:27-46)."""

    def body(x, _):
        x_next = rk4_step(lambda s, _u: f(s), x, None, dt)
        return x_next, x_next

    _, traj = jax.lax.scan(body, x0, None, length=steps)
    return traj
