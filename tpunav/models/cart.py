"""Differential-drive cart dynamics model (batched ODE).

Data-parallel re-design of ``controller::CartModel``
(ref: controller/include/controller/mppi.hpp:31-53). The ODE is written
over arbitrary leading batch axes so a single call evaluates all K
rollouts' derivatives at once.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class CartParams(NamedTuple):
    wheel_radius: jnp.ndarray
    wheel_base: jnp.ndarray


def kinematic_cart(params: CartParams, x, u):
    """Diff-drive kinematic ODE (ref: mppi.hpp:41-48).

    x: (..., 3) state [x, y, theta]; u: (..., 2) wheel velocities [uL, uR].
    Returns dx/dt of shape (..., 3):
        dx = (r/2)(uL+uR)cos(theta), dy = (r/2)(uL+uR)sin(theta),
        dtheta = (r/base)(uR-uL).
    """
    theta = x[..., 2]
    fwd = (params.wheel_radius / 2.0) * (u[..., 0] + u[..., 1])
    dtheta = (params.wheel_radius / params.wheel_base) * (u[..., 1] - u[..., 0])
    return jnp.stack(
        [fwd * jnp.cos(theta), fwd * jnp.sin(theta), dtheta], axis=-1
    )
