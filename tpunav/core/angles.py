"""Angle utilities (pure JAX, vmappable, branch-free).

Data-parallel re-design of the reference's constexpr angle helpers
(ref: rigid2d/include/rigid2d/rigid2d.hpp:24-138). All functions operate
elementwise on arrays of any shape and preserve dtype.
"""

from __future__ import annotations

import jax.numpy as jnp

PI = jnp.pi
TWO_PI = 2.0 * jnp.pi


def deg2rad(deg):
    """Degrees → radians (ref: rigid2d.hpp:36-39)."""
    return deg * (jnp.pi / 180.0)


def rad2deg(rad):
    """Radians → degrees (ref: rigid2d.hpp:44-47)."""
    return rad * (180.0 / jnp.pi)


def normalize_angle_pi(rad):
    """Wrap angle(s) to [-pi, pi) (both +pi and -pi map to -pi).

    Matches the reference formula exactly (ref: rigid2d.hpp:53-64):
    q = floor((rad+pi)/2pi); r = (rad+pi) - q*2pi; r += 2pi if r < 0; r - pi.
    Branch-free via ``jnp.where`` so it vectorizes.
    """
    rad = jnp.asarray(rad)
    shifted = rad + PI
    r = shifted - jnp.floor(shifted / TWO_PI) * TWO_PI
    r = jnp.where(r < 0, r + TWO_PI, r)
    return r - PI


def normalize_angle_2pi(rad):
    """Wrap angle(s) to [0, 2pi) (ref: rigid2d.hpp:69-104)."""
    rad = jnp.asarray(rad)
    r = rad - jnp.floor(rad / TWO_PI) * TWO_PI
    r = jnp.where(r < 0, r + TWO_PI, r)
    return r


def almost_equal(d1, d2, epsilon: float = 1.0e-12):
    """abs-eps comparison (ref: rigid2d.hpp:24-27). Returns bool array."""
    return jnp.abs(jnp.asarray(d1) - jnp.asarray(d2)) < epsilon
