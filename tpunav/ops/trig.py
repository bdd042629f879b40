"""Polynomial trigonometry helpers for the RBPF map integration.

The per-cell bearing of ``estimation/rbpf/grid.py:integrate_scan`` is
quantized to a beam index, so where an atan2 rounds decides which beam a
boundary cell reads. This Cephes-style ``atan2`` builds from +,*,/ and
selects only, so every backend (and any kernel written against the same
formulas) evaluates the same polynomial and quantizes cells to beams
identically, instead of differing wherever two library atan2
implementations round a cell across a beam boundary. Max error ≲ 2e-7 rad
over the full plane (f32) — three orders below the 1°-beam quantization
it feeds.
"""

from __future__ import annotations

import jax.numpy as jnp

_PI = 3.14159265358979323846
_PI_2 = _PI / 2.0
_PI_4 = _PI / 4.0
_TAN_PI_8 = 0.41421356237309503  # tan(pi/8); Cephes atanf range split


def atan_poly(t):
    """atan on t >= 0 (Cephes atanf): direct minimax polynomial below
    tan(pi/8), argument transform (t-1)/(t+1) + pi/4 above."""
    big = t > _TAN_PI_8
    tr = jnp.where(big, (t - 1.0) / (t + 1.0), t)
    z = tr * tr
    r = (((8.05374449538e-2 * z - 1.38776856032e-1) * z
          + 1.99777106478e-1) * z - 3.33329491539e-1) * z * tr + tr
    return jnp.where(big, r + _PI_4, r)


def atan2(y, x):
    """Four-quadrant arctangent matching jnp.arctan2 conventions
    (range (-pi, pi]; atan2(0, 0) = 0), built from elementwise ops only."""
    ax = jnp.abs(x)
    ay = jnp.abs(y)
    hi = jnp.maximum(ax, ay)
    lo = jnp.minimum(ax, ay)
    t = lo / jnp.maximum(hi, 1e-30)
    r = atan_poly(t)
    r = jnp.where(ay > ax, _PI_2 - r, r)     # reflect past pi/4
    r = jnp.where(x < 0.0, _PI - r, r)       # left half-plane
    return jnp.where(y < 0.0, -r, r)         # lower half-plane


def positive_mod(a, period: float):
    """a mod period into [0, period) for possibly-negative a, from
    floor/multiply only."""
    q = jnp.floor(a * (1.0 / period))
    m = a - q * period
    # Guard the float edge m == period (a tiny negative a can round up).
    return jnp.where(m >= period, m - period, jnp.maximum(m, 0.0))


def round_half_up(a):
    """floor(a + 0.5): round-half-away for non-negative a (the beam
    quantizer's domain); identical in both the XLA and kernel paths."""
    return jnp.floor(a + 0.5)
