"""SE(2) Lie-group operations on batched arrays (pure JAX).

Data-parallel re-design of the reference's ``rigid2d::Transform2D``
(ref: rigid2d/include/rigid2d/rigid2d.hpp:314-372,
rigid2d/src/rigid2d/rigid2d.cpp:120-303). Instead of a stateful C++ class,
a transform is a plain ``(..., 3)`` array ``[theta, x, y]`` so every op is
vmappable/scannable and fuses under XLA. Twists are ``(..., 3)`` arrays
``[w, vx, vy]`` (matching ``rigid2d::Twist2D``).

The screw-exponential ``exp_twist`` is branch-free: it replaces the
reference's three-way ``almost_equal`` branch (rigid2d.cpp:239-303) with a
Taylor-guarded sinc formulation, which is exactly equal in the w!=0 and
w==0 limits but compiles to straight-line vector code.
"""

from __future__ import annotations

import jax.numpy as jnp

from .angles import normalize_angle_pi

# Small-angle guard for the sinc-like terms of the SE(2) exponential.
_SMALL_W = 1e-6


def identity(dtype=jnp.float32):
    """Identity transform."""
    return jnp.zeros((3,), dtype=dtype)


def make(theta, x, y):
    """Build transform(s) from components; broadcasts like jnp.stack."""
    theta, x, y = jnp.broadcast_arrays(
        jnp.asarray(theta), jnp.asarray(x), jnp.asarray(y)
    )
    return jnp.stack([theta, x, y], axis=-1)


def theta_of(T):
    return T[..., 0]


def translation_of(T):
    return T[..., 1:3]


def compose(a, b):
    """a ∘ b (ref: Transform2D::operator*= rigid2d.cpp:215-224).

    Angles add without wrapping, exactly like the reference (which stores
    the running sum and only wraps at odometry-update time).
    """
    ta = a[..., 0]
    ca, sa = jnp.cos(ta), jnp.sin(ta)
    bx, by = b[..., 1], b[..., 2]
    x = a[..., 1] + ca * bx - sa * by
    y = a[..., 2] + sa * bx + ca * by
    return jnp.stack([ta + b[..., 0], x, y], axis=-1)


def inverse(T):
    """T^{-1} (ref: Transform2D::inv rigid2d.cpp:170-186)."""
    t = T[..., 0]
    c, s = jnp.cos(t), jnp.sin(t)
    x, y = T[..., 1], T[..., 2]
    return jnp.stack([-t, -(c * x + s * y), -(-s * x + c * y)], axis=-1)


def apply(T, p):
    """Apply transform(s) to point(s) ``p`` of shape (..., 2)
    (ref: Transform2D::operator() rigid2d.cpp:160-167)."""
    t = T[..., 0]
    c, s = jnp.cos(t), jnp.sin(t)
    px, py = p[..., 0], p[..., 1]
    return jnp.stack(
        [T[..., 1] + c * px - s * py, T[..., 2] + s * px + c * py], axis=-1
    )


def adjoint(T, V):
    """Change twist ``V=[w,vx,vy]`` coordinate frame by the adjoint of T
    (ref: Transform2D::operator() on Twist2D, rigid2d.cpp:189-199)."""
    t = T[..., 0]
    c, s = jnp.cos(t), jnp.sin(t)
    w, vx, vy = V[..., 0], V[..., 1], V[..., 2]
    x, y = T[..., 1], T[..., 2]
    return jnp.stack(
        [w, vx * c - vy * s + w * y, vx * s + vy * c - w * x], axis=-1
    )


def exp_twist(V):
    """SE(2) exponential of a unit-time twist ``V=[w,vx,vy]`` → transform.

    Equals the reference's screw integration (rigid2d.cpp:239-303): the
    rotational part is w wrapped to (-pi,pi] (the reference computes it as
    atan2(sin|w|·sgn(w), cos|w|)), the translational part is the SE(2)
    "V-matrix" applied to [vx,vy]:

        dx = A·vx − B·vy,  dy = B·vx + A·vy,
        A = sin(w)/w,      B = (1−cos(w))/w,

    with 5th/4th-order Taylor guards near w=0 so the formula is branch-free
    and exact in both limits (w=0 reduces to pure translation, matching the
    reference's beta=|v| normalize-then-rescale path algebraically).
    """
    w, vx, vy = V[..., 0], V[..., 1], V[..., 2]
    small = jnp.abs(w) < _SMALL_W
    # Guard the denominator; the wrong branch's value is discarded by where.
    w_safe = jnp.where(small, jnp.ones_like(w), w)
    A = jnp.where(small, 1.0 - w * w / 6.0, jnp.sin(w_safe) / w_safe)
    B = jnp.where(small, w / 2.0 - w * w * w / 24.0,
                  (1.0 - jnp.cos(w_safe)) / w_safe)
    dx = A * vx - B * vy
    dy = B * vx + A * vy
    dtheta = jnp.arctan2(jnp.sin(w), jnp.cos(w))
    return jnp.stack([dtheta, dx, dy], axis=-1)


def integrate_twist(T, V):
    """T ∘ exp(V): advance transform T by one unit-time twist
    (ref: Transform2D::integrateTwist rigid2d.cpp:239-303)."""
    return compose(T, exp_twist(V))


def log_twist(T):
    """SE(2) logarithm: transform → unit-time twist ``[w,vx,vy]``.

    Inverse of :func:`exp_twist` (no reference counterpart — the C++ never
    needs it; we use it for ICP pose deltas and proposal means).
    """
    w = normalize_angle_pi(T[..., 0])
    x, y = T[..., 1], T[..., 2]
    small = jnp.abs(w) < _SMALL_W
    w_safe = jnp.where(small, jnp.ones_like(w), w)
    A = jnp.where(small, 1.0 - w * w / 6.0, jnp.sin(w_safe) / w_safe)
    B = jnp.where(small, w / 2.0 - w * w * w / 24.0,
                  (1.0 - jnp.cos(w_safe)) / w_safe)
    # Invert the 2x2 V-matrix [[A,-B],[B,A]]: det = A² + B².
    det = A * A + B * B
    vx = (A * x + B * y) / det
    vy = (-B * x + A * y) / det
    return jnp.stack([w, vx, vy], axis=-1)


def displacement(T):
    """(theta, x, y) view of the transform — identity on our representation
    (ref: Transform2D::displacement rigid2d.cpp:227-235)."""
    return T
