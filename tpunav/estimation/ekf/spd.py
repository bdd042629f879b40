"""Symmetric-positive-definite covariance repair.

Data-parallel re-design of the reference's SPD utilities
(ref: nuslam/src/nuslam/ekf_filter.cpp:18-91). The C++ ``isSPD`` does an
LLT round-trip and ``nearestSPD`` runs Higham's polar-factor iteration
with a full SVD *loop* until LLT succeeds. On an accelerator a single ``eigh`` with
eigenvalue clipping produces the nearest SPD matrix in Frobenius norm
directly (Higham 1988's analytical solution), with no data-dependent loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def is_spd(mat):
    """True if the matrix is symmetric positive definite — detected by a
    Cholesky attempt, mirroring the reference's LLT probe
    (ref: ekf_filter.cpp:28-45). NaN factor ⇒ not SPD."""
    # Tolerance-based symmetry probe, like Eigen's isApprox in the
    # reference (exact comparison would flag the benign asymmetry that
    # (I-KH)Σ accumulates at machine precision).
    scale = jnp.maximum(jnp.max(jnp.abs(mat)), 1.0)
    tol = 1e5 * jnp.finfo(mat.dtype).eps  # dtype-aware isApprox tolerance
    sym = jnp.max(jnp.abs(mat - mat.T)) <= tol * scale
    chol = jnp.linalg.cholesky(mat)
    return jnp.logical_and(sym, jnp.all(jnp.isfinite(chol)))


def nearest_spd(mat, floor: float = 0.0):
    """Nearest SPD matrix: symmetrize, then clip eigenvalues up to a small
    positive floor (ref behavior: ekf_filter.cpp:49-91; same fixed point,
    computed in one eigh instead of an SVD + eigenvalue-shift loop)."""
    sym = 0.5 * (mat + mat.T)
    w, v = jnp.linalg.eigh(sym)
    # Match the reference's escalation: the floor scales with the largest
    # eigenvalue's ulp (ekf_filter.cpp:80-86 uses eps(norm(Ahat))).
    eps = jnp.finfo(mat.dtype).eps
    lo = jnp.maximum(floor, eps * jnp.maximum(jnp.max(jnp.abs(w)), 1.0))
    w = jnp.maximum(w, lo)
    return (v * w) @ v.T


def repair_if_needed(mat):
    """Repair only when the Cholesky probe fails
    (ref: ekf_filter.cpp:298-305, 330-335 apply nearestSPD conditionally)."""
    return jax.lax.cond(is_spd(mat), lambda m: m, nearest_spd, mat)
