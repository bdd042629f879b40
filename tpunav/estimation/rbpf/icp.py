"""2D ICP scan matching: batched nearest-neighbor + closed-form Procrustes.

Data-parallel replacement for the reference's PCL IterativeClosestPoint
wrapper (ref: bmapping/include/bmapping/cloud_alignment.hpp:28-80,
bmapping/src/bmapping/cloud_alignment.cpp — PCL is a CPU-only native
dependency, SURVEY.md §2.8). Correspondences are a dense (B×B) masked
distance matrix (360 beams — trivially small); the per-iteration rigid
alignment is the closed-form 2D Procrustes solution (atan2 of the
cross-covariance), iterated a fixed ``max_iter`` times under ``lax.scan``
so the whole match is one traced program.

Convention matches the reference: ``icp_match(src, dst, T_init)`` returns
the SE(2) transform mapping source points into the destination cloud's
frame; with source = current scan and destination = previous scan the
result is the robot's motion delta in the previous body frame
(ref: pclICPWrapper cloud_alignment.cpp:37-72 with the odometry delta as
initial guess, particle_filter.cpp:602-612).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ...core import se2


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """(ref: pclICP cloud_alignment.cpp:160-195 — max_iter=100,
    max_correspondence=0.5 m, RANSAC outlier rejection at 0.05 m,
    convergence on mean residual.)

    ``outlier_thresh`` is the deterministic equivalent of PCL's RANSAC
    rejection: each iteration gates correspondences at
    ``max(outlier_thresh, outlier_scale·q40_residual)`` (0.4 quantile of
    the gated residuals) — loose while the fit is coarse, tightening to
    the reference's 0.05 m once the cloud locks on, so gross mismatches
    (clutter, dynamic obstacles) never enter the Gauss-Newton normal
    equations. The sub-median anchor assumes the gated set is < ~60%
    contaminated; beyond that the anneal stalls at max_corr_dist and the
    convergence criteria below reject the match.

    Convergence requires ALL of: final mean residual ≤
    ``converged_rmse``; the last Gauss-Newton step's |(dθ,dx,dy)| ≤
    ``transform_eps`` (PCL's transformation-epsilon criterion — an
    oscillating match that lands with small rmse no longer reports
    success); inlier fraction ≥ ``min_inlier_frac``; and the
    correspondence-normal spectrum min-eigenvalue ≥ ``min_normal_eig``
    (a corridor constrains only one translation direction → the
    match is unobservable and must take the motion-model fallback,
    ref: particle_filter.cpp:160-176)."""

    max_iter: int = 30
    max_corr_dist: float = 0.5
    converged_rmse: float = 0.05
    outlier_thresh: float = 0.05
    outlier_scale: float = 3.0
    transform_eps: float = 1e-3
    min_inlier_frac: float = 0.2
    min_normal_eig: float = 0.05


class ICPResult(NamedTuple):
    transform: jnp.ndarray     # (3,) [theta, x, y]
    converged: jnp.ndarray     # bool
    rmse: jnp.ndarray          # mean inlier correspondence distance
    inlier_frac: jnp.ndarray   # fraction of valid src points kept
    delta_norm: jnp.ndarray    # |(dθ,dx,dy)| of the final GN step
    normal_eig: jnp.ndarray    # min eigenvalue of the normal spectrum


def scan_to_points(ranges, range_min, range_max, beam_min=0.0,
                   beam_delta=jnp.pi / 180.0):
    """Polar scan → sensor-frame points + validity mask
    (ref: createPointCloud cloud_alignment.cpp:76-157)."""
    n = ranges.shape[0]
    angles = beam_min + beam_delta * jnp.arange(n, dtype=ranges.dtype)
    valid = jnp.logical_and(ranges >= range_min, ranges < range_max)
    r = jnp.where(valid, ranges, range_min)
    pts = jnp.stack([r * jnp.cos(angles), r * jnp.sin(angles)], axis=-1)
    return pts, valid


def icp_match(cfg: ICPConfig, src, src_valid, dst, dst_valid,
              T_init) -> ICPResult:
    """Align ``src`` onto ``dst``. src/dst: (N, 2) + validity masks;
    T_init: (3,) initial guess [theta, x, y].

    Point-to-LINE metric: each source point is matched to the local line
    through its nearest destination point and that point's scan-adjacent
    neighbors, and one Gauss-Newton step solves the 3x3 normal equations
    per iteration. This replaces PCL's point-to-point estimator — on
    resampled wall scans point-to-point systematically underestimates
    motion (each sample matches its own shifted copy), which showed up as
    linear pose drift in closed-loop runs; point-to-line is the standard
    fix (Censi's PLICP) and is just as data-parallel.
    """
    big = jnp.asarray(1e9, src.dtype)
    n = dst.shape[0]
    n_src_valid = jnp.maximum(
        jnp.sum(src_valid.astype(src.dtype)), 1e-9)

    def iteration(T, _):
        moved = se2.apply(T, src)                       # (N, 2)
        d2 = jnp.sum(
            (moved[:, None, :] - dst[None, :, :]) ** 2, axis=-1)
        d2 = jnp.where(dst_valid[None, :], d2, big)
        nn = jnp.argmin(d2, axis=1)
        nn_d = jnp.sqrt(jnp.take_along_axis(d2, nn[:, None], 1)[:, 0])
        # Correspondence rejection (PCL max_correspondence_distance).
        gate = jnp.logical_and(src_valid, nn_d <= cfg.max_corr_dist)
        # Robust outlier rejection (PCL RANSAC threshold 0.05 m, ref:
        # cloud_alignment.cpp:160-195): annealed residual gate at
        # max(outlier_thresh, outlier_scale·q40) — the 0.4 quantile of
        # the currently gated correspondences via masked sort. A
        # quantile BELOW 0.5 keeps the anchor on the inlier mode up to
        # ~60% contamination of the gated set (advisor r4: the median
        # tracks the outliers at ≥50% contamination, so rej never
        # tightened); beyond that the gate degrades gracefully to the
        # loose max_corr_dist and convergence is rejected by the
        # rmse/inlier-fraction criteria instead.
        d_masked = jnp.sort(jnp.where(gate, nn_d, big))
        cnt = jnp.sum(gate.astype(jnp.int32))
        med = d_masked[jnp.maximum((2 * cnt) // 5, 0)]
        rej = jnp.maximum(jnp.asarray(cfg.outlier_thresh, src.dtype),
                          cfg.outlier_scale * med)
        w = jnp.logical_and(gate, nn_d <= rej).astype(src.dtype)
        wsum = jnp.maximum(jnp.sum(w), 1e-9)

        q = dst[nn]                                     # matched targets
        # Local line through the scan-adjacent neighbors of the match.
        prv = jnp.clip(nn - 1, 0, n - 1)
        nxt = jnp.clip(nn + 1, 0, n - 1)
        both_ok = jnp.logical_and(dst_valid[prv], dst_valid[nxt])
        tang = jnp.where(both_ok[:, None], dst[nxt] - dst[prv],
                         jnp.zeros_like(q))
        tnorm = jnp.linalg.norm(tang, axis=-1, keepdims=True)
        line_ok = (tnorm[:, 0] > 1e-9)
        tang = tang / jnp.maximum(tnorm, 1e-9)
        normal = jnp.stack([-tang[:, 1], tang[:, 0]], axis=-1)
        # Fallback to point-to-point direction for degenerate lines.
        diff = q - moved
        dnorm = jnp.maximum(jnp.linalg.norm(diff, axis=-1, keepdims=True),
                            1e-9)
        normal = jnp.where(line_ok[:, None], normal, diff / dnorm)

        # Gauss-Newton on r_i = n_i · (p_i + [J p_i]θ + t − q_i),
        # J = 90° rotation. Unknowns x = (θ, tx, ty).
        jp = jnp.stack([-moved[:, 1], moved[:, 0]], axis=-1)
        a = jnp.stack([jnp.sum(normal * jp, axis=-1),
                       normal[:, 0], normal[:, 1]], axis=-1)  # (N, 3)
        b = jnp.sum(normal * (q - moved), axis=-1)            # (N,)
        aw = a * w[:, None]
        # HIGHEST: in TF32 (a GPU's default for f32 products) these
        # near-singular normal equations lose their small pivots.
        ata = jnp.matmul(aw.T, a, precision=jax.lax.Precision.HIGHEST) + \
            1e-9 * jnp.eye(3, dtype=a.dtype)
        atb = jnp.matmul(aw.T, b, precision=jax.lax.Precision.HIGHEST)
        x = jnp.linalg.solve(ata, atb)
        T_delta = jnp.stack([x[0], x[1], x[2]])
        T_new = se2.compose(T_delta, T)
        rmse = jnp.sum(w * nn_d) / wsum
        # Observability: spectrum of the unit-normal outer-product sum.
        # Eigenvalues are in [0,1] and sum to 1 — a corridor's normals
        # all point one way, so the min eigenvalue collapses to ~0.
        nmat = jnp.matmul((normal * w[:, None]).T, normal,
                          precision=jax.lax.Precision.HIGHEST) / wsum       # (2, 2)
        tr, det = nmat[0, 0] + nmat[1, 1], \
            nmat[0, 0] * nmat[1, 1] - nmat[0, 1] * nmat[1, 0]
        disc = jnp.sqrt(jnp.maximum(tr * tr / 4.0 - det, 0.0))
        min_eig = tr / 2.0 - disc
        diag = {"rmse": rmse, "delta": jnp.linalg.norm(x),
                "inlier_frac": jnp.sum(w) / n_src_valid,
                "min_eig": min_eig}
        return T_new, diag

    T, diags = jax.lax.scan(iteration, jnp.asarray(T_init, src.dtype),
                            None, length=cfg.max_iter)
    rmse = diags["rmse"][-1]
    delta = diags["delta"][-1]
    inlier_frac = diags["inlier_frac"][-1]
    min_eig = diags["min_eig"][-1]
    converged = (
        (rmse <= cfg.converged_rmse)
        & (delta <= cfg.transform_eps)
        & (inlier_frac >= cfg.min_inlier_frac)
        & (min_eig >= cfg.min_normal_eig)
        & (jnp.sum(src_valid) > 0))
    T = T.at[0].set(jnp.arctan2(jnp.sin(T[0]), jnp.cos(T[0])))
    return ICPResult(transform=T, converged=converged, rmse=rmse,
                     inlier_frac=inlier_frac, delta_norm=delta,
                     normal_eig=min_eig)
