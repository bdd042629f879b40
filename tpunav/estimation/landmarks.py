"""Lidar landmark detection: clustering + algebraic circle fitting.

Data-parallel re-design of ``nuslam::Landmarks``
(ref: nuslam/include/nuslam/landmarks.hpp:99-141,
nuslam/src/nuslam/landmarks.cpp). Design mapping (SURVEY.md §2.3):

- Euclidean clustering (ref: clusterScan landmarks.cpp:354-446) becomes a
  ``lax.scan`` carrying the previous *valid* endpoint, producing per-beam
  cluster ids by cumulative-summing "gap > epsilon" flags — plus the same
  wrap-around first/last merge and the <4-point cluster drop, done with
  masks instead of vector erases.
- The "hyper-accurate" algebraic circle fit (ref: composeCircle
  landmarks.cpp:99-237) is reformulated over the 4x4 moment matrix
  S = ZᵀZ accumulated with ``segment_sum``: the reference's full SVD of
  the (m, 4) design matrix Z only ever feeds Y = VΣVᵀ = sqrt(ZᵀZ) and the
  4x4 eigenproblem of Y·H⁻¹·Y, so the whole fit is two 4x4 ``eigh``s per
  cluster, vmapped — no variable-length per-cluster gathers at all.
- Circle-vs-wall classification via inscribed-angle statistics
  (ref: classifyCircles landmarks.cpp:448-509) is vectorized with
  per-cluster endpoint lookups + masked mean/std.

All shapes static: ``max_clusters`` caps the number of output circles.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

_SIGMA4_EPS = 1e-12   # small-singular-value branch (ref: landmarks.cpp:168)


@dataclasses.dataclass(frozen=True)
class LaserProps:
    """Lidar geometry (ref: nuslam::LaserProperties landmarks.hpp:20-79 and
    LDS-01 constants in landmarks_node.cpp:68-77)."""

    beam_min: float = 0.0
    beam_delta: float = jnp.pi / 180.0 * 1.0   # 1 degree
    range_min: float = 0.12
    range_max: float = 3.5
    num_beams: int = 360


@dataclasses.dataclass(frozen=True)
class LandmarkConfig:
    props: LaserProps = LaserProps()
    epsilon: float = 0.075          # cluster gap (ref: landmarks_node.cpp:77)
    radius_thresh: float = 0.05     # (ref: landmarks.cpp ctor radius_thresh)
    min_points: int = 4             # (ref: num_points landmarks.cpp:253)
    max_clusters: int = 64          # static output capacity
    angle_std: float = 0.15         # (ref: classifyCircles gates)
    mu_min_deg: float = 90.0
    mu_max_deg: float = 135.0
    # Inscribed-angle circle/wall classification in featureDetection.
    # Default False = the reference's shipped behavior (radius filter
    # only; classifyCircles exists but is bypassed, landmarks.cpp:
    # 299-307). True additionally rejects wall/corner clusters whose
    # algebraic fit sneaks under radius_thresh (phantom landmarks).
    use_classify: bool = False


class Circles(NamedTuple):
    centers: jnp.ndarray   # (C, 2)
    radii: jnp.ndarray     # (C,)
    valid: jnp.ndarray     # (C,) bool


def laser_end_points(props: LaserProps, ranges):
    """Polar scan → cartesian endpoints + validity mask
    (ref: Landmarks::laserEndPoints landmarks.cpp:314-350)."""
    angles = props.beam_min + props.beam_delta * jnp.arange(
        props.num_beams, dtype=ranges.dtype)
    valid = jnp.logical_and(ranges >= props.range_min,
                            ranges < props.range_max)
    pts = jnp.stack([ranges * jnp.cos(angles), ranges * jnp.sin(angles)],
                    axis=-1)
    return pts, valid


def cluster_scan(cfg: LandmarkConfig, pts, valid):
    """Assign a cluster id to every beam (invalid beams get id -1).

    Matches the reference's sequential pass over *valid* endpoints
    (ref: clusterScan landmarks.cpp:354-446): a valid point opens a new
    cluster when its distance to the previous valid point exceeds epsilon;
    afterwards the first and last clusters merge if the first and last
    valid endpoints are within epsilon (scan starting mid-cluster).
    """
    n = pts.shape[0]

    def gap_step(prev, inp):
        p, ok = inp
        d = jnp.linalg.norm(p - prev)
        new_cluster = jnp.logical_and(ok, d > cfg.epsilon)
        prev = jnp.where(ok, p, prev)
        return prev, new_cluster

    # Previous-valid carry seeded with the first valid point so the very
    # first valid beam produces distance 0 (ref: :404-405 curr=prev=front).
    first_idx = jnp.argmax(valid)
    seed = pts[first_idx]
    _, new_flags = jax.lax.scan(gap_step, seed, (pts, valid))

    ids = jnp.cumsum(new_flags.astype(jnp.int32))
    ids = jnp.where(valid, ids, -1)

    # Wrap-around merge (ref: :416-432).
    last_idx = n - 1 - jnp.argmax(valid[::-1])
    any_valid = jnp.any(valid)
    wrap = jnp.logical_and(
        any_valid,
        jnp.linalg.norm(pts[first_idx] - pts[last_idx]) <= cfg.epsilon)
    last_id = ids[last_idx]
    first_id = ids[first_idx]
    distinct = last_id != first_id
    ids = jnp.where(
        jnp.logical_and(jnp.logical_and(wrap, distinct), ids == last_id),
        first_id, ids)
    return ids


def _fit_from_moments(S, z_bar, count):
    """Circle parameters (a, b, R²) in centroid coordinates from the 4x4
    moment matrix S = ZᵀZ (ref: composeCircle landmarks.cpp:99-237)."""
    # Eigendecomposition of S = V Σ² Vᵀ replaces the reference's SVD of Z.
    s_eig, V = jnp.linalg.eigh(S)           # ascending eigenvalues
    s_eig = jnp.maximum(s_eig, 0.0)
    sigma = jnp.sqrt(s_eig)                 # singular values of Z

    # Branch 1: rank-deficient — null vector of S (ref: :168-172).
    A_small = V[:, 0]

    # Branch 2: Y = sqrt(S), Q = Y Hinv Y, smallest positive eigenvalue.
    # HIGHEST: f32 products may otherwise run in TF32 on a GPU, too
    # coarse for the eigen-solve's smallest positive eigenvalue.
    Y = jnp.matmul(V * sigma, V.T, precision=jax.lax.Precision.HIGHEST)
    Hinv = jnp.array([
        [0.0, 0.0, 0.0, 0.5],
        [0.0, 1.0, 0.0, 0.0],
        [0.0, 0.0, 1.0, 0.0],
        [0.5, 0.0, 0.0, 0.0],
    ], dtype=S.dtype).at[3, 3].set(-2.0 * z_bar)
    Q = jnp.matmul(jnp.matmul(Y, Hinv, precision=jax.lax.Precision.HIGHEST), Y, precision=jax.lax.Precision.HIGHEST)
    q_eig, W = jnp.linalg.eigh(Q)
    # Smallest strictly-positive eigenvalue (ref: :196-207).
    q_masked = jnp.where(q_eig > 0.0, q_eig, jnp.inf)
    idx = jnp.argmin(q_masked)
    Astar = W[:, idx]
    # A = Y⁻¹ A* via least squares (ref uses a COD solve, :229).
    A_gen = jnp.linalg.lstsq(Y, Astar)[0]

    A = jnp.where(sigma[0] < _SIGMA4_EPS, A_small, A_gen)

    a = -A[1] / (2.0 * A[0])
    b = -A[2] / (2.0 * A[0])
    r2 = (A[1] * A[1] + A[2] * A[2] - 4.0 * A[0] * A[3]) / (4.0 * A[0] * A[0])
    return a, b, jnp.sqrt(jnp.maximum(r2, 0.0))


def fit_circles(cfg: LandmarkConfig, pts, ids, valid):
    """Per-cluster circle fits from per-beam points + cluster ids.

    Returns :class:`Circles` with ``max_clusters`` slots. Pipeline per
    cluster (ref: featureDetection landmarks.cpp:269-276): centroid →
    centroid shift → moment accumulation → 4x4 algebraic fit.
    """
    C = cfg.max_clusters
    seg = jnp.where(valid, jnp.clip(ids, 0, C - 1), C)  # invalid → overflow

    ones = valid.astype(pts.dtype)
    count = jax.ops.segment_sum(ones, seg, num_segments=C + 1)[:C]
    sx = jax.ops.segment_sum(pts[:, 0] * ones, seg, num_segments=C + 1)[:C]
    sy = jax.ops.segment_sum(pts[:, 1] * ones, seg, num_segments=C + 1)[:C]
    cnt_safe = jnp.maximum(count, 1.0)
    cx, cy = sx / cnt_safe, sy / cnt_safe   # (ref: centroid :43-60)

    # Shifted coordinates per point (ref: shiftCentroidToOrigin :64-95).
    x = pts[:, 0] - cx[jnp.clip(seg, 0, C - 1)]
    y = pts[:, 1] - cy[jnp.clip(seg, 0, C - 1)]
    z = x * x + y * y

    def moment(v):
        return jax.ops.segment_sum(v * ones, seg, num_segments=C + 1)[:C]

    # S = ZᵀZ with Z rows [z, x, y, 1] — ten unique entries.
    m_zz, m_zx, m_zy, m_z = moment(z * z), moment(z * x), moment(z * y), moment(z)
    m_xx, m_xy, m_x = moment(x * x), moment(x * y), moment(x)
    m_yy, m_y = moment(y * y), moment(y)

    S = jnp.stack([
        jnp.stack([m_zz, m_zx, m_zy, m_z], axis=-1),
        jnp.stack([m_zx, m_xx, m_xy, m_x], axis=-1),
        jnp.stack([m_zy, m_xy, m_yy, m_y], axis=-1),
        jnp.stack([m_z, m_x, m_y, count], axis=-1),
    ], axis=-2)                                        # (C, 4, 4)
    z_bar = m_z / cnt_safe

    ok = count >= cfg.min_points                       # (ref: :437-445)
    # Guard degenerate slots so eigh never sees garbage.
    S_safe = jnp.where(ok[:, None, None], S,
                       jnp.eye(4, dtype=S.dtype)[None])

    a, b, r = jax.vmap(_fit_from_moments)(S_safe, z_bar, count)
    centers = jnp.stack([cx + a, cy + b], axis=-1)

    ok = jnp.logical_and(ok, r <= cfg.radius_thresh)   # (ref: :296-307)
    ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(centers), axis=-1))
    return Circles(centers=centers, radii=r, valid=ok)


def classify_circles(cfg: LandmarkConfig, pts, ids, valid, circles: Circles):
    """Inscribed-angle circle/wall test per cluster
    (ref: classifyCircles landmarks.cpp:448-509): for every inner point P,
    the angle at P subtended by the cluster endpoints; a circle has mean
    angle in [mu_min, mu_max] degrees with std < angle_std.

    Provided for parity with the reference API; featureDetection itself
    uses the radius filter (the reference bypasses this test too,
    landmarks.cpp:278-307).
    """
    C = cfg.max_clusters
    n = pts.shape[0]
    seg = jnp.where(valid, jnp.clip(ids, 0, C - 1), C)
    idx = jnp.arange(n)

    big = jnp.asarray(n + 1)
    first = jax.ops.segment_min(jnp.where(valid, idx, big), seg,
                                num_segments=C + 1)[:C]
    last = jax.ops.segment_max(jnp.where(valid, idx, -1), seg,
                               num_segments=C + 1)[:C]
    first = jnp.clip(first, 0, n - 1)
    last = jnp.clip(last, 0, n - 1)
    p_start = pts[first]                       # (C, 2)
    p_end = pts[last]

    seg_c = jnp.clip(seg, 0, C - 1)
    ps = p_start[seg_c]
    pe = p_end[seg_c]
    a = jnp.linalg.norm(pts - pe, axis=-1)
    b = jnp.linalg.norm(ps - pe, axis=-1)
    c = jnp.linalg.norm(pts - ps, axis=-1)
    # Law of cosines angle at the inner point (ref: lawCosines helper).
    cos_arg = jnp.clip((a * a + c * c - b * b) /
                       jnp.maximum(2.0 * a * c, 1e-12), -1.0, 1.0)
    ang = jnp.arccos(cos_arg)

    inner = jnp.logical_and(valid, jnp.logical_and(idx != first[seg_c],
                                                   idx != last[seg_c]))
    w = inner.astype(pts.dtype)
    n_inner = jax.ops.segment_sum(w, seg, num_segments=C + 1)[:C]
    n_safe = jnp.maximum(n_inner, 1.0)
    mean = jax.ops.segment_sum(ang * w, seg, num_segments=C + 1)[:C] / n_safe
    var = jax.ops.segment_sum(
        (ang - mean[seg_c]) ** 2 * w, seg, num_segments=C + 1)[:C] / n_safe
    std = jnp.sqrt(var)

    mu_min = jnp.deg2rad(cfg.mu_min_deg)
    mu_max = jnp.deg2rad(cfg.mu_max_deg)
    is_circle = jnp.logical_and(
        std < cfg.angle_std,
        jnp.logical_and(mean >= mu_min, mean <= mu_max))
    return jnp.logical_and(is_circle, jnp.logical_and(circles.valid,
                                                      n_inner >= 1))


def _roll_to_cluster_boundary(cfg: LandmarkConfig, pts, valid):
    """Rotate the beam axis so index 0 falls on a cluster boundary.

    The reference reorders a wrap-around cluster's points contiguously
    when merging (landmarks.cpp:416-432); our index-based
    ``classify_circles`` endpoints assume the same, so rotate the scan to
    the first cluster-opening gap before classifying (no-op when the
    whole scan is one cluster)."""
    def gap_step(prev, inp):
        p, ok = inp
        d = jnp.linalg.norm(p - prev)
        new_cluster = jnp.logical_and(ok, d > cfg.epsilon)
        prev = jnp.where(ok, p, prev)
        return prev, new_cluster

    first_idx = jnp.argmax(valid)
    _, gaps = jax.lax.scan(gap_step, pts[first_idx], (pts, valid))
    shift = jnp.where(jnp.any(gaps), jnp.argmax(gaps), 0)
    return jnp.roll(pts, -shift, axis=0), jnp.roll(valid, -shift)


def feature_detection(cfg: LandmarkConfig, ranges) -> Circles:
    """Full pipeline: scan → endpoints → clusters → circle fits → radius
    filter, plus the inscribed-angle circle/wall classification when
    ``cfg.use_classify`` (ref: Landmarks::featureDetection
    landmarks.cpp:259-310; classifyCircles :448-509).
    Fully jittable; returns ``max_clusters`` fixed-size slots."""
    pts, valid = laser_end_points(cfg.props, ranges)
    if cfg.use_classify:
        pts, valid = _roll_to_cluster_boundary(cfg, pts, valid)
    ids = cluster_scan(cfg, pts, valid)
    circles = fit_circles(cfg, pts, ids, valid)
    if cfg.use_classify:
        keep = classify_circles(cfg, pts, ids, valid, circles)
        circles = circles._replace(valid=keep)
    return circles


def circles_to_measurements(circles: Circles):
    """Detected circles → the EKF's measurement format: (C, 2) robot-frame
    centers with NaN rows for empty slots — the TurtleMap-over-a-topic
    hand-off between the reference's landmarks node and slam node
    (ref: nuslam/src/landmarks_node.cpp:84-104 publishing
    nuslam/msg/TurtleMap.msg, consumed at slam_node.cpp:109-123)."""
    return jnp.where(circles.valid[:, None], circles.centers, jnp.nan)
