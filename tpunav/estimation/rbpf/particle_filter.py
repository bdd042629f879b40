"""Rao-Blackwellized particle filter for grid SLAM, batched over particles.

Data-parallel re-design of ``bmapping::ParticleFilter``
(ref: bmapping/include/bmapping/particle_filter.hpp:89-233,
bmapping/src/bmapping/particle_filter.cpp). Design mapping (SURVEY.md §2.4):

- The per-particle loop (particle_filter.cpp:158-241) becomes a particle
  batch axis: poses (P, 3), log-weights (P,), and per-particle maps
  (P, H, W) — every stage vmapped.
- Weights live in LOG space: the C++ multiplies raw scan likelihoods
  (~1e-150 doubles) into weights; f32 would flush those to zero.
- ICP failure fallback (:160-176) is preserved as a ``lax.cond``: motion-
  model sampling + scan-likelihood weighting when the matcher diverges.
- Low-variance resampling (:468-500) is a vectorized systematic resample:
  cumulative weights + searchsorted gather of the whole particle state
  (including each particle's map).

One deliberate fix vs the reference: ``gaussianProposal`` evaluates the
odometry likelihood against ``particle.prev_pose``, which at call time
still holds the pose from TWO updates ago (it is reassigned only after
sampling, :214-220). We use the particle's current (pre-update) pose, so
the proposal compares the same interval the odometry delta spans.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ...core import se2
from ...core.angles import normalize_angle_pi
from .grid import (
    GridConfig,
    esdf,
    grid_init,
    integrate_scan,
    likelihood_field_batch,
)
from .icp import ICPConfig, icp_match, scan_to_points


@dataclasses.dataclass(frozen=True)
class PFConfig:
    """(ref: bmapping/launch/slam.launch:19-46 defaults.)

    Sensor-density caveat (measured, r5): the scan-matched proposal
    assumes LDS-01-like beam density. At 360 beams/1° the filter holds
    ~3 cm over a constantly-turning course; at 90-180 beams the ~mm
    per-match bias of sparse wall sampling compounds through the
    proposal into meter-scale drift on the same course. Down-beamed
    configs (some tests use 60-90 beams for speed) are smoke-level
    only — don't read fidelity from them."""

    num_particles: int = 40
    k_samples: int = 50              # samples per proposal mode
    srr: float = 0.1                 # odometry model alphas (Table 5.5)
    srt: float = 0.2
    str_: float = 0.1
    stt: float = 0.2
    motion_noise: Tuple[float, float, float] = (1e-10, 1e-10, 1e-10)
    sample_range: Tuple[float, float, float] = (1e-10, 1e-8, 1e-8)
    scan_lik_min: float = 1.0
    scan_lik_max: float = 20.0
    pose_lik_min: float = 1.0
    pose_lik_max: float = 10.0
    grid: GridConfig = GridConfig()
    icp: ICPConfig = ICPConfig()


class PFState(NamedTuple):
    poses: jnp.ndarray        # (P, 3) [theta, x, y]
    prev_poses: jnp.ndarray   # (P, 3)
    log_weights: jnp.ndarray  # (P,)
    grids: jnp.ndarray        # (P, H, W) log-odds
    dists: jnp.ndarray        # (P, H, W) ESDF of each grid
    prev_scan: jnp.ndarray    # (B,) previous ranges (ICP target)
    has_prev: jnp.ndarray     # bool
    key: jnp.ndarray


def pf_init(cfg: PFConfig, pose=None, seed: int = 0,
            dtype=jnp.float32) -> PFState:
    p = cfg.num_particles
    pose0 = jnp.zeros(3, dtype) if pose is None else jnp.asarray(pose, dtype)
    g = grid_init(cfg.grid, dtype)
    return PFState(
        poses=jnp.broadcast_to(pose0, (p, 3)).copy(),
        prev_poses=jnp.broadcast_to(pose0, (p, 3)).copy(),
        log_weights=jnp.full((p,), -jnp.log(float(p)), dtype),
        grids=jnp.broadcast_to(g, (p, *g.shape)).copy(),
        dists=jnp.broadcast_to(esdf(cfg.grid, g), (p, *g.shape)).copy(),
        prev_scan=jnp.zeros((cfg.grid.num_beams,), dtype),
        has_prev=jnp.asarray(False),
        key=jax.random.PRNGKey(seed),
    )


def _sample_motion_model(cfg: PFConfig, pose, u, key):
    """Unicycle propagation + sampled noise (ref: sampleMotionModel
    particle_filter.cpp:295-322 — same formula as the EKF's motionUpdate)."""
    w = jax.random.normal(key, (3,), pose.dtype) * jnp.sqrt(
        jnp.asarray(cfg.motion_noise, pose.dtype))
    om, vx = u[0], u[1]
    small = jnp.abs(om) < 1e-12
    om_safe = jnp.where(small, 1.0, om)
    th = normalize_angle_pi(pose[0] + jnp.where(small, 0.0, om) + w[0])
    dx = jnp.where(small, vx * jnp.cos(th),
                   (-vx / om_safe) * jnp.sin(th) +
                   (vx / om_safe) * jnp.sin(th + om)) + w[1]
    dy = jnp.where(small, vx * jnp.sin(th),
                   (vx / om_safe) * jnp.cos(th) -
                   (vx / om_safe) * jnp.cos(th + om)) + w[2]
    return jnp.stack([th, pose[1] + dx, pose[2] + dy])


def _pdf_normal(x, var):
    return jnp.exp(-0.5 * x * x / var) / jnp.sqrt(2.0 * jnp.pi * var)


def pose_likelihood_odom(cfg: PFConfig, cur_pose, prev_pose, cur_odom,
                         prev_odom):
    """Odometry motion-model probability, rot1/trans/rot2 decomposition
    (ref: poseLikelihoodOdom particle_filter.cpp:383-437, Probabilistic
    Robotics Table 5.5). Poses/odoms are (3,) [theta, x, y]."""
    def decompose(a, b):
        rot1 = jnp.arctan2(b[2] - a[2], b[1] - a[1]) - a[0]
        trans = jnp.hypot(b[1] - a[1], b[2] - a[2])
        rot2 = normalize_angle_pi(
            normalize_angle_pi(b[0]) - normalize_angle_pi(a[0]) - rot1)
        return rot1, trans, rot2

    rot1, trans, rot2 = decompose(prev_odom, cur_odom)
    rot1h, transh, rot2h = decompose(prev_pose, cur_pose)

    v1 = cfg.srr * rot1h ** 2 + cfg.srt * transh ** 2
    v2 = cfg.str_ * transh ** 2 + cfg.stt * (rot1h ** 2 + rot2h ** 2)
    v3 = cfg.srr * rot2h ** 2 + cfg.srt * transh ** 2
    tiny = 1e-12
    p1 = _pdf_normal(normalize_angle_pi(
        normalize_angle_pi(rot1) - normalize_angle_pi(rot1h)),
        jnp.maximum(v1, tiny))
    p2 = _pdf_normal(trans - transh, jnp.maximum(v2, tiny))
    p3 = _pdf_normal(normalize_angle_pi(
        normalize_angle_pi(rot2) - normalize_angle_pi(rot2h)),
        jnp.maximum(v3, tiny))
    return p1 * p2 * p3


def _icp_init_guess(cur_odom, prev_odom):
    """Odometry-delta initial guess for the scan matcher.

    Deliberate fix vs the reference: icpInitGuess
    (particle_filter.cpp:602-612) pairs the WORLD-frame displacement with
    the heading difference, but the scan matcher's transform lives in the
    previous BODY frame — the reference guess is only right near zero
    heading. We rotate the displacement into the previous body frame
    (T_init = T_prev⁻¹ ∘ T_cur), which is what ICP actually estimates.
    """
    dth = normalize_angle_pi(normalize_angle_pi(cur_odom[0]) -
                             normalize_angle_pi(prev_odom[0]))
    c, s = jnp.cos(prev_odom[0]), jnp.sin(prev_odom[0])
    dx = cur_odom[1] - prev_odom[1]
    dy = cur_odom[2] - prev_odom[2]
    return jnp.stack([dth, c * dx + s * dy, -s * dx + c * dy])


def _draw_samples(cfg: PFConfig, pose, T_icp, key):
    """Per-particle proposal samples around the ICP mode
    (ref: sampleMode particle_filter.cpp:504-519). Returns the (k, 3)
    samples and the key for the final pose draw."""
    k1, k2 = jax.random.split(key)
    T_x = se2.compose(pose, T_icp)                 # mode (ref: :181-186)
    std = jnp.sqrt(jnp.asarray(cfg.sample_range, pose.dtype))
    samples = T_x + jax.random.normal(k1, (cfg.k_samples, 3),
                                      pose.dtype) * std
    samples = samples.at[:, 0].set(normalize_angle_pi(samples[:, 0]))
    return samples, k2


def _gaussian_from_samples(cfg: PFConfig, samples, logp_scan, pose,
                           cur_odom, prev_odom, k2):
    """Likelihood-weighted Gaussian fit + draw for ONE particle given its
    precomputed scan log-likelihoods (ref: gaussianProposal
    particle_filter.cpp:522-599). Returns (new_pose, log η)."""
    p_scan = jnp.clip(jnp.exp(jnp.clip(logp_scan, -60.0, 60.0)),
                      cfg.scan_lik_min, cfg.scan_lik_max)
    p_pose = jax.vmap(
        lambda s: pose_likelihood_odom(cfg, s, pose, cur_odom, prev_odom)
    )(samples)
    p_pose = jnp.clip(p_pose, cfg.pose_lik_min, cfg.pose_lik_max)

    p = p_scan * p_pose                            # (k,)
    eta = jnp.sum(p)
    mu = jnp.sum(samples * p[:, None], axis=0) / eta
    mu = mu.at[0].set(normalize_angle_pi(mu[0]))
    diff = samples - mu
    # HIGHEST: a TF32 product (a GPU's default for f32) can leave this
    # near-singular covariance indefinite, and the Cholesky then NaNs.
    sigma = jnp.einsum("ki,kj,k->ij", diff, diff, p,
                       precision=jax.lax.Precision.HIGHEST) / eta
    chol = jnp.linalg.cholesky(
        sigma + 1e-12 * jnp.eye(3, dtype=sigma.dtype))
    new_pose = mu + jnp.matmul(chol, jax.random.normal(k2, (3,), mu.dtype),
                               precision=jax.lax.Precision.HIGHEST)
    new_pose = new_pose.at[0].set(normalize_angle_pi(new_pose[0]))
    return new_pose, jnp.log(eta)


def _low_variance_resample(cfg: PFConfig, st: PFState, key) -> PFState:
    """Systematic resampling with the reference's partitioning
    (ref: lowVarianceResampling particle_filter.cpp:468-500: r drawn from
    a standard normal scaled by 1/P, strides of 1/(P-1); the selected
    particles keep their weights)."""
    p = cfg.num_particles
    w = jnp.exp(st.log_weights - jax.nn.logsumexp(st.log_weights))
    cum = jnp.cumsum(w)
    r = jax.random.normal(key, (), w.dtype) / p
    u_pts = r + jnp.arange(p, dtype=w.dtype) / (p - 1)
    idx = jnp.clip(jnp.searchsorted(cum, u_pts), 0, p - 1).astype(jnp.int32)
    return st._replace(
        poses=st.poses[idx],
        prev_poses=st.prev_poses[idx],
        log_weights=st.log_weights[idx],
        grids=st.grids[idx],
        dists=st.dists[idx],
    )


def pf_slam_step(cfg: PFConfig, st: PFState, ranges, u, cur_odom,
                 prev_odom) -> PFState:
    """One full RBPF SLAM update
    (ref: ParticleFilter::SLAM particle_filter.cpp:141-251):
    ICP against the previous scan (odometry init guess) → per-particle
    pose proposal (Gaussian proposal on success, motion model on failure)
    → per-particle map integration → weight normalization → conditional
    low-variance resampling at N_eff < P/2.
    """
    p = cfg.num_particles
    key, k_icp, k_particles, k_res = jax.random.split(st.key, 4)
    pkeys = jax.random.split(k_particles, p)

    src, src_ok = scan_to_points(ranges, cfg.grid.range_min,
                                 cfg.grid.range_max, cfg.grid.beam_min,
                                 cfg.grid.beam_delta)
    dst, dst_ok = scan_to_points(st.prev_scan, cfg.grid.range_min,
                                 cfg.grid.range_max, cfg.grid.beam_min,
                                 cfg.grid.beam_delta)
    T_init = _icp_init_guess(cur_odom, prev_odom)
    icp = icp_match(cfg.icp, src, src_ok, dst, dst_ok, T_init)
    matcher_ok = jnp.logical_and(icp.converged, st.has_prev)

    def success_branch(_):
        samples, k2s = jax.vmap(
            lambda pose, k: _draw_samples(cfg, pose, icp.transform, k)
        )(st.poses, pkeys)                                # (P, k, 3)
        logp_scan = likelihood_field_batch(cfg.grid, st.dists, ranges,
                                           samples)
        return jax.vmap(
            lambda s, lp, pose, k2: _gaussian_from_samples(
                cfg, s, lp, pose, cur_odom, prev_odom, k2)
        )(samples, logp_scan, st.poses, k2s)

    def fail_branch(_):
        """Motion-model sampling + scan-likelihood weighting when ICP
        fails (ref: particle_filter.cpp:160-176)."""
        new_poses = jax.vmap(
            lambda pose, k: _sample_motion_model(cfg, pose, u, k)
        )(st.poses, pkeys)
        logw = likelihood_field_batch(cfg.grid, st.dists, ranges,
                                      new_poses[:, None, :])[:, 0]
        return new_poses, logw

    new_poses, dlogw = jax.lax.cond(matcher_ok, success_branch,
                                    fail_branch, None)
    log_weights = st.log_weights + dlogw

    # Every particle integrates the scan into ITS OWN map (ref: :236-240).
    grids = jax.vmap(
        lambda g, pose: integrate_scan(cfg.grid, g, ranges, pose)
    )(st.grids, new_poses)
    dists = jax.vmap(lambda g: esdf(cfg.grid, g))(grids)

    # Normalize + N_eff (ref: normalizeWeights/effectiveParticles
    # :442-465).
    log_weights = log_weights - jax.nn.logsumexp(log_weights)
    w = jnp.exp(log_weights)
    neff = 1.0 / jnp.sum(w * w)

    st = PFState(poses=new_poses, prev_poses=st.poses,
                 log_weights=log_weights, grids=grids, dists=dists,
                 prev_scan=ranges, has_prev=jnp.asarray(True), key=key)
    st = jax.lax.cond(
        neff < p / 2,
        lambda s: _low_variance_resample(cfg, s, k_res),
        lambda s: s, st)
    return st


def best_particle(st: PFState):
    """Highest-weight particle's (pose, grid) — the filter's estimate
    (ref: getRobotState/newMap particle_filter.cpp:255-291)."""
    i = jnp.argmax(st.log_weights)
    return st.poses[i], st.grids[i]
