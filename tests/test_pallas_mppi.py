"""Fused Pallas MPPI kernel vs the XLA reference path.

Runs the Triton kernel under the Pallas interpreter (there is no GPU
here); the compiled kernel is checked on the card by chip_smoke.py. The
kernel draws its perturbations with the same key and the same
``sample_perturbations`` call as ``mppi_solve``, so the two solve the
same problem and must agree to float tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpunav.control.mppi import (
    MPPIConfig,
    cost_to_go,
    init_controls,
    mppi_solve,
    rollout_losses,
    sample_perturbations,
    shift_controls,
    update_controls,
)
from tpunav.models.cart import CartParams
from tpunav.ops.pallas_mppi import (
    combine_softmax_partials,
    mppi_solve_fused,
    mppi_solve_partials,
)

MODEL = CartParams(0.033, 0.160)
POSE = jnp.asarray([0.1, -0.2, 0.3], jnp.float32)
XD = jnp.asarray([1.0, 1.0, 0.0], jnp.float32)


def _xla(cfg, u, key, pose=POSE, xd=XD, extra_cost=None):
    return jax.jit(lambda u, k: mppi_solve(cfg, MODEL, u, k, pose, xd,
                                           extra_cost))(u, key)


@pytest.mark.parametrize("k,n", [(128, 10), (256, 25), (100, 20)])
def test_fused_solve_matches_xla(k, n):
    cfg = MPPIConfig(horizon=n * 0.01, dt=0.01, rollouts=k)
    u = init_controls(cfg)
    key = jax.random.PRNGKey(k)
    cmd_p, u_p = mppi_solve_fused(cfg, MODEL, u, key, POSE, XD,
                                  interpret=True)
    cmd_x, u_x = _xla(cfg, u, key)
    np.testing.assert_allclose(np.asarray(cmd_p), np.asarray(cmd_x),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(u_p), np.asarray(u_x),
                               rtol=1e-4, atol=1e-5)


def test_fused_solve_nonzero_nominal():
    cfg = MPPIConfig(horizon=0.2, dt=0.01, rollouts=128)
    u = init_controls(cfg) + jnp.asarray([1.5, -0.5], jnp.float32)
    pose = jnp.zeros(3, jnp.float32)
    xd = jnp.asarray([0.5, 0.0, 0.0], jnp.float32)
    key = jax.random.PRNGKey(3)
    cmd_p, _ = mppi_solve_fused(cfg, MODEL, u, key, pose, xd,
                                interpret=True)
    cmd_x, _ = _xla(cfg, u, key, pose, xd)
    np.testing.assert_allclose(np.asarray(cmd_p), np.asarray(cmd_x),
                               rtol=1e-4, atol=1e-5)


def test_fused_solve_with_obstacles_matches_xla():
    """In-kernel primitive obstacle cost (BASELINE config 2) vs the XLA
    path with the same analytic segment cost."""
    from tpunav.control.obstacle_cost import (SegmentCostParams,
                                              make_segment_obstacle_cost,
                                              segments_from_circles)

    cfg = MPPIConfig(horizon=0.25, dt=0.01, rollouts=128)
    params = SegmentCostParams(r_safe=0.1, w_hit=1e6, w_field=1e3,
                               sigma=0.2)
    segs = jnp.concatenate([
        segments_from_circles(jnp.array([[0.5, 0.1]]), jnp.array([0.05])),
        jnp.array([[0.3, -0.4, 0.3, 0.4, 0.0]], jnp.float32),  # wall
    ])
    u = init_controls(cfg)
    pose = jnp.asarray([0.0, 0.0, 0.0], jnp.float32)
    xd = jnp.asarray([1.0, 0.2, 0.0], jnp.float32)
    key = jax.random.PRNGKey(7)

    cmd_p, u_p = mppi_solve_fused(cfg, MODEL, u, key, pose, xd,
                                  obstacles=segs, obs_cfg=params,
                                  interpret=True)
    cmd_x, u_x = _xla(cfg, u, key, pose, xd,
                      extra_cost=make_segment_obstacle_cost(params, segs))
    np.testing.assert_allclose(np.asarray(cmd_p), np.asarray(cmd_x),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(u_p), np.asarray(u_x),
                               rtol=1e-4, atol=1e-4)


def test_partials_decomposition_matches_full_update():
    """The sharded path's math: per-shard (blocks, N, 6) partials with
    LOCAL mins, rescaled by exp((m_g-m_l)/lambda) and summed across
    shards, must reproduce the single-device softmax update (the combine
    in parallel/mppi_sharded.py)."""
    cfg = MPPIConfig(horizon=0.15, dt=0.01, rollouts=256)
    u = init_controls(cfg) + jnp.asarray([0.5, -0.2], jnp.float32)
    pose = jnp.asarray([0.05, -0.1, 0.2], jnp.float32)
    xd = jnp.asarray([0.8, 0.4, 0.0], jnp.float32)
    noise = sample_perturbations(cfg, jax.random.PRNGKey(11))

    parts = [np.asarray(mppi_solve_partials(
        cfg, MODEL, u, noise[s * 128:(s + 1) * 128], pose, xd,
        block_k=128, interpret=True))[0] for s in range(2)]
    m_g = np.minimum(parts[0][:, 0], parts[1][:, 0])
    red = np.zeros((cfg.steps, 5), np.float64)
    for p in parts:
        s = np.exp((m_g - p[:, 0]) / cfg.lambda_)
        red[:, 0] += s * p[:, 1]
        red[:, 1] += s * p[:, 2]
        red[:, 2] += s * p[:, 3]
        red[:, 3] += p[:, 4]
        red[:, 4] += p[:, 5]
    denom = red[:, 0] + 1e-8 * cfg.rollouts
    du = np.stack([(red[:, 1] + 1e-8 * red[:, 3]) / denom,
                   (red[:, 2] + 1e-8 * red[:, 4]) / denom], axis=1)
    u_sharded = np.clip(np.asarray(u) + du, -cfg.max_wheel_vel,
                        cfg.max_wheel_vel)

    loss, _ = rollout_losses(cfg, MODEL, pose, u[None] + noise, xd)
    u_x = update_controls(cfg, u, noise, cost_to_go(loss))
    np.testing.assert_allclose(u_sharded, np.asarray(u_x), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("block_k", [16, 64, 256])
def test_block_size_does_not_change_the_solve(block_k):
    """Any power-of-two block (one block, several, or a padded last one)
    gives the same controls: the per-block partials combine exactly."""
    cfg = MPPIConfig(horizon=0.2, dt=0.01, rollouts=200)
    u = init_controls(cfg)
    key = jax.random.PRNGKey(21)
    cmd_b, u_b = mppi_solve_fused(cfg, MODEL, u, key, POSE, XD,
                                  block_k=block_k, interpret=True)
    cmd_x, u_x = _xla(cfg, u, key)
    np.testing.assert_allclose(np.asarray(cmd_b), np.asarray(cmd_x),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(u_b), np.asarray(u_x),
                               rtol=1e-4, atol=1e-5)


def test_partials_shape_and_padding():
    """K=100 in blocks of 64: two programs, the second padded with 28
    masked lanes that add nothing to the noise sums."""
    cfg = MPPIConfig(horizon=0.1, dt=0.01, rollouts=100)
    noise = sample_perturbations(cfg, jax.random.PRNGKey(2))
    part = np.asarray(mppi_solve_partials(
        cfg, MODEL, init_controls(cfg), noise, POSE, XD, block_k=64,
        interpret=True))
    assert part.shape == (2, cfg.steps, 6)
    nz = np.asarray(noise)
    np.testing.assert_allclose(part[0, :, 4], nz[:64, :, 0].sum(0),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(part[1, :, 5], nz[64:, :, 1].sum(0),
                               rtol=1e-5, atol=1e-5)
    # Each block's min lane carries weight exp(0) = 1.
    assert np.all(part[:, :, 1] >= 1.0 - 1e-6)


@pytest.mark.parametrize("block_k", [8, 96, 100])
def test_block_k_must_be_power_of_two(block_k):
    cfg = MPPIConfig(horizon=0.1, dt=0.01, rollouts=128)
    with pytest.raises(ValueError):
        mppi_solve_fused(cfg, MODEL, init_controls(cfg),
                         jax.random.PRNGKey(0), POSE, XD, block_k=block_k,
                         interpret=True)


def test_noise_shape_is_checked():
    cfg = MPPIConfig(horizon=0.1, dt=0.01, rollouts=64)
    with pytest.raises(ValueError):
        mppi_solve_partials(cfg, MODEL, init_controls(cfg),
                            jnp.zeros((64, 5, 2), jnp.float32), POSE, XD,
                            interpret=True)


def test_combine_single_block_equals_update_controls():
    """combine_softmax_partials on one block's exact partials is the
    reference update (mppi.cpp:112-126), clamp and shift included."""
    cfg = MPPIConfig(horizon=0.05, dt=0.01, rollouts=8, lambda_=0.5)
    rng = np.random.default_rng(0)
    j = rng.uniform(0.0, 2.0, (cfg.steps, cfg.rollouts))
    z = rng.standard_normal((cfg.rollouts, cfg.steps, 2))
    u = rng.uniform(-1.0, 1.0, (cfg.steps, 2))
    m = j.min(axis=1)
    e = np.exp((m[:, None] - j) / cfg.lambda_)
    part = np.stack([m, e.sum(1), np.einsum("nk,kn->n", e, z[..., 0]),
                     np.einsum("nk,kn->n", e, z[..., 1]),
                     z[..., 0].sum(0), z[..., 1].sum(0)], axis=1)[None]
    cmd, u_next = combine_softmax_partials(
        cfg, jnp.asarray(u), jnp.asarray(part),
        lambda v: jnp.min(v, axis=0), lambda v: jnp.sum(v, axis=0))
    u_ref = update_controls(cfg, jnp.asarray(u), jnp.asarray(z),
                            jnp.asarray(j))
    np.testing.assert_allclose(np.asarray(cmd), np.asarray(u_ref[0]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(u_next),
                               np.asarray(shift_controls(cfg, u_ref)),
                               rtol=1e-10, atol=1e-12)
