"""Sharded-MPPI tests on a virtual 8-device CPU mesh: the sharded solve
must produce bitwise-compatible controls with an equivalent single-device
computation fed the same per-shard noise.
"""

import jax
import jax.numpy as jnp
import numpy as np

from tpunav.control import mppi as m
from tpunav.models.cart import CartParams
from tpunav.parallel import mppi_solve_sharded, rollout_mesh

MODEL = CartParams(0.033, 0.160)


def _cfg(k):
    return m.MPPIConfig(rollouts=k, horizon=0.2, dt=0.01)


def _replicated_reference(cfg, nshards, u, key, pose, xd):
    """Single-device computation with the SAME noise layout the sharded
    version generates (per-shard folded keys, concatenated)."""
    sig = jnp.sqrt(jnp.asarray([cfg.ul_var, cfg.ur_var], dtype=u.dtype))
    k_local = cfg.rollouts // nshards
    noise = jnp.concatenate([
        jax.random.normal(jax.random.fold_in(key, i),
                          (k_local, cfg.steps, 2), u.dtype) * sig
        for i in range(nshards)
    ])
    loss, _ = m.rollout_losses(cfg, MODEL, pose, u[None] + noise, xd)
    j = m.cost_to_go(loss)
    u_new = m.update_controls(cfg, u, noise, j)
    return u_new[0], m.shift_controls(cfg, u_new)


def test_sharded_matches_single_device():
    mesh = rollout_mesh()
    nd = mesh.devices.size
    assert nd == 8, f"expected 8 virtual devices, got {nd}"
    cfg = _cfg(8 * 4)
    u = m.init_controls(cfg, dtype=jnp.float64)
    key = jax.random.PRNGKey(11)
    pose = jnp.array([0.1, -0.2, 0.3])
    xd = jnp.array([1.0, 1.0, 0.0])

    # Compute the single-device reference first: the sharded solve donates
    # its control buffer.
    cmd_r, u_next_r = _replicated_reference(cfg, nd, u, key, pose, xd)

    solve = mppi_solve_sharded(cfg, MODEL, mesh)
    cmd_s, u_next_s = solve(u, key, pose, xd)
    assert np.allclose(np.asarray(cmd_s), np.asarray(cmd_r), atol=1e-10)
    assert np.allclose(np.asarray(u_next_s), np.asarray(u_next_r),
                       atol=1e-10)


def test_sharded_rejects_indivisible_k():
    mesh = rollout_mesh()
    try:
        mppi_solve_sharded(_cfg(10), MODEL, mesh)
        raised = False
    except ValueError:
        raised = True
    assert raised


def test_sharded_closed_loop_step_runs():
    # One full solve on the mesh with reference-scale config.
    mesh = rollout_mesh()
    cfg = m.MPPIConfig(rollouts=16, horizon=0.5, dt=0.01)
    solve = mppi_solve_sharded(cfg, MODEL, mesh)
    u = m.init_controls(cfg, dtype=jnp.float64)
    cmd, u_next = solve(u, jax.random.PRNGKey(0),
                        jnp.zeros(3, jnp.float64),
                        jnp.array([0.5, 0.0, 0.0]))
    assert np.all(np.isfinite(np.asarray(cmd)))
    assert u_next.shape == (cfg.steps, 2)


def test_fused_sharded_matches_single_fused_kernel():
    """The fused kernel's partials path on all 8 mesh devices (Pallas
    interpreter): per-shard partials + pmin/psum combine must equal the
    one-device kernel and the XLA solve fed the identical per-shard
    noise."""
    from tpunav.ops.pallas_mppi import (combine_softmax_partials,
                                        mppi_solve_partials)

    mesh = rollout_mesh()
    nd = mesh.devices.size
    cfg = m.MPPIConfig(rollouts=8 * 128, horizon=0.2, dt=0.01)
    u = m.init_controls(cfg, dtype=jnp.float32)
    key = jax.random.PRNGKey(5)
    pose = jnp.array([0.1, -0.2, 0.3], jnp.float32)
    xd = jnp.array([1.0, 1.0, 0.0], jnp.float32)
    sig = jnp.sqrt(jnp.asarray([cfg.ul_var, cfg.ur_var], jnp.float32))
    noise = jnp.concatenate([
        jax.random.normal(jax.random.fold_in(key, i),
                          (cfg.rollouts // nd, cfg.steps, 2),
                          jnp.float32) * sig for i in range(nd)])
    part = mppi_solve_partials(cfg, MODEL, u, noise, pose, xd,
                               interpret=True)
    cmd_1, u_next_1 = combine_softmax_partials(
        cfg, u, part, lambda v: jnp.min(v, 0), lambda v: jnp.sum(v, 0))
    cmd_r, u_next_r = _replicated_reference(cfg, nd, u, key, pose, xd)

    solve = m_sharded(cfg, mesh, fused=True, interpret=True)
    cmd_8, u_next_8 = solve(u, key, pose, xd)
    assert nd == 8
    for a, b in ((cmd_8, cmd_1), (u_next_8, u_next_1), (cmd_8, cmd_r),
                 (u_next_8, u_next_r)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_fused_sharded_rejects_bad_axis_split():
    mesh = rollout_mesh()
    try:
        m_sharded(_cfg(129), mesh, fused=True)
        raised = False
    except ValueError:
        raised = True
    assert raised


def m_sharded(cfg, mesh, **kw):
    return mppi_solve_sharded(cfg, MODEL, mesh, **kw)
