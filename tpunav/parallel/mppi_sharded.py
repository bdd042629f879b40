"""MPPI with the rollout axis K sharded over a device mesh.

This is the project's data-parallel + collective story (SURVEY.md §2.7):
the reference runs K rollouts in a sequential loop on one core
(ref: controller/src/controller/mppi.cpp:81-106); here each device rolls
out K/D trajectories and the per-timestep softmax-weighted control update
is reduced across the mesh with ``pmin``/``psum`` collectives, which XLA
hands to NCCL over NVLink.

The math matches :func:`tpunav.control.mppi.mppi_solve` exactly:
- global row-min subtraction (mppi.cpp:112-114) → ``lax.pmin`` over K-shards;
- softmax normalizer and the weighted perturbation sum (mppi.cpp:116-121)
  → one fused ``lax.psum`` of the stacked sums — a single latency-bound
  collective per solve, not one per timestep.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..control.mppi import (
    MPPIConfig,
    cost_to_go,
    rollout_losses,
    shift_controls,
)
from ..models.cart import CartParams
from ..ops.pallas_mppi import combine_softmax_partials, mppi_solve_partials


def _local_noise(cfg: MPPIConfig, axis: str, u, key):
    """This shard's (K/D, N, 2) perturbations, drawn from a device-folded
    key so no (K, N, 2) array ever lives on one device."""
    k_local = cfg.rollouts // jax.lax.axis_size(axis)
    sig = jnp.sqrt(jnp.asarray([cfg.ul_var, cfg.ur_var], dtype=u.dtype))
    local_key = jax.random.fold_in(key, jax.lax.axis_index(axis))
    return jax.random.normal(
        local_key, (k_local, cfg.steps, 2), u.dtype) * sig


def _sharded_body(cfg: MPPIConfig, model: CartParams, axis: str,
                  u, key, pose_xyt, xd):
    """Per-shard XLA solve; runs under shard_map with K split over
    ``axis``. u/key/pose/xd are replicated."""
    noise = _local_noise(cfg, axis, u, key)
    loss, _ = rollout_losses(cfg, model, pose_xyt, u[None] + noise, xd)
    j = cost_to_go(loss)                                   # (N, K/D)

    # Global per-timestep min (ref: mppi.cpp:112-114).
    row_min = jax.lax.pmin(jnp.min(j, axis=1), axis)       # (N,)
    w = jnp.exp(-(j - row_min[:, None]) / cfg.lambda_) + 1e-8

    # Fuse numerator (N, 2) and denominator (N, 1) into ONE psum.
    numer = jnp.einsum("nk,knc->nc", w, noise,
                       precision=jax.lax.Precision.HIGHEST)
    denom = jnp.sum(w, axis=1, keepdims=True)
    reduced = jax.lax.psum(
        jnp.concatenate([numer, denom], axis=1), axis)     # (N, 3)

    u_new = u + reduced[:, :2] / reduced[:, 2:3]
    u_new = jnp.clip(u_new, -cfg.max_wheel_vel, cfg.max_wheel_vel)
    return u_new[0], shift_controls(cfg, u_new)


def _fused_sharded_body(cfg: MPPIConfig, model: CartParams, axis: str,
                        interpret: bool, u, key, pose_xyt, xd):
    """Per-shard fused-kernel solve + exact cross-shard softmax combine.

    The kernel emits per-block partials with the LOCAL min m_l
    (ops/pallas_mppi.py:mppi_solve_partials); the recombination algebra
    lives in ONE place — ops/pallas_mppi.py:combine_softmax_partials —
    here with one pmin + one fused psum per solve over both the blocks
    and the shards.
    """
    noise = _local_noise(cfg, axis, u, key)
    part = mppi_solve_partials(cfg, model, u, noise, pose_xyt, xd,
                               interpret=interpret)
    return combine_softmax_partials(
        cfg, u, part,
        min_fn=lambda m: jax.lax.pmin(jnp.min(m, axis=0), axis),
        sum_fn=lambda x: jax.lax.psum(jnp.sum(x, axis=0), axis))


def mppi_solve_sharded(cfg: MPPIConfig, model: CartParams, mesh: Mesh,
                       axis: str = "k", fused: bool = False,
                       interpret: bool = False):
    """Build a jitted sharded solve: (u, key, pose_xyt, xd) → (cmd, u_next).

    ``cfg.rollouts`` must be divisible by the size of mesh axis ``axis``.
    All arguments and results are replicated; only the rollout working
    set is sharded. ``fused`` runs the Pallas kernel on each shard
    (``interpret`` runs it under the Pallas interpreter, for CPU tests);
    both paths draw the same per-shard noise from ``key``.
    """
    # Shard count = the NAMED axis size, not the whole mesh (on a
    # multi-axis mesh devices.size would over-split K).
    nshards = int(mesh.shape[axis])
    if cfg.rollouts % nshards != 0:
        raise ValueError(
            f"rollouts={cfg.rollouts} not divisible by axis '{axis}' "
            f"size {nshards}")
    if fused:
        body = partial(_fused_sharded_body, cfg, model, axis, interpret)
    else:
        body = partial(_sharded_body, cfg, model, axis)
    # check_vma=False: outputs are replicated by construction (the psum
    # reduces over the only mesh axis), which the varying-manual-axes
    # checker cannot infer statically.
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,))
