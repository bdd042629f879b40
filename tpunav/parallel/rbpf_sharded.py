"""RBPF grid SLAM with the particle axis sharded over a device mesh.

The reference iterates particles sequentially on one core
(ref: bmapping/src/bmapping/particle_filter.cpp:158-241); the single-device
path (tpunav.estimation.rbpf) vmaps them. Here the particle axis —
poses (P,3), log-weights (P,), and crucially the per-particle maps
(P,H,W) + ESDFs — is sharded across devices (SURVEY.md §2.7 "per-particle
map parallelism"):

- ICP runs replicated (it is particle-independent: one scan pair).
- Proposal sampling, map integration, and the ESDF rebuild — the dominant
  cost — run on local particles only: P/D maps per chip.
- Weight normalization and N_eff are ``pmax``/``psum`` collectives in log
  space (one fused latency-bound reduction per step).
- Low-variance resampling is the one genuinely cross-device stage: the
  (P,) weight vector is all-gathered (tiny), systematic-resample indices
  are computed replicated, and particle state — poses, weights, and the
  log-odds maps — is exchanged via an ``all_gather`` + gather. The ESDF
  plane is NOT exchanged: it is a pure function of the grid, so each
  shard rebuilds it locally post-gather (bit-identical, half the
  resample payload). Resampling only fires at N_eff < P/2; to keep
  collectives out of ``lax.cond`` (SPMD requires uniform execution) the
  gather always runs with identity indices when no resample is due —
  the collective-free ESDF rebuild, by contrast, does sit in a cond and
  runs only on actual resamples.

The PRNG key structure mirrors the single-chip ``pf_slam_step`` (same
split roles, the global per-particle key table sliced per shard), so a
sharded run matches the unsharded one to float-reduction tolerance — the
basis of the parity test in tests/test_rbpf_sharded.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..estimation.rbpf.icp import icp_match, scan_to_points
from ..estimation.rbpf.grid import (esdf, integrate_scan,
                                    likelihood_field_batch)
from ..estimation.rbpf.particle_filter import (
    PFConfig,
    PFState,
    _draw_samples,
    _gaussian_from_samples,
    _icp_init_guess,
    _sample_motion_model,
)


def state_sharding(mesh: Mesh, axis_name: str = "p"):
    """NamedSharding pytree for a PFState with the particle axis sharded."""
    part = NamedSharding(mesh, P(axis_name))
    rep = NamedSharding(mesh, P())
    return PFState(poses=part, prev_poses=part, log_weights=part,
                   grids=part, dists=part, prev_scan=rep, has_prev=rep,
                   key=rep)


def _sharded_step(cfg: PFConfig, axis: str, st: PFState,
                  ranges, u, cur_odom, prev_odom) -> PFState:
    """Per-shard body; runs under shard_map with P split over ``axis``."""
    p_total = cfg.num_particles
    nshards = jax.lax.axis_size(axis)
    shard = jax.lax.axis_index(axis)
    p_local = p_total // nshards

    # Key structure matches the single-chip pf_slam_step exactly (split-4
    # with the same roles, global per-particle key table sliced per
    # shard) so sharded and unsharded runs agree to float tolerance.
    key, _k_icp, k_particles, k_res = jax.random.split(st.key[0], 4)
    pkeys_all = jax.random.split(k_particles, p_total)
    pkeys = jax.lax.dynamic_slice_in_dim(pkeys_all, shard * p_local,
                                         p_local)

    # ── ICP scan matching: replicated, particle-independent (ref:
    # :602-612 + cloud_alignment.cpp) ──
    src, src_ok = scan_to_points(ranges, cfg.grid.range_min,
                                 cfg.grid.range_max, cfg.grid.beam_min,
                                 cfg.grid.beam_delta)
    dst, dst_ok = scan_to_points(st.prev_scan, cfg.grid.range_min,
                                 cfg.grid.range_max, cfg.grid.beam_min,
                                 cfg.grid.beam_delta)
    T_init = _icp_init_guess(cur_odom, prev_odom)
    icp = icp_match(cfg.icp, src, src_ok, dst, dst_ok, T_init)
    matcher_ok = jnp.logical_and(icp.converged, st.has_prev)

    # ── Per-particle proposal on LOCAL particles (same staging as
    # pf_slam_step: batched likelihood sweep + vmapped Gaussian fit) ──
    def success_branch(_):
        samples, k2s = jax.vmap(
            lambda pose, k: _draw_samples(cfg, pose, icp.transform, k)
        )(st.poses, pkeys)
        logp_scan = likelihood_field_batch(cfg.grid, st.dists, ranges,
                                           samples)
        return jax.vmap(
            lambda s, lp, pose, k2: _gaussian_from_samples(
                cfg, s, lp, pose, cur_odom, prev_odom, k2)
        )(samples, logp_scan, st.poses, k2s)

    def fail_branch(_):
        new_poses = jax.vmap(
            lambda pose, k: _sample_motion_model(cfg, pose, u, k)
        )(st.poses, pkeys)
        logw = likelihood_field_batch(cfg.grid, st.dists, ranges,
                                      new_poses[:, None, :])[:, 0]
        return new_poses, logw

    new_poses, dlogw = jax.lax.cond(matcher_ok, success_branch,
                                    fail_branch, None)
    log_weights = st.log_weights + dlogw

    # ── Local map integration + ESDF rebuild (the dominant cost: P/D
    # maps per device) ──
    grids = jax.vmap(
        lambda g, pose: integrate_scan(cfg.grid, g, ranges, pose)
    )(st.grids, new_poses)
    dists = jax.vmap(lambda g: esdf(cfg.grid, g))(grids)

    # ── Global log-normalization + N_eff via collectives ──
    m = jax.lax.pmax(jnp.max(log_weights), axis)
    denom = jax.lax.psum(jnp.sum(jnp.exp(log_weights - m)), axis)
    log_weights = log_weights - (m + jnp.log(denom))
    w_local = jnp.exp(log_weights)
    neff = 1.0 / jax.lax.psum(jnp.sum(w_local * w_local), axis)

    # ── Systematic resample indices, replicated (ref: :468-500) ──
    w_all = jax.lax.all_gather(w_local, axis).reshape(p_total)
    lw_all = jax.lax.all_gather(log_weights, axis).reshape(p_total)
    cum = jnp.cumsum(w_all)
    r = jax.random.normal(k_res, (), w_all.dtype) / p_total
    u_pts = r + (shard * p_local +
                 jnp.arange(p_local, dtype=w_all.dtype)) / (p_total - 1)
    res_idx = jnp.clip(jnp.searchsorted(cum, u_pts), 0,
                       p_total - 1).astype(jnp.int32)
    own_idx = shard * p_local + jnp.arange(p_local, dtype=jnp.int32)
    resample = neff < p_total / 2
    idx = jnp.where(resample, res_idx, own_idx)

    # ── Cross-shard particle exchange: all_gather + gather. Identity
    # indices make this a pass-through when no resample fires. ──
    def exchange(x_local):
        x_all = jax.lax.all_gather(x_local, axis)
        x_all = x_all.reshape((p_total,) + x_local.shape[1:])
        return x_all[idx]

    poses = exchange(new_poses)
    prev_poses = exchange(st.poses)
    grids = exchange(grids)
    log_weights = lw_all[idx]

    # The ESDF is a pure function of the grid — REBUILD it locally after
    # the exchange instead of all_gathering a second (P, H, W) plane
    # (shipping it doubled the one bandwidth-bound collective; payload
    # 25.6 → 12.8 MB at P=500/80x80). The rebuild is bit-identical to the
    # pre-exchange ``dists`` (same esdf on the same grids), and only runs
    # when a resample actually fired — the identity-index pass-through
    # keeps the local fields valid otherwise. The rebuild has no
    # collectives, so it is legal inside lax.cond under SPMD (the
    # predicate is psum-derived, uniform across shards).
    dists = jax.lax.cond(
        resample, lambda g: jax.vmap(lambda gg: esdf(cfg.grid, gg))(g),
        lambda g: dists, grids)

    return PFState(poses=poses, prev_poses=prev_poses,
                   log_weights=log_weights, grids=grids, dists=dists,
                   prev_scan=ranges, has_prev=jnp.asarray(True),
                   key=key[None])


def pf_slam_step_sharded(cfg: PFConfig, mesh: Mesh, axis_name: str = "p"):
    """Build the jitted sharded SLAM step.

    Returns ``step(state, ranges, u, cur_odom, prev_odom) -> state`` where
    the state's particle-axis leaves are sharded over ``mesh``'s
    ``axis_name``. ``state.key`` must have a leading length-1 axis (it is
    replicated; shard_map passes it through whole).
    """
    nshards = mesh.shape[axis_name]
    if cfg.num_particles % nshards != 0:
        raise ValueError(
            f"num_particles={cfg.num_particles} not divisible by "
            f"{nshards} shards")

    part = P(axis_name)
    rep = P()
    state_spec = PFState(poses=part, prev_poses=part, log_weights=part,
                         grids=part, dists=part, prev_scan=rep,
                         has_prev=rep, key=rep)
    body = functools.partial(_sharded_step, cfg, axis_name)
    # check_vma=False: the replicated leaves (prev_scan, has_prev, key)
    # are replicated by construction, which the varying-manual-axes
    # checker cannot infer; the out_specs pytree states the sharding.
    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(state_spec, rep, rep, rep, rep),
        out_specs=state_spec,
        check_vma=False)
    return jax.jit(mapped)


def pf_init_sharded(cfg: PFConfig, mesh: Mesh, axis_name: str = "p",
                    pose=None, seed: int = 0, dtype=jnp.float32) -> PFState:
    """pf_init with device placement over the mesh (key gets the leading
    length-1 axis the sharded step expects)."""
    from ..estimation.rbpf.particle_filter import pf_init

    st = pf_init(cfg, pose=pose, seed=seed, dtype=dtype)
    st = st._replace(key=st.key[None])
    shardings = state_sharding(mesh, axis_name)
    return jax.device_put(st, shardings)
