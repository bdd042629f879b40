"""Fused MPPI rollout + cost-to-go + softmax partials as one Pallas kernel
for Hopper, through Triton.

The XLA path (tpunav.control.mppi) lowers the solve to a ``lax.scan``
over the N horizon steps: one short loop iteration per step, with the
(N, K, 3) trajectory and the (N, K) loss written to device memory and read
back by separate cost-to-go and softmax kernels. Here one program per
block of BK rollouts runs the whole horizon with (x, y, θ) in registers
(ref semantics: controller/src/controller/mppi.cpp:72-140):

- grid: ``ceil(K / BK)`` programs, BK a power of two (K is padded with
  masked lanes);
- rollouts: the cart-specific RK4 with three trig pairs per step (for the
  diff-drive cart θ̇ depends only on the held controls, so the k2 and k3
  stage inputs coincide);
- loss: each step's (BK,) loss row is stored to a (N, K) buffer that
  stays in L2 (9.8 MB at K=49,152, N=50), then read back in reverse to
  form each rollout's cost-to-go in registers;
- update: per step, the program emits its softmax partials
  [m_l, Σe, Σe·z0, Σe·z1, Σz0, Σz1] with e = exp((m_l − j)/λ) over its
  block, as a (blocks, N, 6) output. :func:`combine_softmax_partials`
  reduces them over blocks here and over devices in
  parallel/mppi_sharded.py.

Noise is drawn outside the kernel with ``jax.random`` (the same
:func:`tpunav.control.mppi.sample_perturbations` draw ``mppi_solve``
makes), laid out (2, N, K) so that each step's block load coalesces. For
equal keys the kernel therefore solves exactly the problem ``mppi_solve``
solves.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..control.mppi import MPPIConfig, sample_perturbations, shift_controls
from ..models.cart import CartParams

BLOCK_K = 128      # rollouts per program (tuned on an H100, see PERF.md)


def _mppi_kernel(cfg: MPPIConfig, model: CartParams, k: int, bk: int,
                 n_obs: int, p_ref, u_ref, nz_ref, *refs):
    if n_obs:
        obs_ref, part_ref, loss_ref = refs
    else:
        part_ref, loss_ref = refs
    n = cfg.steps
    wr, wb = model.wheel_radius, model.wheel_base
    dt = cfg.dt
    q0, q1, q2 = cfg.q_diag
    r0, r1 = cfg.r_diag
    p0, p1, p2 = cfg.p1_diag
    xdx, xdy, xdt = p_ref[3], p_ref[4], p_ref[5]
    # The packed obstacle array, loaded once per program: (O, 5)
    # primitives [ax, ay, bx, by, r] and the weights row.
    obs = [[obs_ref[o, c] for c in range(5)] for o in range(n_obs + 1)] \
        if n_obs else []

    # ── Rollouts over the horizon; each step's loss row goes to L2 ──
    def step(t, carry):
        x, y, th = carry
        ul = u_ref[t, 0] + nz_ref[0, t, :]
        ur = u_ref[t, 1] + nz_ref[1, t, :]

        # Classical RK4 with zero-order-hold control (rk4.cpp:95-115),
        # written in ops/rk4.py's accumulation order; k3 == k2 here.
        w = (wr / wb) * (ur - ul)
        fwd = (wr / 2.0) * (ul + ur)
        k1x = fwd * jnp.cos(th)
        k1y = fwd * jnp.sin(th)
        th2 = th + dt * 0.5 * w
        k2x = fwd * jnp.cos(th2)
        k2y = fwd * jnp.sin(th2)
        th4 = th + dt * w
        k4x = fwd * jnp.cos(th4)
        k4y = fwd * jnp.sin(th4)
        s = dt / 6.0
        x = x + s * (k1x + 2.0 * k2x + 2.0 * k2x + k4x)
        y = y + s * (k1y + 2.0 * k2y + 2.0 * k2y + k4y)
        th = th + s * (w + 2.0 * w + 2.0 * w + w)

        # LQR loss (mppi.hpp:87-93); the terminal row REPLACES the
        # running loss (mppi.cpp:105).
        ex, ey, et = x - xdx, y - xdy, th - xdt
        running = (ex * ex * q0 + ey * ey * q1 + et * et * q2) + \
            (ul * ul * r0 + ur * ur * r1)
        terminal = ex * ex * p0 + ey * ey * p1 + et * et * p2
        loss = jnp.where(t == n - 1, terminal, running)

        if n_obs:
            # Analytic primitive-set obstacle cost on the block's
            # positions — control/obstacle_cost.py's
            # make_segment_obstacle_cost, added after the terminal
            # overwrite like the XLA path's extra_cost. The weights are
            # the packed array's last row, so tuning them never
            # recompiles the kernel.
            d = jnp.full((bk,), jnp.inf, jnp.float32)
            for ax, ay, bx, by, rr in obs[:n_obs]:
                abx, aby = bx - ax, by - ay
                inv = 1.0 / jnp.maximum(abx * abx + aby * aby, 1e-12)
                tp = jnp.clip(((x - ax) * abx + (y - ay) * aby) * inv,
                              0.0, 1.0)
                px = x - (ax + tp * abx)
                py = y - (ay + tp * aby)
                d = jnp.minimum(d, jnp.sqrt(px * px + py * py) - rr)
            r_safe, w_hit, w_field, inv_sigma, _ = obs[n_obs]
            hit = jnp.where(d <= r_safe, 1.0, 0.0)
            loss = loss + w_hit * hit + \
                w_field * jnp.exp(-(d - r_safe) * inv_sigma)

        loss_ref[t, :] = loss
        return x, y, th

    init = tuple(jnp.full((bk,), p_ref[i], jnp.float32) for i in range(3))
    jax.lax.fori_loop(0, n, step, init)

    # ── Reverse pass: cost-to-go (mppi.cpp:15-25) accumulated in
    # registers, and the block's softmax partials per step
    # (mppi.cpp:112-121). Padded lanes take no part in min or sums. ──
    lane = pl.program_id(0) * bk + jnp.arange(bk, dtype=jnp.int32)
    valid = lane < k
    inv_lam = 1.0 / cfg.lambda_

    def back(i, acc):
        t = n - 1 - i
        acc = acc + loss_ref[t, :]
        jt = jnp.where(valid, acc, jnp.inf)
        m = jnp.min(jt)
        e = jnp.where(valid, jnp.exp((m - jt) * inv_lam), 0.0)
        z0 = nz_ref[0, t, :]
        z1 = nz_ref[1, t, :]
        part_ref[0, t, 0] = m
        part_ref[0, t, 1] = jnp.sum(e)
        part_ref[0, t, 2] = jnp.sum(e * z0)
        part_ref[0, t, 3] = jnp.sum(e * z1)
        part_ref[0, t, 4] = jnp.sum(z0)
        part_ref[0, t, 5] = jnp.sum(z1)
        return acc

    jax.lax.fori_loop(0, n, back, jnp.zeros((bk,), jnp.float32))


def _block_size(k: int, block_k: int) -> int:
    if block_k < 16 or block_k & (block_k - 1):
        raise ValueError(f"block_k must be a power of two >= 16, got "
                         f"{block_k}")
    return min(block_k, max(16, pl.next_power_of_2(k)))


def _num_warps(bk: int) -> int:
    """One rollout per thread, 1 to 8 warps: the best warp count at each
    block size in the H100 sweep (PERF.md)."""
    return max(1, min(8, bk // 32))


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "model", "block_k", "interpret"))
def _partials(cfg: MPPIConfig, model: CartParams, u, noise, pose_xyt, xd,
              obstacles=None, block_k: int = BLOCK_K,
              interpret: bool = False):
    f32 = jnp.float32
    k, n = noise.shape[0], cfg.steps
    if noise.shape[1:] != (n, 2):
        raise ValueError(f"noise must be (K, {n}, 2), got {noise.shape}")
    bk = _block_size(k, block_k)
    blocks = -(-k // bk)
    # (K, N, 2) → (2, N, K): contiguous along K, padded to whole blocks.
    nz = jnp.pad(jnp.transpose(noise.astype(f32), (2, 1, 0)),
                 ((0, 0), (0, 0), (0, blocks * bk - k)))
    params = jnp.concatenate([pose_xyt.astype(f32).reshape(3),
                              xd.astype(f32).reshape(3),
                              jnp.zeros(2, f32)])
    n_obs = 0 if obstacles is None else obstacles.shape[0] - 1

    in_specs = [pl.BlockSpec((8,), lambda i: (0,)),
                pl.BlockSpec((n, 2), lambda i: (0, 0)),
                pl.BlockSpec((2, n, bk), lambda i: (0, 0, i))]
    args = [params, u.astype(f32), nz]
    if n_obs:
        in_specs.append(pl.BlockSpec(obstacles.shape, lambda i: (0, 0)))
        args.append(obstacles.astype(f32))

    part, _ = pl.pallas_call(
        functools.partial(_mppi_kernel, cfg, model, k, bk, n_obs),
        grid=(blocks,),
        in_specs=in_specs,
        out_specs=[pl.BlockSpec((1, n, 6), lambda i: (i, 0, 0)),
                   pl.BlockSpec((n, bk), lambda i: (0, i))],
        out_shape=[jax.ShapeDtypeStruct((blocks, n, 6), f32),
                   jax.ShapeDtypeStruct((n, blocks * bk), f32)],  # loss
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=_num_warps(bk),
                                                 num_stages=1),
        interpret=interpret,
        name="mppi_rollout_partials",
    )(*args)
    return part


def pack_obstacles(obstacles, obs_cfg):
    """Pack (O, 5) segment primitives [ax, ay, bx, by, r] and the cost
    weights (:class:`tpunav.control.obstacle_cost.SegmentCostParams`) into
    the kernel's (O+1, 5) layout: the weights ride in the trailing row as
    runtime scalars [r_safe, w_hit, w_field, 1/sigma, 0], so tuning the
    field never recompiles the kernel. Returns None when obstacles is
    None."""
    if obstacles is None:
        return None
    if obs_cfg is None:
        raise ValueError("pass obstacles and obs_cfg together")
    row = jnp.asarray([[obs_cfg.r_safe, obs_cfg.w_hit, obs_cfg.w_field,
                        1.0 / obs_cfg.sigma, 0.0]], jnp.float32)
    return jnp.concatenate([jnp.asarray(obstacles, jnp.float32), row])


def mppi_solve_partials(cfg: MPPIConfig, model: CartParams, u, noise,
                        pose_xyt, xd, obstacles=None, obs_cfg=None,
                        block_k: int = BLOCK_K, interpret: bool = False):
    """Roll out the (K, N, 2) perturbations ``noise`` around ``u`` and
    return the (blocks, N, 6) softmax partials [m_l, Σe, Σe·z0, Σe·z1,
    Σz0, Σz1] (e = exp((m_l − j)/λ) over each block of ``block_k``
    rollouts) for :func:`combine_softmax_partials`. ``obstacles`` ((O, 5)
    segment primitives) + ``obs_cfg`` add the analytic obstacle cost at
    every step."""
    return _partials(cfg, model, u, noise, pose_xyt, xd,
                     pack_obstacles(obstacles, obs_cfg), block_k=block_k,
                     interpret=interpret)


def combine_softmax_partials(cfg: MPPIConfig, u, part, min_fn, sum_fn):
    """Recombine (…, N, 6) softmax partials [m_l, Σe, Σe·z0, Σe·z1, Σz0,
    Σz1] into the updated controls — the one implementation of the
    rescaled-exponential algebra, shared by the single-device solve
    (jnp.min/jnp.sum over the leading block axis) and the cross-device
    path (min_fn/sum_fn = pmin/psum over a mesh axis,
    parallel/mppi_sharded.py). The reference softmax (mppi.cpp:112-121)
    is w = exp((m_g−j)/λ) + 1e-8 with the GLOBAL min m_g;
    exp((m_g−j)/λ) = exp((m_g−m_l)/λ)·exp((m_l−j)/λ), so each contribution
    rescales by s = exp((m_g−m_l)/λ) and the 1e-8 floor adds the plain
    noise sums."""
    m_l = part[..., 0]
    m_g = min_fn(m_l)                                       # (N,)
    s = jnp.exp((m_g - m_l) * (1.0 / cfg.lambda_))
    contrib = s[..., None] * part[..., 1:4]
    red = sum_fn(jnp.concatenate([contrib, part[..., 4:6]], axis=-1))
    denom = red[:, 0] + 1e-8 * cfg.rollouts                 # red: (N, 5)
    du0 = (red[:, 1] + 1e-8 * red[:, 3]) / denom
    du1 = (red[:, 2] + 1e-8 * red[:, 4]) / denom
    u_new = u + jnp.stack([du0, du1], axis=1).astype(u.dtype)
    u_new = jnp.clip(u_new, -cfg.max_wheel_vel, cfg.max_wheel_vel)
    return u_new[0], shift_controls(cfg, u_new)


def mppi_solve_fused(cfg: MPPIConfig, model: CartParams, u, key, pose_xyt,
                     xd, obstacles=None, obs_cfg=None,
                     block_k: int = BLOCK_K, interpret: bool = False):
    """Drop-in kernel replacement for :func:`tpunav.control.mppi.mppi_solve`:
    the same key draws the same perturbations. ``obstacles`` ((O, 5)
    segment primitives [ax, ay, bx, by, r]) + ``obs_cfg``
    (:class:`tpunav.control.obstacle_cost.SegmentCostParams`) add the
    analytic obstacle cost to every rollout step in the kernel.
    Returns (wheel_cmd (2,), u_next (N, 2)) like ``mppi_solve``."""
    noise = sample_perturbations(cfg, key, dtype=u.dtype)
    part = mppi_solve_partials(cfg, model, u, noise, pose_xyt, xd,
                               obstacles, obs_cfg, block_k=block_k,
                               interpret=interpret)
    return combine_softmax_partials(
        cfg, u, part,
        min_fn=lambda m: jnp.min(m, axis=0),
        sum_fn=lambda x: jnp.sum(x, axis=0))
