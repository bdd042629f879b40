"""Stage-by-stage cost decomposition of the RBPF SLAM update.

Times each stage of ``pf_slam_step`` at BASELINE scale (P=500, k=50,
360 beams, 80×80 maps): N reps dispatched back to back, one terminal
block. Every stage is the plain XLA formulation. ``--closed-loop``
decomposes examples/rbpf_explore_demo.py's scan interval instead.

    python examples/profile_rbpf_stages.py [--closed-loop]
"""

import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from tpunav.runtime import cache as _cache  # noqa: E402
_cache.enable()
import jax.numpy as jnp  # noqa: E402

from tpunav.estimation.rbpf import (GridConfig, PFConfig,  # noqa: E402
                                    pf_init, pf_slam_step)
from tpunav.estimation.rbpf.icp import (ICPConfig, icp_match,  # noqa: E402
                                        scan_to_points)
from tpunav.estimation.rbpf.particle_filter import (  # noqa: E402
    _draw_samples,
    _gaussian_from_samples,
    _low_variance_resample,
    pose_likelihood_odom,
)
from tpunav.estimation.rbpf.grid import (esdf, integrate_scan,  # noqa: E402
                                         likelihood_field_batch)
from tpunav.sim.lidar import box_segments, scan_segments  # noqa: E402

P, K = 500, 50


def timeit(label, fn, *args, reps=10):
    jax.block_until_ready(fn(*args))
    t0 = time.time()
    outs = [fn(*args) for _ in range(reps)]   # async; one terminal block
    jax.block_until_ready(outs[-1])
    print(f"{label:32s} {(time.time() - t0) / reps * 1e3:8.2f} ms",
          flush=True)


def _devices():
    d = jax.devices()
    print(f"devices: {len(d)} x {d[0].platform} {d[0].device_kind}",
          flush=True)


def main():
    _devices()
    grid = GridConfig()
    cfg = PFConfig(num_particles=P, k_samples=K,
                   sample_range=(1e-6, 1e-5, 1e-5),
                   motion_noise=(1e-6, 1e-5, 1e-5),
                   grid=grid, icp=ICPConfig(max_iter=25))
    segs = box_segments(-1.8, -1.8, 1.8, 1.8, jnp.float32)
    u = jnp.array([0.03, 0.02], jnp.float32)
    pose = jnp.array([0.06, 0.04, 0.01], jnp.float32)
    prev = jnp.zeros(3, jnp.float32)
    scan = scan_segments(pose, segs, num_beams=grid.num_beams,
                         max_range=grid.range_max,
                         key=jax.random.PRNGKey(0), noise_std=0.002)

    step = jax.jit(lambda s: pf_slam_step(cfg, s, scan, u, pose, prev))
    st = jax.block_until_ready(step(pf_init(cfg, seed=0)))
    st = jax.block_until_ready(step(st))      # warm maps

    samples = st.poses[:, None, :] + jax.random.normal(
        jax.random.PRNGKey(9), (P, K, 3), jnp.float32) * 0.003

    lik = jax.jit(lambda d, s: likelihood_field_batch(grid, d, scan, s))
    timeit("likelihood sweep P*K", lik, st.dists, samples)

    integrate = jax.jit(lambda g, ps: jax.vmap(
        lambda gg, q: integrate_scan(grid, gg, scan, q))(g, ps))
    timeit("map integrate", integrate, st.grids, st.poses)
    timeit("distance field (EDT)",
           jax.jit(lambda g: jax.vmap(lambda gg: esdf(grid, gg))(g)),
           st.grids)

    timeit("icp (25 iters)",
           jax.jit(lambda a, b: icp_match(
               cfg.icp,
               *scan_to_points(a, grid.range_min, grid.range_max,
                               grid.beam_min, grid.beam_delta),
               *scan_to_points(b, grid.range_min, grid.range_max,
                               grid.beam_min, grid.beam_delta),
               jnp.zeros(3, jnp.float32))),
           scan, st.prev_scan)

    timeit("pose_lik P*K",
           jax.jit(lambda s, p: jax.vmap(jax.vmap(
               lambda si, pi: pose_likelihood_odom(cfg, si, pi, pose,
                                                   prev),
               in_axes=(0, None)))(s, p)),
           samples, st.poses)

    lp = lik(st.dists, samples)
    ks = jax.random.split(jax.random.PRNGKey(3), P)
    timeit("gauss fit+draw",
           jax.jit(lambda s, w, ps, kk: jax.vmap(
               lambda a, b, c, d: _gaussian_from_samples(
                   cfg, a, b, c, pose, prev, d))(s, w, ps, kk)),
           samples, lp, st.poses, ks)

    timeit("draw samples",
           jax.jit(lambda ps, kk: jax.vmap(
               lambda a, b: _draw_samples(cfg, a,
                                          jnp.zeros(3, jnp.float32), b)
           )(ps, kk)),
           st.poses, ks)

    timeit("resample gather",
           jax.jit(lambda s: _low_variance_resample(
               cfg, s, jax.random.PRNGKey(1))),
           st)

    timeit("FULL pf step", step, st, reps=5)


def profile_closed_loop(num_particles=500, reps=10):
    """Per-SCAN budget of the closed-loop exploration run. Times each
    stage of examples/rbpf_explore_demo.py's scan interval — the 6-solve
    fused MPPI control chunk, the pf_slam_step, the lidar raycast — with
    pipelined dispatch, plus the full chained interval; the remainder is
    host glue + the serialization the chain forces (each stage waits on
    the previous one's output). Returns {stage: ms_per_scan}."""
    from examples.rbpf_explore_demo import (MODEL, TICKS_PER_SCAN,
                                            build as build_explore,
                                            solve_key)
    from tpunav.control.mppi import init_controls as mppi_init
    from tpunav.estimation.rbpf import pf_init as pf_init_fn, pf_slam_step
    from tpunav.ops.pallas_mppi import mppi_solve_fused
    from tpunav.sim.lidar import box_segments, scan_segments

    pf_cfg, mppi_cfg, run_chunk = build_explore(num_particles,
                                                scans_per_chunk=reps)
    pf = pf_init_fn(pf_cfg, seed=3)
    state = (pf, jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32),
             mppi_init(mppi_cfg), jnp.zeros(2, jnp.float32),
             jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))
    # Warm/compile every stage, advance to a populated filter.
    state = run_chunk(*state)[:7]
    jax.block_until_ready(state[0].poses)
    pf2, tp, op, u2, _wv, _wi, tk = state

    results = {}

    def timed(label, fn, *args):
        jax.block_until_ready(fn(*args))
        t0 = time.time()
        outs = [fn(*args) for _ in range(reps)]
        jax.block_until_ready(outs[-1])
        results[label] = (time.time() - t0) / reps * 1e3

    grid = pf_cfg.grid
    segs = box_segments(-1.8, -1.8, 1.8, 1.8, jnp.float32)
    scan = scan_segments(tp, segs, num_beams=grid.num_beams,
                         max_range=grid.range_max,
                         key=jax.random.PRNGKey(5), noise_std=0.002)

    @jax.jit
    def control(u, pose, tk):
        def body(t, u):
            _, u = mppi_solve_fused(
                mppi_cfg, MODEL, u, solve_key(tk * TICKS_PER_SCAN + t),
                jnp.stack([pose[1], pose[2], pose[0]]),
                jnp.zeros(3, jnp.float32))
            return u
        return jax.lax.fori_loop(0, TICKS_PER_SCAN, body, u)

    timed(f"mppi control chunk ({TICKS_PER_SCAN} fused K=2048 solves)",
          control, u2, op, tk)
    timed("pf_slam_step",
          jax.jit(lambda s, sc, co, po: pf_slam_step(
              pf_cfg, s, sc, jnp.asarray([0.01, 0.005], jnp.float32),
              co, po)),
          pf2, scan, op, op)
    timed("lidar sense (raycast)",
          jax.jit(lambda p, k: scan_segments(
              p, segs, num_beams=grid.num_beams, max_range=grid.range_max,
              key=jax.random.fold_in(jax.random.PRNGKey(31), k),
              noise_std=0.002)), tp, tk)

    # Full chained interval (stages + host glue), per scan.
    t0 = time.time()
    out = run_chunk(*state)
    jax.block_until_ready(out[0].poses)
    results["FULL scan interval (chained)"] = (time.time() - t0) \
        / reps * 1e3

    known = sum(v for k, v in results.items() if not k.startswith("FULL"))
    results["host glue + chain serialization"] = \
        results["FULL scan interval (chained)"] - known
    return results


def main_closed_loop():
    _devices()
    res = profile_closed_loop()
    for k, v in res.items():
        print(f"{k:48s} {v:8.2f} ms/scan", flush=True)
    return res


if __name__ == "__main__":
    import sys as _sys
    if "--closed-loop" in _sys.argv:
        main_closed_loop()
    else:
        main()
