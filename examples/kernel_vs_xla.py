"""The fused MPPI kernel against the plain XLA solve, on one GPU.

    python examples/kernel_vs_xla.py

Times, for both solvers, in one process on one card:

- 100 back-to-back solves chained in a ``lax.scan`` (bench.py's method)
  at K=49,152 and K=4,096 rollouts, N=50 steps, and the noise draw alone;
- a block-size sweep of the kernel at K=49,152;
- the waypoint course (K=4,096, control/waypoint_loop.run_course) in
  ticks/s;
- 240 ticks of the EKF+MPPI closed loop (BASELINE configs 3 and 4,
  K=4,096, control/slam_loop.py) in ticks/s.

Every line is one JSON object naming the device; times are best of
repeated windows, with the median beside it.
"""

import json
import os
import statistics
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from tpunav.runtime import cache as _cache  # noqa: E402
_cache.enable()
import jax.numpy as jnp  # noqa: E402

from bench import device_info  # noqa: E402
from tpunav.control.mppi import (MPPIConfig, init_controls,  # noqa: E402
                                 mppi_solve, sample_perturbations)
from tpunav.models.cart import CartParams  # noqa: E402
from tpunav.ops.pallas_mppi import BLOCK_K, mppi_solve_fused  # noqa: E402

MODEL = CartParams(0.033, 0.160)
POSE = jnp.zeros(3, jnp.float32)
XD = jnp.asarray([1.0, 1.0, 0.0], jnp.float32)
SOLVES = 100


def emit(device, **kw):
    print(json.dumps({**kw, "device": device}), flush=True)


def window_times(run, reps):
    """run() dispatches one window and returns its last output."""
    jax.block_until_ready(run())             # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    return min(times), statistics.median(times)


def chained(k, solve):
    cfg = MPPIConfig(horizon=0.5, dt=0.01, rollouts=k)

    @jax.jit
    def many(u, key):
        def body(c, _):
            u, key = c
            key, sub = jax.random.split(key)
            cmd, u = solve(cfg, u, sub)
            return (u, key), cmd
        return jax.lax.scan(body, (u, key), None, length=SOLVES)

    state = {"c": (init_controls(cfg), jax.random.PRNGKey(0))}

    def run():
        state["c"], cmds = many(*state["c"])
        return cmds
    return run


def xla(cfg, u, key):
    return mppi_solve(cfg, MODEL, u, key, POSE, XD)


def fused(block_k=BLOCK_K):
    return lambda cfg, u, key: mppi_solve_fused(cfg, MODEL, u, key, POSE,
                                                XD, block_k=block_k)


def noise_only(cfg, u, key):
    return jnp.sum(sample_perturbations(cfg, key)), u


def main():
    device = device_info()
    for k in (49_152, 4096):
        for name, solve in (("xla", xla), ("fused", fused()),
                            ("noise draw only", noise_only)):
            best, med = window_times(chained(k, solve), reps=5)
            emit(device, what=f"mppi solve, {name}", K=k, N=50,
                 us_per_solve=best / SOLVES * 1e6,
                 median_us_per_solve=med / SOLVES * 1e6)
    for bk in (64, 128, 256, 512):
        best, med = window_times(chained(49_152, fused(bk)), reps=3)
        emit(device, what="mppi solve, fused sweep", K=49_152, block_k=bk,
             us_per_solve=best / SOLVES * 1e6,
             median_us_per_solve=med / SOLVES * 1e6)

    from tpunav.control.waypoint_loop import (CourseConfig, course_init,
                                              run_course)
    from chip_smoke import PENTAGON

    cfg = MPPIConfig(horizon=0.5, dt=0.01, rollouts=4096)
    wpts = jnp.asarray(PENTAGON, jnp.float32)
    for use_fused in (False, True):
        course = CourseConfig(max_ticks=20_000, use_fused=use_fused)
        run = jax.jit(lambda s: run_course(cfg, course, MODEL, wpts, s))
        st0 = course_init(cfg, jnp.zeros(3), seed=0)
        best, med = window_times(lambda: run(st0), reps=3)
        st = run(st0)
        emit(device, what="waypoint course, "
             + ("fused" if use_fused else "xla"), K=4096,
             ticks=int(st.ticks), done=bool(st.done),
             ticks_per_s=int(st.ticks) / best,
             median_ticks_per_s=int(st.ticks) / med)

    import bench
    for use_fused in (False, True):
        for known in (True, False):
            r = bench.bench_slam_loop(known_da=known, use_fused=use_fused)
            emit(device, what="slam loop, "
                 + ("fused" if use_fused else "xla"),
                 config=3 if known else 4, ticks_per_s=r["value"],
                 median_ticks_per_s=r["median"])


if __name__ == "__main__":
    main()
