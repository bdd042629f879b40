"""Smoke run of tpunav's main path on an NVIDIA GPU, in one process.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the sharded paths only

Phases, in order (the one-card run):

1. ``device``: JAX's first device must be a GPU; prints its kind, the
   device count, the JAX version and the card's name and power limit.
2. ``mppi_kernel``: the compiled Triton MPPI kernel against the plain
   ``mppi_solve`` fed the same key, at K=1,024 and K=49,152 (N=50), and
   its in-kernel obstacle cost at the obstacle demo's shape.
3. ``mppi_course``: the K=4,096 waypoint course on the pentagon until
   every waypoint is reached once, within the demo's tick budget.
4. ``ekf``: 200 known-DA and 200 unknown-DA EKF SLAM updates at n=50 on
   the GPU against the same jitted chain on this process's CPU device.
5. ``slam_loop``: 240 EKF+MPPI closed-loop ticks of BASELINE configs 3
   and 4 (K=4,096).
6. ``rbpf``: 20 RBPF SLAM scans at P=500 on the 80x80 map, and the
   likelihood sweep and map integrate + distance field against the CPU
   device on fixed inputs.

``--four-cards`` runs only the sharded MPPI solve (XLA and kernel
partials) at K=49,152 and the sharded RBPF step at P=500 through a
forced resample, each against the one-card computation.

Every phase prints what it compared, the tolerance, the worst error, the
compile time and the device memory. Any failure ends the run with a
non-zero exit and no result line; without a GPU the run stops before the
first phase. The last line of a passing run is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import os

# The ekf and rbpf phases compare against this process's CPU device.
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpunav.control.mppi import (MPPIConfig, cost_to_go,  # noqa: E402
                                 init_controls, mppi_solve, rollout_losses,
                                 shift_controls, update_controls)
from tpunav.models.cart import CartParams  # noqa: E402
from tpunav.ops.pallas_mppi import (combine_softmax_partials,  # noqa: E402
                                    mppi_solve_fused, mppi_solve_partials)
from tpunav.runtime import cache  # noqa: E402

MODEL = CartParams(0.033, 0.160)         # configs/diff_params.yaml
MPPI_ATOL = 2e-4                          # on cmd and u_next
# configs/real_waypoints.yaml: the pentagon course.
PENTAGON = ((0.0, 0.0, 0.0), (1.0, 0.0, 1.5707), (1.0, 1.0, 2.3562),
            (0.5, 2.0, -2.3562), (0.0, 1.0, -1.5707))
COURSE_MAX_TICKS = 20_000                 # examples/mppi_waypoints_demo.py
LIK_P99 = 1e-4                            # summed log-likelihood, p99
FLIP_SHARE = 0.01                         # samples/cells past a boundary


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(phase: str, what: str, err: float, tol: float) -> None:
    log(phase, f"{what}: worst error {err:.3e} (tolerance {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{phase}: {what}: error {err} > {tol}")


def compile_fn(fn, *args):
    """jit + AOT-compile ``fn`` for ``args``; returns (compiled, seconds)."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def memory(compiled=None) -> str:
    """The step's compiled memory footprint and the device's peak use."""
    parts = []
    if compiled is not None:
        ma = compiled.memory_analysis()
        if ma is not None:
            parts.append(f"args={ma.argument_size_in_bytes} "
                         f"out={ma.output_size_in_bytes} "
                         f"temp={ma.temp_size_in_bytes} bytes")
    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        parts.append(f"peak_bytes_in_use={stats['peak_bytes_in_use']}")
    return "; ".join(parts) or "memory stats not available"


def max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) -
                               np.asarray(b, np.float64))))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# ── 1. device ──────────────────────────────────────────────────────────

def phase_device(cards: int) -> dict:
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX's first device is "
                         f"{devs[0].platform}")
    if len(devs) < cards:
        raise SystemExit(f"chip_smoke: needs {cards} GPUs, found "
                         f"{len(devs)}")
    log("device", f"kind={devs[0].device_kind} count={len(devs)} "
                  f"jax={jax.__version__}")
    print(nvidia_smi(), flush=True)   # name, power limit per card
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# ── 2. mppi_kernel ─────────────────────────────────────────────────────

def phase_mppi_kernel(ks=(1024, 49_152), obstacle_k=4096) -> None:
    """The compiled kernel vs the plain solve, same key → same noise."""
    from tpunav.control.obstacle_cost import (SegmentCostParams,
                                              make_segment_obstacle_cost,
                                              segments_from_polygons)

    pose = jnp.asarray([0.1, -0.2, 0.3], jnp.float32)
    xd = jnp.asarray([1.0, 1.0, 0.0], jnp.float32)
    key = jax.random.PRNGKey(5)
    for k in ks:
        cfg = MPPIConfig(horizon=0.5, dt=0.01, rollouts=k)
        u = init_controls(cfg)
        c, secs = compile_fn(
            lambda u, kk: mppi_solve_fused(cfg, MODEL, u, kk, pose, xd),
            u, key)
        cmd_k, u_k = c(u, key)
        with jax.default_matmul_precision("highest"):
            cmd_x, u_x = jax.jit(
                lambda u, kk: mppi_solve(cfg, MODEL, u, kk, pose, xd))(u,
                                                                       key)
        log("mppi_kernel", f"K={k} N={cfg.steps}: kernel vs mppi_solve "
                           f"(same key); compile {secs:.2f} s; "
                           f"{memory(c)}")
        check("mppi_kernel", f"K={k} cmd", max_abs(cmd_k, cmd_x), MPPI_ATOL)
        check("mppi_kernel", f"K={k} u_next", max_abs(u_k, u_x), MPPI_ATOL)

    # In-kernel obstacle cost at examples/obstacle_mppi_demo.py's shape,
    # from a pose whose rollouts reach the wall's corner.
    wall = [[[0.95, 0.7], [1.05, 0.7], [1.05, 1.3], [0.95, 1.3]]]
    segs = segments_from_polygons(wall)
    obs_cfg = SegmentCostParams(r_safe=0.1, w_hit=1e7, w_field=2e3,
                                sigma=0.05)
    cfg = MPPIConfig(horizon=0.5, dt=0.01, rollouts=obstacle_k)
    u = init_controls(cfg) + jnp.asarray([3.0, 3.0], jnp.float32)
    pose = jnp.asarray([0.8, 0.62, 0.3], jnp.float32)
    xd = jnp.asarray([1.3, 0.5, 0.0], jnp.float32)
    c, secs = compile_fn(
        lambda u, kk: mppi_solve_fused(cfg, MODEL, u, kk, pose, xd,
                                       obstacles=segs, obs_cfg=obs_cfg),
        u, key)
    cmd_k, u_k = c(u, key)
    extra = make_segment_obstacle_cost(obs_cfg, segs)
    with jax.default_matmul_precision("highest"):
        cmd_x, u_x = jax.jit(lambda u, kk: mppi_solve(
            cfg, MODEL, u, kk, pose, xd, extra_cost=extra))(u, key)
    log("mppi_kernel", f"K={obstacle_k} with {segs.shape[0]} wall "
                       f"segments: kernel vs mppi_solve(extra_cost); "
                       f"compile {secs:.2f} s; {memory(c)}")
    check("mppi_kernel", "obstacle cmd", max_abs(cmd_k, cmd_x), MPPI_ATOL)
    check("mppi_kernel", "obstacle u_next", max_abs(u_k, u_x), MPPI_ATOL)


# ── 3. mppi_course ─────────────────────────────────────────────────────

def phase_mppi_course(k=4096, waypoints=PENTAGON,
                      max_ticks=COURSE_MAX_TICKS) -> None:
    """The waypoint course with the kernel in the loop, as one device
    program, until every waypoint has been reached once."""
    from tpunav.control import waypoint_loop as wl

    cfg = MPPIConfig(horizon=0.5, dt=0.01, rollouts=k)
    course = wl.CourseConfig(goal_thresh=0.1, tick_dt=1.0 / 60.0,
                             max_ticks=max_ticks, use_fused=True)
    wpts = jnp.asarray(waypoints, jnp.float32)
    st0 = wl.course_init(cfg, jnp.zeros(3), seed=0)
    c, secs = compile_fn(
        lambda s: wl.run_course(cfg, course, MODEL, wpts, s), st0)
    t0 = time.perf_counter()
    st = jax.block_until_ready(c(st0))
    wall = time.perf_counter() - t0
    ticks, visits = int(st.ticks), int(st.visits)
    log("mppi_course", f"K={k}: {ticks} ticks in {wall:.3f} s = "
                       f"{ticks / wall:.1f} ticks/s on "
                       f"{jax.devices()[0].device_kind} (informative); "
                       f"compile {secs:.2f} s; {memory(c)}")
    log("mppi_course", f"visited {visits}/{len(waypoints)} waypoints "
                       f"(budget {max_ticks} ticks)")
    if not (bool(st.done) and visits == len(waypoints)):
        raise AssertionError(f"mppi_course: {visits}/{len(waypoints)} "
                             f"waypoints within {max_ticks} ticks")
    if not np.all(np.isfinite(np.asarray(st.pose))):
        raise AssertionError("mppi_course: non-finite pose")


# ── 4. ekf ─────────────────────────────────────────────────────────────

EKF_STATE_ATOL = 1e-3                     # metres / radians


def _ekf_course(n: int, n_visible: int, updates: int):
    """bench.py's EKF course: a ring of landmarks seen from a drifting
    pose, NaN-padded to capacity."""
    u = np.asarray([0.02, 0.01], np.float32)
    ang = np.linspace(0.0, 2 * np.pi, n_visible, endpoint=False)
    lms = np.stack([2.0 * np.cos(ang), 2.0 * np.sin(ang)], -1)
    rng = np.random.default_rng(11)
    pose = np.zeros(3)
    meas = np.full((updates, n, 2), np.nan, np.float32)
    for i in range(updates):
        th = pose[0] + u[0]
        pose = np.asarray([th, pose[1] + u[1] * np.cos(th),
                           pose[2] + u[1] * np.sin(th)])
        c, s = np.cos(pose[0]), np.sin(pose[0])
        rel = lms - pose[None, 1:3]
        rf = np.stack([c * rel[:, 0] + s * rel[:, 1],
                       -s * rel[:, 0] + c * rel[:, 1]], -1)
        meas[i, :n_visible] = rf + 1e-3 * rng.standard_normal(rf.shape)
    return jnp.asarray(u), jnp.asarray(meas)


def phase_ekf(n=50, n_visible=12, updates=200) -> None:
    """Known- and unknown-DA chains on the GPU vs the CPU device."""
    from tpunav.estimation.ekf.filter import (EKFConfig, ekf_init,
                                              known_correspondence_slam,
                                              slam_unknown_da)

    cfg = EKFConfig(num_landmarks=n, dmin=5e1, dmax=1e4,
                    measurement_noise=(1e-4, 1e-4))
    u, meas = _ekf_course(n, n_visible, updates)
    cpu = jax.devices("cpu")[0]
    for name, fn in (("known", known_correspondence_slam),
                     ("unknown", slam_unknown_da)):
        def chain(st, ms, fn=fn):
            return jax.lax.scan(lambda s, m: (fn(cfg, s, m, u), None),
                                st, ms)[0]

        st0 = ekf_init(cfg, jnp.float32)
        c, secs = compile_fn(chain, st0, meas)
        a = jax.block_until_ready(c(st0, meas))
        b = jax.jit(chain)(*jax.device_put((st0, meas), cpu))
        log("ekf", f"{name} DA, n={n}, {updates} updates: GPU vs CPU "
                   f"device; compile {secs:.2f} s; {memory(c)}")
        if int(a.count) != int(b.count):
            raise AssertionError(f"ekf {name}: landmark count "
                                 f"{int(a.count)} vs {int(b.count)}")
        if not np.array_equal(np.asarray(a.active), np.asarray(b.active)):
            raise AssertionError(f"ekf {name}: active masks differ")
        log("ekf", f"{name} DA: {int(a.count)} landmarks on both devices, "
                   f"active masks equal")
        n_live = 3 + 2 * int(a.count)
        check("ekf", f"{name} DA state", max_abs(a.state[:n_live],
                                                 b.state[:n_live]),
              EKF_STATE_ATOL)


# ── 5. slam_loop ───────────────────────────────────────────────────────

SLAM_POSE_ERR = 0.05                      # metres, estimate vs truth


def phase_slam_loop(k=4096, ticks=240) -> None:
    """BASELINE configs 3 and 4 at bench.py's shapes, kernel in the loop."""
    from tpunav.control import slam_loop as sl
    from tpunav.estimation.ekf import EKFConfig

    mppi_cfg = MPPIConfig(horizon=0.5, dt=0.02, rollouts=k,
                          ul_var=4.0, ur_var=4.0)
    ekf_cfg = EKFConfig(num_landmarks=50, dmin=5e1, dmax=1e4,
                        spd_repair=False, motion_noise=(1e-6, 1e-6, 1e-6),
                        measurement_noise=(1e-5, 1e-5))
    waypoints = jnp.asarray([[0.4, 0.0, 0.0], [0.3, 0.4, 1.57],
                             [-0.3, 0.3, 3.0], [-0.4, -0.3, -2.0],
                             [0.2, -0.4, -0.5]], jnp.float32)
    for config, known_da, n_lms in ((3, True, 12), (4, False, 48)):
        cfg = sl.SlamLoopConfig(known_da=known_da, sensor_every=1,
                                visibility=1.2, cycles=1000, use_fused=True)
        ang = jnp.linspace(0.0, 2 * jnp.pi, n_lms, endpoint=False)
        rad = jnp.where(jnp.arange(n_lms) % 2 == 0, 0.9, 1.4)
        lms = jnp.stack([rad * jnp.cos(ang), rad * jnp.sin(ang)], -1)

        def run(st):
            def body(s, _):
                s = sl.slam_loop_tick(mppi_cfg, ekf_cfg, cfg, MODEL,
                                      waypoints, lms, s)
                est = sl.robot_pose(s.ekf)            # [theta, x, y]
                return s, (s.true_pose, est)
            return jax.lax.scan(body, st, None, length=ticks)

        st0 = sl.slam_loop_init(mppi_cfg, ekf_cfg, seed=0)
        c, secs = compile_fn(run, st0)
        st, (truth, est) = jax.block_until_ready(c(st0))
        truth, est = np.asarray(truth), np.asarray(est)
        if not (np.all(np.isfinite(truth)) and np.all(np.isfinite(est))):
            raise AssertionError(f"slam_loop config {config}: non-finite "
                                 "pose")
        err = float(np.max(np.hypot(truth[:, 0] - est[:, 1],
                                    truth[:, 1] - est[:, 2])))
        log("slam_loop", f"config {config} ({n_lms} landmarks, K={k}, "
                         f"{ticks} ticks, {int(st.ekf.count)} tracked, "
                         f"{int(st.visits)} waypoints reached); compile "
                         f"{secs:.2f} s; {memory(c)}")
        check("slam_loop", f"config {config} estimate vs truth (m)", err,
              SLAM_POSE_ERR)


# ── 6. rbpf ────────────────────────────────────────────────────────────

RBPF_POSE_ERR = 0.05                      # metres, best particle vs truth
GRID_P99 = 1e-4                           # log-odds and distance (m)


def _rbpf_course(grid, scans: int, wall=1.8):
    """bench.py's RBPF course: a box room, scans + odometry computed up
    front (u = [0.03 rad, 0.02 m] per scan)."""
    from tpunav.sim.lidar import box_segments, scan_segments

    segs = box_segments(-wall, -wall, wall, wall, jnp.float32)
    u = jnp.array([0.03, 0.02], jnp.float32)
    pose = jnp.zeros(3, jnp.float32)
    poses, ranges = [], []
    for i in range(scans):
        th = pose[0] + u[0]
        pose = jnp.stack([th, pose[1] + u[1] * jnp.cos(th),
                          pose[2] + u[1] * jnp.sin(th)])
        poses.append(pose)
        ranges.append(scan_segments(
            pose, segs, num_beams=grid.num_beams,
            beam_delta=grid.beam_delta, max_range=grid.range_max,
            key=jax.random.fold_in(jax.random.PRNGKey(7), i),
            noise_std=0.002))
    return u, jnp.stack(poses), jnp.stack(ranges)


def _flip_check(phase, what, a, b, p99_tol):
    err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    check(phase, f"{what} p99", float(np.quantile(err, 0.99)), p99_tol)
    share = float(np.mean(err > p99_tol))
    check(phase, f"{what} share past a cell boundary", share, FLIP_SHARE)


def phase_rbpf(p=500, scans=20, k_samples=50, grid=None,
               icp_iters=25) -> None:
    from tpunav.estimation.rbpf import (GridConfig, PFConfig, pf_init,
                                        pf_slam_step)
    from tpunav.estimation.rbpf.grid import (esdf, integrate_scan,
                                             likelihood_field_batch)
    from tpunav.estimation.rbpf.icp import ICPConfig

    grid = grid or GridConfig()            # 4x4 m @ 0.05 m, 360 beams
    cfg = PFConfig(num_particles=p, k_samples=k_samples,
                   sample_range=(1e-6, 1e-5, 1e-5),
                   motion_noise=(1e-6, 1e-5, 1e-5),
                   grid=grid, icp=ICPConfig(max_iter=icp_iters))
    u, truth, ranges = _rbpf_course(grid, scans)
    prevs = jnp.concatenate([jnp.zeros((1, 3), jnp.float32), truth[:-1]])

    st = pf_init(cfg, seed=0)
    step, secs = compile_fn(
        lambda s, r, co, po: pf_slam_step(cfg, s, r, u, co, po),
        st, ranges[0], truth[0], prevs[0])
    errs = []
    for i in range(scans):
        st = step(st, ranges[i], truth[i], prevs[i])
        best = int(jnp.argmax(st.log_weights))
        errs.append(float(jnp.hypot(st.poses[best, 1] - truth[i, 1],
                                    st.poses[best, 2] - truth[i, 2])))
    if not (np.all(np.isfinite(np.asarray(st.poses))) and
            np.all(np.isfinite(np.asarray(st.log_weights)))):
        raise AssertionError("rbpf: non-finite poses or weights")
    log("rbpf", f"P={p}, {grid.height}x{grid.width} map, "
                f"{grid.num_beams} beams, k={k_samples}, {scans} scans; "
                f"state {st.grids.nbytes + st.dists.nbytes} bytes of "
                f"maps + distance fields; compile {secs:.2f} s; "
                f"{memory(step)}")
    check("rbpf", "best particle vs truth (m)", max(errs), RBPF_POSE_ERR)

    # Fixed inputs: the hot stages on the GPU vs the CPU device.
    cpu = jax.devices("cpu")[0]
    scan = ranges[-1]
    poses = truth[-1][None] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(1), (p, 3), jnp.float32)

    def update(grids, poses):
        g = jax.vmap(lambda g, q: integrate_scan(grid, g, scan, q))(grids,
                                                                     poses)
        return g, jax.vmap(lambda gg: esdf(grid, gg))(g)

    grids0 = pf_init(cfg).grids
    c, secs = compile_fn(update, grids0, poses)
    g_gpu, d_gpu = c(grids0, poses)
    g_cpu, d_cpu = jax.jit(update)(*jax.device_put((grids0, poses), cpu))
    log("rbpf", f"integrate + distance field, P={p}: GPU vs CPU device; "
                f"compile {secs:.2f} s; {memory(c)}")
    _flip_check("rbpf", "log-odds", g_gpu, g_cpu, GRID_P99)
    _flip_check("rbpf", "distance field (m)", d_gpu, d_cpu, GRID_P99)

    samples = poses[:, None, :] + 0.01 * jax.random.normal(
        jax.random.PRNGKey(3), (p, k_samples, 3), jnp.float32)
    lik = lambda d, s: likelihood_field_batch(grid, d, scan, s)  # noqa: E731
    d_dev = jax.device_put(d_cpu, jax.devices()[0])
    c, secs = compile_fn(lik, d_dev, samples)
    a = c(d_dev, samples)
    b = jax.jit(lik)(*jax.device_put((d_cpu, samples), cpu))
    log("rbpf", f"likelihood sweep, P={p} x k={k_samples}: GPU vs CPU "
                f"device; compile {secs:.2f} s; {memory(c)}")
    _flip_check("rbpf", "summed log-likelihood", a, b, LIK_P99)


# ── 7. four cards ──────────────────────────────────────────────────────

def phase_four_cards(k=49_152, p=500, scans=4, grid=None, k_samples=50,
                     devices=None) -> None:
    """Sharded MPPI (XLA and kernel partials) and sharded RBPF over four
    devices, each against the one-device computation."""
    from jax.sharding import Mesh

    from tpunav.estimation.rbpf import GridConfig, PFConfig, pf_init
    from tpunav.estimation.rbpf import pf_slam_step
    from tpunav.estimation.rbpf.icp import ICPConfig
    from tpunav.parallel.mppi_sharded import mppi_solve_sharded
    from tpunav.parallel.rbpf_sharded import (pf_init_sharded,
                                              pf_slam_step_sharded,
                                              state_sharding)

    devices = list(devices or jax.devices()[:4])
    nd = len(devices)
    mesh = Mesh(np.asarray(devices), ("k",))
    one = devices[0]

    # MPPI: the one-device reference draws the same per-shard noise.
    cfg = MPPIConfig(horizon=0.5, dt=0.01, rollouts=k)
    pose = jnp.asarray([0.1, -0.2, 0.3], jnp.float32)
    xd = jnp.asarray([1.0, 1.0, 0.0], jnp.float32)
    key = jax.random.PRNGKey(11)
    sig = jnp.sqrt(jnp.asarray([cfg.ul_var, cfg.ur_var], jnp.float32))
    noise = jnp.concatenate([
        jax.random.normal(jax.random.fold_in(key, i),
                          (k // nd, cfg.steps, 2), jnp.float32) * sig
        for i in range(nd)])
    u = init_controls(cfg)
    with jax.default_matmul_precision("highest"):
        loss, _ = rollout_losses(cfg, MODEL, pose, u[None] + noise, xd)
        u_ref = update_controls(cfg, u, noise, cost_to_go(loss))
    ref = (u_ref[0], shift_controls(cfg, u_ref))
    part = mppi_solve_partials(cfg, MODEL, u, noise, pose, xd)
    ref_kernel = combine_softmax_partials(
        cfg, u, part, lambda m: jnp.min(m, 0), lambda x: jnp.sum(x, 0))
    check("four_cards", f"MPPI K={k} one-device kernel vs XLA u_next",
          max_abs(ref_kernel[1], ref[1]), MPPI_ATOL)
    for fused in (False, True):
        name = "kernel partials" if fused else "XLA"
        solve = mppi_solve_sharded(cfg, MODEL, mesh, fused=fused)
        t0 = time.perf_counter()
        cmd, u_next = jax.block_until_ready(
            solve(init_controls(cfg), key, pose, xd))
        log("four_cards", f"MPPI {name} sharded over {nd} devices, K={k}: "
                          f"first call (compile + run) "
                          f"{time.perf_counter() - t0:.2f} s; {memory()}")
        check("four_cards", f"MPPI {name} cmd vs one device",
              max_abs(cmd, ref[0]), MPPI_ATOL)
        check("four_cards", f"MPPI {name} u_next vs one device",
              max_abs(u_next, ref[1]), MPPI_ATOL)

    # RBPF: sharded vs unsharded through a forced resample.
    grid = grid or GridConfig()
    pcfg = PFConfig(num_particles=p, k_samples=k_samples,
                    sample_range=(1e-6, 1e-5, 1e-5),
                    motion_noise=(1e-6, 1e-5, 1e-5),
                    grid=grid, icp=ICPConfig(max_iter=25))
    u_odo, truth, ranges = _rbpf_course(grid, scans + 1)
    prevs = jnp.concatenate([jnp.zeros((1, 3), jnp.float32), truth[:-1]])
    st_s = pf_init_sharded(pcfg, mesh, axis_name="k", seed=5)
    shards = st_s.grids.addressable_shards
    spread = sorted((s.device.id, s.data.shape[0]) for s in shards)
    log("four_cards", f"pf_init_sharded: grids {st_s.grids.shape} as "
                      f"(device, particles) {spread}")
    if (len(st_s.grids.sharding.device_set) != nd or
            any(n != p // nd for _, n in spread)):
        raise AssertionError(f"four_cards: particle state not spread over "
                             f"{nd} devices: {spread}")
    step_s = pf_slam_step_sharded(pcfg, mesh, axis_name="k")
    step_1 = jax.jit(lambda s, r, co, po: pf_slam_step(pcfg, s, r, u_odo,
                                                       co, po))
    st_1 = jax.device_put(pf_init(pcfg, seed=5), one)
    hog = jnp.where(jnp.arange(p) == 3, 0.0, -50.0).astype(jnp.float32)
    for i in range(scans + 1):
        if i == scans:
            # Particle 3 takes ~all the weight: N_eff ≈ 1, so this step
            # must resample and copy its map across the devices.
            st_1 = st_1._replace(log_weights=jax.device_put(hog, one))
            st_s = st_s._replace(log_weights=jax.device_put(
                hog, state_sharding(mesh, "k").log_weights))
        st_1 = step_1(st_1, ranges[i], truth[i], prevs[i])
        st_s = step_s(st_s, ranges[i], u_odo, truth[i], prevs[i])
    st_s, st_1 = jax.block_until_ready((st_s, st_1))
    log("four_cards", f"RBPF P={p} over {nd} devices, {scans} scans + a "
                      f"forced resample: sharded vs one device; "
                      f"{memory()}")
    check("four_cards", "RBPF poses", max_abs(st_s.poses, st_1.poses), 1e-4)
    check("four_cards", "RBPF log-weights",
          max_abs(st_s.log_weights, st_1.log_weights), 1e-3)
    check("four_cards", "RBPF log-odds grids",
          max_abs(st_s.grids, st_1.grids), 1e-3)
    _, counts = np.unique(np.asarray(st_s.poses[:, 1]), return_counts=True)
    resampled = float(counts.max()) / p
    log("four_cards", f"largest share of particles holding one pose after "
                      f"the forced resample: {resampled:.3f}")
    if resampled < 0.5:
        raise AssertionError("four_cards: the forced resample did not fire")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)
    cache.enable()
    device = phase_device(4 if args.four_cards else 1)
    if args.four_cards:
        phase_four_cards()
    else:
        phase_mppi_kernel()
        phase_mppi_course()
        phase_ekf()
        phase_slam_loop()
        phase_rbpf()
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
