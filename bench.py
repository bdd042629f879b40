"""Benchmarks: EKF SLAM (known/unknown DA), the EKF+MPPI closed-loop
tick (BASELINE configs 3-4), RBPF SLAM updates, and MPPI solve
throughput, on one GPU.

Prints one JSON line {"metric", "value", "unit", "vs_baseline",
"median", "device"} per workload as soon as it finishes — the headline
MPPI line last. "value" is best-of-trials; "median" records the spread.
"device" names the platform, device kind and count as JAX reports them,
and the card's name and power limit from nvidia-smi. Without a GPU the
script exits before the first workload.

MPPI baseline: the reference C++ controller sustains 50 solves/s at K=5,
N=100 on CPU (ref: controller/README.md:4) ≈ 2,500 rollouts/s
(BASELINE.md). Here K=49,152 rollouts of a 50-step horizon run through
the fused Pallas kernel per solve (tpunav/ops/pallas_mppi.py: rollouts,
loss, cost-to-go and per-block softmax partials in one kernel; noise
from jax.random); solves are chained in a lax.scan so the measurement
reflects back-to-back device throughput.

RBPF baseline: the reference keeps 40 particles real-time at the LDS-01's
5 Hz scan rate on CPU (bmapping/launch/slam.launch:19-46) = 200
particle-updates/s, rebuilding every particle's FMM ESDF each scan
(grid_mapper.cpp:333-435). Here the full pf_slam_step (proposal sweep +
map integration + exact EDT + resampling) is particle-batched on one
device at P=500 (BASELINE config 5).
"""

import json
import statistics
import subprocess
import time

import jax

from tpunav.runtime import cache as _cache
_cache.enable()
import jax.numpy as jnp

from tpunav.control.mppi import MPPIConfig, init_controls
from tpunav.models.cart import CartParams
from tpunav.ops.pallas_mppi import mppi_solve_fused

K = 49_152
N_STEPS = 50
SOLVES_PER_CALL = 100
CALLS_PER_TRIAL = 8
TRIALS = 4

REF_ROLLOUTS_PER_SEC = 2_500.0
REF_PARTICLE_UPDATES_PER_SEC = 40 * 5.0
# The reference publishes no EKF timing; its slam node free-spins on the
# 60 Hz sensor stream (nuslam/src/slam_node.cpp:261-263 gated by the fake
# encoders' rate, rigid2d/src/fake_diff_encoders_node.cpp:91), so 60
# updates/s is the de-facto node-rate bound BASELINE configs 3-4 run at.
REF_EKF_UPDATES_PER_SEC = 60.0


def device_info():
    """The device every line names; exits unless JAX's device is a GPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench: needs a GPU; JAX's first device is "
                         f"{devs[0].platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card}


def bench_mppi():
    cfg = MPPIConfig(horizon=0.5, dt=0.01, rollouts=K)  # N = 50 steps
    cart = CartParams(0.033, 0.160)
    pose = jnp.zeros(3, jnp.float32)
    xd = jnp.asarray([1.0, 1.0, 0.0], jnp.float32)

    @jax.jit
    def many_solves(u, key):
        def body(carry, _):
            u, key = carry
            key, sub = jax.random.split(key)
            cmd, u = mppi_solve_fused(cfg, cart, u, sub, pose, xd)
            return (u, key), cmd

        (u, key), cmds = jax.lax.scan(body, (u, key), None,
                                      length=SOLVES_PER_CALL)
        return u, key, cmds

    u, key = init_controls(cfg), jax.random.PRNGKey(0)

    # Warmup / compile.
    u, key, cmds = many_solves(u, key)
    jax.block_until_ready(cmds)

    times = []
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        # Dispatch the whole trial async; block once at the end.
        for _ in range(CALLS_PER_TRIAL):
            u, key, cmds = many_solves(u, key)
        jax.block_until_ready(cmds)
        times.append(time.perf_counter() - t0)

    solves = SOLVES_PER_CALL * CALLS_PER_TRIAL
    solves_per_s = solves / min(times)
    rollouts_per_s = solves_per_s * K
    return {
        "metric": f"mppi_rollouts_per_sec_per_chip (K={K}, H={N_STEPS} "
                  f"steps, {solves_per_s:.1f} solves/s, fused kernel)",
        "value": round(rollouts_per_s, 1),
        "unit": "rollouts/s",
        "vs_baseline": round(rollouts_per_s / REF_ROLLOUTS_PER_SEC, 2),
        "median": round(solves * K / statistics.median(times), 1),
    }


def bench_rbpf(p=500, updates=20, grid=None, wall=1.8):
    """Deployment-shaped measurement: scans arrive from the sensor (here
    precomputed), and each arriving scan dispatches ONE jitted
    pf_slam_step with a donated state; successive dispatches pipeline
    (the filter steps once per 5 Hz scan, so no deployment chains many
    updates into one program).

    ``grid``/``wall`` parameterize the map (bench_rbpf.py sweeps P and
    the 8x8 m 160x160 map)."""
    from tpunav.estimation.rbpf import (GridConfig, PFConfig, pf_init,
                                        pf_slam_step)
    from tpunav.estimation.rbpf.icp import ICPConfig
    from tpunav.sim.lidar import box_segments, scan_segments

    grid = grid or GridConfig()              # 4x4 m @ 0.05, 360 beams
    cfg = PFConfig(num_particles=p, k_samples=50,
                   sample_range=(1e-6, 1e-5, 1e-5),
                   motion_noise=(1e-6, 1e-5, 1e-5),
                   grid=grid, icp=ICPConfig(max_iter=25))
    segs = box_segments(-wall, -wall, wall, wall, jnp.float32)
    u = jnp.array([0.03, 0.02], jnp.float32)

    # Simulated course: scans + odometry, computed up front.
    scans, odoms = [], []
    pose = jnp.zeros(3, jnp.float32)
    for i in range(updates):
        th = pose[0] + u[0]
        pose = jnp.stack([th, pose[1] + u[1] * jnp.cos(th),
                          pose[2] + u[1] * jnp.sin(th)])
        odoms.append(pose)
        scans.append(scan_segments(
            pose, segs, num_beams=grid.num_beams, max_range=grid.range_max,
            key=jax.random.fold_in(jax.random.PRNGKey(7), i),
            noise_std=0.002))
    prevs = [jnp.zeros(3, jnp.float32)] + odoms[:-1]

    step = jax.jit(
        lambda s, scan, od, pv: pf_slam_step(cfg, s, scan, u, od, pv),
        donate_argnums=0)

    def chain(st):
        for i in range(updates):
            st = step(st, scans[i], odoms[i], prevs[i])
        return st

    jax.block_until_ready(chain(pf_init(cfg, seed=0)).poses)  # compile
    times = []
    for _ in range(3):
        st0 = jax.block_until_ready(pf_init(cfg, seed=0))
        t0 = time.perf_counter()
        st = chain(st0)
        jax.block_until_ready(st.poses)
        times.append(time.perf_counter() - t0)

    rate = updates / min(times)
    return {
        "metric": f"rbpf_slam_updates_per_sec (P={p} particles, "
                  f"{grid.height}x{grid.width} map, 360 beams, k=50, "
                  f"per-scan dispatch)",
        "value": round(rate, 2),
        "unit": "updates/s",
        "vs_baseline": round(rate * p / REF_PARTICLE_UPDATES_PER_SEC, 2),
        "median": round(updates / statistics.median(times), 2),
    }


def bench_ekf(n=50, n_visible=12, updates=200):
    """EKF SLAM update throughput at capacity n=50 (the EKF half of
    BASELINE configs 3-4's EKF+MPPI loops). Per-update dispatch with donated
    state, pipelined like the RBPF bench; f32; both known-DA
    (ref: ekf_filter.cpp:298-411) and unknown-DA Mahalanobis gating
    (ref: ekf_filter.cpp:112-294) are timed, the known-DA rate is the
    reported value."""
    from tpunav.estimation.ekf.filter import (EKFConfig, ekf_init,
                                              known_correspondence_slam,
                                              slam_unknown_da)

    cfg = EKFConfig(num_landmarks=n, dmin=5e1, dmax=1e4,
                    measurement_noise=(1e-4, 1e-4))
    u = jnp.array([0.02, 0.01], jnp.float32)

    # Course: a ring of true landmarks observed from a drifting pose,
    # n_visible visible per update (NaN-padded to capacity, the
    # TurtleMap wire shape).
    ang = jnp.linspace(0.0, 2 * jnp.pi, n_visible, endpoint=False)
    lms = jnp.stack([2.0 * jnp.cos(ang), 2.0 * jnp.sin(ang)], -1)
    pose = jnp.zeros(3, jnp.float32)
    meas_seq = []
    for i in range(updates):
        th = pose[0] + u[0]
        pose = jnp.stack([th, pose[1] + u[1] * jnp.cos(th),
                          pose[2] + u[1] * jnp.sin(th)])
        c, s = jnp.cos(pose[0]), jnp.sin(pose[0])
        rel = lms - pose[None, 1:3]
        rf = jnp.stack([c * rel[:, 0] + s * rel[:, 1],
                        -s * rel[:, 0] + c * rel[:, 1]], -1)
        rf = rf + 1e-3 * jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(11), i), rf.shape)
        meas_seq.append(jnp.pad(rf.astype(jnp.float32),
                                ((0, n - n_visible), (0, 0)),
                                constant_values=jnp.nan))
    meas_seq = [jax.device_put(m) for m in meas_seq]

    results, medians = {}, {}
    for name, fn in (("known", known_correspondence_slam),
                     ("unknown", slam_unknown_da)):
        step = jax.jit(lambda st, m, fn=fn: fn(cfg, st, m, u),
                       donate_argnums=0)

        def chain(st):
            for m in meas_seq:
                st = step(st, m)
            return st

        jax.block_until_ready(chain(ekf_init(cfg, jnp.float32)).state)
        times = []
        for _ in range(3):
            st0 = jax.block_until_ready(ekf_init(cfg, jnp.float32))
            t0 = time.perf_counter()
            st = chain(st0)
            jax.block_until_ready(st.state)
            times.append(time.perf_counter() - t0)
        results[name] = updates / min(times)
        medians[name] = updates / statistics.median(times)

    known = {
        "metric": f"ekf_slam_updates_per_sec (n={n} capacity, "
                  f"{n_visible} meas/update, f32, known DA)",
        "value": round(results["known"], 1),
        "unit": "updates/s",
        "vs_baseline": round(results["known"] / REF_EKF_UPDATES_PER_SEC, 2),
        "median": round(medians["known"], 1),
    }
    unknown = {
        "metric": f"ekf_slam_unknown_da_updates_per_sec (n={n} capacity, "
                  f"{n_visible} meas/update, f32, Mahalanobis gating)",
        "value": round(results["unknown"], 1),
        "unit": "updates/s",
        "vs_baseline": round(results["unknown"] / REF_EKF_UPDATES_PER_SEC,
                             2),
        "median": round(medians["unknown"], 1),
    }
    return known, unknown


def bench_slam_loop(known_da: bool, ticks=240, n=50, rollouts=4096,
                    use_fused=True):
    """Closed-loop Hz for BASELINE configs 3-4: the
    FULL estimate→plan→act tick — landmark sensor → known/unknown-DA EKF
    update at capacity n=50 → MPPI solve (K=4096) → plant → odometry —
    compiled as one device program (control/slam_loop.py), chained in a
    lax.scan like the MPPI bench and timed per-tick. The sensor fires
    EVERY tick (sensor_every=1): every tick pays a full measurement
    update, the strictest closed-loop rate. The reference's equivalent
    loop is slam_node free-spinning at the 60 Hz fake-encoder rate
    (nuslam/src/slam_node.cpp:261-464)."""
    from tpunav.control.slam_loop import (SlamLoopConfig, slam_loop_init,
                                          slam_loop_tick)
    from tpunav.control.mppi import MPPIConfig
    from tpunav.estimation.ekf import EKFConfig
    from tpunav.models.cart import CartParams

    mppi_cfg = MPPIConfig(horizon=0.5, dt=0.02, rollouts=rollouts,
                          ul_var=4.0, ur_var=4.0)
    ekf_cfg = EKFConfig(num_landmarks=n, dmin=5e1, dmax=1e4,
                        spd_repair=False,
                        motion_noise=(1e-6, 1e-6, 1e-6),
                        measurement_noise=(1e-5, 1e-5))
    cfg = SlamLoopConfig(known_da=known_da, sensor_every=1,
                         visibility=1.2, cycles=1000,
                         use_fused=use_fused)
    model = CartParams(0.033, 0.160)
    waypoints = jnp.asarray([[0.4, 0.0, 0.0], [0.3, 0.4, 1.57],
                             [-0.3, 0.3, 3.0], [-0.4, -0.3, -2.0],
                             [0.2, -0.4, -0.5]], jnp.float32)
    # Config 3: the reference's 12-cylinder block world; config 4: a
    # dense 48-cylinder world exercising the capacity-50 gating chain.
    n_lms = 12 if known_da else 48
    ang = jnp.linspace(0.0, 2 * jnp.pi, n_lms, endpoint=False)
    rad = jnp.where(jnp.arange(n_lms) % 2 == 0, 0.9, 1.4)
    landmarks = jnp.stack([rad * jnp.cos(ang), rad * jnp.sin(ang)], -1)

    @jax.jit
    def run(st):
        def body(s, _):
            s = slam_loop_tick(mppi_cfg, ekf_cfg, cfg, model, waypoints,
                               landmarks, s)
            return s, s.true_pose
        return jax.lax.scan(body, st, None, length=ticks)

    st0 = slam_loop_init(mppi_cfg, ekf_cfg, seed=0)
    st, _ = run(st0)
    jax.block_until_ready(st.true_pose)          # compile + warm
    times = []
    for _ in range(3):
        s = jax.block_until_ready(slam_loop_init(mppi_cfg, ekf_cfg, seed=0))
        t0 = time.perf_counter()
        s, traj = run(s)
        jax.block_until_ready(traj)
        times.append(time.perf_counter() - t0)

    rate = ticks / min(times)
    da = "known" if known_da else "unknown"
    config = 3 if known_da else 4
    return {
        "metric": f"ekf_mppi_closed_loop_ticks_per_sec (config {config}: "
                  f"{da} DA, n={n} capacity, {n_lms} landmarks, "
                  f"K={rollouts} MPPI solve every tick)",
        "value": round(rate, 1),
        "unit": "ticks/s",
        "vs_baseline": round(rate / REF_EKF_UPDATES_PER_SEC, 2),
        "median": round(ticks / statistics.median(times), 1),
    }


def main():
    device = device_info()
    benches = [bench_ekf, lambda: bench_slam_loop(known_da=True),
               lambda: bench_slam_loop(known_da=False), bench_rbpf,
               bench_mppi]           # headline metric LAST
    for bench in benches:
        out = bench()
        for line in out if isinstance(out, tuple) else (out,):
            print(json.dumps({**line, "device": device}), flush=True)


if __name__ == "__main__":
    main()
