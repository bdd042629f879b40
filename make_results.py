"""Reproduce the reference's README error tables as a committed artifact —
STATISTICAL: every closed-loop config runs ≥20 seeds; rows report mean ± std and the worst case, and the full-stack
barrier run reports a success rate.

Configs (the reference's de-facto system tests, SURVEY.md §4 tier 3):

1. EKF SLAM, known DA — lidar raycast → circle detector → filter
   (ref table: nuslam/README.md:24-34)
2. EKF SLAM, unknown DA at 50-landmark capacity, 12-cylinder world
   (ref: nuslam/README.md:39-50)
3. Dense-world unknown DA — 44 cylinders through the lidar detector,
   MPPI in the loop (config 4 at its stated scale)
4. RBPF grid SLAM, 500 particles under the fused-MPPI exploration loop
   (ref table: bmapping/README.md:33-47 at 40 particles, teleop)
5. Full stack (RBPF map → D* Lite replanning → fused MPPI) success rate
6. Closed-loop RBPF per-scan budget decomposition

Run on a GPU:  python -m make_results
"""

import datetime
import sys

import jax

from tpunav.runtime import cache as _cache
_cache.enable()
import numpy as np

N_SEEDS = 20
FS_SEEDS = 10         # full-stack runs are ~40 s each (warm caches)


def fmt_err(e):
    return (f"x {e[1]:+.4f} m, y {e[2]:+.4f} m, "
            f"yaw {np.degrees(e[0]):+.3f}°")


def fmt_stats(errs):
    """errs: (S, 3) [θ, x, y] → mean±std |xy| + yaw, worst case."""
    xy = np.hypot(errs[:, 1], errs[:, 2])
    yaw = np.degrees(np.abs(errs[:, 0]))
    return (f"|xy| {xy.mean()*100:.2f} ± {xy.std()*100:.2f} cm "
            f"(worst {xy.max()*100:.2f}), "
            f"|yaw| {yaw.mean():.2f} ± {yaw.std():.2f}° "
            f"(worst {yaw.max():.2f})")


def main(out="RESULTS.md"):
    print("devices:", jax.devices(), flush=True)
    from examples.lidar_ekf_slam_demo import run as ekf_run, run_many
    from examples.rbpf_explore_demo import run_experiment, seed_sweep
    from tpunav.estimation.ekf import (EKFConfig, known_correspondence_slam,
                                       slam_unknown_da)

    seeds = np.arange(N_SEEDS)
    rows = []

    # ── 1. EKF known DA, lidar → detector ──
    cfg_known = EKFConfig(num_landmarks=12, spd_repair=False,
                          motion_noise=(1e-6, 1e-6, 1e-6),
                          measurement_noise=(1e-5, 1e-5))
    ekf_err, odo_err, n_lm, wall, steps, _ = ekf_run(
        known_correspondence_slam, cfg_known, True)
    e_s, e_o, counts, wall_m = run_many(known_correspondence_slam,
                                        cfg_known, True, seeds)
    rows.append((
        "EKF SLAM (known DA, lidar→detector)",
        np.asarray(ekf_err), np.asarray(odo_err),
        f"{N_SEEDS} seeds: SLAM {fmt_stats(np.asarray(e_s))}; "
        f"odometry {fmt_stats(np.asarray(e_o))}",
        f"{n_lm}/12 landmarks, {steps} steps, 12-cylinder block world, "
        f"360-beam lidar σ=1e-3; {N_SEEDS}-seed sweep in {wall_m:.0f}s "
        f"(vmapped courses)",
        "nuslam/README.md:24-34 (x 0.000, y 0.000, yaw 0.008°; "
        "odom 0.030/0.099/−7.964°)"))
    print("EKF known done", flush=True)

    # ── 2. EKF unknown DA, capacity 50, 12-cylinder world ──
    cfg_unk = EKFConfig(num_landmarks=50, dmin=5e1, dmax=1e4,
                        spd_repair=False,
                        motion_noise=(1e-5, 1e-5, 1e-5),
                        measurement_noise=(1e-5, 1e-5))
    ekf_err, odo_err, n_lm, wall, steps, _ = ekf_run(
        slam_unknown_da, cfg_unk, False)
    e_s, e_o, counts, wall_m = run_many(slam_unknown_da, cfg_unk, False,
                                        seeds)
    counts = np.asarray(counts)
    rows.append((
        "EKF SLAM (unknown DA, Mahalanobis, capacity 50)",
        np.asarray(ekf_err), np.asarray(odo_err),
        f"{N_SEEDS} seeds: SLAM {fmt_stats(np.asarray(e_s))}; "
        f"odometry {fmt_stats(np.asarray(e_o))}; landmarks tracked "
        f"{counts.mean():.1f} ± {counts.std():.1f}",
        f"{n_lm} landmarks tracked (seed 0), {steps} steps, same world",
        "nuslam/README.md:39-50 (x −0.008, y 0.038, yaw −1.633°; "
        "odom 0.015/0.084/−6.975°)"))
    print("EKF unknown done", flush=True)

    # ── 3. Dense world: config 4 at its stated scale, real perception ──
    from examples.dense_world_slam_demo import run_batch
    dw, dw_wall = run_batch(seeds)
    dw_s = np.asarray(dw["ekf_err"])
    dw_o = np.asarray(dw["odo_err"])
    dw_c = np.asarray(dw["count"])
    dw_v = np.asarray(dw["visits"])
    rows.append((
        "Dense-world EKF SLAM (unknown DA, 44 cylinders, MPPI in the "
        "loop)",
        dw_s[0], dw_o[0],
        f"{N_SEEDS} seeds: SLAM {fmt_stats(dw_s)}; odometry "
        f"{fmt_stats(dw_o)}; landmarks tracked {dw_c.mean():.1f} ± "
        f"{dw_c.std():.1f} of 44 true, waypoints reached "
        f"{dw_v.mean():.1f}",
        f"lidar → clustering+circle-fit detector → capacity-50 gating, "
        f"K=2048 MPPI closed loop, 5000 ticks @ 20 Hz, odometry bias "
        f"1e-4/tick; {N_SEEDS}-seed sweep in {dw_wall:.0f}s (vmapped)",
        "nuslam/README.md:39-50 — the reference's unknown-DA table is a "
        "12-landmark world at visibility 0.6 m; this world is ~4x "
        "larger with detector-based perception"))
    print("dense world done", flush=True)

    # ── 4. RBPF exploration (config 5) ──
    r = run_experiment()
    sw_s, sw_o = seed_sweep(seeds=tuple(range(N_SEEDS)))
    rows.append((
        f"RBPF grid SLAM ({r['num_particles']} particles, MPPI "
        f"exploration loop K={r['mppi_rollouts']})",
        r["slam_err"], r["odom_err"],
        f"{N_SEEDS} filter seeds (40-scan course): SLAM "
        f"{fmt_stats(sw_s)}; odometry {fmt_stats(sw_o)}",
        f"{r['n_scans']} scans @ {r['updates_per_sec']:.1f} updates/s "
        f"closed loop (median {r['updates_per_sec_median']:.1f}), "
        f"{r['mppi_solves']} fused solves, {r['occupied_cells']} "
        f"occupied cells, torque-capped motor dynamics (τ=50 ms), "
        f"reference-scale odometry drift, checkpoint/restore mid-run, "
        f"per-scan error/N_eff time series → "
        f"examples/out/rbpf_explore_timeseries.png",
        "bmapping/README.md:33-47 (x −1.04 cm, y 3.81 cm, yaw 1.98°; "
        "odom 19.5/−10.5 cm, 2.62°)"))
    print("RBPF explore done", flush=True)

    # ── 5. Full stack success rate ──
    from examples.full_stack_demo import plot as fs_plot, run as fs_run
    fs_results = []
    for s in range(FS_SEEDS):
        fs = fs_run(verbose=False, seed=5 + s)
        fs_results.append(fs)
        print(f"full stack seed {5 + s}: reached={fs['reached']} "
              f"goal_err={fs['final_goal_err_m']*100:.1f} cm", flush=True)
    fs_plot(fs_results[0])
    n_ok = sum(f["reached"] for f in fs_results)
    goal_errs = np.asarray([f["final_goal_err_m"] for f in fs_results])
    slam_errs = np.asarray([f["slam_vs_true_m"] for f in fs_results])
    fullstack_line = (
        f"Full stack (RBPF map → D* Lite replanning → fused MPPI, one "
        f"loop): goal reached in {n_ok}/{FS_SEEDS} seeded runs through "
        f"an initially-unknown barrier; final goal error "
        f"{goal_errs.mean()*100:.1f} ± {goal_errs.std()*100:.1f} cm "
        f"(worst {goal_errs.max()*100:.1f}), SLAM-vs-truth "
        f"{slam_errs.mean()*100:.1f} ± {slam_errs.std()*100:.1f} cm "
        f"(examples/full_stack_demo.py; the reference runs mapping, "
        f"planning and control as separate launches with a SCRIPTED "
        f"obstacle reveal — grid_planner_node.cpp:217-264).")
    print("full stack done", flush=True)

    # ── 6. Closed-loop budget decomposition ──
    from examples.profile_rbpf_stages import profile_closed_loop
    budget = profile_closed_loop()
    budget_lines = [
        "## Closed-loop RBPF per-scan budget (config 5)",
        "",
        "| stage | ms/scan (pipelined) |",
        "|---|---|",
    ] + [f"| {k} | {v:.2f} |" for k, v in budget.items()] + [
        "",
        "The chained interval can run faster than the sum of its "
        "isolated stages — control, sense, and SLAM dispatches overlap "
        "on the device — so a negative remainder is pipelining overlap, "
        "not measurement error. Per-stage breakdown of the filter step: "
        "examples/profile_rbpf_stages.py.",
        "",
    ]

    from bench import device_info
    d = device_info()
    dev = f"{d['platform']} {d['kind']} ({d['card']})"
    when = datetime.datetime.now(datetime.UTC).strftime("%Y-%m-%d %H:%M UTC")
    lines = [
        "# RESULTS — closed-loop fidelity vs the reference README tables",
        "",
        f"Generated by `python -m make_results` on `{dev}`, {when}.",
        "All errors are FINAL pose error vs simulation ground truth; "
        "odometry error is the dead-reckoned pose of the same run "
        "(the reference's PoseError topics, tsim/msg/PoseError.msg). "
        f"Seed-0 rows show the per-axis breakdown; the {N_SEEDS}-seed "
        "statistics carry the spread (mean ± std, worst case).",
        "",
    ]
    for name, slam, odo, stats, cfg_s, ref_s in rows:
        lines += [
            f"## {name}",
            "",
            f"| | pose error (seed 0) |",
            f"|---|---|",
            f"| **SLAM** | {fmt_err(slam)} |",
            f"| odometry only | {fmt_err(odo)} |",
            "",
            f"Statistics: {stats}.",
            "",
            f"Config: {cfg_s}.",
            f"Reference: {ref_s}.",
            "",
        ]
    lines += [
        "## Full navigation stack (beyond-reference integration)",
        "",
        fullstack_line,
        "",
    ] + budget_lines
    with open(out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "RESULTS.md")
