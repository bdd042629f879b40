"""Two-PROCESS sharded RBPF SLAM: the multi-host mapping proof.

The MPPI two-process proof (examples/mppi_two_process.py) validates the
psum/pmin solve collectives across OS processes; this does the same for
the RISKY RBPF collective — the all_gather particle/map exchange that a
resample routes across process boundaries
(parallel/rbpf_sharded.py:exchange; ref: the reference's per-particle
map loop bmapping/src/bmapping/particle_filter.cpp:158-241 and its
two-machine launch nuturtle_robot/launch/basic_remote.launch:1-40).

Each worker joins a 2-process global mesh (4 CPU devices each → 8-way
particle sharding), runs two normal SLAM steps, then FORCES a resample
by concentrating the weights on one particle — N_eff collapses below
P/2, so the third step's exchange gathers nearly every particle's pose
AND map from the shard that owns the winner, across the process
boundary. Both workers must land on identical replicated results, and
tests/test_distributed.py asserts the run equals a single-process
8-device run of the same program.

Worker mode:

    python -m examples.rbpf_two_process --process-id N \
        --num-processes 2 --coordinator localhost:PORT --out /tmp/out.npz

Launcher mode (no args): spawns 2 workers, checks cross-process
agreement.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np

LOCAL_DEVICES = 4     # per process → 2 processes span an 8-device mesh
P_TOTAL = 16
STEPS = 2


def run_course(jax, mesh):
    """The deterministic course both the 2-process workers and the
    single-process check run: STEPS normal updates, then a
    forced-resample update (weights concentrated on particle 3)."""
    import jax.numpy as jnp

    from tpunav.estimation.rbpf import GridConfig, PFConfig
    from tpunav.estimation.rbpf.icp import ICPConfig
    from tpunav.parallel.rbpf_sharded import (
        pf_init_sharded,
        pf_slam_step_sharded,
        state_sharding,
    )
    from tpunav.sim.lidar import box_segments, scan_segments

    grid = GridConfig(resolution=0.1, num_beams=90,
                      beam_delta=2 * jnp.pi / 90)
    cfg = PFConfig(num_particles=P_TOTAL, k_samples=8, grid=grid,
                   sample_range=(1e-4, 1e-3, 1e-3),
                   motion_noise=(1e-4, 1e-3, 1e-3),
                   icp=ICPConfig(max_iter=10))
    segs = box_segments(-1.5, -1.5, 1.5, 1.5, jnp.float32)
    st = pf_init_sharded(cfg, mesh, axis_name="p", seed=5)
    step = pf_slam_step_sharded(cfg, mesh, axis_name="p")

    u = jnp.asarray([0.0, 0.05], jnp.float32)
    odom_prev = jnp.zeros(3, jnp.float32)
    for i in range(STEPS):
        odom = jnp.asarray([0.0, 0.05 * (i + 1), 0.0], jnp.float32)
        ranges = scan_segments(odom, segs, num_beams=grid.num_beams,
                               beam_delta=grid.beam_delta,
                               max_range=grid.range_max)
        st = step(st, ranges, u, odom, odom_prev)
        odom_prev = odom

    # Concentrate the weights: particle 3 gets ~all the mass, so N_eff≈1
    # and the next step MUST resample — the all_gather exchange then
    # copies particle 3's pose and whole MAP to (nearly) every slot,
    # across the process boundary in the 2-process run.
    lw = jnp.where(jnp.arange(P_TOTAL) == 3, 0.0, -50.0).astype(jnp.float32)
    lw = jax.device_put(lw, state_sharding(mesh, "p").log_weights)
    st = st._replace(log_weights=lw)

    odom = jnp.asarray([0.0, 0.05 * (STEPS + 1), 0.0], jnp.float32)
    ranges = scan_segments(odom, segs, num_beams=grid.num_beams,
                           beam_delta=grid.beam_delta,
                           max_range=grid.range_max)
    st = step(st, ranges, u, odom, odom_prev)
    return st


def worker(args):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    flags.append(f"--xla_force_host_platform_device_count={LOCAL_DEVICES}")
    os.environ["XLA_FLAGS"] = " ".join(flags)
    import jax
    jax.config.update("jax_platforms", "cpu")

    from tpunav.runtime.distributed import initialize, process_info

    assert initialize(coordinator_address=args.coordinator,
                      num_processes=args.num_processes,
                      process_id=args.process_id)
    info = process_info()
    assert info["global_devices"] == LOCAL_DEVICES * args.num_processes

    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices()).reshape(-1), ("p",))
    t0 = time.time()
    st = run_course(jax, mesh)
    jax.block_until_ready(st.poses)

    # The particle axis spans both processes — fetch the global arrays
    # through one more collective (each worker then holds the full set).
    from jax.experimental import multihost_utils

    poses = multihost_utils.process_allgather(st.poses, tiled=True)
    log_weights = multihost_utils.process_allgather(st.log_weights,
                                                    tiled=True)
    out = {"poses": np.asarray(poses),
           "log_weights": np.asarray(log_weights),
           "process_id": args.process_id,
           "global_devices": info["global_devices"],
           "wall_s": time.time() - t0}
    np.savez(args.out, **out)
    print(f"[proc {args.process_id}] {info} ({out['wall_s']:.1f}s)",
          flush=True)


def launcher(out_dir=None):
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coord = f"localhost:{port}"
    out_dir = out_dir or tempfile.mkdtemp(prefix="rbpf_2proc_")
    outs = [os.path.join(out_dir, f"rbpf_2proc_{i}.npz") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "examples.rbpf_two_process",
             "--process-id", str(i), "--num-processes", "2",
             "--coordinator", coord, "--out", outs[i]],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        for i in range(2)
    ]
    rcs = [p.wait(timeout=600) for p in procs]
    assert rcs == [0, 0], f"worker exit codes {rcs}"
    a, b = (np.load(o) for o in outs)
    np.testing.assert_array_equal(a["poses"], b["poses"])
    np.testing.assert_array_equal(a["log_weights"], b["log_weights"])
    # The forced resample must have duplicated the winner across slots.
    uniq = np.unique(np.round(a["poses"], 6), axis=0)
    assert len(uniq) < P_TOTAL, "resample did not duplicate particles"
    print(f"2-process RBPF consistent across the forced resample "
          f"({len(uniq)} unique particles of {P_TOTAL}, "
          f"{int(a['global_devices'])} devices)")
    return outs[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", type=str, default=None)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--out-dir", type=str, default=None)
    args = ap.parse_args()
    if args.process_id is None:
        launcher(args.out_dir)
    else:
        worker(args)


if __name__ == "__main__":
    main()
