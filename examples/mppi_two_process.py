"""Two-PROCESS sharded MPPI: the multi-host deployment proof.

The reference runs its stack across two machines via roslaunch
``<machine>`` tags (ref: nuturtle_robot/launch/basic_remote.launch:1-40 —
ssh-spawned nodes sharing one ROS master). The JAX equivalent is
SPMD: every process runs THIS script, ``jax.distributed.initialize``
wires them over the coordinator, and one global mesh spans all
processes' devices so the MPPI softmax reduction (pmin + one fused psum
per solve, parallel/mppi_sharded.py) rides the inter-process link.

Worker mode (spawned per process, CPU devices stand in for chips):

    python -m examples.mppi_two_process --process-id N \
        --num-processes 2 --coordinator localhost:PORT \
        --out /tmp/result.npy

Launcher mode (no args): spawns 2 workers itself, waits, checks both
produced the identical replicated result, and reports solves/s.
tests/test_distributed.py asserts the result also matches a
single-process 8-device run bit-for-bit.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np

LOCAL_DEVICES = 4     # per process → 2 processes span an 8-device mesh
SOLVES = 20


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

    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tpunav.control.mppi import MPPIConfig, init_controls
    from tpunav.models.cart import CartParams
    from tpunav.parallel.mppi_sharded import mppi_solve_sharded

    cfg = MPPIConfig(horizon=0.5, dt=0.01, rollouts=1024)
    model = CartParams(0.033, 0.160)
    mesh = Mesh(np.asarray(jax.devices()).reshape(-1), ("k",))
    solve = mppi_solve_sharded(cfg, model, mesh)

    pose = jnp.asarray([0.1, -0.2, 0.3], jnp.float32)
    xd = jnp.asarray([1.0, 1.0, 0.0], jnp.float32)
    key = jax.random.PRNGKey(7)

    u = init_controls(cfg)
    cmd, u = jax.block_until_ready(solve(u, key, pose, xd))  # compile
    t0 = time.time()
    u2 = init_controls(cfg)
    for i in range(SOLVES):
        key_i = jax.random.fold_in(jax.random.PRNGKey(7), i)
        cmd, u2 = solve(u2, key_i, pose, xd)
    jax.block_until_ready(u2)
    dt = time.time() - t0

    # Outputs are replicated; every process holds identical values.
    out = {"cmd": np.asarray(cmd), "u": np.asarray(u2),
           "solves_per_sec": SOLVES / dt,
           "process_id": args.process_id,
           "global_devices": info["global_devices"]}
    np.savez(args.out, **out)
    print(f"[proc {args.process_id}] {info} -> {SOLVES / dt:.1f} solves/s",
          flush=True)


def launcher(out_dir=None):
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coord = f"localhost:{port}"
    # Per-run output dir (advisor r2: a fixed tempdir path races with
    # concurrent runs on one machine).
    out_dir = out_dir or tempfile.mkdtemp(prefix="mppi_2proc_")
    outs = [os.path.join(out_dir, f"mppi_2proc_{i}.npz")
            for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "examples.mppi_two_process",
             "--process-id", str(i), "--num-processes", "2",
             "--coordinator", coord, "--out", outs[i]],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        for i in range(2)
    ]
    rcs = [p.wait(timeout=600) for p in procs]
    assert rcs == [0, 0], f"worker exit codes {rcs}"
    a, b = (np.load(o) for o in outs)
    np.testing.assert_array_equal(a["cmd"], b["cmd"])
    np.testing.assert_array_equal(a["u"], b["u"])
    print(f"2-process run consistent: cmd={a['cmd']} "
          f"({a['solves_per_sec']:.1f} / {b['solves_per_sec']:.1f} "
          f"solves/s per process, {int(a['global_devices'])} devices)")
    return outs[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", type=str, default=None)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--out-dir", type=str, default=None,
                    help="launcher mode: directory for worker outputs")
    args = ap.parse_args()
    if args.process_id is None:
        launcher(args.out_dir)
    else:
        worker(args)


if __name__ == "__main__":
    main()
