"""Standalone RBPF benchmark sweep.

- P in {40, 500, 1000, 2000} at the reference map (80x80, 4x4 m @ 0.05)
  — the updates/s-vs-particle-count curve (P=40 is the apples-to-apples
  row against the reference's CPU budget, P=500 is BASELINE config 5 and
  the line `bench.py` emits for the driver).
- P=500 on the 8x8 m 160x160 map — twice the reference's world per side.

Methodology (per-scan dispatch, donated state, best-of) lives in
:func:`bench.bench_rbpf`.
"""

import json

from bench import bench_rbpf, device_info


def main():
    device = device_info()
    for p in (40, 500, 1000, 2000):
        print(json.dumps({**bench_rbpf(p=p), "device": device}), flush=True)

    from tpunav.estimation.rbpf import GridConfig
    big = GridConfig(xmin=-4.0, xmax=4.0, ymin=-4.0, ymax=4.0)
    print(json.dumps({**bench_rbpf(p=500, grid=big, wall=3.2),
                      "device": device}), flush=True)


if __name__ == "__main__":
    main()
