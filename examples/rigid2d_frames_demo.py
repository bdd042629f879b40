"""Interactive SE(2) frame-math demo.

JAX equivalent of the reference's `rigid2d_node`
(ref: rigid2d/src/rigid2d_node.cpp:11-218): read two transforms Tab and
Tbc, a point, a vector, and a twist, plus the frame they're expressed in;
print all six transforms (Tab, Tba, Tbc, Tcb, Tac, Tca) and the
point/vector/twist re-expressed in every frame (point via
``se2.apply``, twist via the adjoint).

Run with no stdin (piped/CI) to use the built-in sample input.
"""

import sys

import jax.numpy as jnp

from tpunav.core import se2


def read_floats(prompt, n, default):
    if not sys.stdin.isatty():
        print(f"{prompt} -> (sample) {default}")
        return default
    raw = input(f"{prompt}: ").split()
    return [float(v) for v in raw[:n]] if raw else default


def read_frame(default="a"):
    if not sys.stdin.isatty():
        print(f"frame of point/vector/twist (a/b/c) -> (sample) {default}")
        return default
    raw = input("frame of point/vector/twist (a/b/c): ").strip().lower()
    return raw if raw in ("a", "b", "c") else default


def show(name, T):
    xy = se2.translation_of(T)
    print(f"  {name}: theta={float(se2.theta_of(T)):+.6f} "
          f"x={float(xy[0]):+.6f} y={float(xy[1]):+.6f}")


def main():
    deg2rad = jnp.pi / 180.0
    th_ab, x_ab, y_ab = read_floats(
        "Tab as [deg x y]", 3, [90.0, 0.0, 1.0])
    th_bc, x_bc, y_bc = read_floats(
        "Tbc as [deg x y]", 3, [90.0, 1.0, 0.0])
    px, py = read_floats("point [x y]", 2, [1.0, 1.0])
    wz, vx, vy = read_floats("twist [w vx vy]", 3, [1.0, 2.0, 3.0])
    frame = read_frame()

    Tab = se2.make(th_ab * deg2rad, x_ab, y_ab)
    Tbc = se2.make(th_bc * deg2rad, x_bc, y_bc)
    Tba, Tcb = se2.inverse(Tab), se2.inverse(Tbc)
    Tac = se2.compose(Tab, Tbc)
    Tca = se2.inverse(Tac)

    print("transforms (ref prints the same six):")
    for name, T in [("Tab", Tab), ("Tba", Tba), ("Tbc", Tbc),
                    ("Tcb", Tcb), ("Tac", Tac), ("Tca", Tca)]:
        show(name, T)

    # Map the user quantities into ALL frames (ref: :150-218).
    to_a = {"a": se2.identity(), "b": Tab, "c": Tac}[frame]
    p_a = se2.apply(to_a, jnp.asarray([px, py]))
    V = jnp.asarray([wz, vx, vy])
    V_a = se2.adjoint(to_a, V)
    for tgt, T in [("a", se2.identity()), ("b", Tba), ("c", Tca)]:
        p = se2.apply(T, p_a)
        Vt = se2.adjoint(T, V_a)
        print(f"  in frame {tgt}: point=({float(p[0]):+.6f}, "
              f"{float(p[1]):+.6f})  twist=({float(Vt[0]):+.6f}, "
              f"{float(Vt[1]):+.6f}, {float(Vt[2]):+.6f})")


if __name__ == "__main__":
    main()
