"""First-order wheel-motor dynamics with a torque/acceleration cap.

The reference drives wheel joints through Gazebo's physics engine: the
plugin sets a VELOCITY TARGET per wheel and a maximum motor torque, and
the engine ramps the joint toward the target as fast as the torque allows
(ref: nuturtle_gazebo/src/turtle_drive_plugin.cpp:226-232; max torque
1.5 N·m from nuturtle_description/config/diff_params.yaml:19). A
pure-kinematic plant that snaps to the commanded velocity is therefore
slightly optimistic. This module is the JAX equivalent: a
jittable first-order tracking law

    v' = v + (1 - exp(-dt/τ)) · (v_cmd - v),  |v' - v| ≤ a_max·dt

shared by the host plant (sim/plant.py) and the fused device control
loops (closed-loop demos). τ = 0 disables the lag (exact legacy
behavior); a_max = τ_max / I_eff caps the ramp like the engine's torque
clamp.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class MotorParams:
    """τ = 0 → ideal (instant) tracking. Defaults model the reference's
    burger wheel: max_motor_torque 1.5 N·m against an effective per-wheel
    inertia of ~2.4e-3 kg·m² (robot mass ~1 kg on r=0.033 m wheels +
    rotor), i.e. a_max ≈ 625 rad/s² — fast, but no longer a step."""

    time_const: float = 0.0          # s; 0 disables dynamics
    max_torque: float = 1.5          # N·m (diff_params.yaml:19)
    eff_inertia: float = 2.4e-3      # kg·m² per wheel

    @property
    def max_accel(self) -> float:
        return self.max_torque / self.eff_inertia


def track(params: MotorParams, vel, cmd, dt: float):
    """One dt of velocity tracking; vel/cmd are (2,) wheel velocities
    (works elementwise for any matching shape). Jit-safe; with
    time_const == 0 this is exactly ``cmd``."""
    if params.time_const <= 0.0:
        return cmd
    import math
    alpha = 1.0 - math.exp(-dt / params.time_const)
    dv = alpha * (cmd - vel)
    lim = params.max_accel * dt
    return vel + jnp.clip(dv, -lim, lim)
