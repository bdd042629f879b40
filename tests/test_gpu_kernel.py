"""The compiled Triton MPPI kernel on the card (skipped without a GPU).

Run on a machine with a GPU:
``TPUNAV_GPU_TESTS=1 python -m pytest tests -m gpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpunav.control.mppi import MPPIConfig, init_controls, mppi_solve
from tpunav.models.cart import CartParams
from tpunav.ops.pallas_mppi import mppi_solve_fused

MODEL = CartParams(0.033, 0.160)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1024, 49_152])
def test_compiled_kernel_matches_xla(gpu, k):
    cfg = MPPIConfig(horizon=0.5, dt=0.01, rollouts=k)
    u = init_controls(cfg, dtype=jnp.float32)
    pose = jnp.asarray([0.1, -0.2, 0.3], jnp.float32)
    xd = jnp.asarray([1.0, 1.0, 0.0], jnp.float32)
    key = jax.random.PRNGKey(5)
    cmd_k, u_k = jax.jit(
        lambda u, kk: mppi_solve_fused(cfg, MODEL, u, kk, pose, xd))(u, key)
    with jax.default_matmul_precision("highest"):
        cmd_x, u_x = jax.jit(
            lambda u, kk: mppi_solve(cfg, MODEL, u, kk, pose, xd))(u, key)
    np.testing.assert_allclose(np.asarray(cmd_k), np.asarray(cmd_x),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(u_k), np.asarray(u_x), atol=2e-4)
