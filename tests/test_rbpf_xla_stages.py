"""The RBPF's hot stages in their XLA form against brute-force numpy:
the likelihood-field sweep and map integration + exact distance field,
at the reference's 80x80 map and the 160x160 8x8 m map."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpunav.estimation.rbpf.grid import (
    GridConfig,
    esdf,
    grid_init,
    integrate_scan,
    likelihood_field_batch,
)
from tpunav.sim.lidar import box_segments, scan_segments

GRIDS = {
    80: GridConfig(),                                        # 4x4 m
    160: GridConfig(xmin=-4.0, xmax=4.0, ymin=-4.0, ymax=4.0),
}


def _world(cfg, p=3, wall=1.5):
    segs = box_segments(-wall, -wall, wall, wall, jnp.float32)
    pose = jnp.asarray([0.1, 0.05, -0.02], jnp.float32)
    scan = scan_segments(pose, segs, num_beams=cfg.num_beams,
                         beam_delta=cfg.beam_delta, max_range=cfg.range_max,
                         key=jax.random.PRNGKey(0), noise_std=0.01)
    poses = pose[None] + 0.03 * jax.random.normal(
        jax.random.PRNGKey(1), (p, 3), jnp.float32)
    grids = jnp.broadcast_to(grid_init(cfg),
                             (p, cfg.height, cfg.width)).copy()
    grids = jax.vmap(lambda g, q: integrate_scan(cfg, g, scan, q))(grids,
                                                                  poses)
    return scan, poses, grids


def _edt_numpy(occ, res, cap):
    """Exact Euclidean distance (m) from every cell to the nearest
    occupied cell, by enumeration."""
    ys, xs = np.nonzero(occ)
    if len(ys) == 0:
        return np.full(occ.shape, cap)
    h, w = occ.shape
    cy, cx = np.mgrid[0:h, 0:w]
    d2 = np.full(occ.shape, np.inf)
    for y, x in zip(ys, xs):
        d2 = np.minimum(d2, (cy - y) ** 2 + (cx - x) ** 2)
    return np.minimum(np.sqrt(d2) * res, cap)


def _likelihood_numpy(cfg, dist, ranges, pose):
    beam = cfg.beam_min + cfg.beam_delta * np.arange(cfg.num_beams)
    ang = pose[0] + beam
    ranges = np.asarray(ranges, np.float64)
    valid = (ranges >= cfg.range_min) & (ranges < cfg.range_max)
    r = np.where(valid, ranges, cfg.range_min)
    ex = pose[1] + r * np.cos(ang)
    ey = pose[2] + r * np.sin(ang)
    ix = np.clip(np.floor((ex - cfg.xmin) / cfg.resolution), 0,
                 cfg.width - 1).astype(int)
    iy = np.clip(np.floor((ey - cfg.ymin) / cfg.resolution), 0,
                 cfg.height - 1).astype(int)
    d = dist[iy, ix]
    var = cfg.sigma_hit ** 2
    pz = cfg.z_hit / np.sqrt(2 * np.pi * var) * np.exp(-0.5 * d * d / var) \
        + cfg.z_rand / cfg.z_max
    if not np.any(dist < cfg.max_occ_dist):
        return 0.0
    return float(np.sum(np.where(valid, np.log(pz), 0.0)))


@pytest.mark.parametrize("size", [80, 160])
def test_integrate_and_esdf_match_brute_force_edt(size):
    cfg = GRIDS[size]
    _, _, grids = _world(cfg, p=2)
    for g in np.asarray(grids):
        occ = g >= cfg.l_occ
        assert occ.sum() > 50             # the walls were mapped
        d = np.asarray(esdf(cfg, jnp.asarray(g)))
        ref = _edt_numpy(occ, cfg.resolution, cfg.max_occ_dist)
        np.testing.assert_allclose(d, ref, atol=1e-5)


@pytest.mark.parametrize("size", [80, 160])
def test_likelihood_sweep_matches_brute_force(size):
    cfg = GRIDS[size]
    scan, poses, grids = _world(cfg, p=3)
    dists = jax.vmap(lambda g: esdf(cfg, g))(grids)
    samples = poses[:, None, :] + 0.01 * jax.random.normal(
        jax.random.PRNGKey(3), (3, 4, 3), jnp.float32)
    got = np.asarray(likelihood_field_batch(cfg, dists, scan, samples))
    assert got.shape == (3, 4)
    ref = np.array([[_likelihood_numpy(cfg, np.asarray(dists[i]), scan,
                                       np.asarray(samples[i, j],
                                                  np.float64))
                     for j in range(4)] for i in range(3)])
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_likelihood_empty_map_scores_zero():
    cfg = GRIDS[80]
    dists = jnp.full((2, cfg.height, cfg.width), cfg.max_occ_dist)
    scan = jnp.full((cfg.num_beams,), 1.0)
    out = likelihood_field_batch(cfg, dists, scan, jnp.zeros((2, 5, 3)))
    np.testing.assert_array_equal(np.asarray(out), 0.0)
