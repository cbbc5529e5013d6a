"""Distance-transform tests: exactness vs brute force, at a small grid and
at the half-resolution KITTI grid the frontend builds (184x616)."""

import numpy as np
import pytest
import jax.numpy as jnp

from direct_stereo_slam_tpu.ops.distance_map import (
    MAX_DIST, build_distance_map, reference_distance_map)

pytestmark = pytest.mark.smoke


def _brute_force(pu, pv, mask, h2, w2):
    ui = np.clip(np.round(pu).astype(int), 0, w2 - 1)
    vi = np.clip(np.round(pv).astype(int), 0, h2 - 1)
    occ = np.zeros((h2, w2), bool)
    occ[vi[mask], ui[mask]] = True
    ys, xs = np.nonzero(occ)
    gy, gx = np.mgrid[0:h2, 0:w2]
    if len(ys) == 0:
        return np.full((h2, w2), float(MAX_DIST))
    # chebyshev distance to the nearest occupied cell, capped
    d = np.min(
        np.maximum(np.abs(gy[..., None] - ys), np.abs(gx[..., None] - xs)),
        axis=-1,
    )
    return np.minimum(d, MAX_DIST).astype(np.float32)


def test_matches_brute_force_chebyshev():
    rng = np.random.RandomState(3)
    h2, w2 = 40, 64
    n = 25
    pu = rng.rand(n).astype(np.float32) * (w2 - 1)
    pv = rng.rand(n).astype(np.float32) * (h2 - 1)
    mask = rng.rand(n) < 0.8
    out = np.asarray(build_distance_map(
        jnp.asarray(pu), jnp.asarray(pv), jnp.asarray(mask), h2, w2))
    ref = _brute_force(pu, pv, mask, h2, w2)
    np.testing.assert_array_equal(out, ref)


def test_empty_mask_is_all_max():
    h2, w2 = 16, 24
    out = np.asarray(build_distance_map(
        jnp.zeros(4), jnp.zeros(4), jnp.zeros(4, bool), h2, w2))
    assert np.all(out == MAX_DIST)


def test_chunked_reference_matches_brute_force():
    rng = np.random.RandomState(1)
    h2, w2, n = 37, 53, 40
    pu = rng.rand(n).astype(np.float32) * (w2 - 1)
    pv = rng.rand(n).astype(np.float32) * (h2 - 1)
    mask = rng.rand(n) < 0.7
    np.testing.assert_array_equal(
        reference_distance_map(pu, pv, mask, h2, w2, rows_per_chunk=5),
        _brute_force(pu, pv, mask, h2, w2))


def test_half_res_kitti_grid_matches_brute_force():
    """The frontend's grid: KITTI 1232x368 at half resolution, with the
    preset-0 active point budget projected into it."""
    rng = np.random.RandomState(0)
    h2, w2, n = 184, 616, 2000
    pu = rng.rand(n).astype(np.float32) * (w2 - 1)
    pv = rng.rand(n).astype(np.float32) * (h2 - 1)
    mask = rng.rand(n) < 0.9
    out = np.asarray(build_distance_map(
        jnp.asarray(pu), jnp.asarray(pv), jnp.asarray(mask), h2, w2))
    np.testing.assert_array_equal(
        out, reference_distance_map(pu, pv, mask, h2, w2))
