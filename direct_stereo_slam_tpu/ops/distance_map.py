"""Half-resolution distance transform for activation gating.

Equivalent of the reference's ``CoarseDistanceMap`` (BFS over projected
active points, TrackerAndScaler.cpp:1197-1334; consumed by activatePointsMT,
FrontEnd.cpp:431-445): active window points are projected into the newest
keyframe at half resolution, and candidate points are only activated where
the distance to the nearest existing point exceeds an adaptive threshold —
keeping the active set spatially uniform.

The BFS becomes MAX_DIST iterations of a 3x3 min-plus relaxation
(chebyshev distance, capped at MAX_DIST — the gate only needs distances up
to ``4 * my_type`` anyway, reference FrontEnd.cpp:442). XLA fuses the
relaxation chain; ``reference_distance_map`` is the plain numpy brute
force it is checked against.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

MAX_DIST = 16


def _relax_once(d: jnp.ndarray) -> jnp.ndarray:
    """One 3x3 min-plus (chebyshev) relaxation step with MAX_DIST borders.

    Separable: a 3x3 window min is a 3x1 row-min then a 1x3 column-min —
    4 shifted operands per iteration instead of 8. Shifts are built by
    slice+concat with a constant border row/column (no wrap-around)."""
    h, w = d.shape
    big_row = jnp.full((1, w), float(MAX_DIST), d.dtype)
    up = jnp.concatenate([d[1:], big_row], axis=0)
    down = jnp.concatenate([big_row, d[:-1]], axis=0)
    rowmin = jnp.minimum(d, jnp.minimum(up, down))
    big_col = jnp.full((h, 1), float(MAX_DIST), d.dtype)
    left = jnp.concatenate([rowmin[:, 1:], big_col], axis=1)
    right = jnp.concatenate([big_col, rowmin[:, :-1]], axis=1)
    winmin = jnp.minimum(rowmin, jnp.minimum(left, right))
    return jnp.minimum(d, winmin + 1.0)


@partial(jax.jit, static_argnums=(3, 4))
def build_distance_map(
    pu: jnp.ndarray,      # [N] projected pixel x at half resolution
    pv: jnp.ndarray,      # [N]
    mask: jnp.ndarray,    # [N] bool
    h2: int,
    w2: int,
) -> jnp.ndarray:
    """Returns [h2, w2] float distance-to-nearest-occupied (capped)."""
    ui = jnp.clip(jnp.round(pu).astype(jnp.int32), 0, w2 - 1)
    vi = jnp.clip(jnp.round(pv).astype(jnp.int32), 0, h2 - 1)
    occ = jnp.zeros((h2, w2), bool).at[vi, ui].max(mask)
    dist = jnp.where(occ, 0.0, float(MAX_DIST))
    return jax.lax.fori_loop(0, MAX_DIST, lambda _, d: _relax_once(d), dist)


def reference_distance_map(pu, pv, mask, h2: int, w2: int,
                           rows_per_chunk: int = 8) -> np.ndarray:
    """Numpy brute force: chebyshev distance from every cell to the nearest
    occupied cell, capped at MAX_DIST. Rows go in chunks so a half-res
    KITTI grid against thousands of points stays small in memory."""
    pu, pv, mask = np.asarray(pu), np.asarray(pv), np.asarray(mask, bool)
    ui = np.clip(np.round(pu).astype(int), 0, w2 - 1)
    vi = np.clip(np.round(pv).astype(int), 0, h2 - 1)
    occ = np.zeros((h2, w2), bool)
    occ[vi[mask], ui[mask]] = True
    ys, xs = np.nonzero(occ)
    out = np.full((h2, w2), float(MAX_DIST), np.float32)
    if len(ys) == 0:
        return out
    gx = np.arange(w2)
    for y0 in range(0, h2, rows_per_chunk):
        gy = np.arange(y0, min(y0 + rows_per_chunk, h2))
        d = np.maximum(np.abs(gy[:, None, None] - ys),
                       np.abs(gx[None, :, None] - xs)).min(-1)
        out[gy] = np.minimum(d, MAX_DIST)
    return out
