"""Semi-dense inverse-depth template for the coarse tracker.

Equivalent of ``TrackerAndScaler::makeCoarseDepthL0`` + per-level point-list
extraction (reference TrackerAndScaler.cpp:143-315): active window points
projected into the newest keyframe are scatter-added into a level-0
idepth/weight map, 2x2 sum-pooled up the pyramid, hole-dilated (diagonal
neighbors on levels 0-1, axis neighbors above — reference lines 190-275),
then normalized and compacted into fixed-budget per-level point lists.

Array form: scatter-add via ``.at[].add``; dilation via shifted adds
(elementwise); compaction via ``jnp.nonzero(size=...)`` so all shapes stay
static.
The whole build runs as one jitted program once per keyframe.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class TrackerTemplate(NamedTuple):
    """Per-level fixed-budget point lists (the tracker's reference data)."""

    pu: Tuple[jnp.ndarray, ...]      # [B_l] pixel x at level l
    pv: Tuple[jnp.ndarray, ...]      # [B_l]
    pid: Tuple[jnp.ndarray, ...]     # [B_l] inverse depth
    pcolor: Tuple[jnp.ndarray, ...]  # [B_l] reference intensity
    pmask: Tuple[jnp.ndarray, ...]   # [B_l] bool

    @property
    def levels(self) -> int:
        return len(self.pu)


def default_budgets(w: int, h: int, levels: int, base: int = 8192) -> Tuple[int, ...]:
    out = []
    for l in range(levels):
        hw = (w >> l) * (h >> l)
        b = min(hw, max(base >> l, 128))
        out.append(((b + 127) // 128) * 128)
    return tuple(out)


def _shift2d(x: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Shift with zero padding: out[y, x] = in[y+dy, x+dx]."""
    h, w = x.shape
    out = jnp.zeros_like(x)
    ys = slice(max(dy, 0), h + min(dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    return out.at[yd, xd].set(x[ys, xs])


def _dilate_once(idepth: jnp.ndarray, weight: jnp.ndarray, offsets) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fill weight<=0 holes with the mean of neighbors that have weight>0
    (reference TrackerAndScaler.cpp:203-231 / 246-275). ``idepth`` here is the
    raw weighted sum; the reference averages sums the same way."""
    has = (weight > 0).astype(jnp.float32)
    s = jnp.zeros_like(idepth)
    n = jnp.zeros_like(weight)
    cnt = jnp.zeros_like(weight)
    for dy, dx in offsets:
        w_s = _shift2d(weight, dy, dx)
        i_s = _shift2d(idepth, dy, dx)
        m = (w_s > 0).astype(jnp.float32)
        s = s + i_s * m
        n = n + w_s * m
        cnt = cnt + m
    fill = (weight <= 0) & (cnt > 0)
    cnt_safe = jnp.maximum(cnt, 1.0)
    idepth = jnp.where(fill, s / cnt_safe, idepth)
    weight = jnp.where(fill, n / cnt_safe, weight)
    return idepth, weight


@partial(jax.jit, static_argnums=(5, 6))
def build_template(
    proj_u: jnp.ndarray,      # [N] projected pixel x in the reference KF (lvl 0)
    proj_v: jnp.ndarray,      # [N]
    proj_id: jnp.ndarray,     # [N] projected (new) inverse depth
    proj_w: jnp.ndarray,      # [N] per-point weight sqrt(1e-3 / HdiF)
    ref_img: jnp.ndarray,     # [H, W] reference intensity (level 0); coarser
                              # levels are re-derived by 2x2 mean to match the
                              # pyramid builder
    levels: int,
    budgets: Tuple[int, ...],
    valid: jnp.ndarray = None,  # [N] bool
) -> TrackerTemplate:
    H, W = ref_img.shape
    if valid is None:
        valid = jnp.ones_like(proj_u, dtype=bool)

    ui = jnp.clip((proj_u + 0.5).astype(jnp.int32), 0, W - 1)
    vi = jnp.clip((proj_v + 0.5).astype(jnp.int32), 0, H - 1)
    ok = valid & (proj_id > 0) & (proj_u >= 0) & (proj_v >= 0) & (proj_u < W) & (proj_v < H)
    wgt = jnp.where(ok, proj_w, 0.0)

    idepth0 = jnp.zeros((H, W), jnp.float32).at[vi, ui].add(proj_id * wgt)
    weight0 = jnp.zeros((H, W), jnp.float32).at[vi, ui].add(wgt)

    # pyramid of sums (2x2 sum-pool, reference lines 166-187). Reshape
    # form, NOT four strided slices of the fresh scatter output (same
    # form as ops/pyramid's reshape-pool).
    def pool(x):
        h2, w2 = x.shape[0] // 2, x.shape[1] // 2
        return x[: 2 * h2, : 2 * w2].reshape(h2, 2, w2, 2).sum((1, 3))

    idepths = [idepth0]
    weights = [weight0]
    img = ref_img
    imgs = [img]
    for l in range(1, levels):
        idepths.append(pool(idepths[-1]))
        weights.append(pool(weights[-1]))
        img = 0.25 * pool(img)
        imgs.append(img)

    # dilation (reference lines 190-233: diagonals on lvl 0-1; 235-275: axes)
    diag = [(1, 1), (-1, -1), (1, -1), (-1, 1)]
    axes = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    for l in range(min(2, levels)):
        idepths[l], weights[l] = _dilate_once(idepths[l], weights[l], diag)
    for l in range(2, levels):
        idepths[l], weights[l] = _dilate_once(idepths[l], weights[l], axes)

    # normalize + compact to fixed-budget lists (reference lines 277-314)
    pu, pv, pid, pcolor, pmask = [], [], [], [], []
    for l in range(levels):
        d, wsum, img_l = idepths[l], weights[l], imgs[l]
        h_l, w_l = d.shape
        ys = jax.lax.broadcasted_iota(jnp.int32, (h_l, w_l), 0)
        xs = jax.lax.broadcasted_iota(jnp.int32, (h_l, w_l), 1)
        border_ok = (ys >= 2) & (ys < h_l - 2) & (xs >= 2) & (xs < w_l - 2)
        idn = d / jnp.maximum(wsum, 1e-12)
        good = border_ok & (wsum > 0) & (idn > 0) & jnp.isfinite(img_l)

        B = budgets[l]
        flat_good = good.reshape(-1)
        (idx,) = jnp.nonzero(flat_good, size=B, fill_value=0)
        count = jnp.sum(flat_good)
        lane_ok = jnp.arange(B) < count

        pu.append(jnp.where(lane_ok, (idx % w_l).astype(jnp.float32), 0.0))
        pv.append(jnp.where(lane_ok, (idx // w_l).astype(jnp.float32), 0.0))
        pid.append(jnp.where(lane_ok, idn.reshape(-1)[idx], 0.0))
        pcolor.append(jnp.where(lane_ok, img_l.reshape(-1)[idx], 0.0))
        pmask.append(lane_ok)

    return TrackerTemplate(tuple(pu), tuple(pv), tuple(pid), tuple(pcolor), tuple(pmask))


def scale_template_idepth(template: TrackerTemplate, scale: jnp.ndarray) -> TrackerTemplate:
    """``scaleCoarseDepthL0`` (reference TrackerAndScaler.cpp:329-336):
    divide all template inverse depths by the accepted stereo scale."""
    return template._replace(pid=tuple(p / scale for p in template.pid))
