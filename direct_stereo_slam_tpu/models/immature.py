"""Immature points: creation, epipolar trace, and activation.

Equivalent of DSO's ``ImmaturePoint`` (creation +
``traceOn`` epipolar depth search; reference call sites FrontEnd.cpp:299-314,
936-960) and the activation optimizer ``optimizeImmaturePoint``
(FrontEndOptPoint.cpp:34-179). All operations are batched over a fixed
budget of candidate points per host frame with validity masks; the epipolar
search evaluates a fixed grid of sample positions along the segment
(masked beyond the actual length) instead of a data-dependent loop.

Status machine follows DSO's IPS_* (config-gated activation logic in
FrontEnd.cpp:394-449).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import PATTERN_OFFSETS, SLAMConfig
from ..ops.interp import (bilinear_gather, bilinear_gather_frames,
                          bilinear_take_frames,
                          bilinear_take_plane)

_HI = jax.lax.Precision.HIGHEST

# status codes (DSO ImmaturePointStatus)
IPS_GOOD = 0
IPS_OOB = 1
IPS_OUTLIER = 2
IPS_SKIPPED = 3
IPS_BADCONDITION = 4
IPS_UNINITIALIZED = 5

NUM_TRACE_STEPS = 64
MIN_TEST_RADIUS = 2.0    # setting_minTraceTestRadius


class ImmaturePoints(NamedTuple):
    """Fixed-budget candidate points of ONE host frame."""

    valid: jnp.ndarray        # [NI] bool
    u: jnp.ndarray            # [NI]
    v: jnp.ndarray            # [NI]
    idepth_min: jnp.ndarray   # [NI]
    idepth_max: jnp.ndarray   # [NI] (inf until first successful trace)
    color: jnp.ndarray        # [NI, 8]
    weight: jnp.ndarray       # [NI, 8]
    grad_h: jnp.ndarray       # [NI, 3] pattern gradient hessian (gxx,gxy,gyy)
    quality: jnp.ndarray      # [NI]
    my_type: jnp.ndarray      # [NI] selection scale 1/2/4
    status: jnp.ndarray       # [NI] int32 IPS_*
    pixel_interval: jnp.ndarray  # [NI] last trace interval in pixels


def _pattern():
    du = jnp.asarray([o[0] for o in PATTERN_OFFSETS], jnp.float32)
    dv = jnp.asarray([o[1] for o in PATTERN_OFFSETS], jnp.float32)
    return du, dv


@partial(jax.jit, static_argnums=(2,))
def create_points(
    host_planes: jnp.ndarray,      # [H, W, 3] level-0 (I, dx, dy)
    selection_map: jnp.ndarray,    # [H, W] int8 {0,1,2,4}
    budget: int,
    outlier_th_sum: float = 50.0 * 50.0,
) -> ImmaturePoints:
    """Make immature points from a selection map (DSO ImmaturePoint ctor +
    makeNewTraces loop, FrontEnd.cpp:948-960): store pattern colors,
    gradient weights sqrt(c^2/(c^2+|g|^2)) and the 2x2 gradient hessian."""
    H, W = selection_map.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    border_ok = (ys >= 3) & (ys < H - 4) & (xs >= 3) & (xs < W - 4)
    good = (selection_map > 0) & border_ok

    flat = good.reshape(-1)
    (idx,) = jnp.nonzero(flat, size=budget, fill_value=0)
    count = jnp.sum(flat)
    lane_ok = jnp.arange(budget) < count

    u = (idx % W).astype(jnp.float32)
    v = (idx // W).astype(jnp.float32)
    my_type = selection_map.reshape(-1)[idx].astype(jnp.float32)

    du, dv = _pattern()
    pu8 = u[:, None] + du
    pv8 = v[:, None] + dv
    hit = bilinear_gather(host_planes, pu8, pv8)     # [NI, 8, 3]
    color = hit[..., 0]
    g2 = hit[..., 1] ** 2 + hit[..., 2] ** 2
    weight = jnp.sqrt(outlier_th_sum / (outlier_th_sum + g2))
    gxx = jnp.sum(hit[..., 1] * hit[..., 1], axis=-1)
    gxy = jnp.sum(hit[..., 1] * hit[..., 2], axis=-1)
    gyy = jnp.sum(hit[..., 2] * hit[..., 2], axis=-1)

    lane_ok = lane_ok & jnp.all(jnp.isfinite(color), axis=-1)
    return ImmaturePoints(
        valid=lane_ok,
        u=u, v=v,
        idepth_min=jnp.zeros(budget, jnp.float32),
        idepth_max=jnp.full((budget,), jnp.inf, jnp.float32),
        color=color, weight=weight,
        grad_h=jnp.stack([gxx, gxy, gyy], -1),
        quality=jnp.full((budget,), 1e4, jnp.float32),
        my_type=my_type,
        status=jnp.full((budget,), IPS_UNINITIALIZED, jnp.int32),
        pixel_interval=jnp.zeros(budget, jnp.float32),
    )


@partial(jax.jit, static_argnums=(6, 7, 8))
def trace_points(
    pts: ImmaturePoints,
    target_planes: jnp.ndarray,   # [H, W, 3]
    KRKi: jnp.ndarray,            # [3,3] K R_th K^-1 (level 0)
    Kt: jnp.ndarray,              # [3] K t_th
    aff_a: jnp.ndarray,           # host->target brightness transfer
    aff_b: jnp.ndarray,
    cfg: SLAMConfig,
    max_search_px: float = None,
    num_steps: int = NUM_TRACE_STEPS,
) -> ImmaturePoints:
    """Epipolar depth search (DSO ImmaturePoint::traceOn). The fixed sample
    grid spans the whole (clamped) epipolar segment with NUM_TRACE_STEPS
    uniform samples plus a GN sub-pixel refinement, instead of DSO's
    1-px-step loop. ``max_search_px`` overrides the mono search cap
    (setting_maxPixSearch) — pass e.g. W/3 for static-stereo traces."""
    H, W = target_planes.shape[:2]
    tc = cfg.trace
    max_pix_search = (
        max_search_px if max_search_px is not None else tc.max_pix_search_frac * (H + W)
    )
    NI = pts.u.shape[0]

    # skip already-OOB points (DSO keeps them OOB forever)
    traceable = pts.valid & (pts.status != IPS_OOB)

    pr = jnp.matmul(jnp.stack([pts.u, pts.v, jnp.ones_like(pts.u)], -1),
                    KRKi.T, precision=_HI)                       # [NI,3]
    ptp_min = pr + Kt[None, :] * pts.idepth_min[:, None]
    u_min = ptp_min[:, 0] / ptp_min[:, 2]
    v_min = ptp_min[:, 1] / ptp_min[:, 2]
    oob_min = ~((u_min > 4) & (v_min > 4) & (u_min < W - 5) & (v_min < H - 5))

    have_max = jnp.isfinite(pts.idepth_max)
    id_for_max = jnp.where(have_max, pts.idepth_max, 0.01)
    ptp_max = pr + Kt[None, :] * id_for_max[:, None]
    u_max = ptp_max[:, 0] / ptp_max[:, 2]
    v_max = ptp_max[:, 1] / ptp_max[:, 2]

    d_u = u_max - u_min
    d_v = v_max - v_min
    dist_full = jnp.sqrt(d_u * d_u + d_v * d_v)
    dirx = d_u / jnp.maximum(dist_full, 1e-9)
    diry = d_v / jnp.maximum(dist_full, 1e-9)
    # effective search length: clamp to the cap; infinite-max points search
    # the full cap along the direction given by the tiny-idepth probe
    dist = jnp.where(have_max, jnp.minimum(dist_full, max_pix_search), max_pix_search)
    u_max = u_min + dirx * dist
    v_max = v_min + diry * dist
    oob_max = ~((u_max > 4) & (v_max > 4) & (u_max < W - 5) & (v_max < H - 5))

    # error-in-pixel from the gradient hessian vs the epipolar direction
    gxx, gxy, gyy = pts.grad_h[:, 0], pts.grad_h[:, 1], pts.grad_h[:, 2]
    a = dirx * dirx * gxx + 2 * dirx * diry * gxy + diry * diry * gyy
    b = diry * diry * gxx - 2 * dirx * diry * gxy + dirx * dirx * gyy
    error_px = 0.2 + 0.2 * (a + b) / jnp.maximum(a, 1e-9)
    badcond = error_px > 10.0
    error_px = jnp.minimum(error_px, 10.0)
    # not worth tracing: interval shorter than slack, or the achievable
    # precision exceeds the interval (DSO's two IPS_SKIPPED conditions)
    skipped = (dist < tc.trace_slack_interval) | (
        error_px * tc.trace_min_improvement_factor > dist
    )

    # ---- discrete search: uniform samples over [0, dist] -----------------
    t = jnp.arange(num_steps, dtype=jnp.float32)[None, :]             # [1, S]
    step_len = jnp.maximum(dist, 1e-6)[:, None] / (num_steps - 1)
    px = u_min[:, None] + dirx[:, None] * t * step_len                 # [NI, S]
    py = v_min[:, None] + diry[:, None] * t * step_len
    s_ok = (px > 3) & (py > 3) & (px < W - 4) & (py < H - 4)

    # pattern rotated by the 2x2 block of KRKi (DSO rotatetPattern)
    du, dv = _pattern()
    rdu = KRKi[0, 0] * du + KRKi[0, 1] * dv
    rdv = KRKi[1, 0] * du + KRKi[1, 1] * dv
    spx = px[..., None] + rdu[None, None, :]                           # [NI, S, 8]
    spy = py[..., None] + rdv[None, None, :]
    # flat-take form: the generic gather lowering is pathologically slow
    # (~97 ms/frame) when converged points' sample positions cluster; see
    # interp.bilinear_take_plane
    hit = bilinear_take_plane(target_planes[..., 0], spx, spy)  # [NI, S, 8]
    res = hit - (aff_a * pts.color[:, None, :] + aff_b)
    energy = jnp.sum(res * res, axis=-1)                               # [NI, S]
    energy = jnp.where(s_ok, energy, jnp.inf)

    best_i = jnp.argmin(energy, axis=-1)
    best_e = jnp.min(energy, axis=-1)
    # second best at least MIN_TEST_RADIUS pixels away
    far = jnp.abs(t - best_i[:, None].astype(jnp.float32)) * step_len >= MIN_TEST_RADIUS
    second_e = jnp.min(jnp.where(far, energy, jnp.inf), axis=-1)
    new_quality = jnp.where(
        jnp.isfinite(second_e), second_e / jnp.maximum(best_e, 1e-9), 1e4
    )
    # DSO keeps the historical min quality when the interval was long
    quality = jnp.where(
        dist > 3.0, new_quality, jnp.minimum(pts.quality, new_quality)
    )

    best_u = u_min + dirx * step_len[:, 0] * best_i.astype(jnp.float32)
    best_v = v_min + diry * step_len[:, 0] * best_i.astype(jnp.float32)

    # ---- GN refinement along the line (3 iterations) ---------------------
    def gn_body(_, carry):
        bu, bv, be = carry
        spx = bu[:, None] + rdu[None, :]
        spy = bv[:, None] + rdv[None, :]
        hit_i = bilinear_take_plane(target_planes[..., 0], spx, spy)
        hit_dx = bilinear_take_plane(target_planes[..., 1], spx, spy)
        hit_dy = bilinear_take_plane(target_planes[..., 2], spx, spy)
        r = hit_i - (aff_a * pts.color + aff_b)
        gdotd = hit_dx * dirx[:, None] + hit_dy * diry[:, None]
        Hs = jnp.sum(gdotd * gdotd, axis=-1)
        bs = jnp.sum(r * gdotd, axis=-1)
        stp = jnp.clip(-bs / jnp.maximum(Hs, 1e-9), -0.5, 0.5) * tc.trace_step_size
        nu = bu + stp * dirx
        nv = bv + stp * diry
        ne = jnp.sum(
            (bilinear_take_plane(target_planes[..., 0],
                                 nu[:, None] + rdu[None, :],
                                 nv[:, None] + rdv[None, :])
             - (aff_a * pts.color + aff_b)) ** 2, axis=-1)
        better = ne < be
        return (
            jnp.where(better, nu, bu),
            jnp.where(better, nv, bv),
            jnp.where(better, ne, be),
        )

    best_u, best_v, best_e = jax.lax.fori_loop(
        0, tc.trace_gn_iterations, gn_body, (best_u, best_v, best_e)
    )

    energy_th = 8.0 * 12.0 * 12.0 * tc.trace_extra_slack_on_th
    outlier = best_e > energy_th

    # ---- idepth interval update (DSO trace tail) -------------------------
    use_x = dirx * dirx > diry * diry
    # DSO updates the interval to bestU +- errorInPixel (x1.0) — the
    # slack factor belongs to the skip gates above, not the interval width
    err = error_px

    def id_from_px(uu, vv):
        idx_ = (pr[:, 2] * uu - pr[:, 0]) / jnp.maximum(
            jnp.abs(Kt[0] - Kt[2] * uu), 1e-12) * jnp.sign(Kt[0] - Kt[2] * uu)
        idy_ = (pr[:, 2] * vv - pr[:, 1]) / jnp.maximum(
            jnp.abs(Kt[1] - Kt[2] * vv), 1e-12) * jnp.sign(Kt[1] - Kt[2] * vv)
        return jnp.where(use_x, idx_, idy_)

    id_lo = id_from_px(best_u - err * dirx, best_v - err * diry)
    id_hi = id_from_px(best_u + err * dirx, best_v + err * diry)
    new_min = jnp.minimum(id_lo, id_hi)
    new_max = jnp.maximum(id_lo, id_hi)

    good = traceable & ~oob_min & ~skipped & ~badcond & ~outlier & ~oob_max
    status = jnp.where(
        ~traceable, pts.status,
        jnp.where(oob_min | oob_max, IPS_OOB,
        jnp.where(skipped, IPS_SKIPPED,
        jnp.where(badcond, IPS_BADCONDITION,
        jnp.where(outlier, IPS_OUTLIER, IPS_GOOD)))),
    )
    # SKIPPED/BADCONDITION keep the previous interval; GOOD updates it
    upd = good
    return pts._replace(
        idepth_min=jnp.where(upd, new_min, pts.idepth_min),
        idepth_max=jnp.where(upd, new_max, pts.idepth_max),
        quality=jnp.where(traceable, quality, pts.quality),
        status=status,
        pixel_interval=jnp.where(upd, 2.0 * error_px, pts.pixel_interval),
    )


class ActivationResult(NamedTuple):
    idepth: jnp.ndarray        # [NI] optimized inverse depth
    idepth_hessian: jnp.ndarray  # [NI]
    energy: jnp.ndarray        # [NI] final summed energy over targets
    num_good: jnp.ndarray      # [NI] residuals passing the outlier check
    ok: jnp.ndarray            # [NI] activation accepted


@partial(jax.jit, static_argnums=(8,))
def activate_points(
    pts: ImmaturePoints,
    host_slot: jnp.ndarray,     # scalar int: the host's BA slot
    images: jnp.ndarray,        # [Wn, H, W, 3] all window frames (level 0)
    frame_valid: jnp.ndarray,   # [Wn]
    T_cw: jnp.ndarray,          # [Wn, 4, 4] current worldToCam
    aff: jnp.ndarray,           # [Wn, 2]
    calib: jnp.ndarray,         # [4]
    exposure: jnp.ndarray,      # [Wn] frame exposure times
    cfg: SLAMConfig,
) -> ActivationResult:
    """Batched 1-D inverse-depth GN over pattern residuals toward all other
    window frames (FrontEndOptPoint.cpp:34-179)."""
    Wn, H, Wd = images.shape[0], images.shape[1], images.shape[2]
    fx, fy, cx, cy = calib
    tc = cfg.trace
    du, dv = _pattern()
    pu8 = pts.u[:, None] + du
    pv8 = pts.v[:, None] + dv
    xh = (pu8 - cx) / fx
    yh = (pv8 - cy) / fy

    T_hw = jnp.linalg.inv(T_cw)  # camToWorld; anchor precision not critical
    Tth = jnp.einsum("tij,jk->tik", T_cw, T_hw[host_slot], precision=_HI)  # [Wn,4,4]
    Rth = Tth[:, :3, :3]
    tth = Tth[:, :3, 3]
    a_t = jnp.exp(aff[:, 0] - aff[host_slot, 0]) * (
        exposure / jnp.maximum(exposure[host_slot], 1e-9))
    b_t = aff[:, 1] - a_t * aff[host_slot, 1]
    t_ok = frame_valid & (jnp.arange(Wn) != host_slot)

    id0 = jnp.clip(0.5 * (pts.idepth_min + jnp.minimum(pts.idepth_max, 1e3)), 1e-4, 1e3)

    def residual_pass(idepth):
        """returns (H_id [NI], b_id [NI], E [NI], n_good [NI])"""
        Xh = jnp.stack([xh, yh, jnp.ones_like(xh)], -1) / idepth[:, None, None]
        pt = jnp.einsum("tij,pkj->tpki", Rth, Xh, precision=_HI) + tth[:, None, None, :]
        z = pt[..., 2]
        un = pt[..., 0] / z
        vn = pt[..., 1] / z
        Ku = fx * un + cx
        Kv = fy * vn + cy
        inb = (Ku > 2) & (Kv > 2) & (Ku < Wd - 3) & (Kv < H - 3) & (z > 1e-4)

        # ROW-GATHER frames form: 4 row gathers for this pass's
        # [lanes, Wn, 8] index sets (~16k-131k) rather than the flat-take
        # form's 12 takes (numerics bitwise-identical)
        t_fold = jnp.arange(Wn, dtype=jnp.int32)[:, None, None]
        hit_i, hit_dx, hit_dy = bilinear_gather_frames(images, t_fold, Ku, Kv)
        r = hit_i - (a_t[:, None, None] * pts.color[None] + b_t[:, None, None])
        hw = jnp.where(jnp.abs(r) < 9.0, 1.0, 9.0 / jnp.maximum(jnp.abs(r), 1e-9))
        wpat = pts.weight[None] ** 2

        # Jd (same geometry as BA): dr/d idepth
        dr_dpt = jnp.stack([
            (1.0 / z) * hit_dx * fx,
            (1.0 / z) * hit_dy * fy,
            -(1.0 / z) * (un * hit_dx * fx + vn * hit_dy * fy),
        ], -1)
        dpt_did = -(pt - tth[:, None, None, :]) / idepth[None, :, None, None]
        Jd = jnp.sum(dr_dpt * dpt_did, -1)

        pair_e = jnp.sum(jnp.where(inb, hw * r * r * (2 - hw) * wpat, 0.0), -1)
        pair_in = jnp.all(inb, -1) & t_ok[:, None]
        th = 8.0 * cfg.trace.outlier_th
        pair_good = pair_in & (pair_e < th)
        m = (pair_good[..., None] & inb).astype(jnp.float32) * hw * wpat
        H_id = jnp.sum(m * Jd * Jd, axis=(0, 2))
        b_id = jnp.sum(m * Jd * r, axis=(0, 2))
        E = jnp.sum(jnp.where(pair_good, pair_e, jnp.where(pair_in, th, 0.0)), 0)
        n_good = jnp.sum(pair_good.astype(jnp.int32), 0)
        return H_id, b_id, E, n_good

    # LM with the carried-pass structure (one residual_pass per iteration
    # instead of two: a rejected trial keeps the carried H/b/E, an
    # accepted one's pass becomes the next linearization — the same
    # restructure ba._optimize_impl documents at ~2.4x; the [NI, Wn, 8]
    # warp+gather dominates this dispatch)
    def gn(_, carry):
        idep, lam, H_id, b_id, E, n_good = carry
        stp = -b_id / jnp.maximum(H_id * (1 + lam), 1e-9)
        new_id = jnp.clip(idep + stp, 1e-5, 50.0)
        H2, b2, E2, n2 = residual_pass(new_id)
        better = E2 < E
        sel = lambda a, b: jnp.where(better, a, b)
        return (sel(new_id, idep), jnp.where(better, lam * 0.5, lam * 4.0),
                sel(H2, H_id), sel(b2, b_id), sel(E2, E), sel(n2, n_good))

    H0, b0, E0, ng0 = residual_pass(id0)
    idep, _, H_id, b_id, E, n_good = jax.lax.fori_loop(
        0, 3, gn, (id0, jnp.full_like(id0, 0.1), H0, b0, E0, ng0))

    ok = (
        pts.valid
        & (n_good >= 1)
        & (H_id > cfg.ba.min_idepth_h_act)
        & (idep > 1e-5)
        & jnp.isfinite(E)
    )
    return ActivationResult(idepth=idep, idepth_hessian=H_id, energy=E,
                            num_good=n_good, ok=ok)


@partial(jax.jit, static_argnums=(1,))
def can_activate(pts: ImmaturePoints, cfg: SLAMConfig) -> jnp.ndarray:
    """FrontEnd.cpp:410-416 activation pre-gates."""
    return (
        pts.valid
        & ((pts.status == IPS_GOOD)
           | (pts.status == IPS_SKIPPED)
           | (pts.status == IPS_BADCONDITION)
           | (pts.status == IPS_OOB))
        & (pts.pixel_interval < 8.0)
        & (pts.quality > cfg.trace.min_trace_quality)
        & ((pts.idepth_max + pts.idepth_min) > 0)
        & jnp.isfinite(pts.idepth_max)
    )


# ---------------------------------------------------------------------------
# Stacked-window batch forms
#
# The frontend keeps ONE ImmaturePoints pytree with a leading [S] slot axis
# (rather than a dict of per-slot pytrees) so trace / activation / gating
# over the whole window are single vmapped dispatches, where a per-slot loop
# would dispatch ~7 programs every frame (trace) and ~3x7 per keyframe
# (activate+gate+insert).
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(0, 1))
def empty_batch(n_slots: int, budget: int) -> ImmaturePoints:
    """All-invalid stacked candidate set [S, NI]."""
    z = jnp.zeros((n_slots, budget), jnp.float32)
    return ImmaturePoints(
        valid=jnp.zeros((n_slots, budget), bool),
        u=z, v=z,
        idepth_min=z,
        idepth_max=jnp.full((n_slots, budget), jnp.inf, jnp.float32),
        color=jnp.zeros((n_slots, budget, 8), jnp.float32),
        weight=jnp.zeros((n_slots, budget, 8), jnp.float32),
        grad_h=jnp.zeros((n_slots, budget, 3), jnp.float32),
        quality=z,
        my_type=z,
        status=jnp.full((n_slots, budget), IPS_UNINITIALIZED, jnp.int32),
        pixel_interval=z,
    )


@jax.jit
def set_slot(batch: ImmaturePoints, slot, pts: ImmaturePoints) -> ImmaturePoints:
    """Write one slot's candidate set into the stacked batch."""
    return jax.tree_util.tree_map(
        lambda full, one: full.at[slot].set(one), batch, pts)


@jax.jit
def clear_slots(batch: ImmaturePoints, slot_mask) -> ImmaturePoints:
    """Invalidate whole slots ([S] bool mask)."""
    return batch._replace(valid=batch.valid & ~slot_mask[:, None])


@partial(jax.jit, static_argnums=(6,))
def trace_points_all(
    pts: ImmaturePoints,          # stacked [S, NI]
    target_planes: jnp.ndarray,   # [H, W, 3]
    KRKi: jnp.ndarray,            # [S, 3, 3]
    Kt: jnp.ndarray,              # [S, 3]
    aff_a: jnp.ndarray,           # [S]
    aff_b: jnp.ndarray,           # [S]
    cfg: SLAMConfig,
) -> ImmaturePoints:
    """traceOn for every window slot in ONE dispatch (uncompacted
    reference form: every lane pays the full search; kept as the
    semantics oracle for trace_points_all_compact's equivalence test)."""
    fn = lambda p, k, t, a, b: trace_points(p, target_planes, k, t, a, b, cfg)
    return jax.vmap(fn)(pts, KRKi, Kt, aff_a, aff_b)


@partial(jax.jit, static_argnums=(6, 7, 8, 9))
def trace_points_all_compact(
    pts: ImmaturePoints,          # stacked [S, NI]
    target_planes: jnp.ndarray,   # [H, W, 3]
    KRKi: jnp.ndarray,            # [S, 3, 3]
    Kt: jnp.ndarray,              # [S, 3]
    aff_a: jnp.ndarray,           # [S]
    aff_b: jnp.ndarray,           # [S]
    cfg: SLAMConfig,
    num_steps: int = None,
    budget: int = None,
    max_reach: float = None,
) -> Tuple[ImmaturePoints, jnp.ndarray, jnp.ndarray]:
    """traceOn for the whole window with DEVICE-SIDE SEARCH COMPACTION.

    The fixed-shape form (trace_points_all) pays the 64-step epipolar
    search for all S x NI lanes every frame, although in steady state ~80% of
    lanes are converged (interval below the slack gate), OOB, or invalid:
    DSO's traceOn (ImmaturePoint.cpp) early-returns on those without
    touching the image. Here:

      phase 1 (full [S, NI], no image access): epipolar geometry from the
        idepth interval, the OOB/SKIPPED/BADCONDITION gates, and the
        search mask;
      phase 2: search-needing lanes are compacted (row-major lane order)
        into a fixed ``cfg.trace.search_budget`` subset, which alone pays
        the uniform-grid sample energy + GN refinement + interval update;
      phase 3: results scatter back into the [S, NI] arrays.

    Lanes failing a phase-1 gate take their gate status but keep their
    previous quality/interval — this is EXACTLY DSO's early-return
    behavior (the uncompacted form updated quality from a search it ran
    anyway, a minor deviation removed here). Search-needing lanes beyond
    the budget keep their previous state wholesale and trace on a later
    frame; n_overflow reports them (0 in steady state — fresh candidates
    arrive ~1024/KF against the 2048 default).

    TIERED dispatch (r4): ``budget``/``num_steps``/``max_reach`` let the
    caller run a SMALL steady-state program on most frames. The trace is
    gather-bound and budget-shaped — cost = budget x num_steps x 8 taps
    regardless of real lane occupancy — but in steady state nearly all
    searching lanes have a
    BRACKETED idepth interval whose epipolar segment is a few px, so a
    (1024, 16)-shaped program with ``max_reach = 15`` covers them at
    DSO's own 1 px sample spacing at ~1/6 of the work. Lanes whose segment exceeds
    ``max_reach`` (fresh candidates: idepth in (0, inf) clamps to
    maxPixSearch) are DEFERRED — previous state kept, counted in
    n_overflow — until the frontend's next full-shape dispatch (the
    KF-event trace and the first post-KF frame always run the full
    program). Deviation from DSO (which searches every immature every
    frame) is bounded by the n_overflow counter, which stays hot in the
    timing report.

    Returns (updated points, n_searched, n_overflow); n_searched counts
    every lane DSO would have searched this frame, n_overflow the subset
    that was deferred (budget overflow + out-of-reach)."""
    S, NI = pts.u.shape
    H, W = target_planes.shape[:2]
    tc = cfg.trace
    if num_steps is None:
        num_steps = tc.num_steps
    budget = min(tc.search_budget if budget is None else budget, S * NI)
    max_pix_search = tc.max_pix_search_frac * (H + W)

    # ---- phase 1: geometry + gates on all [S, NI] lanes ------------------
    traceable = pts.valid & (pts.status != IPS_OOB)
    xyz = jnp.stack([pts.u, pts.v, jnp.ones_like(pts.u)], -1)   # [S, NI, 3]
    pr = jnp.einsum("sij,snj->sni", KRKi, xyz, precision=_HI)
    ptp_min = pr + Kt[:, None, :] * pts.idepth_min[..., None]
    u_min = ptp_min[..., 0] / ptp_min[..., 2]
    v_min = ptp_min[..., 1] / ptp_min[..., 2]
    oob_min = ~((u_min > 4) & (v_min > 4) & (u_min < W - 5) & (v_min < H - 5))

    have_max = jnp.isfinite(pts.idepth_max)
    id_for_max = jnp.where(have_max, pts.idepth_max, 0.01)
    ptp_max = pr + Kt[:, None, :] * id_for_max[..., None]
    u_max = ptp_max[..., 0] / ptp_max[..., 2]
    v_max = ptp_max[..., 1] / ptp_max[..., 2]
    d_u = u_max - u_min
    d_v = v_max - v_min
    dist_full = jnp.sqrt(d_u * d_u + d_v * d_v)
    dirx = d_u / jnp.maximum(dist_full, 1e-9)
    diry = d_v / jnp.maximum(dist_full, 1e-9)
    dist = jnp.where(have_max, jnp.minimum(dist_full, max_pix_search),
                     max_pix_search)
    u_max = u_min + dirx * dist
    v_max = v_min + diry * dist
    oob_max = ~((u_max > 4) & (v_max > 4) & (u_max < W - 5) & (v_max < H - 5))

    gxx, gxy, gyy = pts.grad_h[..., 0], pts.grad_h[..., 1], pts.grad_h[..., 2]
    a = dirx * dirx * gxx + 2 * dirx * diry * gxy + diry * diry * gyy
    b = diry * diry * gxx - 2 * dirx * diry * gxy + dirx * dirx * gyy
    error_px = 0.2 + 0.2 * (a + b) / jnp.maximum(a, 1e-9)
    badcond = error_px > 10.0
    error_px = jnp.minimum(error_px, 10.0)
    skipped = (dist < tc.trace_slack_interval) | (
        error_px * tc.trace_min_improvement_factor > dist)

    want = traceable & ~oob_min & ~oob_max & ~skipped & ~badcond
    if max_reach is None:
        search = want
        n_deferred = jnp.int32(0)
    else:
        search = want & (dist <= max_reach)
        n_deferred = jnp.sum((want & (dist > max_reach)).astype(jnp.int32))
    n_search = jnp.sum(want.astype(jnp.int32))
    n_overflow = jnp.maximum(
        jnp.sum(search.astype(jnp.int32)) - budget, 0) + n_deferred

    # gate statuses; searched lanes are overwritten by the scatter below,
    # overflow lanes fall through to their previous status
    status1 = jnp.where(
        ~traceable, pts.status,
        jnp.where(oob_min | oob_max, IPS_OOB,
        jnp.where(skipped, IPS_SKIPPED,
        jnp.where(badcond, IPS_BADCONDITION, pts.status))))

    # ---- phase 2: compact + search ---------------------------------------
    flat = lambda arr: arr.reshape((S * NI,) + arr.shape[2:])
    (cidx,) = jnp.nonzero(flat(search), size=budget, fill_value=S * NI)
    lane_ok = cidx < S * NI
    idx_c = jnp.minimum(cidx, S * NI - 1)
    slot = idx_c // NI
    take = lambda arr: flat(arr)[idx_c]

    c_u_min, c_v_min = take(u_min), take(v_min)
    c_dirx, c_diry = take(dirx), take(diry)
    c_dist = take(dist)
    c_err = take(error_px)
    c_color = take(pts.color)                       # [B, 8]
    c_pr = take(pr)                                 # [B, 3]
    c_Kt = Kt[slot]                                 # [B, 3]
    c_a = aff_a[slot][:, None]
    c_b = aff_b[slot][:, None]

    du, dv = _pattern()
    rdu_s = KRKi[:, 0, 0, None] * du[None] + KRKi[:, 0, 1, None] * dv[None]
    rdv_s = KRKi[:, 1, 0, None] * du[None] + KRKi[:, 1, 1, None] * dv[None]
    c_rdu = rdu_s[slot]                             # [B, 8]
    c_rdv = rdv_s[slot]

    t = jnp.arange(num_steps, dtype=jnp.float32)[None, :]           # [1, T]
    step_len = jnp.maximum(c_dist, 1e-6)[:, None] / (num_steps - 1)
    px = c_u_min[:, None] + c_dirx[:, None] * t * step_len          # [B, T]
    py = c_v_min[:, None] + c_diry[:, None] * t * step_len
    s_ok = (px > 3) & (py > 3) & (px < W - 4) & (py < H - 4)
    spx = px[..., None] + c_rdu[:, None, :]                         # [B, T, 8]
    spy = py[..., None] + c_rdv[:, None, :]
    hit = bilinear_take_plane(target_planes[..., 0], spx, spy)
    res = hit - (c_a[:, :, None] * c_color[:, None, :] + c_b[:, :, None])
    energy = jnp.sum(res * res, axis=-1)                            # [B, T]
    energy = jnp.where(s_ok, energy, jnp.inf)

    best_i = jnp.argmin(energy, axis=-1)
    best_e = jnp.min(energy, axis=-1)
    far = jnp.abs(t - best_i[:, None].astype(jnp.float32)) * step_len \
        >= MIN_TEST_RADIUS
    second_e = jnp.min(jnp.where(far, energy, jnp.inf), axis=-1)
    new_quality = jnp.where(
        jnp.isfinite(second_e), second_e / jnp.maximum(best_e, 1e-9), 1e4)
    c_quality = jnp.where(
        c_dist > 3.0, new_quality,
        jnp.minimum(take(pts.quality), new_quality))

    best_u = c_u_min + c_dirx * step_len[:, 0] * best_i.astype(jnp.float32)
    best_v = c_v_min + c_diry * step_len[:, 0] * best_i.astype(jnp.float32)

    def gn_body(_, carry):
        bu, bv, be = carry
        gpx = bu[:, None] + c_rdu
        gpy = bv[:, None] + c_rdv
        hit_i = bilinear_take_plane(target_planes[..., 0], gpx, gpy)
        hit_dx = bilinear_take_plane(target_planes[..., 1], gpx, gpy)
        hit_dy = bilinear_take_plane(target_planes[..., 2], gpx, gpy)
        r = hit_i - (c_a * c_color + c_b)
        gdotd = hit_dx * c_dirx[:, None] + hit_dy * c_diry[:, None]
        Hs = jnp.sum(gdotd * gdotd, axis=-1)
        bs = jnp.sum(r * gdotd, axis=-1)
        stp = jnp.clip(-bs / jnp.maximum(Hs, 1e-9), -0.5, 0.5) \
            * tc.trace_step_size
        nu = bu + stp * c_dirx
        nv = bv + stp * c_diry
        ne = jnp.sum(
            (bilinear_take_plane(target_planes[..., 0],
                                 nu[:, None] + c_rdu, nv[:, None] + c_rdv)
             - (c_a * c_color + c_b)) ** 2, axis=-1)
        better = ne < be
        return (jnp.where(better, nu, bu), jnp.where(better, nv, bv),
                jnp.where(better, ne, be))

    best_u, best_v, best_e = jax.lax.fori_loop(
        0, tc.trace_gn_iterations, gn_body, (best_u, best_v, best_e))

    energy_th = 8.0 * 12.0 * 12.0 * tc.trace_extra_slack_on_th
    outlier = best_e > energy_th

    use_x = c_dirx * c_dirx > c_diry * c_diry

    def id_from_px(uu, vv):
        idx_ = (c_pr[:, 2] * uu - c_pr[:, 0]) / jnp.maximum(
            jnp.abs(c_Kt[:, 0] - c_Kt[:, 2] * uu), 1e-12) \
            * jnp.sign(c_Kt[:, 0] - c_Kt[:, 2] * uu)
        idy_ = (c_pr[:, 2] * vv - c_pr[:, 1]) / jnp.maximum(
            jnp.abs(c_Kt[:, 1] - c_Kt[:, 2] * vv), 1e-12) \
            * jnp.sign(c_Kt[:, 1] - c_Kt[:, 2] * vv)
        return jnp.where(use_x, idx_, idy_)

    id_lo = id_from_px(best_u - c_err * c_dirx, best_v - c_err * c_diry)
    id_hi = id_from_px(best_u + c_err * c_dirx, best_v + c_err * c_diry)
    new_min = jnp.minimum(id_lo, id_hi)
    new_max = jnp.maximum(id_lo, id_hi)

    # ---- phase 3: scatter back --------------------------------------------
    good_c = lane_ok & ~outlier
    scat = lambda dst, val, ok: flat(dst).at[
        jnp.where(ok, cidx, S * NI)].set(val, mode="drop").reshape(S, NI)

    status = scat(status1,
                  jnp.where(outlier, IPS_OUTLIER, IPS_GOOD), lane_ok)
    return pts._replace(
        idepth_min=scat(pts.idepth_min, new_min, good_c),
        idepth_max=scat(pts.idepth_max, new_max, good_c),
        quality=scat(pts.quality, c_quality, lane_ok),
        status=status,
        pixel_interval=scat(pts.pixel_interval, 2.0 * c_err, good_c),
    ), n_search, n_overflow


@partial(jax.jit, static_argnums=(8,))
def activate_points_all(
    pts: ImmaturePoints,          # stacked [S, NI]
    slots: jnp.ndarray,           # [S] slot indices
    images: jnp.ndarray,
    frame_valid: jnp.ndarray,
    T_cw: jnp.ndarray,
    aff: jnp.ndarray,
    calib: jnp.ndarray,
    exposure: jnp.ndarray,        # [S]
    cfg: SLAMConfig,
) -> ActivationResult:
    """optimizeImmaturePoint for every slot's candidates in ONE dispatch."""
    fn = lambda p, s: activate_points(
        p, s, images, frame_valid, T_cw, aff, calib, exposure, cfg)
    return jax.vmap(fn)(pts, slots)
