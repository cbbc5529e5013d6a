"""Fused direct-alignment residual / Jacobian / Hessian passes.

This is the array-program equivalent of the reference's hot SIMD loops —
``calcResPose`` + ``calcGSSSEPose`` (TrackerAndScaler.cpp:699-852, 640-697),
``calcResScale`` + ``calcGSSSEScale`` (TrackerAndScaler.cpp:1007-1172,
966-1005) and ``PoseEstimator::calcRes``/``calcGSSSE``
(PoseEstimator.cpp:141-296, 84-139). Each C++ function does two passes
(residual buffering, then SSE accumulation); here each flavor is ONE fused
pass: warp -> bilinear gather -> Huber/cutoff -> Jacobian -> masked
reduction to (H, b, stats). Everything is batched over a fixed-size padded
point list; XLA fuses the elementwise pipeline and the reductions.

All flavors share the same per-point warped-term math; they differ only in
the warp and the parameter Jacobian:

* pose (8-DoF: SE3 tangent + affine a,b)  — tracker & loop estimator
* scale (1-DoF stereo scale)

Statistics vector mirrors the reference's ``Vec6 rs``:
``(E, num_terms, flow_t, 0, flow_rt, saturated_ratio)``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from functools import partial

# Hessian/gradient reductions and point-warp matmuls need full f32: an
# unpinned f32 product may run at reduced precision (TF32 on a GPU).
_HI = jax.lax.Precision.HIGHEST
_mm = partial(jnp.matmul, precision=_HI)

from .interp import bilinear_gather
from ..config import SCALE_XI_TRANS, SCALE_XI_ROT, SCALE_A, SCALE_B


class ResStats(NamedTuple):
    E: jnp.ndarray              # total energy (saturated terms add max_energy)
    num_terms: jnp.ndarray      # number of valid terms in E
    flow_t: jnp.ndarray         # mean squared translation-only pixel shift
    flow_rt: jnp.ndarray        # mean squared rot+trans pixel shift
    saturated_ratio: jnp.ndarray

    @property
    def mean_energy(self):
        return self.E / jnp.maximum(self.num_terms, 1.0)


class PosePassOut(NamedTuple):
    stats: ResStats
    H: jnp.ndarray              # [8, 8] preconditioned Gauss-Newton Hessian
    b: jnp.ndarray              # [8] preconditioned gradient
    num_in: jnp.ndarray         # inlier (non-saturated, valid) count


class ScalePassOut(NamedTuple):
    stats: ResStats
    H: jnp.ndarray              # scalar
    b: jnp.ndarray              # scalar


# preconditioner applied to the 8-param pose+affine system
# (reference TrackerAndScaler.cpp:685-696; note DSO's swapped naming —
# tangent[0:3] is translation and receives "SCALE_XI_ROT"=1.0).
POSE_PRECOND = jnp.array(
    [SCALE_XI_TRANS] * 3 + [SCALE_XI_ROT] * 3 + [SCALE_A, SCALE_B],
    dtype=jnp.float32,
)


def _huber_energy(r, hw, sat, max_energy):
    return jnp.where(sat, max_energy, hw * r * r * (2.0 - hw))


# ---------------------------------------------------------------------------
# image operand: plain [H, W, 3] plane, or a FOLDED batch (stack [B, H, W, 3],
# lane scalar). The folded form exists for batch-eval over B sequences: a
# vmapped pass over per-sequence planes hands XLA batched-operand gathers;
# closing the stack over the vmap and folding the lane index into one
# rank-1 take keeps the flat-gather lowering at any B. Values are
# bitwise-identical.
#
# The PLAIN path uses the generic row gather, NOT the flat-take form: these
# passes run over small index sets (~2000 template points per level), where
# the take form's 12 takes pay 12 fixed per-op overheads inside the LM
# while_loops. The take forms remain for the LARGE index sets (epipolar
# trace) where the row gather's lowering can be pathological; see
# ops/interp.py.
# ---------------------------------------------------------------------------


def _img_dims(img):
    if isinstance(img, tuple):
        return img[0].shape[1], img[0].shape[2]
    return img.shape[0], img.shape[1]


def _sample_img(img, Ku, Kv):
    if isinstance(img, tuple):
        from .interp import bilinear_take_frames
        stack, lane = img
        fidx = jnp.broadcast_to(jnp.asarray(lane, jnp.int32), Ku.shape)
        return bilinear_take_frames(stack, fidx, Ku, Kv)
    hit = bilinear_gather(img, Ku, Kv)
    return hit[..., 0], hit[..., 1], hit[..., 2]


def _flow_stats(Ku, Kv, Ku_t, Kv_t, Ku_t2, Kv_t2, Ku_rt2, Kv_rt2, u0, v0, mask):
    """Optical-flow indicators over a subsample (every 32nd point at level 0,
    TrackerAndScaler.cpp:754-784). `mask` selects the subsample lanes."""
    m = mask.astype(jnp.float32)
    num = jnp.sum(m) * 2.0 + 0.1
    d2 = lambda a, b, x, y: (a - x) ** 2 + (b - y) ** 2
    flow_t = jnp.sum(m * (d2(Ku_t, Kv_t, u0, v0) + d2(Ku_t2, Kv_t2, u0, v0))) / num
    flow_rt = jnp.sum(m * (d2(Ku, Kv, u0, v0) + d2(Ku_rt2, Kv_rt2, u0, v0))) / num
    return flow_t, flow_rt


def pose_residual_pass(
    img: jnp.ndarray,          # [H, W, 3] target-level (I, dx, dy)
    pu: jnp.ndarray,           # [N] point pixel x at this level (ref frame)
    pv: jnp.ndarray,           # [N] point pixel y
    pid: jnp.ndarray,          # [N] point inverse depth
    pcolor: jnp.ndarray,       # [N] reference intensity
    pmask: jnp.ndarray,        # [N] bool validity
    RKi: jnp.ndarray,          # [3, 3] R * K^-1 at this level
    Ki: jnp.ndarray,           # [3, 3] K^-1 (for translation-only flow probe)
    t: jnp.ndarray,            # [3]
    aff_a: jnp.ndarray,        # scalar: multiplicative brightness transfer
    aff_b: jnp.ndarray,        # scalar: additive brightness transfer
    ref_b0: jnp.ndarray,       # scalar: reference frame's b (for d/da term)
    fx: float, fy: float, cx: float, cy: float,
    huber_th: float,
    cutoff_th: jnp.ndarray,
    compute_flow: bool = True,
) -> PosePassOut:
    """Track-pose flavor (TrackerAndScaler.cpp:699-852 + 640-697).

    Residual: ``I_new(warp(p)) - (a * I_ref(p) + b)``; warped terms produce
    an 8-param Jacobian [trans(3), rot(3), aff_a, aff_b] accumulated into
    H = J^T W J / n and b = J^T W r / n, preconditioned by POSE_PRECOND.
    """
    H_img, W_img = _img_dims(img)
    xyz1 = jnp.stack([pu, pv, jnp.ones_like(pu)], axis=-1)  # [N, 3]
    Kixyz = _mm(xyz1, RKi.T)                                     # R K^-1 x
    pt = Kixyz + t[None, :] * pid[:, None]
    u = pt[:, 0] / pt[:, 2]
    v = pt[:, 1] / pt[:, 2]
    Ku = fx * u + cx
    Kv = fy * v + cy
    new_id = pid / pt[:, 2]

    valid = (
        pmask
        & (Ku > 2.0) & (Kv > 2.0)
        & (Ku < W_img - 3.0) & (Kv < H_img - 3.0)
        & (new_id > 0.0)
    )

    hit_i, hit_dx, hit_dy = _sample_img(img, Ku, Kv)
    valid &= jnp.isfinite(hit_i)

    residual = hit_i - (aff_a * pcolor + aff_b)
    abs_r = jnp.abs(residual)
    hw = jnp.where(abs_r < huber_th, 1.0, huber_th / jnp.maximum(abs_r, 1e-12))
    sat = abs_r > cutoff_th
    max_energy = 2.0 * huber_th * cutoff_th - huber_th * huber_th

    vf = valid.astype(jnp.float32)
    energy = jnp.sum(vf * _huber_energy(residual, hw, sat, max_energy))
    num_terms = jnp.sum(vf)
    num_sat = jnp.sum(vf * sat.astype(jnp.float32))

    # ---- flow indicators (subsampled translation-only / rot+trans probes) --
    if compute_flow:
        n = pu.shape[0]
        sub = (jnp.arange(n) % 32 == 0) & pmask
        Kixyz0 = _mm(xyz1, Ki.T)
        def proj(p):
            return fx * p[:, 0] / p[:, 2] + cx, fy * p[:, 1] / p[:, 2] + cy
        KuT, KvT = proj(Kixyz0 + t[None, :] * pid[:, None])
        KuT2, KvT2 = proj(Kixyz0 - t[None, :] * pid[:, None])
        KuR2, KvR2 = proj(Kixyz - t[None, :] * pid[:, None])
        flow_t, flow_rt = _flow_stats(
            Ku, Kv, KuT, KvT, KuT2, KvT2, KuR2, KvR2, pu, pv, sub
        )
    else:
        flow_t = jnp.float32(0.0)
        flow_rt = jnp.float32(0.0)

    # ---- Jacobian + H/b accumulation over non-saturated valid terms -------
    in_mask = (valid & ~sat).astype(jnp.float32)
    dxfx = hit_dx * fx
    dyfy = hit_dy * fy
    J = jnp.stack(
        [
            new_id * dxfx,
            new_id * dyfy,
            -new_id * (u * dxfx + v * dyfy),
            -(u * v * dxfx + (1.0 + v * v) * dyfy),
            u * v * dyfy + (1.0 + u * u) * dxfx,
            u * dyfy - v * dxfx,
            aff_a * (ref_b0 - pcolor),
            -jnp.ones_like(u),
        ],
        axis=-1,
    )  # [N, 8]
    w = (in_mask * hw)[:, None]
    n_in = jnp.sum(in_mask)
    n_safe = jnp.maximum(n_in, 1.0)
    Jw = J * w
    H = _mm(Jw.T, J) / n_safe                       # [8,8]
    b = _mm(Jw.T, residual[:, None])[:, 0] / n_safe  # [8]

    H = H * POSE_PRECOND[:, None] * POSE_PRECOND[None, :]
    b = b * POSE_PRECOND

    stats = ResStats(
        E=energy,
        num_terms=num_terms,
        flow_t=flow_t,
        flow_rt=flow_rt,
        saturated_ratio=num_sat / jnp.maximum(num_terms, 1.0),
    )
    return PosePassOut(stats=stats, H=H, b=b, num_in=n_in)


def pose3d_residual_pass(
    img: jnp.ndarray,          # [H, W, 3]
    px: jnp.ndarray, py: jnp.ndarray, pz: jnp.ndarray,  # [N] 3D ref points
    pcolor: jnp.ndarray,       # [N] reference intensity at this level
    pmask: jnp.ndarray,
    R: jnp.ndarray, t: jnp.ndarray,
    aff_a: jnp.ndarray, aff_b: jnp.ndarray, ref_b0: jnp.ndarray,
    fx: float, fy: float, cx: float, cy: float,
    huber_th: float, cutoff_th: jnp.ndarray,
) -> PosePassOut:
    """Loop-closure pose-estimator flavor (PoseEstimator.cpp:141-296): the
    reference points are 3D (metric) instead of pixel+idepth; Jacobian is
    identical with warped inverse depth."""
    H_img, W_img, _ = img.shape
    xyz = jnp.stack([px, py, pz], axis=-1)
    pt = _mm(xyz, R.T) + t[None, :]
    u = pt[:, 0] / pt[:, 2]
    v = pt[:, 1] / pt[:, 2]
    Ku = fx * u + cx
    Kv = fy * v + cy
    new_id = 1.0 / pt[:, 2]

    valid = (
        pmask
        & (Ku > 2.0) & (Kv > 2.0)
        & (Ku < W_img - 3.0) & (Kv < H_img - 3.0)
        & (new_id > 0.0)
    )
    hit = bilinear_gather(img, Ku, Kv)   # small index set: row-gather regime
    hit_i, hit_dx, hit_dy = hit[..., 0], hit[..., 1], hit[..., 2]
    valid &= jnp.isfinite(hit_i)

    residual = hit_i - (aff_a * pcolor + aff_b)
    abs_r = jnp.abs(residual)
    hw = jnp.where(abs_r < huber_th, 1.0, huber_th / jnp.maximum(abs_r, 1e-12))
    sat = abs_r > cutoff_th
    max_energy = 2.0 * huber_th * cutoff_th - huber_th * huber_th

    vf = valid.astype(jnp.float32)
    energy = jnp.sum(vf * _huber_energy(residual, hw, sat, max_energy))
    num_terms = jnp.sum(vf)
    num_sat = jnp.sum(vf * sat.astype(jnp.float32))

    in_mask = (valid & ~sat).astype(jnp.float32)
    dxfx = hit_dx * fx
    dyfy = hit_dy * fy
    J = jnp.stack(
        [
            new_id * dxfx,
            new_id * dyfy,
            -new_id * (u * dxfx + v * dyfy),
            -(u * v * dxfx + (1.0 + v * v) * dyfy),
            u * v * dyfy + (1.0 + u * u) * dxfx,
            u * dyfy - v * dxfx,
            aff_a * (ref_b0 - pcolor),
            -jnp.ones_like(u),
        ],
        axis=-1,
    )
    w = (in_mask * hw)[:, None]
    n_in = jnp.sum(in_mask)
    n_safe = jnp.maximum(n_in, 1.0)
    Jw = J * w
    H = _mm(Jw.T, J) / n_safe
    b = _mm(Jw.T, residual[:, None])[:, 0] / n_safe
    H = H * POSE_PRECOND[:, None] * POSE_PRECOND[None, :]
    b = b * POSE_PRECOND

    stats = ResStats(
        E=energy,
        num_terms=num_terms,
        flow_t=jnp.float32(0.0),
        flow_rt=jnp.float32(0.0),
        saturated_ratio=num_sat / jnp.maximum(num_terms, 1.0),
    )
    return PosePassOut(stats=stats, H=H, b=b, num_in=n_in)


def scale_residual_pass(
    img1: jnp.ndarray,         # [H, W, 3] second-camera level planes
    pu: jnp.ndarray, pv: jnp.ndarray, pid: jnp.ndarray, pcolor: jnp.ndarray,
    pmask: jnp.ndarray,
    R01Ki: jnp.ndarray,        # [3,3] rot(cam0->cam1) * K0^-1 at this level
    Ki0: jnp.ndarray,          # [3,3] K0^-1 (flow probe)
    t01: jnp.ndarray,          # [3] stereo translation
    scale: jnp.ndarray,        # scalar
    fx1: float, fy1: float, cx1: float, cy1: float,
    huber_th: float, cutoff_th: jnp.ndarray,
) -> ScalePassOut:
    """Stereo scale flavor (TrackerAndScaler.cpp:1007-1172 + 966-1005).

    Warp: ``pt = s * R01 K0^-1 x + t01 * id``; residual has no affine term.
    The 1-DoF Jacobian follows the reference's closed form: with
    ``rx = R01 K0^-1 x / id``, ``J = (dx fx1 (rx1 tz - rx3 tx) +
    dy fy1 (rx2 tz - rx3 ty)) / (s rx3 + tz)^2``.
    """
    H_img, W_img = _img_dims(img1)
    xyz1 = jnp.stack([pu, pv, jnp.ones_like(pu)], axis=-1)
    rKix = _mm(xyz1, R01Ki.T)                       # [N, 3]
    pt = scale * rKix + t01[None, :] * pid[:, None]
    u = pt[:, 0] / pt[:, 2]
    v = pt[:, 1] / pt[:, 2]
    Ku = fx1 * u + cx1
    Kv = fy1 * v + cy1
    new_id = pid / pt[:, 2]

    valid = (
        pmask
        & (Ku > 2.0) & (Kv > 2.0)
        & (Ku < W_img - 3.0) & (Kv < H_img - 3.0)
        & (new_id > 0.0)
    )
    hit_i, hit_dx, hit_dy = _sample_img(img1, Ku, Kv)
    valid &= jnp.isfinite(hit_i)

    residual = hit_i - pcolor
    abs_r = jnp.abs(residual)
    hw = jnp.where(abs_r < huber_th, 1.0, huber_th / jnp.maximum(abs_r, 1e-12))
    sat = abs_r > cutoff_th
    max_energy = 2.0 * huber_th * cutoff_th - huber_th * huber_th

    vf = valid.astype(jnp.float32)
    energy = jnp.sum(vf * _huber_energy(residual, hw, sat, max_energy))
    num_terms = jnp.sum(vf)
    num_sat = jnp.sum(vf * sat.astype(jnp.float32))

    # 1-DoF scale Jacobian
    rx = rKix / pid[:, None]
    tx, ty, tz = t01[0], t01[1], t01[2]
    deno_sqrt = scale * rx[:, 2] + tz
    deno = 1.0 / jnp.maximum(deno_sqrt * deno_sqrt, 1e-20)
    xno = rx[:, 0] * tz - rx[:, 2] * tx
    yno = rx[:, 1] * tz - rx[:, 2] * ty
    Js = hit_dx * fx1 * deno * xno + hit_dy * fy1 * deno * yno

    in_mask = (valid & ~sat).astype(jnp.float32)
    w = in_mask * hw
    n_in = jnp.sum(in_mask)
    n_safe = jnp.maximum(n_in, 1.0)
    H = jnp.sum(w * Js * Js) / n_safe
    b = jnp.sum(w * Js * residual) / n_safe

    stats = ResStats(
        E=energy,
        num_terms=num_terms,
        flow_t=jnp.float32(0.0),
        flow_rt=jnp.float32(0.0),
        saturated_ratio=num_sat / jnp.maximum(num_terms, 1.0),
    )
    return ScalePassOut(stats=stats, H=H, b=b)
