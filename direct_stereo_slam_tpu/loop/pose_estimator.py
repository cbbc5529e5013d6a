"""Direct loop-closure pose estimation.

Equivalent of the reference's ``PoseEstimator`` (pose_estimation/
PoseEstimator.cpp): stand-alone coarse-to-fine LM alignment of a matched
keyframe's sparse 3D points (with per-level intensities) against the
current keyframe's pyramid, seeded by the Scan-Context PCA relative pose,
with acceptance gates on the final residual (< RES_THRES), inlier ratio
(> INNER_PERCENT) and affine sanity (cpp:463-505).

Reuses the same fused residual/H/b pass (``pose3d_residual_pass``) and LM
policy (cutoff doubling, one-shot level repeat) as the coarse tracker —
the reference triplicates this machinery; here it is one kernel family.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SLAMConfig
from ..geometry import lie
from ..geometry.camera import PyramidIntrinsics
from ..models.tracker import AffLight, aff_from_to, _solve_inc
from ..ops.residual_hb import POSE_PRECOND, pose3d_residual_pass

_HI = jax.lax.Precision.HIGHEST


class LoopPoseResult(NamedTuple):
    T: jnp.ndarray            # refined [4,4] tfm_cur_matched
    pose_error: jnp.ndarray   # sqrt(E/n) at level 0
    inlier_ratio: jnp.ndarray
    aff: AffLight
    ok: jnp.ndarray
    # which acceptance gate(s) passed — diagnostics for loop_count=0 laps
    ok_res: jnp.ndarray = None
    ok_inlier: jnp.ndarray = None
    ok_aff: jnp.ndarray = None


def _estimate_level(
    img_l, px, py, pz, pcolor_l, pmask,
    fx, fy, cx, cy,
    T0, aff0: AffLight, ref_exposure, new_exposure, max_iters, cfg: SLAMConfig,
):
    tc = cfg.tracker
    zero_aff = AffLight(jnp.float32(0.0), jnp.float32(0.0))

    def run_pass(T, aff, cutoff):
        a_rel, b_rel = aff_from_to(
            ref_exposure, zero_aff.a, zero_aff.b, new_exposure, aff.a, aff.b
        )
        return pose3d_residual_pass(
            img_l, px, py, pz, pcolor_l, pmask,
            T[:3, :3], T[:3, 3], a_rel, b_rel, zero_aff.b,
            fx, fy, cx, cy, tc.huber_th, cutoff,
        )

    def cut_cond(c):
        repeat, out = c
        return (out.stats.saturated_ratio > tc.saturated_ratio_repeat) & (
            repeat < tc.cutoff_repeat_max)

    def cut_body(c):
        repeat, _ = c
        repeat = repeat * 2.0
        return repeat, run_pass(T0, aff0, tc.coarse_cutoff_th * repeat)

    out0 = run_pass(T0, aff0, jnp.float32(tc.coarse_cutoff_th))
    repeat, out0 = jax.lax.while_loop(cut_cond, cut_body, (jnp.float32(1.0), out0))
    cutoff = tc.coarse_cutoff_th * repeat

    def lm_cond(c):
        return (c["it"] < max_iters) & ~c["done"]

    def lm_body(c):
        lam = c["lam"]
        inc = _solve_inc(c["H"], c["b"], lam, cfg)
        extrap = jnp.where(
            lam < tc.lambda_extrapolation_limit,
            jnp.sqrt(jnp.sqrt(tc.lambda_extrapolation_limit / lam)), 1.0)
        inc = inc * extrap
        inc_scaled = inc * POSE_PRECOND
        inc_scaled = jnp.where(jnp.isfinite(jnp.sum(inc_scaled)), inc_scaled, 0.0)
        T_new = jnp.matmul(lie.se3_exp(inc_scaled[:6]), c["T"], precision=_HI)
        aff_new = AffLight(c["aff_a"] + inc_scaled[6], c["aff_b"] + inc_scaled[7])
        out = run_pass(T_new, aff_new, cutoff)
        accept = (out.stats.E / jnp.maximum(out.stats.num_terms, 1.0)) < (
            c["E"] / jnp.maximum(c["n"], 1.0))
        sel = lambda a, b: jnp.where(accept, a, b)
        return {
            "it": c["it"] + 1,
            "T": sel(T_new, c["T"]),
            "aff_a": sel(aff_new.a, c["aff_a"]),
            "aff_b": sel(aff_new.b, c["aff_b"]),
            "H": sel(out.H, c["H"]), "b": sel(out.b, c["b"]),
            "E": sel(out.stats.E, c["E"]), "n": sel(out.stats.num_terms, c["n"]),
            "in": sel(out.num_in, c["in"]),
            "lam": jnp.where(accept, lam * tc.lambda_accept_factor,
                             jnp.maximum(lam * tc.lambda_reject_factor,
                                         tc.lambda_extrapolation_limit)),
            "done": jnp.linalg.norm(inc) <= tc.inc_break_norm,
        }

    init = {
        "it": jnp.int32(0), "T": T0, "aff_a": aff0.a, "aff_b": aff0.b,
        "H": out0.H, "b": out0.b, "E": out0.stats.E, "n": out0.stats.num_terms,
        "in": out0.num_in,
        "lam": jnp.float32(tc.lambda_init), "done": jnp.bool_(False),
    }
    fin = jax.lax.while_loop(lm_cond, lm_body, init)
    return (fin["T"], AffLight(fin["aff_a"], fin["aff_b"]), fin["E"], fin["n"],
            fin["in"], repeat)


@partial(jax.jit, static_argnums=(7, 8))
def estimate(
    pyr_cur: Tuple[jnp.ndarray, ...],  # current KF pyramid planes per level
    px: jnp.ndarray, py: jnp.ndarray, pz: jnp.ndarray,   # [K] matched points
    pcolors: jnp.ndarray,              # [K, L] per-level intensities
    pmask: jnp.ndarray,                # [K]
    T_init: jnp.ndarray,               # [4,4] tfm_cur_matched seed
    intr: PyramidIntrinsics,
    cfg: SLAMConfig,
    ref_exposure: jnp.ndarray = None,
    new_exposure: jnp.ndarray = None,
) -> LoopPoseResult:
    if ref_exposure is None:
        ref_exposure = jnp.float32(1.0)
    if new_exposure is None:
        new_exposure = jnp.float32(1.0)
    levels = len(pyr_cur)
    tc = cfg.tracker
    T = T_init
    aff = AffLight(jnp.float32(0.0), jnp.float32(0.0))
    have_repeated = jnp.bool_(False)
    E0 = jnp.float32(0.0)
    n0 = jnp.float32(1.0)
    n_in = jnp.float32(0.0)

    for lvl in range(levels - 1, -1, -1):
        args = (
            pyr_cur[lvl], px, py, pz, pcolors[:, lvl], pmask,
            intr.fx[lvl], intr.fy[lvl], intr.cx[lvl], intr.cy[lvl],
        )
        max_it = tc.max_iterations[min(lvl, len(tc.max_iterations) - 1)]
        T, aff, E, n, n_inl, repeat = _estimate_level(
            *args, T, aff, ref_exposure, new_exposure, max_it, cfg)

        need_repeat = (repeat > 1.0) & ~have_repeated

        def do_repeat(op):
            T_, a_, b_ = op
            T2, aff2, E2, n2, in2, _ = _estimate_level(
                *args, T_, AffLight(a_, b_), ref_exposure, new_exposure,
                max_it, cfg)
            return T2, aff2.a, aff2.b, E2, n2, in2

        def no_repeat(op):
            T_, a_, b_ = op
            return T_, a_, b_, E, n, n_inl

        T, aa, ab, E, n, n_inl = jax.lax.cond(
            need_repeat, do_repeat, no_repeat, (T, aff.a, aff.b))
        aff = AffLight(aa, ab)
        have_repeated = have_repeated | (repeat > 1.0)
        if lvl == 0:
            E0, n0, n_in = E, n, n_inl

    pose_error = jnp.sqrt(E0 / jnp.maximum(n0, 1.0))
    total = jnp.maximum(jnp.sum(pmask.astype(jnp.float32)), 1.0)
    # "inner percent" counts EVERY in-view term, saturated included — the
    # reference's lastInners[0] is calcRes's numTermsInE, which increments
    # for cutoff-saturated residuals too (PoseEstimator.cpp:249-257,
    # 483-484): the gate measures VISIBILITY of the matched points in the
    # current frame, not unsaturated-inlier fraction. Using the
    # non-saturated count here rejected every real revisit whose overlap
    # was partial (r4 diagnosis: 24/24 verifications failed with
    # n_in/total at 20-60% while err was passing).
    inlier_ratio = 100.0 * n0 / total

    lp = cfg.loop
    ok_res = pose_error < lp.res_thres
    ok_inlier = inlier_ratio > lp.inner_percent
    # affine gates (cpp:465-477)
    ok_aff = jnp.bool_(True)
    if tc.affine_mode_a != 0:
        ok_aff &= jnp.abs(aff.a) <= tc.max_aff_a
    if tc.affine_mode_b != 0:
        ok_aff &= jnp.abs(aff.b) <= tc.max_aff_b
    rel_a, rel_b = aff_from_to(
        ref_exposure, jnp.float32(0.0), jnp.float32(0.0),
        new_exposure, aff.a, aff.b)
    if tc.affine_mode_a == 0:
        ok_aff &= jnp.abs(jnp.log(jnp.maximum(rel_a, 1e-12))) <= tc.max_rel_aff_log_a
    if tc.affine_mode_b == 0:
        ok_aff &= jnp.abs(rel_b) <= tc.max_rel_aff_b
    ok = ok_res & ok_inlier & ok_aff

    return LoopPoseResult(T=T, pose_error=pose_error,
                          inlier_ratio=inlier_ratio, aff=aff, ok=ok,
                          ok_res=ok_res, ok_inlier=ok_inlier, ok_aff=ok_aff)


class LoopPoseBatchResult(NamedTuple):
    best: LoopPoseResult          # winning seed's result (ok seeds first,
    #                               then lowest pose_error)
    seed_errors: jnp.ndarray      # [S] per-seed pose_error (diagnostics)
    seed_inliers: jnp.ndarray     # [S] per-seed inlier ratio
    seed_ok: jnp.ndarray          # [S]


@partial(jax.jit, static_argnums=(7, 8))
def estimate_batch(
    pyr_cur: Tuple[jnp.ndarray, ...],
    px: jnp.ndarray, py: jnp.ndarray, pz: jnp.ndarray,
    pcolors: jnp.ndarray,
    pmask: jnp.ndarray,
    T_inits: jnp.ndarray,              # [S, 4, 4] seed stack
    intr: PyramidIntrinsics,
    cfg: SLAMConfig,
    ref_exposure: jnp.ndarray = None,
    new_exposure: jnp.ndarray = None,
) -> LoopPoseBatchResult:
    """Multi-seed direct alignment in ONE device dispatch.

    The coarse tracker escapes local minima with a 78-candidate
    perturbation try-list (FrontEnd.cpp:132-186); the reference's
    PoseEstimator gets only the single PCA seed, and its acceptance is
    correspondingly marginal — revisit laps were seen to swing between 5
    and 0 accepted revisits on last-ulp numerics shifts because the LM converges to a
    nearby local minimum whose level-0 residual sits just above
    RES_THRES. This is the try-list idea applied to loop closure, and on
    an accelerator it is nearly free: vmap the whole coarse-to-fine LM over the seed
    stack (batched matmuls/gathers, one dispatch ~ the cost of one seed)
    and select — ok seeds first, lowest pose_error among them.
    """
    if ref_exposure is None:
        ref_exposure = jnp.float32(1.0)
    if new_exposure is None:
        new_exposure = jnp.float32(1.0)

    def one(T0):
        return estimate.__wrapped__(
            pyr_cur, px, py, pz, pcolors, pmask, T0, intr, cfg,
            ref_exposure, new_exposure)

    res = jax.vmap(one)(T_inits)
    # rank: passing seeds by pose_error, failing seeds pushed to +inf
    key = jnp.where(res.ok, res.pose_error, jnp.inf)
    best_ok = jnp.argmin(key)
    any_ok = jnp.any(res.ok)
    # fallback (diagnostics only — nothing accepts): the seed closest to
    # acceptance. A seed that projects ZERO points reads pose_error 0 /
    # inlier 0 — rank visibility-passing seeds by error first, then any
    # seed with nonzero visibility, so best_err never reports a
    # degenerate 0.00.
    lp = cfg.loop
    vis_key = jnp.where(res.inlier_ratio > lp.inner_percent,
                        res.pose_error,
                        jnp.where(res.inlier_ratio > 0.0,
                                  res.pose_error + 1e3, jnp.inf))
    best_err = jnp.argmin(vis_key)
    idx = jnp.where(any_ok, best_ok, best_err)
    best = LoopPoseResult(
        T=res.T[idx], pose_error=res.pose_error[idx],
        inlier_ratio=res.inlier_ratio[idx],
        aff=AffLight(res.aff.a[idx], res.aff.b[idx]), ok=res.ok[idx],
        ok_res=res.ok_res[idx], ok_inlier=res.ok_inlier[idx],
        ok_aff=res.ok_aff[idx])
    return LoopPoseBatchResult(best=best, seed_errors=res.pose_error,
                               seed_inliers=res.inlier_ratio,
                               seed_ok=res.ok)


def make_seed_stack(primary: np.ndarray, extras, yaw_perturb_deg) -> np.ndarray:
    """[S, 4, 4] seed stack: primary, then extras, then yaw perturbations
    of the primary about its own camera-frame Y axis (Scan Context's PCA
    alignment leaves yaw as the dominant seed error mode)."""
    seeds = [np.asarray(primary, np.float64)]
    for e in extras:
        seeds.append(np.asarray(e, np.float64))
    for deg in yaw_perturb_deg:
        th = np.deg2rad(deg)
        R = np.array([[np.cos(th), 0.0, np.sin(th), 0.0],
                      [0.0, 1.0, 0.0, 0.0],
                      [-np.sin(th), 0.0, np.cos(th), 0.0],
                      [0.0, 0.0, 0.0, 1.0]])
        seeds.append(np.asarray(primary, np.float64) @ R)
    return np.stack(seeds).astype(np.float32)
