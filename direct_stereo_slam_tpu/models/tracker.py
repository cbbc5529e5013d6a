"""Coarse-to-fine LM pose tracker (the reference's ``trackNewestCoarse``).

Implements the full policy of TrackerAndScaler.cpp:451-638 as one jitted
program per candidate batch:

* per-level LM with accept/reject, lambda schedule 0.5x/4x, increment-norm
  break at 1e-3 (cpp:505-593),
* cutoff-doubling pre-loop while >60% of residuals saturate (cpp:477-485),
* one-shot level repeat after a cutoff-doubled level (cpp:601-604),
* affine gates on the result (cpp:615-626),
* flow indicators from the finest level (cpp:595-597).

Deviation from the reference: the serial 80+-candidate try-list
with early abort (FrontEnd.cpp:200-247) becomes *batched* evaluation via
``vmap`` — a cheap stage of the 5 motion-model candidates first, then (only
if none passes) the 78 rotation-perturbation candidates in one batch. The
winner is the first in-order candidate whose residual beats
``re_track_threshold * last_rmse``, else the argmin — matching the
reference's stopping rule up to its serial achievedRes tightening.

Every LM iteration is exactly one fused residual pass (the pass returns
energy and H/b together, so DSO's separate calcRes/calcGSSSE calls fuse).
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
from ..ops.residual_hb import POSE_PRECOND, pose_residual_pass
from .depth_template import TrackerTemplate

_HI = jax.lax.Precision.HIGHEST


class AffLight(NamedTuple):
    """DSO AffLight: per-frame brightness-transfer params (a, b)."""

    a: jnp.ndarray
    b: jnp.ndarray


def aff_from_to(exp_f, a_f, b_f, exp_t, a_t, b_t):
    """DSO ``AffLight::fromToVecExposure``: relative (a, b) mapping frame F's
    intensities onto frame T's."""
    a = jnp.exp(a_t - a_f) * (exp_t / jnp.maximum(exp_f, 1e-9))
    b = b_t - a * b_f
    return a, b


class TrackResult(NamedTuple):
    T: jnp.ndarray                 # [4, 4] ref-to-new
    aff: AffLight                  # new frame's (a, b)
    res_per_level: jnp.ndarray     # [L] sqrt(E/n) at each level's end
    flow: jnp.ndarray              # [3] (flow_t, 0, flow_rt) from level 0
    ok: jnp.ndarray                # bool: gates passed, residuals finite


def _solve_inc(H, b, lam, cfg: SLAMConfig):
    """LM-damped solve with DSO's affine-mode sub-block logic
    (TrackerAndScaler.cpp:505-534)."""
    Hl = H + lam * jnp.diag(jnp.diag(H))
    mode_a, mode_b = cfg.tracker.affine_mode_a, cfg.tracker.affine_mode_b
    if mode_a < 0 and mode_b < 0:       # fix both
        inc6 = jnp.linalg.solve(Hl[:6, :6], -b[:6])
        inc = jnp.concatenate([inc6, jnp.zeros(2, dtype=b.dtype)])
    elif mode_a >= 0 and mode_b < 0:    # fix b
        inc7 = jnp.linalg.solve(Hl[:7, :7], -b[:7])
        inc = jnp.concatenate([inc7, jnp.zeros(1, dtype=b.dtype)])
    elif mode_a < 0 and mode_b >= 0:    # fix a (stitch b into slot 6)
        idx = jnp.array([0, 1, 2, 3, 4, 5, 7])
        Hs = Hl[idx][:, idx]
        bs = b[idx]
        inc7 = jnp.linalg.solve(Hs, -bs)
        inc = jnp.concatenate(
            [inc7[:6], jnp.zeros(1, dtype=b.dtype), inc7[6:7]]
        )
    else:                               # optimize both
        inc = jnp.linalg.solve(Hl, -b)
    return inc


def _track_level(
    img_l: jnp.ndarray,
    tmpl_pu, tmpl_pv, tmpl_pid, tmpl_pcolor, tmpl_pmask,
    Ki_l: jnp.ndarray,
    fx: float, fy: float, cx: float, cy: float,
    T0: jnp.ndarray,
    aff0: AffLight,
    ref_aff: AffLight,
    ref_exposure: jnp.ndarray,
    new_exposure: jnp.ndarray,
    max_iters: int,
    cfg: SLAMConfig,
    compute_flow: bool,
):
    """One pyramid level of LM. Returns (T, aff, E, n, flow_t, flow_rt,
    cutoff_repeat)."""
    tc = cfg.tracker
    huber = tc.huber_th

    def run_pass(T, aff, cutoff):
        a_rel, b_rel = aff_from_to(
            ref_exposure, ref_aff.a, ref_aff.b, new_exposure, aff.a, aff.b
        )
        return pose_residual_pass(
            img_l, tmpl_pu, tmpl_pv, tmpl_pid, tmpl_pcolor, tmpl_pmask,
            jnp.matmul(T[:3, :3], Ki_l, precision=_HI), Ki_l, T[:3, 3],
            a_rel, b_rel, ref_aff.b,
            fx, fy, cx, cy, huber, cutoff,
            compute_flow=compute_flow,
        )

    # ---- cutoff-doubling pre-loop (cpp:474-485) ---------------------------
    def cut_cond(carry):
        repeat, out = carry
        return (out.stats.saturated_ratio > tc.saturated_ratio_repeat) & (
            repeat < tc.cutoff_repeat_max
        )

    def cut_body(carry):
        repeat, _ = carry
        repeat = repeat * 2.0
        out = run_pass(T0, aff0, tc.coarse_cutoff_th * repeat)
        return repeat, out

    out0 = run_pass(T0, aff0, tc.coarse_cutoff_th * 1.0)
    # Data-derived varying zero: under jax.shard_map's varying-manual-axes
    # typing, constant-initialized while_loop carries (lam/done/flow/repeat)
    # would be 'unvarying' while the loop body emits 'varying' values. Tying
    # every carry constant to the residual pass output keeps the types equal
    # on both sides (and is a no-op outside shard_map). nan_to_num guards a
    # divergent pass (E=NaN/inf) from poisoning the carries via NaN*0.
    zv = jnp.nan_to_num(out0.stats.E) * 0.0
    repeat0 = zv + 1.0
    repeat, out0 = jax.lax.while_loop(cut_cond, cut_body, (repeat0, out0))
    cutoff = tc.coarse_cutoff_th * repeat

    # ---- LM loop (cpp:505-593) -------------------------------------------
    # carry: (it, T, aff_a, aff_b, H, b, E_old, n_old, lam, done)
    def lm_cond2(c):
        return (c["it"] < max_iters) & ~c["done"]

    def lm_body2(c):
        lam = c["lam"]
        inc = _solve_inc(c["H"], c["b"], lam, cfg)
        extrap = jnp.where(
            lam < tc.lambda_extrapolation_limit,
            jnp.sqrt(jnp.sqrt(tc.lambda_extrapolation_limit / lam)),
            1.0,
        )
        inc = inc * extrap
        inc_scaled = inc * POSE_PRECOND
        inc_scaled = jnp.where(jnp.isfinite(jnp.sum(inc_scaled)), inc_scaled, 0.0)

        T_new = jnp.matmul(lie.se3_exp(inc_scaled[:6]), c["T"], precision=_HI)
        aff_new = AffLight(c["aff_a"] + inc_scaled[6], c["aff_b"] + inc_scaled[7])
        out = run_pass(T_new, aff_new, cutoff)

        accept = (out.stats.E / jnp.maximum(out.stats.num_terms, 1.0)) < (
            c["E"] / jnp.maximum(c["n"], 1.0)
        )
        sel = lambda x, y: jnp.where(accept, x, y)
        new_lam = jnp.where(
            accept,
            lam * tc.lambda_accept_factor,
            jnp.maximum(lam * tc.lambda_reject_factor, tc.lambda_extrapolation_limit),
        )
        done = jnp.linalg.norm(inc) <= tc.inc_break_norm
        return {
            "it": c["it"] + 1,
            "T": sel(T_new, c["T"]),
            "aff_a": sel(aff_new.a, c["aff_a"]),
            "aff_b": sel(aff_new.b, c["aff_b"]),
            "H": sel(out.H, c["H"]),
            "b": sel(out.b, c["b"]),
            "E": sel(out.stats.E, c["E"]),
            "n": sel(out.stats.num_terms, c["n"]),
            "flow_t": sel(out.stats.flow_t, c["flow_t"]),
            "flow_rt": sel(out.stats.flow_rt, c["flow_rt"]),
            "lam": new_lam,
            "done": done,
        }

    init = {
        "it": jnp.int32(0),
        "T": T0 + zv,
        "aff_a": aff0.a + zv,
        "aff_b": aff0.b + zv,
        "H": out0.H,
        "b": out0.b,
        "E": out0.stats.E,
        "n": out0.stats.num_terms,
        "flow_t": out0.stats.flow_t + zv,
        "flow_rt": out0.stats.flow_rt + zv,
        "lam": zv + tc.lambda_init,
        "done": zv > 1.0,
    }
    fin = jax.lax.while_loop(lm_cond2, lm_body2, init)
    return (
        fin["T"],
        AffLight(fin["aff_a"], fin["aff_b"]),
        fin["E"],
        fin["n"],
        fin["flow_t"],
        fin["flow_rt"],
        repeat,
    )


def track_candidate(
    pyr_new: Tuple[jnp.ndarray, ...],
    template: TrackerTemplate,
    intr: PyramidIntrinsics,
    cfg: SLAMConfig,
    T_init: jnp.ndarray,
    aff_init: AffLight,
    ref_aff: AffLight,
    ref_exposure: jnp.ndarray,
    new_exposure: jnp.ndarray,
) -> TrackResult:
    """Track one pose candidate over all pyramid levels, coarse to fine,
    including the one-shot level repeat after a cutoff-doubled level."""
    levels = template.levels
    tc = cfg.tracker
    T = T_init
    aff = aff_init
    res_levels = [jnp.float32(0.0)] * levels
    flow_t = jnp.float32(0.0)
    flow_rt = jnp.float32(0.0)
    have_repeated = jnp.bool_(False)

    for lvl in range(levels - 1, -1, -1):
        Ki_l = jnp.asarray(intr.Ki(lvl), dtype=jnp.float32)
        args = (
            pyr_new[lvl],
            template.pu[lvl], template.pv[lvl], template.pid[lvl],
            template.pcolor[lvl], template.pmask[lvl],
            Ki_l,
            intr.fx[lvl], intr.fy[lvl], intr.cx[lvl], intr.cy[lvl],
        )
        max_it = tc.max_iterations[min(lvl, len(tc.max_iterations) - 1)]
        T, aff, E, n, f_t, f_rt, repeat = _track_level(
            *args, T, aff, ref_aff, ref_exposure, new_exposure, max_it, cfg,
            compute_flow=(lvl == 0),
        )
        # one-shot repeat of this level (cpp:601-604), as a 0/1-iteration
        # while_loop rather than lax.cond: cond's branch-output vma
        # unification breaks under jax.shard_map, while_loop carries type
        # cleanly; unbatched it still skips the pass when not needed.
        need_repeat = (repeat > 1.0) & ~have_repeated

        def rep_body(c):
            _, T_, aff_a_, aff_b_, *_rest = c
            T2, aff2, E2, n2, ft2, frt2, _ = _track_level(
                *args, T_, AffLight(aff_a_, aff_b_), ref_aff, ref_exposure,
                new_exposure, max_it, cfg, compute_flow=(lvl == 0),
            )
            return (c[0] + 1, T2, aff2.a, aff2.b, E2, n2, ft2, frt2)

        c0 = (jnp.int32(0), T, aff.a, aff.b, E, n, f_t, f_rt)
        fin = jax.lax.while_loop(
            lambda c: need_repeat & (c[0] < 1), rep_body, c0
        )
        _, T, aff_a, aff_b, E, n, f_t, f_rt = fin
        aff = AffLight(aff_a, aff_b)
        have_repeated = have_repeated | (repeat > 1.0)

        # vacuous tracking (no surviving terms) must read as failure — DSO's
        # 0/0 residual NaN is what triggers its lost detection
        res_levels[lvl] = jnp.where(n > 0, jnp.sqrt(E / jnp.maximum(n, 1.0)), jnp.inf)
        if lvl == 0:
            flow_t, flow_rt = f_t, f_rt

    res = jnp.stack(res_levels)

    # ---- acceptance gates (cpp:615-632) ----------------------------------
    ok = jnp.all(jnp.isfinite(res))
    if tc.affine_mode_a != 0:
        ok &= jnp.abs(aff.a) <= tc.max_aff_a
    if tc.affine_mode_b != 0:
        ok &= jnp.abs(aff.b) <= tc.max_aff_b
    rel_a, rel_b = aff_from_to(
        ref_exposure, ref_aff.a, ref_aff.b, new_exposure, aff.a, aff.b
    )
    if tc.affine_mode_a == 0:
        ok &= jnp.abs(jnp.log(jnp.maximum(rel_a, 1e-12))) <= tc.max_rel_aff_log_a
    if tc.affine_mode_b == 0:
        ok &= jnp.abs(rel_b) <= tc.max_rel_aff_b
    if tc.affine_mode_a < 0:
        aff = AffLight(jnp.float32(0.0), aff.b)
    if tc.affine_mode_b < 0:
        aff = AffLight(aff.a, jnp.float32(0.0))

    return TrackResult(
        T=T, aff=aff, res_per_level=res,
        flow=jnp.stack([flow_t, jnp.float32(0.0), flow_rt]),
        ok=ok,
    )


# jitted single-candidate program: the frontend's steady-state fast path
# (one candidate per frame). Calling track_candidate eager would cost
# thousands of tiny dispatches per frame.
track_candidate_jit = partial(jax.jit, static_argnums=(2, 3))(track_candidate)


@partial(jax.jit, static_argnums=(2, 3))
def track_candidates_batch(
    pyr_new: Tuple[jnp.ndarray, ...],
    template: TrackerTemplate,
    intr: PyramidIntrinsics,
    cfg: SLAMConfig,
    T_inits: jnp.ndarray,          # [B, 4, 4]
    aff_init: AffLight,            # scalars (shared initial aff)
    ref_aff: AffLight,
    ref_exposure: jnp.ndarray,
    new_exposure: jnp.ndarray,
) -> TrackResult:
    """vmap the full coarse-to-fine tracker over B pose candidates."""
    fn = lambda T0: track_candidate(
        pyr_new, template, intr, cfg, T0, aff_init, ref_aff,
        ref_exposure, new_exposure,
    )
    return jax.vmap(fn)(T_inits)


def make_motion_tries(
    T_const: np.ndarray,
    T_last_to_slast: np.ndarray,
    T_fh_to_slast: np.ndarray,
    cfg: SLAMConfig,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build the candidate pose lists (FrontEnd.cpp:147-186), host side.

    Returns (stage1 [5,4,4], stage2 [78,4,4]): stage1 = const/double/half/
    zero-motion/zero-from-KF, stage2 = 26 rotation sign patterns x 3 deltas
    applied on top of the constant-motion hypothesis."""
    inv = np.linalg.inv
    fh2slast = T_fh_to_slast

    stage1 = np.stack(
        [
            inv(fh2slast) @ T_last_to_slast,                       # const motion
            inv(fh2slast) @ inv(fh2slast) @ T_last_to_slast,       # double
            _half_motion(fh2slast) @ T_last_to_slast,              # half
            T_last_to_slast,                                       # zero motion
            np.eye(4, dtype=np.float64),                           # zero from KF
        ]
    ).astype(np.float32)

    rot_signs = [
        (1, 0, 0), (0, 1, 0), (0, 0, 1), (-1, 0, 0), (0, -1, 0),
        (0, 0, -1), (1, 1, 0), (0, 1, 1), (1, 0, 1), (-1, 1, 0),
        (0, -1, 1), (-1, 0, 1), (1, -1, 0), (0, 1, -1), (1, 0, -1),
        (-1, -1, 0), (0, -1, -1), (-1, 0, -1), (-1, -1, -1), (-1, -1, 1),
        (-1, 1, -1), (-1, 1, 1), (1, -1, -1), (1, -1, 1), (1, 1, -1),
        (1, 1, 1),
    ]
    T_c = stage1[0].astype(np.float64)
    out = []
    for delta in cfg.tracker.rot_perturbation_deltas:
        for rs in rot_signs:
            # reference uses an (unnormalized) quaternion (1, dx, dy, dz)
            q = np.array([1.0, rs[0] * delta, rs[1] * delta, rs[2] * delta])
            q = q / np.linalg.norm(q)
            w, x, y, z = q
            R = np.array(
                [
                    [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                ]
            )
            P = np.eye(4)
            P[:3, :3] = R
            out.append(T_c @ P)
    stage2 = np.stack(out).astype(np.float32)
    return stage1, stage2


def _half_motion(T: np.ndarray) -> np.ndarray:
    """SE3::exp(0.5 * log(T))^{-1} (reference FrontEnd.cpp:156-157).

    Pure numpy: this runs on the per-frame host path, where eager jnp
    log/exp would be dozens of device dispatches (see lie.se3_log_np)."""
    xi = lie.se3_log_np(T)
    return np.linalg.inv(lie.se3_exp_np(0.5 * xi))


def select_winner(results: TrackResult, last_rmse: float, cfg: SLAMConfig):
    """Host-side winner selection over a candidate batch: first in-order
    candidate beating re_track_threshold * last_rmse, else argmin residual
    among good candidates (approximates FrontEnd.cpp:200-247)."""
    res0 = np.asarray(results.res_per_level[:, 0])
    ok = np.asarray(results.ok) & np.isfinite(res0)
    thresh = cfg.tracker.re_track_threshold * last_rmse
    order_hit = np.where(ok & (res0 < thresh))[0]
    if len(order_hit) > 0:
        return int(order_hit[0]), True
    if ok.any():
        masked = np.where(ok, res0, np.inf)
        return int(np.argmin(masked)), True
    return 0, False


def select_winner_serial(results: TrackResult, last_rmse: float,
                         cfg: SLAMConfig):
    """Reference-exact serial try-list walk over already-evaluated
    candidates (FrontEnd.cpp:198-248): the winner updates whenever a good
    try strictly beats the per-level achievedRes minimum, achievedRes
    tightens element-wise on every good-so-far try, and the walk breaks
    once achievedRes[0] < re_track_threshold * last_rmse. Candidates past
    the break point are never consulted, so the chosen index can differ
    from ``select_winner``'s first-below-threshold / global-argmin rule.
    (Not emulated: the reference's mid-LM coarse-level abort, which only
    changes whether a losing try finishes, not the comparison itself.)"""
    res = np.asarray(results.res_per_level)        # [N, L]
    ok = np.asarray(results.ok)
    achieved = np.full(res.shape[1], np.nan)
    thresh = cfg.tracker.re_track_threshold * last_rmse
    best, have = 0, False
    for i in range(res.shape[0]):
        r0 = res[i, 0]
        bar = achieved[0] if np.isfinite(achieved[0]) else np.inf
        if ok[i] and np.isfinite(r0) and not (r0 >= bar):
            best, have = i, True
        if have:
            upd = ~np.isfinite(achieved) | (achieved > res[i])
            achieved = np.where(upd, res[i], achieved)
        if have and achieved[0] < thresh:
            break
    return best, have
