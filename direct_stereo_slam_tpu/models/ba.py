"""Windowed photometric bundle adjustment — the array-program EnergyFunctional.

Reimplements the functionality of DSO's ``EnergyFunctional`` (the external
windowed-BA backend the reference links against, SURVEY.md §2.2) together
with the reference's driver logic in FrontEndOptimize.cpp:332-494: sliding
window of up to W keyframes x NP active points, 8-pixel-pattern photometric
residuals between every (point, target-frame) pair, Gauss-Newton with
first-estimate Jacobians, closed-form Schur complement over inverse depths,
quadratic marginalization prior (HM, bM) maintained by point- and
frame-marginalization, per-frame energy thresholds from a residual
percentile (FrontEndOptimize.cpp:79-120), and DSO's default force-accept
iteration scheme with step-size convergence test
(FrontEndOptimize.cpp:182-258, 385-453).

Layout (all fixed shapes, masked):

* frame slots ``[W]``: worldToCam FEJ pose ``T_zero``, additive tangent
  delta ``[W, 8]`` = (trans3, rot3, aff_a, aff_b) — exactly DSO's
  ``FrameHessian::state`` convention (current pose = exp(delta[:6]) @ T_zero)
* global point pool ``[NP]`` hosted via ``p_host`` slot indices
* frame-parameter vector dimension ``D = 4 + 8 W`` (calib first, DSO's CPARS)
* residual grid ``[NP, W]`` — every point against every frame slot, masked
  (replaces DSO's per-point residual vectors)

The whole linearize->assemble->Schur->solve->update iteration is one jitted
program; the Hessian assembly is a single ``[R, D]^T [R, D]`` matmul
(R = NP * W * 8 pattern pixel-rows).

Deviations from DSO (documented):
* gauge: instead of DSO's first-keyframe prior + 7-dim nullspace
  orthogonalization (FrontEndOptimize.cpp:525-574), the oldest keyframe's
  variables are eliminated exactly from every solve (``_free_mask``), the
  remaining global-scale direction is projected out of each step
  (``_nullspaces``), and the anchoring transfers into HM with a strong
  prior when the anchor frame is marginalized. This combination is exact
  where DSO's is iterative, and is stable under the energy-gated LM accept
  (DSO's hard prior + projection + force-accept interact pathologically
  with an energy gate).
* ``setting_solverMode`` momentum variants are not implemented; both the
  energy-gated accept (default) and DSO's force-accept scheme are.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    PATTERN_OFFSETS,
    SCALE_A,
    SCALE_B,
    SCALE_C,
    SCALE_F,
    SCALE_XI_ROT,
    SCALE_XI_TRANS,
    SLAMConfig,
)
from ..geometry import lie
from ..ops.interp import bilinear_gather

_HI = jax.lax.Precision.HIGHEST

# residual states for p_last_res (DSO ResState; NONE = no residual exists)
RES_IN = 0
RES_OOB = 1
RES_OUTLIER = 2
RES_NONE = 3


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


class BAState(NamedTuple):
    # frames ------------------------------------------------------------
    frame_valid: jnp.ndarray     # [W] bool
    frame_id: jnp.ndarray        # [W] int32 global KF id (-1 = empty)
    T_zero: jnp.ndarray          # [W, 4, 4] worldToCam at FEJ point
    delta: jnp.ndarray           # [W, 8] additive state (t3, r3, a, b)
    aff_zero: jnp.ndarray        # [W, 2] affine zero point
    exposure: jnp.ndarray        # [W]
    images: jnp.ndarray          # [W, H, W0, 3] level-0 (I, dx, dy)
    energy_th: jnp.ndarray       # [W] frame energy threshold
    # calib --------------------------------------------------------------
    calib_zero: jnp.ndarray      # [4] fx fy cx cy at FEJ
    calib_delta: jnp.ndarray     # [4]
    # points -------------------------------------------------------------
    p_valid: jnp.ndarray         # [NP] bool
    p_host: jnp.ndarray          # [NP] int32 frame slot
    p_u: jnp.ndarray             # [NP]
    p_v: jnp.ndarray             # [NP]
    p_idepth: jnp.ndarray        # [NP] current
    p_idepth_zero: jnp.ndarray   # [NP] FEJ
    p_color: jnp.ndarray         # [NP, 8] host pattern intensities
    p_weight: jnp.ndarray        # [NP, 8] gradient weights
    p_prior: jnp.ndarray         # [NP] idepth prior strength (init points)
    p_res_good: jnp.ndarray      # [NP, W] bool residual active mask
    # isOOB bookkeeping (DSO PointHessian, used by flagPointsForRemoval
    # FrontEnd.cpp:538-541): lifetime count of good residuals (+= number of
    # active residuals at each keyframe's fix-linearization pass,
    # FrontEndOptimize.cpp:65) and the residual states toward the newest
    # [,0] / second-newest [,1] keyframes (lastResiduals; shifted on KF add
    # FrontEnd.cpp:757-758, updated at the fix pass Optimize.cpp:149-152)
    p_num_good: jnp.ndarray      # [NP] f32 lifetime good-residual count
    p_last_res: jnp.ndarray      # [NP, 2] int32 RES_IN/OOB/OUTLIER/NONE
    # marginalization prior over [D = 4 + 8 W] ---------------------------
    HM: jnp.ndarray              # [D, D]
    bM: jnp.ndarray              # [D]

    @property
    def num_slots(self) -> int:
        return self.frame_valid.shape[0]

    @property
    def num_points(self) -> int:
        return self.p_valid.shape[0]

    def T_current(self) -> jnp.ndarray:
        """[W, 4, 4] current worldToCam = exp(delta) @ T_zero."""
        return jnp.matmul(lie.se3_exp(self.delta[:, :6]), self.T_zero, precision=_HI)

    def aff_current(self) -> jnp.ndarray:
        return self.aff_zero + self.delta[:, 6:8]

    def calib_current(self) -> jnp.ndarray:
        return self.calib_zero + self.calib_delta


def empty_state(n_slots: int, n_points: int, h: int, w: int, calib: np.ndarray) -> BAState:
    D = 4 + 8 * n_slots
    eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (n_slots, 4, 4))
    return BAState(
        frame_valid=jnp.zeros(n_slots, bool),
        frame_id=-jnp.ones(n_slots, jnp.int32),
        T_zero=eye,
        delta=jnp.zeros((n_slots, 8), jnp.float32),
        aff_zero=jnp.zeros((n_slots, 2), jnp.float32),
        exposure=jnp.ones(n_slots, jnp.float32),
        images=jnp.zeros((n_slots, h, w, 3), jnp.float32),
        energy_th=jnp.full((n_slots,), 12.0 * 12.0 * 8.0, jnp.float32),
        calib_zero=jnp.asarray(calib, jnp.float32),
        calib_delta=jnp.zeros(4, jnp.float32),
        p_valid=jnp.zeros(n_points, bool),
        p_host=jnp.zeros(n_points, jnp.int32),
        p_u=jnp.zeros(n_points, jnp.float32),
        p_v=jnp.zeros(n_points, jnp.float32),
        p_idepth=jnp.ones(n_points, jnp.float32),
        p_idepth_zero=jnp.ones(n_points, jnp.float32),
        p_color=jnp.zeros((n_points, 8), jnp.float32),
        p_weight=jnp.ones((n_points, 8), jnp.float32),
        p_prior=jnp.zeros(n_points, jnp.float32),
        p_res_good=jnp.zeros((n_points, n_slots), bool),
        p_num_good=jnp.zeros(n_points, jnp.float32),
        p_last_res=jnp.full((n_points, 2), RES_NONE, jnp.int32),
        HM=jnp.zeros((D, D), jnp.float32),
        bM=jnp.zeros(D, jnp.float32),
    )


# state-vector preconditioner: [calib(4) | per-frame (t3 r3 a b)]
def _precond(n_slots: int) -> jnp.ndarray:
    per_frame = [SCALE_XI_TRANS] * 3 + [SCALE_XI_ROT] * 3 + [SCALE_A, SCALE_B]
    return jnp.asarray([SCALE_F, SCALE_F, SCALE_C, SCALE_C] + per_frame * n_slots,
                       dtype=jnp.float32)


# ---------------------------------------------------------------------------
# linearization
# ---------------------------------------------------------------------------


class Linearization(NamedTuple):
    Hff: jnp.ndarray     # [D, D] frame/calib GN Hessian (unpreconditioned)
    bf: jnp.ndarray      # [D]
    Hfd: jnp.ndarray     # [NP, D] frame-idepth coupling
    Hdd: jnp.ndarray     # [NP] idepth Hessian (incl. point prior)
    bd: jnp.ndarray      # [NP]
    energy: jnp.ndarray  # scalar photometric energy (active residuals)
    pair_energy: jnp.ndarray  # [NP, W] per-residual energy (for thresholds)
    pair_good: jnp.ndarray    # [NP, W] residual passed cutoff/oob checks
    pair_in: jnp.ndarray      # [NP, W] valid + fully in-bounds (pre-threshold)
    num_terms: jnp.ndarray    # scalar


def _pattern_uv(u, v):
    """[..., 8] pattern coordinates (DSO staticPattern #8)."""
    du = jnp.asarray([o[0] for o in PATTERN_OFFSETS], jnp.float32)
    dv = jnp.asarray([o[1] for o in PATTERN_OFFSETS], jnp.float32)
    return u[..., None] + du, v[..., None] + dv


@partial(jax.jit, static_argnums=(1,))
def linearize(state: BAState, cfg: SLAMConfig) -> Linearization:
    """Linearize all (point, target) residuals at the current state with
    first-estimate Jacobians (geometry at zero states, photometric residual
    at current states) — DSO PointFrameResidual::linearize equivalent for
    the whole window at once.

    Jitted at the top level as well as being called inside optimize():
    the frontend's marginalization bookkeeping calls it directly, and an
    eager trace would be hundreds of individual dispatches."""
    W = state.num_slots
    NP = state.num_points
    D = 4 + 8 * W
    Himg, Wimg = state.images.shape[1], state.images.shape[2]
    huber = cfg.ba.huber_th

    fx0, fy0, cx0, cy0 = state.calib_zero
    fxc, fyc, cxc, cyc = state.calib_current()

    T_cur = state.T_current()                     # [W,4,4] worldToCam
    T_zero = state.T_zero
    aff = state.aff_current()                     # [W,2]

    # relative transforms for every (host, target) slot pair -------------
    T_wc_cur = jax.vmap(lie.se3_inverse)(T_cur)   # camToWorld current
    T_wc_zero = jax.vmap(lie.se3_inverse)(T_zero)
    # T_th[t, h] = T_cur[t] @ inv(T_cur[h])
    Tth_cur = jnp.einsum("tij,hjk->thik", T_cur, T_wc_cur, precision=_HI)
    Tth_zero = jnp.einsum("tij,hjk->thik", T_zero, T_wc_zero, precision=_HI)

    # per-point host data -------------------------------------------------
    h_idx = state.p_host                          # [NP]
    pu8, pv8 = _pattern_uv(state.p_u, state.p_v)  # [NP, 8]

    # back-projection at CURRENT calib/idepth for the residual warp,
    # and at ZERO calib/idepth for the Jacobian geometry.
    id_cur = jnp.maximum(state.p_idepth, 1e-6)
    id_zero = jnp.maximum(state.p_idepth_zero, 1e-6)
    Xh_cur = jnp.stack(
        [(pu8 - cxc) / fxc, (pv8 - cyc) / fyc, jnp.ones_like(pu8)], -1
    ) / id_cur[:, None, None]                     # [NP, 8, 3]
    Xh_zero = jnp.stack(
        [(pu8 - cx0) / fx0, (pv8 - cy0) / fy0, jnp.ones_like(pu8)], -1
    ) / id_zero[:, None, None]

    # gather per-point relative transforms to each target ----------------
    # via one-hot matmul (Tth_ph[p, t] = Tth[t, h_idx[p]]) rather than a
    # batched gather of [NP, W, 4, 4]: the [NP, Wh] x [Wh, W*16] einsum is
    # one small dense product.
    host_oh = jax.nn.one_hot(h_idx, W, dtype=jnp.float32)       # [NP, Wh]
    Tth_cur_ph = jnp.einsum(
        "ph,thij->ptij", host_oh, Tth_cur, precision=_HI)       # [NP, W, 4, 4]
    Tth_zero_ph = jnp.einsum(
        "ph,thij->ptij", host_oh, Tth_zero, precision=_HI)
    Rth_cur = Tth_cur_ph[..., :3, :3]            # [NP, W, 3, 3]
    tth_cur = Tth_cur_ph[..., :3, 3]             # [NP, W, 3]
    Rth_zero = Tth_zero_ph[..., :3, :3]
    tth_zero = Tth_zero_ph[..., :3, 3]

    # warp: current (residual) and zero (jacobian geometry)
    pt_cur = jnp.einsum("ptij,pkj->ptki", Rth_cur, Xh_cur, precision=_HI) + tth_cur[:, :, None, :]
    pt_zero = jnp.einsum("ptij,pkj->ptki", Rth_zero, Xh_zero, precision=_HI) + tth_zero[:, :, None, :]

    z_cur = pt_cur[..., 2]
    un_cur = pt_cur[..., 0] / z_cur
    vn_cur = pt_cur[..., 1] / z_cur
    Ku = fxc * un_cur + cxc                       # [NP, W, 8]
    Kv = fyc * vn_cur + cyc

    in_bounds = (
        (Ku > 1.1) & (Kv > 1.1) & (Ku < Wimg - 2.1) & (Kv < Himg - 2.1) & (z_cur > 1e-4)
    )

    # gather target intensities/gradients: vmap bilinear over frame slots.
    # NB: several alternative formulations (planes-first storage +
    # scalar-row gathers, frame-folded flat indices, and r3's rank-1
    # [M, 128]-tiled takes) measured 5-100x FASTER in isolated
    # microbenchmarks but SLOWER inside this program (the r3 A/B measured
    # the tiled-take form at 384 ms/KF sync vs 181 ms for this one); XLA's
    # in-context lowering choice dominates and only an in-program A/B is
    # meaningful here. That A/B predates the discovery that a device-side
    # renderer run degrades the whole session ~30x — re-run it clean via
    # DSSLAM_BA_TAKE_GATHER=1 (A/B only: the take form's different FMA
    # fusion shifts last ulps, so it must not silently become default).
    if os.environ.get("DSSLAM_BA_TAKE_GATHER") == "1":
        from ..ops.interp import bilinear_take_frames
        t_fold = jnp.arange(W, dtype=jnp.int32)[None, :, None]
        hit_i, gx, gy = bilinear_take_frames(state.images, t_fold, Ku, Kv)
    else:
        def gather_frame(img, u, v):
            return bilinear_gather(img, u, v)     # [NP, 8, 3]

        hit = jax.vmap(gather_frame)(
            state.images, Ku.transpose(1, 0, 2), Kv.transpose(1, 0, 2))
        hit = hit.transpose(1, 0, 2, 3)           # [NP, W, 8, 3]
        hit_i, gx, gy = hit[..., 0], hit[..., 1], hit[..., 2]

    # affine transfer host->target per (p, t)
    a_h = aff[h_idx, 0][:, None]
    b_h = aff[h_idx, 1][:, None]
    a_t = aff[None, :, 0]
    b_t = aff[None, :, 1]
    exp_h = state.exposure[h_idx][:, None]
    exp_t = state.exposure[None, :]
    a_th = jnp.exp(a_t - a_h) * (exp_t / jnp.maximum(exp_h, 1e-9))  # [NP, W]
    b_th = b_t - a_th * b_h

    residual = hit_i - (a_th[..., None] * state.p_color[:, None, :] + b_th[..., None])

    # per-pixel robust weights
    wp = state.p_weight[:, None, :]               # pattern gradient weight
    abs_r = jnp.abs(residual)
    hw = jnp.where(abs_r < huber, 1.0, huber / jnp.maximum(abs_r, 1e-12))

    # validity masks ------------------------------------------------------
    # (any pool row may host for any slot: the assembly below groups by
    # p_host with a one-hot projection, so the pool is one shared budget —
    # a well-textured KF can overflow past its P-row segment instead of
    # starving while other segments sit empty; VERDICT r1 item 8)
    t_idx = jnp.arange(W)[None, :]
    pair_mask = (
        state.p_valid[:, None]
        & state.frame_valid[None, :]
        & (t_idx != h_idx[:, None])
        & state.p_res_good
    )
    pix_ok = in_bounds & jnp.isfinite(hit_i) & pair_mask[..., None]

    # per-residual (pair) energy & outlier decision (DSO linearize)
    pix_energy = hw * residual * residual * (2.0 - hw) * wp * wp
    pair_energy = jnp.sum(jnp.where(pix_ok, pix_energy, 0.0), axis=-1)
    all_pix_in = jnp.all(in_bounds | ~pair_mask[..., None], axis=-1)
    th = jnp.maximum(state.energy_th[h_idx][:, None], state.energy_th[None, :])
    is_good = pair_mask & all_pix_in & (pair_energy < th)

    # ---- Jacobians (geometry at FEJ) -----------------------------------
    z0 = jnp.maximum(pt_zero[..., 2], 1e-6)
    un0 = pt_zero[..., 0] / z0
    vn0 = pt_zero[..., 1] / z0
    iz0 = 1.0 / z0
    gxf = gx * fx0                                # use zero-calib focal (FEJ)
    gyf = gy * fy0

    # d r / d pixel-normalized-coords chain: J_uv = [gx*fx, gy*fy]
    # target pose (left-increment on worldToCam), exactly the tracker J:
    Jt = jnp.stack(
        [
            iz0 * gxf,
            iz0 * gyf,
            -iz0 * (un0 * gxf + vn0 * gyf),
            -(un0 * vn0 * gxf + (1.0 + vn0 * vn0) * gyf),
            un0 * vn0 * gyf + (1.0 + un0 * un0) * gxf,
            un0 * gyf - vn0 * gxf,
        ],
        axis=-1,
    )                                              # [NP, W, 8, 6]

    # host pose: dp_t/ddelta_h = -R_th [I | -hat(X_h)];
    # J_h = (dr/dp_t) @ dp_t/ddelta_h. Build dr/dp_t [NP, W, 8, 3] first:
    dr_dpt = jnp.stack(
        [
            iz0 * gxf,
            iz0 * gyf,
            -iz0 * (un0 * gxf + vn0 * gyf),
        ],
        axis=-1,
    )                                              # [NP, W, 8, 3]
    # [I | -hat(Xh)] : [NP, 8, 3, 6]
    Xh = Xh_zero
    zero = jnp.zeros_like(Xh[..., 0])
    one = jnp.ones_like(Xh[..., 0])
    hatX = jnp.stack(
        [
            jnp.stack([zero, Xh[..., 2], -Xh[..., 1]], -1),
            jnp.stack([-Xh[..., 2], zero, Xh[..., 0]], -1),
            jnp.stack([Xh[..., 1], -Xh[..., 0], zero], -1),
        ],
        axis=-2,
    )                                              # [NP, 8, 3, 3] = -hat(X)
    I3 = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), hatX.shape)
    G = jnp.concatenate([I3, hatX], axis=-1)       # [NP, 8, 3, 6]
    RG = jnp.einsum("ptij,pkjl->ptkil", Rth_zero, G, precision=_HI)  # [NP,W,8,3,6]
    Jh = -jnp.einsum("ptki,ptkil->ptkl", dr_dpt, RG, precision=_HI)  # [NP,W,8,6]

    # idepth: dp_t/d id = -(R_th X_h)/id = -(pt_zero - t_th)/id
    dpt_did = -(pt_zero - tth_zero[:, :, None, :]) / id_zero[:, None, None, None]
    Jd = jnp.einsum("ptki,ptki->ptk", dr_dpt, dpt_did, precision=_HI)  # [NP, W, 8]

    # calib (fx fy cx cy): through projection and back-projection
    # projection part: dKu/dfx = un, dKu/dcx = 1; dKv/dfy = vn, dKv/dcy = 1
    # backprojection part: dXh/dfx = (-(u-cx)/fx^2, 0, 0)/id etc -> chain
    xh_x = (pu8 - cx0) / fx0                       # [NP, 8] normalized host x
    xh_y = (pv8 - cy0) / fy0
    # dXh/dfx = (-xh_x / fx0, 0, 0)/id ; dp_t/dfx = R_th @ dXh/dfx
    Rcol0 = Rth_zero[..., :, 0]                    # [NP, W, 3]
    Rcol1 = Rth_zero[..., :, 1]
    dpt_dfx = -(Rcol0[:, :, None, :] * (xh_x / fx0 / id_zero[:, None])[:, None, :, None])
    dpt_dfy = -(Rcol1[:, :, None, :] * (xh_y / fy0 / id_zero[:, None])[:, None, :, None])
    dpt_dcx = -(Rcol0[:, :, None, :] * (1.0 / fx0 / id_zero[:, None])[:, None, :, None])
    dpt_dcy = -(Rcol1[:, :, None, :] * (1.0 / fy0 / id_zero[:, None])[:, None, :, None])
    Jfx = gx * un0 + jnp.einsum("ptki,ptki->ptk", dr_dpt, dpt_dfx, precision=_HI)
    Jfy = gy * vn0 + jnp.einsum("ptki,ptki->ptk", dr_dpt, dpt_dfy, precision=_HI)
    Jcx = gx + jnp.einsum("ptki,ptki->ptk", dr_dpt, dpt_dcx, precision=_HI)
    Jcy = gy + jnp.einsum("ptki,ptki->ptk", dr_dpt, dpt_dcy, precision=_HI)
    Jcalib = jnp.stack([Jfx, Jfy, Jcx, Jcy], axis=-1)  # [NP, W, 8, 4]

    # affine: dr/da_t = -a_th (c - b_h); dr/da_h = +a_th (c - b_h);
    #         dr/db_t = -1;              dr/db_h = +a_th
    c_minus_bh = state.p_color[:, None, :] - b_h[..., None]
    Ja_t = -a_th[..., None] * c_minus_bh
    Ja_h = a_th[..., None] * c_minus_bh
    Jb_t = -jnp.ones_like(Ja_t)
    Jb_h = a_th[..., None] * jnp.ones_like(Ja_t)

    # ---- assemble H/b: block-factored form --------------------------------
    # Every (host s, target t) block shares one 20->D column placement.
    # Instead of materializing dense rows [R, D] (~71 MB at production
    # scale) and one big matmul, compute tiny per-(s,t) 20x20 Hessians and
    # project them: H = sum_st B_st^T H20 B_st. Points are grouped by their
    # ACTUAL p_host through a one-hot [NP, S] projection (not by pool
    # segment), so any row may host for any slot — the one-hot contraction
    # costs S x the segmented reshape on the 20x20 stage (4096 x 8 x 8 x
    # 400 multiply-adds at production scale).
    w_pix = jnp.where(is_good[..., None] & pix_ok, hw * wp * wp, 0.0)  # [NP,W,8]

    J20 = jnp.concatenate(
        [Jcalib, Jh, Ja_h[..., None], Jb_h[..., None],
         Jt, Ja_t[..., None], Jb_t[..., None]], axis=-1)           # [NP, W, 8, 20]
    S = W  # host groups == slots
    onehot = jax.nn.one_hot(h_idx, S, dtype=jnp.float32)           # [NP, S]

    # placement matrices B[s, t] : [20, D]; cols: calib 0:4, host 4+8s,
    # target 4+8t (static, built in numpy at trace time)
    B = np.zeros((S, W, 20, D), np.float32)
    for s_ in range(S):
        for t_ in range(W):
            B[s_, t_, 0:4, 0:4] = np.eye(4)
            B[s_, t_, 4:12, 4 + 8 * s_: 12 + 8 * s_] = np.eye(8)
            B[s_, t_, 12:20, 4 + 8 * t_: 12 + 8 * t_] += np.eye(8)
    B = jnp.asarray(B)

    H20 = jnp.einsum("ps,pwki,pwk,pwkj->swij", onehot, J20, w_pix, J20,
                     precision=_HI)
    b20 = jnp.einsum("ps,pwki,pwk,pwk->swi", onehot, J20, w_pix, residual,
                     precision=_HI)
    Hff = jnp.einsum("swia,swij,swjb->ab", B, H20, B, precision=_HI)
    bf = jnp.einsum("swia,swi->a", B, b20, precision=_HI)

    # Schur blocks grouped by point (host placement via the same one-hot)
    G20 = jnp.einsum("pwki,pwk,pwk->pwi", J20, w_pix, Jd, precision=_HI)
    Hfd = jnp.einsum("pwi,ps,swia->pa", G20, onehot, B, precision=_HI)
    Hdd = jnp.einsum("ptk,ptk,ptk->p", w_pix, Jd, Jd, precision=_HI)
    bd = jnp.einsum("ptk,ptk,ptk->p", w_pix, Jd, residual, precision=_HI)

    # idepth prior (initializer points): quadratic around idepth_zero
    Hdd = Hdd + state.p_prior
    bd = bd + state.p_prior * (state.p_idepth - state.p_idepth_zero)

    # energy bookkeeping: saturated residuals contribute the threshold
    e_contrib = jnp.where(is_good, pair_energy, jnp.where(pair_mask, th, 0.0))
    energy = jnp.sum(e_contrib)
    num_terms = jnp.sum(is_good.astype(jnp.float32)) * 8.0

    return Linearization(
        Hff=Hff, bf=bf, Hfd=Hfd, Hdd=Hdd, bd=bd,
        energy=energy, pair_energy=pair_energy, pair_good=is_good,
        pair_in=pair_mask & all_pix_in,
        num_terms=num_terms,
    )


# ---------------------------------------------------------------------------
# priors & solving
# ---------------------------------------------------------------------------


def _prior_diag(state: BAState, cfg: SLAMConfig) -> jnp.ndarray:
    """Diagonal prior over [D]: calib prior + first-KF pose anchor + affine
    mode priors (DSO FrameHessian::getPrior / CalibHessian prior)."""
    W = state.num_slots
    ba = cfg.ba
    mode_a, mode_b = cfg.tracker.affine_mode_a, cfg.tracker.affine_mode_b
    a_prior = ba.initial_aff_a_prior if mode_a < 0 else float(mode_a)
    b_prior = ba.initial_aff_b_prior if mode_b < 0 else float(mode_b)

    calib = jnp.full((4,), ba.initial_calib_hessian, jnp.float32)
    per_frame = jnp.concatenate(
        [
            jnp.zeros(6, jnp.float32),
            jnp.asarray([a_prior, b_prior], jnp.float32),
        ]
    )
    frames = jnp.tile(per_frame, W).reshape(W, 8)
    # invalid slots: freeze hard so the solve stays well-posed. The gauge
    # anchor (oldest KF) is handled by exact variable elimination in
    # solve_step, NOT by a huge prior — a hard prior fights the nullspace
    # projection and lets force-accept steps silently violate it.
    frames = jnp.where(state.frame_valid[:, None], frames, 1e12)
    return jnp.concatenate([calib, frames.reshape(-1)])


def anchor_slot(state: BAState) -> jnp.ndarray:
    """The gauge-anchor frame: the oldest valid KF in the window. Its pose
    and affine parameters are eliminated from every solve (held constant);
    absolute anchoring transfers into HM when it is marginalized."""
    fid = jnp.where(state.frame_valid, state.frame_id, jnp.int32(2**30))
    return jnp.argmin(fid)


def _free_mask(state: BAState) -> jnp.ndarray:
    """[D] bool: False for the anchor frame's 8 parameters."""
    W = state.num_slots
    D = 4 + 8 * W
    a = anchor_slot(state)
    idx = jnp.arange(D)
    in_anchor = (idx >= 4 + 8 * a) & (idx < 4 + 8 * a + 8)
    return ~in_anchor


def _state_vector(state: BAState) -> jnp.ndarray:
    """Current delta vector x = [calib_delta | frame deltas] (length D)."""
    return jnp.concatenate([state.calib_delta, state.delta.reshape(-1)])


def _nullspaces(state: BAState) -> jnp.ndarray:
    """Remaining gauge direction of the monocular photometric energy with
    the anchor frame eliminated: global scale (free frames translate along
    t_cw while all idepths rescale; cf. DSO's nullspaces_scale,
    FrontEndOptimize.cpp:563-571). The six global-motion directions are
    exactly fixed by the anchor-frame elimination. Returns N [D, 1]."""
    W = state.num_slots
    D = 4 + 8 * W
    T_cur = state.T_current()
    t_cw = T_cur[:, :3, 3]
    a = anchor_slot(state)
    N = jnp.zeros((D, 1), jnp.float32)
    for i in range(W):
        blk = jnp.where(state.frame_valid[i] & (i != a), 1.0, 0.0)
        N = N.at[4 + 8 * i : 4 + 8 * i + 3, 0].set(t_cw[i] * blk)
    return N


def _project_out_nullspace(x: jnp.ndarray, N: jnp.ndarray) -> jnp.ndarray:
    """x <- x - N (N^T N)^+ N^T x (DSO SOLVER_ORTHOGONALIZE_X_LATER)."""
    k = N.shape[1]
    NtN = jnp.matmul(N.T, N, precision=_HI) + 1e-6 * jnp.eye(k, dtype=jnp.float32)
    coef = jnp.linalg.solve(NtN, jnp.matmul(N.T, x[:, None], precision=_HI))
    return x - jnp.matmul(N, coef, precision=_HI)[:, 0]


def solve_step(state: BAState, lin: Linearization, lam: jnp.ndarray, cfg: SLAMConfig):
    """One GN/LM step: Schur over idepths, solve frame system, project the
    gauge nullspace out of the step, back-substitute idepths.
    Returns (x_frames [D], x_idepth [NP])."""
    W = state.num_slots
    D = 4 + 8 * W
    x0 = _state_vector(state)
    prior = _prior_diag(state, cfg)

    Hdd_mult = lin.Hdd * (1.0 + lam) + 1e-10
    inv_Hdd = jnp.where(lin.Hdd > 1e-10, 1.0 / Hdd_mult, 0.0)

    H_sc = jnp.matmul(lin.Hfd.T * inv_Hdd[None, :], lin.Hfd, precision=_HI)
    b_sc = jnp.matmul(lin.Hfd.T, (inv_Hdd * lin.bd)[:, None], precision=_HI)[:, 0]

    H = lin.Hff - H_sc + state.HM + jnp.diag(prior)
    b = lin.bf - b_sc + state.bM + jnp.matmul(state.HM, x0, precision=_HI) + prior * x0

    # eliminate the gauge-anchor frame's variables exactly: zero its
    # rows/cols and gradient; unit diagonal keeps the system non-singular.
    free = _free_mask(state)
    H = jnp.where(free[:, None] & free[None, :], H, 0.0)
    H = H + jnp.diag(jnp.where(free, 0.0, 1.0))
    b = jnp.where(free, b, 0.0)

    # precondition, damp, solve
    P = _precond(W)
    Hp = H * P[:, None] * P[None, :]
    bp = b * P
    Hp = Hp + lam * jnp.diag(jnp.diag(Hp)) + 1e-8 * jnp.eye(D, dtype=jnp.float32)
    xp = jnp.linalg.solve(Hp, -bp)
    x = xp * P

    # project the gauge directions (global SE(3) + scale) out of the step —
    # they are (near-)null for the photometric energy and otherwise absorb
    # arbitrarily large components that wreck FEJ consistency.
    x = _project_out_nullspace(x, _nullspaces(state))

    # back-substitute idepth steps
    x_d = inv_Hdd * (-lin.bd - jnp.matmul(lin.Hfd, x[:, None], precision=_HI)[:, 0])
    return x, x_d


def apply_step(state: BAState, x: jnp.ndarray, x_d: jnp.ndarray) -> BAState:
    W = state.num_slots
    calib_delta = state.calib_delta + x[:4]
    delta = state.delta + x[4:].reshape(W, 8)
    idepth = jnp.where(state.p_valid, state.p_idepth + x_d, state.p_idepth)
    return state._replace(calib_delta=calib_delta, delta=delta, p_idepth=idepth)


def _step_converged(x: jnp.ndarray, x_d: jnp.ndarray, state: BAState, cfg: SLAMConfig):
    """DSO doStepFromBackup convergence test (FrontEndOptimize.cpp:238-258)."""
    W = state.num_slots
    nf = jnp.maximum(jnp.sum(state.frame_valid.astype(jnp.float32)), 1.0)
    xf = x[4:].reshape(W, 8)
    msk = state.frame_valid[:, None].astype(jnp.float32)
    sumT = jnp.sum(msk * xf[:, 0:3] ** 2) / nf
    sumR = jnp.sum(msk * xf[:, 3:6] ** 2) / nf
    sumA = jnp.sum(msk[:, 0] * xf[:, 6] ** 2) / nf
    sumB = jnp.sum(msk[:, 0] * xf[:, 7] ** 2) / nf
    nid = jnp.maximum(jnp.sum(state.p_valid.astype(jnp.float32)), 1.0)
    sumNID = jnp.sum(jnp.where(state.p_valid, jnp.abs(state.p_idepth), 0.0)) / nid
    th = cfg.ba.th_opt_iterations
    return (
        (jnp.sqrt(sumA) < 0.0005 * th)
        & (jnp.sqrt(sumB) < 0.00005 * th)
        & (jnp.sqrt(sumR) < 0.00005 * th)
        & (jnp.sqrt(sumT) * sumNID < 0.00005 * th)
    )


def _optimize_impl(state: BAState, cfg: SLAMConfig, iterations):
    """The windowed BA loop (FrontEndOptimize.cpp:332-486). LM with an
    energy-based accept/reject (the reference's non-force-accept branch,
    FrontEndOptimize.cpp:427-449): a rejected step restores the backup and
    raises lambda x100. The energy compared includes the marginalization
    prior and state priors, so steps along prior-constrained directions are
    judged correctly.

    ``iterations`` is a TRACED scalar (dynamic while_loop bound): the
    frontend varies it with window size (20/15/6, FrontEnd.cpp:768-772) and
    a static bound would compile three separate BA programs.

    Cost structure: ONE linearization per iteration (the carry threads the
    current state's Linearization: an accepted step's lin_new becomes the
    next iteration's lin, a rejected step keeps the old one) plus one for
    the initial state, and the loop exits early once the step converges
    after min_opt_iterations (FrontEndOptimize.cpp:441-446 canbreak) — the
    naive 2-per-iteration + post-loop form costs ~2x the linearizations.

    Returns (state, rmse, energy_finite, final Linearization)."""

    def total_energy(st, lin):
        x = _state_vector(st)
        prior = _prior_diag(st, cfg)
        e_prior = jnp.dot(x, state_dot(st, x, prior), precision=_HI)
        return lin.energy + e_prior

    def state_dot(st, x, prior):
        return jnp.matmul(st.HM, x, precision=_HI) + 2.0 * st.bM + prior * x

    force_accept = cfg.ba.solver_force_accept_step

    def select(pred, a_tree, b_tree):
        return jax.tree_util.tree_map(
            lambda a, b: jnp.where(
                jnp.reshape(pred, (1,) * a.ndim) if a.ndim else pred, a, b
            ),
            a_tree, b_tree,
        )

    def body(carry):
        st, lin, lam, e_old, it, _ = carry
        x, x_d = solve_step(st, lin, lam, cfg)
        converged = _step_converged(x, x_d, st, cfg)
        st_new = apply_step(st, x, x_d)
        done = converged & (it + 1 >= cfg.ba.min_opt_iterations)
        if force_accept:
            # DSO default: always take the step (lambda still shrinks)
            do_apply = (~converged) | (it < cfg.ba.min_opt_iterations)
            st2 = select(do_apply, st_new, st)
            lin2 = linearize(st2, cfg)
            return (st2, lin2, lam * 0.25, e_old, it + 1, done)
        lin_new = linearize(st_new, cfg)
        e_new = total_energy(st_new, lin_new)
        # guard against the outlier-plateau escape: saturated residuals
        # contribute a CAPPED energy, so a wild step that flips most
        # residuals to outliers can "reduce" energy; require the inlier
        # count to survive as well
        accept = (e_new < e_old) & (
            lin_new.num_terms >= 0.3 * lin.num_terms)
        st2 = select(accept, st_new, st)
        lin2 = select(accept, lin_new, lin)
        lam2 = jnp.where(accept, lam * 0.25, jnp.minimum(lam * 100.0, 1e4))
        e2 = jnp.where(accept, e_new, e_old)
        return (st2, lin2, lam2, e2, it + 1, done)

    lin0 = linearize(state, cfg)
    e0 = total_energy(state, lin0)
    # lam/done seeded from a data-derived zero so the while carry's vma
    # typing is equal on both sides under jax.shard_map (no-op otherwise)
    zv = jnp.nan_to_num(e0) * 0.0
    lam0 = zv + 1e-1
    n_it = jnp.asarray(iterations, jnp.int32)
    state, lin, _, _, _, _ = jax.lax.while_loop(
        lambda c: (c[4] < n_it) & ~c[5], body,
        (state, lin0, lam0, e0, jnp.int32(0), zv > 1.0),
    )

    # the carried linearization matches the final state: no extra pass.
    # isOOB bookkeeping at the fix pass (FrontEndOptimize.cpp:60-66,
    # 146-152): numGoodResiduals grows by the number of residuals active
    # at this pass; lastResiduals toward the two newest KFs record their
    # final states (a residual that went OOB/OUTLIER here is dropped from
    # the active set by the p_res_good overwrite — exactly DSO's
    # toRemove deletion — but its recorded state survives for isOOB).
    t_idx = jnp.arange(state.num_slots)[None, :]
    participated = (state.p_valid[:, None] & state.frame_valid[None, :]
                    & (t_idx != state.p_host[:, None]) & state.p_res_good)
    pair_state = jnp.where(
        lin.pair_good, RES_IN,
        jnp.where(lin.pair_in, RES_OUTLIER,
                  jnp.where(participated, RES_OOB, RES_NONE)))
    fid = jnp.where(state.frame_valid, state.frame_id, -1)
    newest = jnp.argmax(fid)
    fid2 = fid.at[newest].set(-1)
    second = jnp.argmax(fid2)
    has2 = fid2[second] >= 0
    lr0 = jnp.where(participated[:, newest], pair_state[:, newest],
                    state.p_last_res[:, 0])
    lr1 = jnp.where(has2 & participated[:, second], pair_state[:, second],
                    state.p_last_res[:, 1])
    state = state._replace(
        p_res_good=lin.pair_good,
        p_num_good=state.p_num_good
        + jnp.sum(lin.pair_good, axis=1).astype(jnp.float32),
        p_last_res=jnp.stack([lr0, lr1], -1),
    )
    rmse = jnp.sqrt(lin.energy / jnp.maximum(lin.num_terms, 1.0))
    return state, rmse, jnp.isfinite(lin.energy), lin


@partial(jax.jit, static_argnums=(1,))
def optimize(state: BAState, cfg: SLAMConfig, iterations):
    """Windowed BA; see _optimize_impl. Returns (state, rmse, ok)."""
    state, rmse, ok, _ = _optimize_impl(state, cfg, iterations)
    return state, rmse, ok


# ---------------------------------------------------------------------------
# energy threshold + FEJ reset (post-optimize bookkeeping)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(2,))
def set_new_frame_energy_th(state: BAState, newest_slot: jnp.ndarray, cfg: SLAMConfig):
    """Percentile-based frame energy threshold for the newest frame
    (FrontEndOptimize.cpp:79-120)."""
    return set_new_frame_energy_th_from_lin(
        state, linearize(state, cfg), newest_slot, cfg)


def set_new_frame_energy_th_from_lin(state: BAState, lin: "Linearization",
                                     newest_slot, cfg: SLAMConfig):
    """Same, reusing an existing linearization of ``state`` (the fused
    keyframe program threads the BA loop's final lin here instead of
    paying another full pass)."""
    is_target = jnp.arange(state.num_slots)[None, :] == newest_slot
    # DSO quantiles over ALL residual energies toward the newest frame
    # (state_NewEnergyWithOutlier), NOT the already-thresholded survivors —
    # using survivors creates a threshold death spiral (each round's
    # quantile is biased low by the previous round's cut).
    sel = lin.pair_in & is_target
    e = jnp.where(sel, lin.pair_energy, jnp.nan)
    nth = jnp.nanquantile(e, cfg.ba.frame_energy_th_n)
    nth = jnp.where(jnp.isfinite(nth), jnp.sqrt(nth), 12.0 * jnp.sqrt(8.0))
    th = nth * cfg.ba.frame_energy_th_fac_median
    th = 26.0 * cfg.ba.frame_energy_th_const_weight + th * (
        1.0 - cfg.ba.frame_energy_th_const_weight
    )
    th = th * th * cfg.ba.overall_energy_th_weight**2
    return state._replace(energy_th=state.energy_th.at[newest_slot].set(th))


@jax.jit
def reset_fej_newest(state: BAState, newest_slot) -> BAState:
    """After optimization, move the newest frame's FEJ point to its current
    pose, keeping the affine delta (FrontEndOptimize.cpp:455-460)."""
    T_cur = state.T_current()
    slot_mask = jnp.arange(state.num_slots) == newest_slot
    T_zero = jnp.where(slot_mask[:, None, None], T_cur, state.T_zero)
    new_delta = state.delta.at[:, 0:6].set(
        jnp.where(slot_mask[:, None], 0.0, state.delta[:, 0:6])
    )
    return state._replace(T_zero=T_zero, delta=new_delta)


# ---------------------------------------------------------------------------
# marginalization
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(2,))
def marginalize_points(state: BAState, marg_mask: jnp.ndarray, cfg: SLAMConfig,
                       lin: "Linearization" = None):
    """Fold flagged points into the marginalization prior (HM, bM) via the
    Schur complement over their idepths (EnergyFunctional::marginalizePointsF),
    weighted by setting_margWeightFac, then invalidate them. Pass ``lin``
    (an existing linearization of ``state``) to skip recomputing the
    full-state pass — the keyframe tail already has one."""
    if lin is None:
        lin = linearize(state, cfg)
    m = (marg_mask & state.p_valid).astype(jnp.float32)
    inv_Hdd = jnp.where(lin.Hdd > 1e-10, 1.0 / lin.Hdd, 0.0) * m

    # rebuild the flagged points' own Hff/bf contribution: recompute from
    # per-point grouped blocks is cheaper than re-deriving rows; use the
    # identity Hff_p = sum over its rows — we re-linearize with only the
    # flagged points valid.
    st_only = state._replace(p_valid=state.p_valid & marg_mask)
    lin_p = linearize(st_only, cfg)

    H_sc = jnp.matmul(lin_p.Hfd.T * inv_Hdd[None, :], lin_p.Hfd, precision=_HI)
    b_sc = jnp.matmul(lin_p.Hfd.T, (inv_Hdd * lin_p.bd)[:, None], precision=_HI)[:, 0]

    w = cfg.ba.marg_weight_fac
    # the prior is quadratic around the CURRENT delta: shift bM accordingly
    x0 = _state_vector(state)
    dH = w * (lin_p.Hff - H_sc)
    db = w * (lin_p.bf - b_sc)
    HM = state.HM + dH
    bM = state.bM + db - jnp.matmul(dH, x0[:, None], precision=_HI)[:, 0]

    return state._replace(
        HM=HM, bM=bM, p_valid=state.p_valid & ~marg_mask
    )


@jax.jit
def drop_points(state: BAState, drop_mask: jnp.ndarray) -> BAState:
    """Drop points without folding them into the prior (outliers)."""
    return state._replace(p_valid=state.p_valid & ~drop_mask)


@jax.jit
def marginalize_frame(state: BAState, slot: jnp.ndarray):
    """Schur-remove a frame's 8 parameters from (HM, bM) and free its slot
    (EnergyFunctional::marginalizeFrame). The caller must have already
    dropped/marginalized all points hosted in the slot and all residuals
    targeting it (mirrors FrontEndMarginalize.cpp:148-215)."""
    W = state.num_slots
    D = 4 + 8 * W
    idx0 = 4 + 8 * slot
    onblock = (jnp.arange(D) >= idx0) & (jnp.arange(D) < idx0 + 8)

    HM, bM = state.HM, state.bM
    # transfer gauge anchoring: if the marginalized frame is the anchor,
    # add a strong pose prior to its block first, so the Schur complement
    # anchors the remaining frames absolutely (DSO folds the frame prior
    # into HM at marginalization, EnergyFunctional::marginalizeFrame).
    is_anchor = anchor_slot(state) == slot
    anchor_prior = jnp.where(is_anchor, 1e8, 0.0)
    diag_add = jnp.where(onblock, anchor_prior, 0.0)
    HM = HM + jnp.diag(diag_add)
    # gather the 8 rows/cols
    sel = jnp.nonzero(onblock, size=8, fill_value=0)[0]
    keep = ~onblock

    Hbb = HM[sel][:, sel]
    Hbb = Hbb + 1e-8 * jnp.eye(8, dtype=jnp.float32)
    Hab = HM[:, sel] * keep[:, None]              # [D, 8] rows outside block
    bb = bM[sel]

    Hbb_inv = jnp.linalg.inv(Hbb)
    HM_new = HM - jnp.matmul(jnp.matmul(Hab, Hbb_inv, precision=_HI), Hab.T, precision=_HI)
    bM_new = bM - jnp.matmul(Hab, jnp.matmul(Hbb_inv, bb[:, None], precision=_HI), precision=_HI)[:, 0]

    # zero the block rows/cols entirely
    mask2d = keep[:, None] & keep[None, :]
    HM_new = jnp.where(mask2d, HM_new, 0.0)
    bM_new = jnp.where(keep, bM_new, 0.0)

    frame_valid = state.frame_valid.at[slot].set(False)
    frame_id = state.frame_id.at[slot].set(-1)
    # invalidate any residuals targeting the slot & any points hosted there
    p_res_good = state.p_res_good.at[:, slot].set(False)
    p_valid = state.p_valid & (state.p_host != slot)
    # reset the slot's delta so _state_vector stays consistent with bM=0
    delta = state.delta.at[slot].set(0.0)

    return state._replace(
        HM=HM_new, bM=bM_new, frame_valid=frame_valid, frame_id=frame_id,
        p_res_good=p_res_good, p_valid=p_valid, delta=delta,
    )


# ---------------------------------------------------------------------------
# window management (host-side helpers; pure functions of the pytree)
# ---------------------------------------------------------------------------


@jax.jit
def current_views(state: BAState):
    """(T_current [W,4,4], aff_current [W,2], calib_current [4],
    frame_valid [W], frame_id [W], p_valid [NP], p_host [NP]) in ONE
    compiled dispatch. Host orchestration should call this (and pull the
    tuple with a single jax.device_get) instead of the eager BAState
    methods: one tuple pull blocks the host once, where separate pulls
    would block once each."""
    return (state.T_current(), state.aff_current(), state.calib_current(),
            state.frame_valid, state.frame_id, state.p_valid, state.p_host)


def _compact_points(state: BAState, budget: int):
    """Gather the pool's VALID rows (valid-first, original row order
    preserved by a stable sort) into a [budget]-row point state sharing the
    frame-level arrays. The BA programs are gather-bound and pool-SHAPED —
    cost scales with NP regardless of the valid mask — so running the
    window's ~2000 live points through a 2560-row view instead of the
    4096-row pool cuts the optimize work at identical results.

    Returns (sub_state, rows [budget], n_dropped). n_dropped > 0 means
    valid rows exceeded the budget and the compact result is WRONG (those
    points' residuals were silently excluded); the caller must detect it
    (it rides the keyframe bundle pull) and redo full-shape."""
    order = jnp.argsort(~state.p_valid, stable=True)
    rows = order[:budget]
    n_valid = jnp.sum(state.p_valid.astype(jnp.int32))
    n_dropped = jnp.maximum(n_valid - budget, 0)
    g = lambda a: a[rows]
    sub = state._replace(
        p_u=g(state.p_u), p_v=g(state.p_v), p_idepth=g(state.p_idepth),
        p_idepth_zero=g(state.p_idepth_zero), p_host=g(state.p_host),
        p_valid=g(state.p_valid), p_color=g(state.p_color),
        p_weight=g(state.p_weight), p_prior=g(state.p_prior),
        p_res_good=g(state.p_res_good), p_num_good=g(state.p_num_good),
        p_last_res=g(state.p_last_res))
    return sub, rows, n_dropped


def _scatter_points(full: BAState, work: BAState, rows) -> BAState:
    """Merge an optimized compact state back into the full pool: frame
    arrays (poses, deltas, calib, energy_th, HM/bM) come from ``work``;
    point arrays update at ``rows``, all other rows keep ``full``'s
    values (they were invalid at compaction time)."""
    return work._replace(
        p_u=full.p_u, p_v=full.p_v,
        p_idepth=full.p_idepth.at[rows].set(work.p_idepth),
        p_idepth_zero=full.p_idepth_zero, p_host=full.p_host,
        p_valid=full.p_valid.at[rows].set(work.p_valid),
        p_color=full.p_color, p_weight=full.p_weight, p_prior=full.p_prior,
        p_res_good=full.p_res_good.at[rows].set(work.p_res_good),
        p_num_good=full.p_num_good.at[rows].set(work.p_num_good),
        p_last_res=full.p_last_res.at[rows].set(work.p_last_res))


@partial(jax.jit, static_argnums=(1, 4))
def optimize_keyframe(state: BAState, cfg: SLAMConfig, iterations,
                      newest_slot, compact_budget: int = None):
    """Fused keyframe BA step: optimize -> percentile energy threshold for
    the newest frame -> FEJ reset -> drop residual-less points, all in ONE
    dispatch chain so the host pulls (rmse, ok) once instead of syncing
    between four programs (the stages mirror FrontEnd.cpp:773-798). The BA
    loop's final linearization is reused for the energy threshold and
    returned as the per-point idepth Hessian for the tracker template
    (DSO likewise reuses the optimization-time idepth_hessian in
    makeCoarseDepthL0, TAS.cpp:158 — it does not re-linearize post-FEJ).

    ``compact_budget`` routes the loop through a valid-row-compacted view
    of the point pool (see _compact_points); identical results as long as
    the window's valid count fits, and ``n_dropped`` reports when it did
    not (the frontend then redoes the step full-shape).

    Returns (state, rmse, ok, Hdd [NP], n_dropped)."""
    if compact_budget is None or compact_budget >= state.num_points:
        work, rows, n_dropped = state, None, jnp.int32(0)
    else:
        work, rows, n_dropped = _compact_points(state, compact_budget)
    work, rmse, ok, lin = _optimize_impl(work, cfg, iterations)
    work = set_new_frame_energy_th_from_lin(
        work, lin, jnp.int32(newest_slot), cfg)
    work = reset_fej_newest(work, jnp.int32(newest_slot))
    no_res = ~jnp.any(work.p_res_good & work.p_valid[:, None], axis=1)
    work = work._replace(p_valid=work.p_valid & ~no_res)
    if rows is None:
        return work, rmse, ok, lin.Hdd, n_dropped
    state = _scatter_points(state, work, rows)
    hdd = jnp.zeros(state.num_points, jnp.float32).at[rows].set(lin.Hdd)
    return state, rmse, ok, hdd, n_dropped


@partial(jax.jit, static_argnums=(1,))
def template_inputs(state: BAState, cfg: SLAMConfig, ref_slot, hdd=None):
    """Device-side makeCoarseDepthL0 input prep: project every window
    point into the reference KF and weight by the BA idepth hessian
    (TAS.cpp:143-176) — no host pull on the template path. Pass ``hdd``
    (the BA loop's final per-point idepth Hessian, from optimize_keyframe)
    to skip the fallback re-linearization."""
    if hdd is None:
        hdd = linearize(state, cfg).Hdd
    fx0, fy0, cx0, cy0 = state.calib_current()
    T_all = state.T_current()                      # [W, 4, 4] worldToCam
    T_ref = T_all[ref_slot]
    T_rh = jnp.einsum("ij,hjk->hik", T_ref,
                      jnp.linalg.inv(T_all), precision=_HI)
    Xh = jnp.stack([
        (state.p_u - cx0) / fx0,
        (state.p_v - cy0) / fy0,
        jnp.ones_like(state.p_u),
    ], -1) / jnp.maximum(state.p_idepth, 1e-6)[:, None]
    R = T_rh[state.p_host, :3, :3]
    t = T_rh[state.p_host, :3, 3]
    pt = jnp.einsum("pij,pj->pi", R, Xh, precision=_HI) + t
    proj_u = fx0 * pt[:, 0] / pt[:, 2] + cx0
    proj_v = fy0 * pt[:, 1] / pt[:, 2] + cy0
    new_id = 1.0 / jnp.maximum(pt[:, 2], 1e-6)
    valid = state.p_valid & (pt[:, 2] > 0)
    # weight = sqrt(1e-3 / HdiF) = sqrt(1e-3 * Hdd) (TAS.cpp:158)
    w = jnp.sqrt(1e-3 * jnp.maximum(hdd, 1e-9))
    return proj_u, proj_v, new_id, w, valid


@jax.jit
def add_frame(
    state: BAState,
    slot: int,
    frame_id: int,
    T_cw: np.ndarray,
    aff: np.ndarray,
    exposure: float,
    image_planes: jnp.ndarray,
) -> BAState:
    """Insert a keyframe into a free slot (EnergyFunctional::insertFrame).
    New residuals toward the new frame activate automatically through the
    dense [NP, W] residual grid. Jitted: one dispatch instead of ~9
    eager scatters (scalar args trace as weak-typed, so repeated calls
    hit the same executable)."""
    T_cw = jnp.asarray(T_cw, jnp.float32)
    aff = jnp.asarray(aff, jnp.float32)
    return state._replace(
        frame_valid=state.frame_valid.at[slot].set(True),
        frame_id=state.frame_id.at[slot].set(frame_id),
        T_zero=state.T_zero.at[slot].set(T_cw),
        delta=state.delta.at[slot].set(0.0),
        aff_zero=state.aff_zero.at[slot].set(aff),
        exposure=state.exposure.at[slot].set(exposure),
        images=state.images.at[slot].set(image_planes),
        energy_th=state.energy_th.at[slot].set(12.0 * 12.0 * 8.0),
        p_res_good=state.p_res_good.at[:, slot].set(True),
        # lastResiduals shift at KF add (FrontEnd.cpp:757-758): the new
        # residual toward this frame starts IN
        p_last_res=jnp.stack(
            [jnp.where(state.p_valid, RES_IN, RES_NONE),
             jnp.where(state.p_valid, state.p_last_res[:, 0], RES_NONE)], -1),
    )


@jax.jit
def add_points(
    state: BAState,
    free_idx: jnp.ndarray,     # [K] point-pool indices to fill
    host_slot: int,
    u: jnp.ndarray, v: jnp.ndarray, idepth: jnp.ndarray,
    color: jnp.ndarray, weight: jnp.ndarray,
    valid: jnp.ndarray,
    prior: jnp.ndarray = None,
) -> BAState:
    """Insert points into the pool. Jitted; scatters use mode="drop" so a
    caller can pass a FIXED-length batch padded with valid=False lanes
    (indices routed out of bounds) — one compiled executable regardless
    of how many points actually activate (a varying K would recompile
    per distinct count)."""
    if prior is None:
        prior = jnp.zeros_like(u)
    idx = jnp.where(valid, free_idx, state.num_points)  # OOB lane -> dropped
    return state._replace(
        p_valid=state.p_valid.at[idx].set(valid, mode="drop"),
        p_host=state.p_host.at[idx].set(host_slot, mode="drop"),
        p_u=state.p_u.at[idx].set(u, mode="drop"),
        p_v=state.p_v.at[idx].set(v, mode="drop"),
        p_idepth=state.p_idepth.at[idx].set(idepth, mode="drop"),
        p_idepth_zero=state.p_idepth_zero.at[idx].set(idepth, mode="drop"),
        p_color=state.p_color.at[idx].set(color, mode="drop"),
        p_weight=state.p_weight.at[idx].set(weight, mode="drop"),
        p_prior=state.p_prior.at[idx].set(prior, mode="drop"),
        p_res_good=state.p_res_good.at[idx, :].set(
            valid[:, None] & jnp.ones((1, state.num_slots), bool), mode="drop"
        ),
        # fresh activations start with residuals toward every window frame
        # (the dense grid above); DSO seeds lastResiduals IN toward the two
        # newest (FrontEndOptPoint.cpp:160-171)
        p_num_good=state.p_num_good.at[idx].set(0.0, mode="drop"),
        p_last_res=state.p_last_res.at[idx, :].set(RES_IN, mode="drop"),
    )
