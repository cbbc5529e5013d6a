"""Visual-odometry front end: the host orchestrator.

Equivalent of the reference's ``FrontEnd`` class
(FrontEnd.{h,cpp}) — per-frame coarse tracking with the motion-model
try-list, keyframe decision, the keyframe pipeline (trace -> flag
marginalization -> insert -> activate -> windowed BA -> scale opt -> point
removal -> new traces -> frame marginalization), and failure detection.
All numeric work runs in jitted device programs; this module owns the
control flow and the fixed-slot bookkeeping that replaces DSO's pointer
graph.

Threading note: the reference runs tracking and mapping in one thread with
a double-buffered tracker-reference swap (FrontEnd.cpp:627-632) and defers
loop closure to a background thread. Here the tracker template is rebuilt
synchronously per keyframe (pure-functional state, no locks), and
marginalized keyframes are appended to ``marginalized_queue`` for the loop
handler.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SLAMConfig
from ..geometry.camera import PyramidIntrinsics
from ..ops.distance_map import build_distance_map
from ..ops.interp import bilinear_gather, bilinear_take_plane
from ..ops.pyramid import Pyramid, build_pyramid_jit as build_pyramid
from ..ops.select import adapt_potential, make_selection_map
from ..utils.timing import StageTimers
from . import ba, immature, initializer
from .depth_template import TrackerTemplate, build_template, default_budgets, scale_template_idepth
from .scale_opt import (
    ScaleState,
    decide_scale_optimization,
    dispatch_scale_optimization,
)
from .tracker import (
    AffLight,
    make_motion_tries,
    select_winner,
    select_winner_serial,
    track_candidate_jit,
    track_candidates_batch,
)

_HI = jax.lax.Precision.HIGHEST


@jax.jit
def _const_motion_candidate(T_rn_last, T_rn_prelast):
    """Device-side constant-motion hypothesis (make_motion_tries stage1[0],
    FrontEnd.cpp:149): with T_rn = warp ref->frame, the reference's
    ``inv(slast_2_sprelast) @ lastF_2_slast`` reduces to
    ``Tl @ inv(Tp) @ Tl``.  Computed on device from device-resident track
    results, so a pipelined frame's dispatch needs no host pull of the
    previous frame's pose."""
    mm = partial(jnp.matmul, precision=_HI)
    return mm(mm(T_rn_last, jnp.linalg.inv(T_rn_prelast)), T_rn_last)


@partial(jax.jit, static_argnums=(3, 4))
def _halfres_distance_map(state, new_slot, K1, h2, w2):
    """Project every active point into the new KF at half resolution and
    build the activation distance map, all in one device program (no host
    pull, one dispatch per keyframe)."""
    fx0, fy0, cx0, cy0 = state.calib_current()
    T_all = state.T_current()
    T_cw_new = T_all[new_slot]
    T_nh = jnp.einsum("ij,hjk->hik", T_cw_new, jnp.linalg.inv(T_all),
                      precision=_HI)
    Xh = jnp.stack([
        (state.p_u - cx0) / fx0,
        (state.p_v - cy0) / fy0,
        jnp.ones_like(state.p_u),
    ], -1) / jnp.maximum(state.p_idepth, 1e-6)[:, None]
    R = T_nh[state.p_host, :3, :3]
    t = T_nh[state.p_host, :3, 3]
    pt = jnp.einsum("pij,pj->pi", R, Xh, precision=_HI) + t
    pu2 = K1[0, 0] * pt[:, 0] / pt[:, 2] + K1[0, 2]
    pv2 = K1[1, 1] * pt[:, 1] / pt[:, 2] + K1[1, 2]
    proj_ok = state.p_valid & (pt[:, 2] > 0)
    return build_distance_map(pu2, pv2, proj_ok, h2, w2)


def _gate_impl(pts, dist_map, KRKi1, Kt1, min_act_dist,
               host_flagged, cfg, w2, h2):
    """Device-side activation gate (FrontEnd.cpp:398-449): project each
    candidate into the new KF at half res with its mid idepth, look up the
    distance map, and emit (gate_ok, drop) masks. gate_ok covers the CHEAP
    gates only (pre-gates + projection + distance map); the expensive
    idepth-LM acceptance is applied afterwards on the compacted survivor
    set (see _gate_compact_activate). The drop rule is the reference's
    exact deletion policy: never-successfully-traced or outlier candidates
    go every pass (cpp:400-408); non-activatable candidates go when their
    HOST is flagged for marginalization or their trace went out of bounds
    (cpp:419-428); activatable candidates whose new-frame projection is
    out of bounds go too (cpp:447-449)."""
    can = immature.can_activate(pts, cfg)
    u1 = (pts.u + 0.5) / 2.0 - 0.5
    v1 = (pts.v + 0.5) / 2.0 - 0.5
    id_mid = 0.5 * (pts.idepth_min + jnp.minimum(pts.idepth_max, 1e3))
    xyz = jnp.stack([u1, v1, jnp.ones_like(u1)], -1)
    ptp = jnp.matmul(xyz, KRKi1.T, precision=_HI) + Kt1[None] * id_mid[:, None]
    z = ptp[:, 2]
    # bounds-test the UNCLIPPED rounded coords (DSO checks the raw int,
    # FrontEnd.cpp:434-437); clip only for the dist_map gather so lanes
    # that fail in_b still index safely. Clipping before the test made
    # the right/bottom checks vacuously true and the reference's deletion
    # of activatable-but-OOB candidates (cpp:447-449) never fired there.
    zs = jnp.where(z == 0, 1e-9, z)
    gu_raw = jnp.floor(ptp[:, 0] / zs + 0.5).astype(jnp.int32)
    gv_raw = jnp.floor(ptp[:, 1] / zs + 0.5).astype(jnp.int32)
    gu = jnp.clip(gu_raw, 0, w2 - 1)
    gv = jnp.clip(gv_raw, 0, h2 - 1)
    in_b = ((z > 0) & (gu_raw > 0) & (gv_raw > 0)
            & (gu_raw < w2 - 1) & (gv_raw < h2 - 1))
    # the reference adds frac(ptp[0]) — of the HOMOGENEOUS x, a DSO quirk
    # that acts as a U[0,1) dither lowering the effective threshold
    # (FrontEnd.cpp:439-440); replicated for behavior parity. Deliberate
    # deviation kept: DSO's addIntoDistFinal makes each acceptance update
    # the distance map for later candidates in the SAME pass; that
    # sequential dependency doesn't vectorize — this pass gates against
    # the pre-pass map only (slightly denser same-round activations).
    dither = ptp[:, 0] - jnp.floor(ptp[:, 0])
    gate = dist_map[gv, gu] + dither >= min_act_dist * pts.my_type
    gate_ok = can & in_b & gate
    never_traced = ~jnp.isfinite(pts.idepth_max) & (
        pts.status != immature.IPS_UNINITIALIZED)
    drop = pts.valid & (
        never_traced
        | (pts.status == immature.IPS_OUTLIER)
        | (~can & (host_flagged | (pts.status == immature.IPS_OOB)))
        | (can & ~in_b))
    return gate_ok, drop


@partial(jax.jit, static_argnums=(12, 13, 14, 15))
def _gate_compact_activate(imm, dist_map, KRKi1, Kt1, min_act_dist,
                           host_flagged, images, frame_valid, T_cw, aff,
                           calib, exposure, cfg, w2, h2, budget):
    """Gate-then-activate (round-3 perf restructure of FrontEnd.cpp:341-500).

    Running the 4-pass idepth-LM gather program over EVERY candidate lane
    ([S x NI x W x 8px]) and gating afterwards does most of its work on
    lanes that fail. Here the CHEAP gates (pre-gates, projection bounds,
    distance map) run on all lanes first, then the survivors of each slot
    are compacted IN LANE ORDER into a fixed [S, budget] subset and only
    that subset pays the LM — ~NI/budget (4-8x) less gather work at
    identical acceptance semantics: the final ok is gate_ok & lm_ok, and
    lane-order compaction reproduces the host's previous first-k insertion
    rule exactly whenever survivors <= budget. Overflow lanes stay
    immature for a later keyframe (the shared pool's existing policy).
    Returns (ok [S,B], idepth [S,B], lane [S,B] original lane map,
    drop [S,NI])."""
    gate_fn = lambda p, k, t, hf: _gate_impl(
        p, dist_map, k, t, min_act_dist, hf, cfg, w2, h2)
    gate_ok, drop = jax.vmap(gate_fn)(imm, KRKi1, Kt1, host_flagged)
    # compact survivors per slot, preserving lane order (stable sort keys:
    # ~gate_ok so True lanes come first)
    lane = jnp.argsort(~gate_ok, axis=1, stable=True)[:, :budget]
    sel_ok = jnp.take_along_axis(gate_ok, lane, axis=1)

    def take(a):
        idx = lane
        while idx.ndim < a.ndim:
            idx = idx[..., None]
        return jnp.take_along_axis(a, idx, axis=1)

    sub = jax.tree_util.tree_map(take, imm)
    S = gate_ok.shape[0]
    acts = immature.activate_points_all(
        sub, jnp.arange(S, dtype=jnp.int32), images, frame_valid,
        T_cw, aff, calib, exposure, cfg)
    ok = sel_ok & acts.ok
    return ok, acts.idepth, lane, drop


@partial(jax.jit, static_argnums=(5,))
def _allocate_candidates(ok, lane, drop, p_valid, participate, P):
    """Device-side emulation of the activation insertion allocator
    (bit-for-policy with the former host loop, which cost one blocking
    pull per KF): walk slots in
    ascending order; each slot's accepted candidates (compacted lane
    order) take the slot's OWN free pool segment rows first (ascending),
    then overflow into any other free rows (ascending), capped by the
    remaining pool capacity. Accepted-but-unplaced candidates are NOT
    consumed (they stay immature for a later KF); dropped candidates are
    consumed regardless.

    ok/lane: [S, BUD] compacted gate results; drop: [S, NI];
    p_valid: [B] pool occupancy; participate: [S] slots to process.
    Returns (src_slot, src_sub, src_lane, dst, host, valid) each [B]
    plus consumed [S, NI]."""
    S, BUD = ok.shape
    NI = drop.shape[1]
    B = p_valid.shape[0]
    i32 = jnp.int32
    rows = jnp.arange(B, dtype=i32)

    def body(s, carry):
        (free, n_fill, src_slot, src_sub, src_lane, dst, host, valid,
         consumed) = carry
        part = participate[s]
        accs = ok[s] & part                              # [BUD]
        n_acc = jnp.sum(accs.astype(i32))
        outside = (rows < s * P) | (rows >= (s + 1) * P)
        key = rows + outside.astype(i32) * B + (~free).astype(i32) * (4 * B)
        order = jnp.argsort(key).astype(i32)             # [B]
        n_free = jnp.sum(free.astype(i32))
        k = jnp.minimum(jnp.minimum(n_free, n_acc), B - n_fill)
        rank = jnp.cumsum(accs.astype(i32)) - 1          # [BUD]
        take = accs & (rank < k)
        gpos = jnp.where(take, n_fill + rank, B)         # B = dropped lane
        dstrow = order[jnp.clip(rank, 0, B - 1)]         # [BUD]
        sub = jnp.arange(BUD, dtype=i32)
        src_slot = src_slot.at[gpos].set(s, mode="drop")
        src_sub = src_sub.at[gpos].set(sub, mode="drop")
        src_lane = src_lane.at[gpos].set(lane[s], mode="drop")
        dst = dst.at[gpos].set(dstrow, mode="drop")
        host = host.at[gpos].set(s, mode="drop")
        valid = valid.at[gpos].set(True, mode="drop")
        free = free.at[jnp.where(take, dstrow, B)].set(False, mode="drop")
        row = drop[s] & part
        row = row.at[jnp.where(take, lane[s], NI)].set(True, mode="drop")
        consumed = consumed.at[s].set(row)
        return (free, n_fill + k, src_slot, src_sub, src_lane, dst, host,
                valid, consumed)

    init = (
        ~p_valid, jnp.int32(0),
        jnp.zeros(B, i32), jnp.zeros(B, i32), jnp.zeros(B, i32),
        jnp.zeros(B, i32), jnp.zeros(B, i32), jnp.zeros(B, bool),
        jnp.zeros((S, NI), bool),
    )
    out = jax.lax.fori_loop(0, S, body, init)
    (_, _, src_slot, src_sub, src_lane, dst, host, valid, consumed) = out
    return src_slot, src_sub, src_lane, dst, host, valid, consumed


@jax.jit
def _insert_candidates_all(state, imm, act_idepth, src_slot, src_sub_lane,
                           src_lane, dst_idx, valid, host):
    """Insert accepted candidates from EVERY slot into the point pool in
    ONE scatter (fixed pool-size batch; invalid lanes drop). src_lane
    indexes the full [S, NI] candidate set; src_sub_lane indexes the
    compacted [S, act_budget] activation outputs."""
    return ba.add_points(
        state, dst_idx, host,
        imm.u[src_slot, src_lane], imm.v[src_slot, src_lane],
        act_idepth[src_slot, src_sub_lane],
        imm.color[src_slot, src_lane], imm.weight[src_slot, src_lane],
        valid,
    )


@jax.jit
def _consume_candidates(imm, consumed):
    """Invalidate activated/dropped candidates ([S, NI] mask)."""
    return imm._replace(valid=imm.valid & ~consumed)


def _flag_points_for_removal(p_valid, pid_a, n_good, Hdd, pair_good,
                             p_num_good, p_last_res, host_flagged, flagged,
                             cfg):
    """flagPointsForRemoval (FrontEnd.cpp:504-583), host-side on pulled
    bundle-4 arrays. Returns (bad, leaving, marg, drop) boolean [NP] masks:

    - ``bad``: negative idepth or zero residuals -> plain drop (:533-537);
    - isOOB (DSO HessianBlocks.h via :538): PROACTIVE removal when (a) a
      well-established point's residual support would concentrate in
      frames leaving the window, (b) its newest-KF residual went OOB, or
      (c) its last two newest-KF residuals were outliers;
    - ``leaving`` = isOOB or host flagged; isInlierNew then gates Schur
      marginalization vs plain drop (:541-563), with the idepth-Hessian
      bar on top.

    Deviation (documented): n_good counts the bundle lin's (post-scale
    re-evaluated) active residuals where DSO reads the fix-pass survivor
    set; DSO also re-linearizes inlier points with resetOOB before the
    Hessian bar — the bundle lin IS a fresh linearization, same effect.
    The returned ``rules`` dict counts which clause fired (support
    concentration / newest-OOB / two-outliers / bad) so the definitional
    wobble's reach is measurable: only the support-concentration clause
    reads n_good against the threshold, so its share of removals bounds
    the deviation's possible effect (PARITY quantification, VERDICT r4
    item 7)."""
    mgar = cfg.ba.min_good_active_res_for_marg
    mgr = cfg.ba.min_good_res_for_marg
    bad = p_valid & ((pid_a < 0) | (n_good == 0))
    vis_in_marg = (pair_good[:, flagged].sum(1) if len(flagged)
                   else np.zeros_like(n_good))
    rule_support = ((n_good >= mgar) & (p_num_good > mgr + 10)
                    & (n_good - vis_in_marg < mgar))
    rule_oob = p_last_res[:, 0] == ba.RES_OOB
    rule_out2 = ((n_good >= 2) & (p_last_res[:, 0] == ba.RES_OUTLIER)
                 & (p_last_res[:, 1] == ba.RES_OUTLIER))
    is_oob = rule_support | rule_oob | rule_out2
    leaving = p_valid & ~bad & (host_flagged | is_oob)
    inlier_new = (n_good >= mgar) & (p_num_good >= mgr)
    marg = leaving & inlier_new & (Hdd > cfg.ba.min_idepth_h_marg)
    drop = bad | (leaving & ~marg)
    proactive = leaving & ~host_flagged     # isOOB fired while host stays
    rules = {
        "bad": int(bad.sum()),
        "support_concentration": int((proactive & rule_support).sum()),
        "newest_oob": int((proactive & rule_oob & ~rule_support).sum()),
        "two_outliers": int((proactive & rule_out2 & ~rule_support
                             & ~rule_oob).sum()),
        "host_leaving": int((leaving & host_flagged).sum()),
    }
    return bad, leaving, marg, drop, rules


@jax.jit
def _gather_level_colors(pyr_data, u, v):
    """Level-0 pixel coords [K] -> per-level interpolated intensity [K, L]
    in one compiled dispatch (loop-handler point export)."""
    cols = []
    for lvl, planes in enumerate(pyr_data):
        ul = (u + 0.5) / (1 << lvl) - 0.5
        vl = (v + 0.5) / (1 << lvl) - 0.5
        cols.append(bilinear_take_plane(planes[..., 0], ul, vl))
    return jnp.stack(cols, -1)


@dataclass
class TrackResultNp:
    """Host copy of the tracker-batch outputs (one device_get per batch)."""

    res_per_level: np.ndarray    # [N, L]
    flow: np.ndarray             # [N, 3]
    T: np.ndarray                # [N, 4, 4]
    aff: np.ndarray              # [N, 2]
    ok: np.ndarray               # [N]


@dataclass
class FrameShell:
    """Host record per processed frame (DSO FrameShell)."""

    incoming_id: int
    timestamp: float
    T_wc: np.ndarray                  # camToWorld
    aff: np.ndarray                   # (a, b)
    tracking_ref_kf: int = -1         # frame_id of the reference KF
    is_kf: bool = False
    exposure: float = 1.0             # ImageAndExposure exposure time


@dataclass
class MarginalizedKF:
    """Record handed to the loop handler when a KF leaves the window
    (reference FrontEndMarginalize.cpp:204 -> LoopHandler::publishKeyframes)."""

    kf_id: int
    incoming_id: int
    timestamp: float
    T_wc: np.ndarray
    dso_error: float
    scale_error: float
    # marginalized points, camera frame: [K, 3]; per-level colors [K, L]
    pts_cam: np.ndarray
    pts_colors: np.ndarray
    # level-0 pyramid planes of the KF (for direct loop alignment when this
    # frame is the CURRENT frame); dropped by the loop handler when done.
    pyr: Optional[tuple] = None
    exposure: float = 1.0


class FrontEnd:
    def __init__(
        self,
        cfg: SLAMConfig,
        intr0: PyramidIntrinsics,
        intr1: PyramidIntrinsics,
        t_cam1_cam0: np.ndarray,
        prev_kf_count: int = 0,
        timers: Optional[StageTimers] = None,
    ):
        self.cfg = cfg
        self.intr0 = intr0
        self.intr1 = intr1
        self.t_cam1_cam0 = np.asarray(t_cam1_cam0, np.float32)
        self.levels = cfg.tracker.pyr_levels

        self.n_slots = cfg.ba.max_frames + 1
        self.pool = self.n_slots * cfg.ba.max_points_per_frame
        H, W = intr0.h[0], intr0.w[0]
        calib = np.array([intr0.fx[0], intr0.fy[0], intr0.cx[0], intr0.cy[0]], np.float32)
        self.ba_state = ba.empty_state(self.n_slots, self.pool, H, W, calib)
        self.budgets = default_budgets(W, H, self.levels)

        # ONE stacked [S, NI] candidate pytree + a host set of live slots
        # (a dict of per-slot pytrees costs one device dispatch per slot
        # per stage; the stacked form makes trace/activate/gate single
        # vmapped dispatches — see immature.py "Stacked-window batch forms")
        self.imm_budget = cfg.ba.max_immature_per_frame
        self.immatures: immature.ImmaturePoints = immature.empty_batch(
            self.n_slots, self.imm_budget)
        self.imm_slots: set = set()
        self.pyramids: Dict[int, Pyramid] = {}   # per-slot full pyramids
        # (kept for loop-closure export: per-level colors + direct alignment)
        self.slot_stats: Dict[int, Dict[str, int]] = {}
        # point-removal rule attribution (PARITY quantification): counts
        # per flagPointsForRemoval clause + stay-host export volume
        self.removal_stats: Dict[str, int] = {}
        self.template: Optional[TrackerTemplate] = None
        self.template_kf_slot = -1
        self.template_ref_aff = AffLight(jnp.float32(0.0), jnp.float32(0.0))
        self.template_ref_aff_np = np.zeros(2, np.float32)
        self.template_ref_exposure = jnp.float32(1.0)
        self.template_ref_exposure_np = 1.0
        self.first_coarse_rmse = -1.0
        self.last_coarse_rmse = 1e9

        self.all_frames: List[FrameShell] = []
        self.kf_shells: List[FrameShell] = []
        self.prev_kf_count = prev_kf_count
        # num_kfs is the GLOBAL keyframe id counter (continues across
        # is_lost reinits via prev_kf_count); kf_shells holds only THIS
        # instance's shells, so every lookup is kf_shells[fid -
        # prev_kf_count]. Starting local-at-0 here would desync those
        # lookups after a reinit (shells resolve to None -> the
        # marginalized-KF export loses its incoming_id/timestamp).
        self.num_kfs = prev_kf_count

        self.initialized = False
        self.is_lost = False
        self.init_failed = False
        self.cur_pose = np.eye(4, dtype=np.float32)   # camToWorld

        self.scale_state = ScaleState()
        self.scale_errors: Dict[int, float] = {}      # per-slot
        self.slot_exposure: Dict[int, float] = {}     # per-slot exposure
        self._cur_exposure = 1.0
        self.last_dso_error = 10e5
        self.current_min_act_dist = 2.0
        self.pot = 5

        self.marginalized_queue: List[MarginalizedKF] = []
        # device-accumulated count of trace-search lanes past
        # cfg.trace.search_budget (pulled once, at the timing report)
        self._trace_overflow_acc = None
        # frames since the last keyframe event (trace tier selection)
        self._frames_since_kf = 0
        # isOOB-removed points whose HOST stays in the window: DSO keeps
        # them in host->pointHessiansMarginalized and exports them to the
        # loop handler only when the host itself marginalizes
        # (FrontEnd.cpp:554-556, LoopHandler.cpp:166-181). Keyed by slot:
        # list of (pts_cam [K,3], colors [K,1]) accumulated per KF event.
        self._marg_export_acc: Dict[int, list] = {}
        self.timers = timers if timers is not None else StageTimers()
        # deferred keyframe-tail commit (see _finalize_keyframe)
        self._pending_finalize = None
        # pipelined tracking (cfg.runtime.pipelined_tracking): one frame in
        # flight + device-resident motion state (T_rn_last, T_rn_prelast,
        # aff_last) so benign frames never block on a host pull
        self._pl_inflight = None
        self._pl_state = None
        # pipelined-mode observability: staged escalations and KF-flush
        # retracks actually exercised (asserted by the long-horizon test)
        self.pl_escalations = 0
        self.pl_retracks = 0
        # newest FULLY-PROCESSED shell (pose/is_kf final). In pipelined
        # mode add_stereo_frame returns the in-flight shell whose pose and
        # is_kf are placeholders until consumed one frame later; viewers and
        # debug dumps must read this instead (ADVICE r3, node.py:103)
        self.last_completed_shell: Optional[FrameShell] = None

        # monocular bootstrap state (cfg.runtime.mono_initializer)
        self.mono_state = None
        self._mono_first_pyr: Optional[Pyramid] = None
        self._mono_frames = 0

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _free_slot(self) -> int:
        valid = self._views_np()[3]
        for i in range(self.n_slots):
            if not valid[i]:
                return i
        raise RuntimeError("no free keyframe slot")

    def _newest_slot(self) -> int:
        views = self._views_np()
        valid, fid = views[3], views[4]
        fid = np.where(valid, fid, -1)
        return int(np.argmax(fid))

    def _active_slots(self) -> List[int]:
        views = self._views_np()
        valid, fid = views[3], views[4]
        slots = [i for i in range(self.n_slots) if valid[i]]
        return sorted(slots, key=lambda s: fid[s])

    def _views_np(self):
        """Host copies of (T_current, aff_current, calib_current,
        frame_valid, frame_id), one blocking pull, cached per BAState
        instance (the state pytree is immutable, so identity is a sound
        cache key)."""
        st = self.ba_state
        if getattr(self, "_views_cache_key", None) is not st:
            self._views_cache = jax.device_get(ba.current_views(st))
            self._views_cache_key = st
        return self._views_cache

    def _kf_pose(self, slot: int) -> np.ndarray:
        """camToWorld of a window KF (current estimate)."""
        T_cw = self._views_np()[0][slot]
        return np.linalg.inv(T_cw)

    # ------------------------------------------------------------------
    # main entry (reference addActiveStereoFrame, FrontEnd.cpp:585-686)
    # ------------------------------------------------------------------

    def add_stereo_frame(self, img0: jnp.ndarray, img1: jnp.ndarray,
                         incoming_id: int, timestamp: float,
                         exposure: float = 1.0) -> FrameShell:
        """``exposure`` is the left image's exposure time (the reference's
        ImageAndExposure; 1.0 when unknown). It enters the brightness
        transfer exactly as DSO's AffLight::fromToVecExposure — tracker,
        windowed BA, trace, and the keyframe/marginalization affine gates
        all scale by exposure ratios."""
        # guard: a 0/negative exposure (unrecorded rows in TUM-monoVO
        # times files) would reach the exp_t/exp_h ratios as a division by
        # zero; DSO's ImageFolderReader repairs such rows, and the dataset
        # reader here does too, but clamp at the pipeline entry regardless
        self._cur_exposure = max(float(exposure), 1e-6)
        pyr0 = build_pyramid(img0, self.levels)

        if not self.initialized:
            shell = self._initialize(pyr0, img1, incoming_id, timestamp)
            if not self.initialized or getattr(shell, "_flow", None) is None:
                return shell
            # mono init just completed AND tracked the current frame: fall
            # through so it gets the keyframe decision like any other frame
        elif (self.cfg.runtime.pipelined_tracking
              and self.cfg.tracker.winner_policy != "serial"):
            return self._process_pipelined(pyr0, img1, incoming_id, timestamp)
        else:
            shell = self._track_frame(pyr0, incoming_id, timestamp)
        if self.is_lost:
            return shell

        need_kf = self._keyframe_decision(shell)
        if need_kf:
            self._make_keyframe(shell, pyr0, img1)
        else:
            self._make_non_keyframe(shell, pyr0)
        self.last_completed_shell = shell
        return shell

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------

    def _initialize(self, pyr0: Pyramid, img1, incoming_id, timestamp) -> FrameShell:
        if self.cfg.runtime.mono_initializer:
            return self._initialize_mono(pyr0, incoming_id, timestamp)
        pyr1 = build_pyramid(img1, self.levels)
        res = initializer.initialize_from_stereo(
            pyr0, pyr1, self.intr0, self.t_cam1_cam0, self.cfg,
            budget=self.cfg.ba.max_immature_per_frame, pot=self.pot,
        )
        shell = FrameShell(incoming_id, timestamp, self.cur_pose.copy(),
                           np.zeros(2, np.float32),
                           exposure=self._cur_exposure)
        self.all_frames.append(shell)
        if not res.ok:
            return shell

        # subsample to the desired density (FrontEnd.cpp:870-881)
        valid = np.asarray(res.valid)
        n_have = valid.sum()
        keep_frac = min(1.0, self.cfg.ba.desired_point_density / max(n_have, 1))
        rng = np.random.RandomState(0)
        keep = valid & (rng.rand(len(valid)) < keep_frac)

        slot = 0
        T_cw = np.linalg.inv(self.cur_pose).astype(np.float32)
        self.ba_state = ba.add_frame(
            self.ba_state, slot, self.num_kfs, T_cw, np.zeros(2),
            shell.exposure, pyr0.data[0],
        )
        self.slot_exposure[slot] = shell.exposure
        # fixed-length padded batch (see _insert_candidates_all): one compiled
        # shape even across reinits with different survivor counts
        P = self.cfg.ba.max_points_per_frame
        cap = min(P, len(valid))
        k = min(cap, int(keep.sum()))
        src = np.zeros(P, np.int32)
        src[:k] = np.nonzero(keep)[0][:k]
        pvalid = np.arange(P) < k
        self.ba_state = ba.add_points(
            self.ba_state, jnp.arange(P), slot,
            res.u[jnp.asarray(src)], res.v[jnp.asarray(src)],
            res.idepth[jnp.asarray(src)],
            res.color[jnp.asarray(src)], res.weight[jnp.asarray(src)],
            jnp.asarray(pvalid),
            prior=jnp.full((P,), self.cfg.ba.idepth_fix_prior, jnp.float32),
        )
        self.slot_stats[slot] = {"out": 0, "marg": 0}
        self.pyramids[slot] = pyr0
        shell.is_kf = True
        shell.tracking_ref_kf = self.num_kfs
        self.kf_shells.append(shell)
        self.num_kfs += 1

        self._make_new_traces(slot, pyr0)
        self._build_template(slot, pyr0)
        self.initialized = True
        return shell

    def _initialize_mono(self, pyr0: Pyramid, incoming_id, timestamp) -> FrameShell:
        """DSO-parity monocular bootstrap (FrontEnd.cpp:607-623, 842-934):
        CoarseInitializer setFirst/trackFrame until snapped+5, then promote
        the FIRST frame to keyframe 0 with the converged (mean-idepth-1
        rescaled) point field. The right camera is never touched — metric
        scale arrives later from the stereo scale optimizer (or never, in
        pure DSO mode with scale_opt.accept_thres = -1)."""
        from . import mono_init

        if self.mono_state is None:
            self.mono_state = mono_init.create(
                pyr0, self.cfg, budget=self.cfg.ba.max_immature_per_frame,
                pot=self.pot)
            self._mono_first_pyr = pyr0
            self._mono_frames = 0
            shell = FrameShell(incoming_id, timestamp, self.cur_pose.copy(),
                               np.zeros(2, np.float32),
                               exposure=self._cur_exposure)
            self.all_frames.append(shell)
            self._mono_first_shell = shell
            return shell

        self.mono_state = mono_init.track_frame(
            self.mono_state, tuple(pyr0.data), self.intr0, self.cfg)
        self._mono_frames += 1
        if not mono_init.is_done(self.mono_state):
            if self._mono_frames > self.cfg.runtime.mono_init_max_frames:
                # restart from the current frame (DSO resets a stale
                # initializer rather than grinding on a dead baseline)
                self.mono_state = mono_init.create(
                    pyr0, self.cfg,
                    budget=self.cfg.ba.max_immature_per_frame, pot=self.pot)
                self._mono_first_pyr = pyr0
                self._mono_frames = 0
                shell = FrameShell(incoming_id, timestamp,
                                   self.cur_pose.copy(),
                                   np.zeros(2, np.float32),
                                   exposure=self._cur_exposure)
                self.all_frames.append(shell)
                self._mono_first_shell = shell
                return shell
            shell = FrameShell(incoming_id, timestamp, self.cur_pose.copy(),
                               np.zeros(2, np.float32),
                               exposure=self._cur_exposure)
            self.all_frames.append(shell)
            return shell

        # ---- snapped: first frame becomes keyframe 0 ----------------------
        u, v, idepth, T_first_new, _rescale = mono_init.to_points(self.mono_state)
        # seed the first post-init track with the converged bootstrap pose
        # (ref -> current warp; the reference carries firstToNew the same
        # way through initializeFromInitializer, FrontEnd.cpp:914-929)
        self._post_init_T_hint = np.asarray(T_first_new, np.float64)
        if len(u) < 8:
            # degenerate convergence: restart from the current frame
            self.mono_state = None
            self._mono_first_pyr = None
            shell = FrameShell(incoming_id, timestamp, self.cur_pose.copy(),
                               np.zeros(2, np.float32),
                               exposure=self._cur_exposure)
            self.all_frames.append(shell)
            return shell
        first_pyr = self._mono_first_pyr
        slot = 0
        T_cw = np.linalg.inv(self.cur_pose).astype(np.float32)
        first_exp = self._mono_first_shell.exposure
        self.ba_state = ba.add_frame(
            self.ba_state, slot, self.num_kfs, T_cw, np.zeros(2),
            first_exp, first_pyr.data[0],
        )
        self.slot_exposure[slot] = first_exp
        # pattern colors + gradient weights at the converged points
        # (ImmaturePoint-ctor equivalents; FrontEnd.cpp:884-893)
        P = self.cfg.ba.max_points_per_frame
        keep_frac = min(1.0, self.cfg.ba.desired_point_density / max(len(u), 1))
        rng = np.random.RandomState(0)
        keep = rng.rand(len(u)) < keep_frac
        k = min(P, int(keep.sum()))
        src = np.zeros(P, np.int32)
        src[:k] = np.nonzero(keep)[0][:k]
        pvalid = np.arange(P) < k
        uu = jnp.asarray(u[src], jnp.float32)
        vv = jnp.asarray(v[src], jnp.float32)
        pu8, pv8 = ba._pattern_uv(uu, vv)
        hit = bilinear_gather(first_pyr.data[0], pu8, pv8)     # [P, 8, 3]
        color = hit[..., 0]
        g2 = hit[..., 1] ** 2 + hit[..., 2] ** 2
        c2 = self.cfg.ba.outlier_th_sum_component
        weight = jnp.sqrt(c2 / (c2 + g2))
        self.ba_state = ba.add_points(
            self.ba_state, jnp.arange(P), slot, uu, vv,
            jnp.asarray(idepth[src], jnp.float32), color, weight,
            jnp.asarray(pvalid),
            prior=jnp.full((P,), self.cfg.ba.idepth_fix_prior, jnp.float32),
        )
        self.slot_stats[slot] = {"out": 0, "marg": 0}
        self.pyramids[slot] = first_pyr
        first_shell = self._mono_first_shell
        first_shell.is_kf = True
        first_shell.tracking_ref_kf = self.num_kfs
        self.kf_shells.append(first_shell)
        self.num_kfs += 1

        self._make_new_traces(slot, first_pyr)
        self._build_template(slot, first_pyr)
        self.initialized = True
        self.mono_state = None
        self._mono_first_pyr = None

        # the CURRENT frame then goes through the normal tracking path
        # (DSO delivers it to makeKeyFrame; here the KF decision fires
        # naturally on the init parallax)
        shell = self._track_frame(pyr0, incoming_id, timestamp)
        return shell

    # ------------------------------------------------------------------
    # tracking (reference trackNewCoarse, FrontEnd.cpp:120-274)
    # ------------------------------------------------------------------

    def _track_frame(self, pyr0: Pyramid, incoming_id, timestamp) -> FrameShell:
        ref_slot = self.template_kf_slot
        T_w_ref = self._kf_pose(ref_slot)

        # motion model from the last two frames
        if len(self.all_frames) >= 2 and self.all_frames[-1].tracking_ref_kf >= 0:
            slast = self.all_frames[-1]
            sprelast = self.all_frames[-2] if len(self.all_frames) >= 2 else slast
            slast_2_sprelast = np.linalg.inv(sprelast.T_wc) @ slast.T_wc
            lastF_2_slast = np.linalg.inv(slast.T_wc) @ T_w_ref
            aff_init = AffLight(jnp.float32(slast.aff[0]), jnp.float32(slast.aff[1]))
            stage1, stage2 = make_motion_tries(
                np.eye(4), lastF_2_slast, slast_2_sprelast, self.cfg
            )
        else:
            # first tracked frame after initialization: no motion history.
            # The reference's 2-frame case degenerates to an empty try list
            # (FrontEnd.cpp:133-135, a known quirk); here the bootstrap's
            # converged first-to-current pose (mono initializer) seeds the
            # primary candidate — identity alone would force the LM to
            # re-find the whole init baseline — with identity + the 78
            # rotation perturbations as fallback coverage.
            seed = getattr(self, "_post_init_T_hint", None)
            if seed is not None:
                stage1 = np.stack([seed.astype(np.float32),
                                   np.eye(4, dtype=np.float32)])
                self._post_init_T_hint = None
            else:
                stage1 = np.stack([np.eye(4, dtype=np.float32)])
            _, stage2 = make_motion_tries(np.eye(4), np.eye(4), np.eye(4), self.cfg)
            aff_init = AffLight(jnp.float32(0.0), jnp.float32(0.0))

        with self.timers.span("track"):
            # staged candidate evaluation (the reference's serial try-list
            # early exit, FrontEnd.cpp:200-247, as growing batches): the
            # constant-motion hypothesis alone wins on almost every frame;
            # the 5 motion-model variants and the 78 rotation perturbations
            # only run on tracking trouble.
            thr = self.cfg.tracker.re_track_threshold * self.last_coarse_rmse

            # per-slot immature counts ride the SAME pull as the tracker
            # outputs: the keyframe pipeline needs them (marginalization
            # flagging, FrontEndMarginalize.cpp:100-107) and pulling them
            # there would cost one more blocking pull per KF
            counts_dev = jnp.sum(self.immatures.valid, axis=1)

            def run(batch, selector=select_winner):
                if len(batch) == 1:
                    # steady-state fast path: the single-candidate program
                    # rather than the vmapped batch-of-1 form
                    r = track_candidate_jit(
                        tuple(pyr0.data), self.template, self.intr0,
                        self.cfg, jnp.asarray(batch[0]), aff_init,
                        self.template_ref_aff, self.template_ref_exposure,
                        jnp.float32(self._cur_exposure),
                    )
                    lift = lambda x: x[None]
                else:
                    r = track_candidates_batch(
                        tuple(pyr0.data), self.template, self.intr0, self.cfg,
                        jnp.asarray(batch), aff_init, self.template_ref_aff,
                        self.template_ref_exposure,
                        jnp.float32(self._cur_exposure),
                    )
                    lift = lambda x: x
                # the previous KF's deferred tail commits HERE: its bundle
                # pull rides the same wait as the just-dispatched track
                # program (the commit's own device ops queue behind it)
                self.flush_pending()
                # one transfer for everything the host needs from the batch
                pulled = jax.device_get((
                    lift(r.res_per_level), lift(r.flow), lift(r.T),
                    lift(jnp.stack([r.aff.a, r.aff.b], -1)), lift(r.ok),
                    counts_dev))
                r_np = TrackResultNp(*pulled[:5])
                self._track_imm_counts = pulled[5]
                # keyed on the immatures pytree identity: any later update
                # (trace, activation consume, slot clear) invalidates it
                self._track_imm_counts_key = self.immatures
                i, g = selector(r_np, self.last_coarse_rmse, self.cfg)
                return r_np, i, g

            if self.cfg.tracker.winner_policy == "serial":
                # parity / A/B mode: evaluate the FULL ordered try-list in
                # one batch, then walk it with the reference's serial
                # achievedRes rule (FrontEnd.cpp:198-248)
                res, idx, good = run(
                    np.concatenate([stage1, stage2], axis=0),
                    selector=select_winner_serial)
            else:
                # escalation batches use the reference's serial selection
                # rule over the already-computed batch: free once the batch
                # ran, and the A/B harness measured it strictly better past
                # the tracker's turn-rate limit (fast-rotation lap ATE 0.78
                # vs 1.15 m) with identical choices on benign scenes
                # (PARITY.md "Policy A/B deltas")
                res, idx, good = run(stage1[:1])
                if not good or float(res.res_per_level[idx, 0]) > thr:
                    res5, idx5, good5 = run(stage1,
                                            selector=select_winner_serial)
                    if good5 and (not good or float(res5.res_per_level[idx5, 0])
                                  < float(res.res_per_level[idx, 0])):
                        res, idx, good = res5, idx5, good5
                if not good or float(res.res_per_level[idx, 0]) > thr:
                    res2, idx2, good2 = run(stage2,
                                            selector=select_winner_serial)
                    if good2 and (not good or float(res2.res_per_level[idx2, 0])
                                  < float(res.res_per_level[idx, 0])):
                        res, idx, good = res2, idx2, good2

        shell = FrameShell(incoming_id, timestamp, self.cur_pose.copy(),
                           np.zeros(2, np.float32),
                           exposure=self._cur_exposure)
        self.all_frames.append(shell)

        r0 = float(res.res_per_level[idx, 0])
        flow = res.flow[idx]
        if not math.isfinite(r0) or not np.all(np.isfinite(flow)):
            # non-finite tracking residual -> lost (FrontEnd.cpp:635-640)
            self.is_lost = True
            return shell
        if not good:
            # "BIG ERROR": take the predicted pose and hope to recover
            # (FrontEnd.cpp:249-255) — candidate 0 is the motion model
            idx = 0
            flow = np.zeros(3, np.float32)
            r0 = float(res.res_per_level[0, 0])

        T_ref_new = res.T[idx]                        # warp ref->new
        shell.T_wc = (T_w_ref @ np.linalg.inv(T_ref_new)).astype(np.float32)
        shell.aff = res.aff[idx].copy()
        shell.tracking_ref_kf = int(self._views_np()[4][ref_slot])
        shell._T_ref_new = T_ref_new
        shell._flow = flow
        shell._res0 = r0
        self.cur_pose = shell.T_wc
        if self.first_coarse_rmse < 0:
            self.first_coarse_rmse = r0
        self.last_coarse_rmse = r0
        return shell

    # ------------------------------------------------------------------
    # pipelined tracking (cfg.runtime.pipelined_tracking)
    # ------------------------------------------------------------------
    # The synchronous per-frame path blocks once per frame: on the tracker
    # pull that all host decisions (pose bookkeeping, KF decision,
    # escalation) hang off, which serializes host work and device work.
    # Pipelined mode hides it: frame N's track
    # program dispatches IMMEDIATELY with a device-computed constant-motion
    # candidate (_const_motion_candidate over device-resident results of
    # N-1/N-2 — no host data needed), its outputs start a copy_to_host_async,
    # and only THEN is frame N-1's (already-arrived) result consumed and
    # fully processed.  Benign frames therefore block ~0 ms on the pull;
    # the steady-state period approaches max(host work, device work)
    # instead of their sum.
    #
    # Semantics vs the synchronous path (all deviations one frame deep,
    # A/B'd in tests/test_pipelined_tracking.py + PARITY.md):
    #  - the keyframe decision/pipeline for frame N-1 runs while frame N is
    #    already in flight, so frame N tracks against the PRE-keyframe
    #    template (the reference, being synchronous, would use the new
    #    one).  The world-frame pose stays correct — it is composed from
    #    the template ref pose the frame was actually tracked against.
    #  - escalation (the staged try-list) is detected one frame late and
    #    re-runs synchronously; any keyframe / escalation / lost event
    #    flushes the pipeline (the in-flight successor consumes
    #    synchronously) and reseeds the device motion state from host
    #    shells, so error never compounds.
    #  - is_lost / init_failed surface one frame later than the reference's
    #    synchronous driver would see them (runtime/node.py re-checks every
    #    frame, so recovery still triggers).

    def _process_pipelined(self, pyr0: Pyramid, img1, incoming_id,
                           timestamp) -> FrameShell:
        if self._pl_state is None:
            # no device motion state yet (post-init / post-flush-reset /
            # post-escalation): one synchronous frame, then seed
            shell = self._track_frame(pyr0, incoming_id, timestamp)
            if self.is_lost:
                return shell
            if self._keyframe_decision(shell):
                self._make_keyframe(shell, pyr0, img1)
            else:
                self._make_non_keyframe(shell, pyr0)
            self.last_completed_shell = shell
            self._pl_seed()
            return shell

        # ---- dispatch frame N (pull-free) -------------------------------
        with self.timers.span("track"):
            Tl, Tp, aff_dev = self._pl_state
            T_cand = _const_motion_candidate(Tl, Tp)
            r = track_candidate_jit(
                tuple(pyr0.data), self.template, self.intr0, self.cfg,
                T_cand, aff_dev, self.template_ref_aff,
                self.template_ref_exposure, jnp.float32(self._cur_exposure))
            counts_dev = jnp.sum(self.immatures.valid, axis=1)
            out = (r.res_per_level, r.flow, r.T,
                   jnp.stack([r.aff.a, r.aff.b], -1), r.ok, counts_dev)
            jax.tree_util.tree_map(
                lambda a: a.copy_to_host_async()
                if hasattr(a, "copy_to_host_async") else None, out)
            # optimistic device-state update (assumes the primary candidate
            # wins — true on almost every frame; escalation reseeds)
            self._pl_state = (r.T, Tl, r.aff)
        # the previous KF's deferred tail commits here: its bundle pull
        # rides the wait of the just-dispatched track program
        self.flush_pending()

        prev = self._pl_inflight
        shell = FrameShell(incoming_id, timestamp, self.cur_pose.copy(),
                           np.zeros(2, np.float32),
                           exposure=self._cur_exposure)
        self.all_frames.append(shell)
        ref_slot = self.template_kf_slot
        self._pl_inflight = {
            "shell": shell, "pyr": pyr0, "img1": img1, "out": out,
            "ref_slot": ref_slot,
            "ref_kf_id": int(self._views_np()[4][ref_slot]),
            "T_w_ref": self._kf_pose(ref_slot),
            "frame_idx": len(self.all_frames) - 1,
            "counts_key": self.immatures,
        }

        # ---- consume frame N-1 ------------------------------------------
        if prev is not None:
            flushed = self._pl_consume(prev)
            if self.is_lost or self.init_failed:
                self._pl_reset()
                return shell
            if flushed:
                # the in-flight successor's candidate/template context is
                # stale (a KF rebuilt the template, or escalation moved the
                # motion model): discard its result and re-track it
                # synchronously against the CURRENT template — exactly what
                # the synchronous path would have computed for it
                inf = self._pl_inflight
                self._pl_inflight = None
                self._pl_consume(inf, retrack=True)
                if self.is_lost or self.init_failed:
                    self._pl_reset()
                    return shell
                self._pl_seed()
        return shell

    def _pl_consume(self, inf, retrack: bool = False) -> bool:
        """Complete a pipelined frame: pull its track result, accept or
        escalate, run shell bookkeeping, keyframe decision and the
        keyframe/non-keyframe pipeline.  Returns True when the pipeline
        must flush (keyframe, escalation, BIG-ERROR or lost): the
        in-flight successor's candidate/template context is stale.

        ``retrack=True`` discards the in-flight result and re-tracks the
        frame synchronously against the CURRENT template (used on pipeline
        flush, where the dispatched program ran against a stale one)."""
        shell = inf["shell"]
        with self.timers.span("track"):
            if retrack:
                self.pl_retracks += 1
                pulled = self._pl_retrack(inf)
            else:
                pulled = jax.device_get(inf["out"])
        res_l, flow, T, affab, ok, counts = [np.asarray(p) for p in pulled]
        # one-trace-stale immature counts (dispatch-time snapshot); the
        # marginalization flagging they feed is a density heuristic
        # (FrontEndMarginalize.cpp:100-107), one trace does not move it.
        # Key them by the DISPATCH-time immatures identity so the staleness
        # guard in _make_keyframe stays truthful: if a trace ran between
        # dispatch and consume, _make_keyframe falls back to an explicit
        # counts pull instead of silently using stale numbers (ADVICE r3)
        self._track_imm_counts = counts
        self._track_imm_counts_key = inf["counts_key"]

        # thr from the CURRENT last_coarse_rmse (= frame N-2's r0, exactly
        # the synchronous semantics; 1e9 right after a KF, also matching)
        thr = self.cfg.tracker.re_track_threshold * self.last_coarse_rmse
        r0 = float(res_l[0])
        good = bool(ok) and math.isfinite(r0) and np.all(np.isfinite(flow))
        flushed = False
        if (not good) or (r0 > thr):
            # trouble: synchronous staged escalation against the CURRENT
            # template (if a KF landed between dispatch and consume this is
            # the new one — the synchronous path's behavior)
            flushed = True
            self.pl_escalations += 1
            res_np, idx, good = self._pl_escalate(inf)
            if res_np is not None:
                T = res_np.T[idx]
                affab = res_np.aff[idx]
                flow = res_np.flow[idx]
                res_l = res_np.res_per_level[idx]
                r0 = float(res_l[0])
                inf["ref_slot"] = self.template_kf_slot
                inf["ref_kf_id"] = int(
                    self._views_np()[4][self.template_kf_slot])
                inf["T_w_ref"] = self._kf_pose(self.template_kf_slot)

        if not (math.isfinite(r0) and np.all(np.isfinite(flow))):
            # non-finite tracking residual -> lost (FrontEnd.cpp:635-640)
            self.is_lost = True
            return True
        if not good:
            # BIG ERROR: keep the motion-model result (FrontEnd.cpp:249-255)
            flow = np.zeros(3, np.float32)

        # world pose: compose against the ref KF's CURRENT estimate when it
        # is still in the window (BA/scale refinements fold in, like the
        # reference's camToTrackingRef recompute), else the dispatch-time
        # snapshot
        if (inf["ref_slot"] in self._active_slots()
                and int(self._views_np()[4][inf["ref_slot"]])
                == inf["ref_kf_id"]):
            T_w_ref = self._kf_pose(inf["ref_slot"])
        else:
            T_w_ref = inf["T_w_ref"]
        shell.T_wc = (T_w_ref @ np.linalg.inv(T)).astype(np.float32)
        shell.aff = np.asarray(affab, np.float32).copy()
        shell.tracking_ref_kf = inf["ref_kf_id"]
        shell._T_ref_new = T
        shell._flow = np.asarray(flow, np.float32)
        shell._res0 = r0
        self.cur_pose = shell.T_wc
        if self.first_coarse_rmse < 0:
            self.first_coarse_rmse = r0
        self.last_coarse_rmse = r0

        if self._keyframe_decision(shell):
            self._make_keyframe(shell, inf["pyr"], inf["img1"])
            flushed = True
        else:
            self._make_non_keyframe(shell, inf["pyr"])
        self.last_completed_shell = shell
        return flushed or self.is_lost or self.init_failed

    def _pl_retrack(self, inf):
        """Fresh single-candidate track of a flushed pipelined frame
        against the CURRENT template (the synchronous path's steady-state
        program: constant-motion candidate + last frame's affine).  Returns
        the same 6-tuple the pipelined pull yields; updates inf's ref-KF
        fields to the current template."""
        idx = inf["frame_idx"]
        fs = self.all_frames
        T_w_ref = self._kf_pose(self.template_kf_slot)
        if idx >= 2:
            slast, sprelast = fs[idx - 1], fs[idx - 2]
            slast_2_sprelast = np.linalg.inv(sprelast.T_wc) @ slast.T_wc
            lastF_2_slast = np.linalg.inv(slast.T_wc) @ T_w_ref
            stage1, _ = make_motion_tries(
                np.eye(4), lastF_2_slast, slast_2_sprelast, self.cfg)
            T_cand = stage1[0]
            aff_init = AffLight(jnp.float32(slast.aff[0]),
                                jnp.float32(slast.aff[1]))
        else:
            T_cand = np.eye(4, dtype=np.float32)
            aff_init = AffLight(jnp.float32(0.0), jnp.float32(0.0))
        r = track_candidate_jit(
            tuple(inf["pyr"].data), self.template, self.intr0, self.cfg,
            jnp.asarray(T_cand), aff_init, self.template_ref_aff,
            self.template_ref_exposure,
            jnp.float32(max(inf["shell"].exposure, 1e-6)))
        counts_dev = jnp.sum(self.immatures.valid, axis=1)
        inf["counts_key"] = self.immatures   # retrack-time snapshot identity
        inf["ref_slot"] = self.template_kf_slot
        inf["ref_kf_id"] = int(self._views_np()[4][self.template_kf_slot])
        inf["T_w_ref"] = T_w_ref
        return jax.device_get((r.res_per_level, r.flow, r.T,
                               jnp.stack([r.aff.a, r.aff.b], -1), r.ok,
                               counts_dev))

    def _pl_escalate(self, inf):
        """Synchronous staged try-list for a pipelined frame whose primary
        candidate failed: the full ordered batch (stage1 + stage2) walked
        with the reference's serial achievedRes rule (FrontEnd.cpp:198-248).
        Rare by construction, so it takes the single bigger batch and one
        pull instead of two staged pulls."""
        idx = inf["frame_idx"]
        fs = self.all_frames
        T_w_ref = self._kf_pose(self.template_kf_slot)
        if idx >= 2:
            slast, sprelast = fs[idx - 1], fs[idx - 2]
            slast_2_sprelast = np.linalg.inv(sprelast.T_wc) @ slast.T_wc
            lastF_2_slast = np.linalg.inv(slast.T_wc) @ T_w_ref
            aff_init = AffLight(jnp.float32(slast.aff[0]),
                                jnp.float32(slast.aff[1]))
        else:
            slast_2_sprelast = np.eye(4)
            lastF_2_slast = np.eye(4)
            aff_init = AffLight(jnp.float32(0.0), jnp.float32(0.0))
        stage1, stage2 = make_motion_tries(
            np.eye(4), lastF_2_slast, slast_2_sprelast, self.cfg)
        batch = np.concatenate([stage1, stage2], axis=0)
        r = track_candidates_batch(
            tuple(inf["pyr"].data), self.template, self.intr0, self.cfg,
            jnp.asarray(batch), aff_init, self.template_ref_aff,
            self.template_ref_exposure,
            jnp.float32(max(inf["shell"].exposure, 1e-6)))
        pulled = jax.device_get((r.res_per_level, r.flow, r.T,
                                 jnp.stack([r.aff.a, r.aff.b], -1), r.ok))
        res_np = TrackResultNp(*pulled)
        i, g = select_winner_serial(res_np, self.last_coarse_rmse, self.cfg)
        return res_np, i, g

    def _pl_seed(self):
        """(Re)seed the device motion state from host shells: requires two
        frames tracked against the current template's world frame."""
        fs = self.all_frames
        if len(fs) < 2 or self.template is None or self.template_kf_slot < 0:
            self._pl_state = None
            return
        T_w_ref = self._kf_pose(self.template_kf_slot)
        Tl = np.linalg.inv(fs[-1].T_wc) @ T_w_ref
        Tp = np.linalg.inv(fs[-2].T_wc) @ T_w_ref
        aff = AffLight(jnp.float32(fs[-1].aff[0]), jnp.float32(fs[-1].aff[1]))
        self._pl_state = (jnp.asarray(Tl, jnp.float32),
                          jnp.asarray(Tp, jnp.float32), aff)

    def _pl_reset(self):
        # A just-dispatched in-flight frame is dropped on lost/init-failure
        # (detection is one frame late in pipelined mode, and the successor
        # frame's image never reaches the reinitialized frontend — the
        # documented pipelined deviation). Pop its placeholder shell so the
        # trajectory carries no bogus row (ADVICE r3, frontend.py:895).
        inf = self._pl_inflight
        if inf is not None and self.all_frames and \
                self.all_frames[-1] is inf["shell"]:
            self.all_frames.pop()
        self._pl_inflight = None
        self._pl_state = None

    def flush_pipeline(self):
        """Synchronously consume any in-flight pipelined frame.  Callers:
        everything that reads the newest shell's pose or serializes state —
        node.finish, checkpointing, trajectory export."""
        inf = self._pl_inflight
        if inf is None:
            return
        self._pl_inflight = None
        self._pl_consume(inf)
        if not (self.is_lost or self.init_failed):
            self._pl_seed()
        else:
            self._pl_reset()

    # ------------------------------------------------------------------
    # keyframe decision (FrontEnd.cpp:644-667)
    # ------------------------------------------------------------------

    def _keyframe_decision(self, shell: FrameShell) -> bool:
        kc = self.cfg.keyframe
        if kc.keyframes_per_second > 0:
            return (shell.timestamp - self.kf_shells[-1].timestamp) > \
                0.95 / kc.keyframes_per_second

        w, h = self.intr0.w[0], self.intr0.h[0]
        # host copy of the reference affine params: float() on the jnp
        # scalars would be a blocking device pull each
        ref_aff = self.template_ref_aff_np
        a_rel = math.exp(shell.aff[0] - ref_aff[0]) * (
            shell.exposure / max(self.template_ref_exposure_np, 1e-9))
        flow_t, _, flow_rt = shell._flow
        score = (
            kc.kf_global_weight * kc.max_shift_weight_t * math.sqrt(max(flow_t, 0.0)) / (w + h)
            + kc.kf_global_weight * kc.max_shift_weight_r * 0.0
            + kc.kf_global_weight * kc.max_shift_weight_rt * math.sqrt(max(flow_rt, 0.0)) / (w + h)
            + kc.kf_global_weight * kc.max_affine_weight * abs(math.log(max(a_rel, 1e-9)))
        )
        return score > 1.0 or 2.0 * self.first_coarse_rmse < shell._res0

    # ------------------------------------------------------------------
    # non-keyframe: trace immatures (FrontEnd.cpp:708-719)
    # ------------------------------------------------------------------

    def _make_non_keyframe(self, shell: FrameShell, pyr0: Pyramid):
        self.flush_pending()        # no-op unless the track pull was skipped
        self._frames_since_kf += 1
        tc = self.cfg.trace
        steady = (tc.steady_after > 0
                  and self._frames_since_kf >= tc.steady_after)
        with self.timers.span("trace"):
            self._trace_all(shell.T_wc, pyr0.data[0], shell.aff,
                            shell.exposure, steady=steady)

    def _trace_all(self, T_wc_new: np.ndarray, target_planes, new_aff,
                   new_exposure: float = 1.0, steady: bool = False):
        """traceOn over every window slot: ONE vmapped dispatch (inactive
        slots carry valid=False lanes; their identity transforms are
        harmless).

        ``steady=True`` selects the small steady-state trace tier
        (cfg.trace.steady_*): by the second frame past a keyframe every
        fresh candidate has a bracketed interval, so the short-reach
        program covers the live population at ~1/6 the gather cost; the
        rare long-segment lane defers (n_overflow) until the next full
        dispatch — the KF-event trace and the first post-KF frame(s)."""
        if not self.imm_slots:
            return
        K = np.asarray(self.intr0.K(0), np.float32)
        Ki = np.linalg.inv(K)
        T_cw_new = np.linalg.inv(T_wc_new)
        aff_all = self._views_np()[1]
        S = self.n_slots
        KRKi = np.tile(np.eye(3, dtype=np.float32), (S, 1, 1))
        Kt = np.zeros((S, 3), np.float32)
        a_rel = np.ones(S, np.float32)
        b_rel = np.zeros(S, np.float32)
        for slot in self.imm_slots:
            T_nh = T_cw_new @ self._kf_pose(slot)
            KRKi[slot] = K @ T_nh[:3, :3] @ Ki
            Kt[slot] = K @ T_nh[:3, 3]
            # clip the exponent: post-divergence affine estimates can be
            # huge and exp overflow poisons the trace transfer with inf
            a_rel[slot] = np.exp(
                np.clip(new_aff[0] - aff_all[slot, 0], -20.0, 20.0)) * (
                new_exposure / max(self.slot_exposure.get(slot, 1.0), 1e-9))
            b_rel[slot] = new_aff[1] - a_rel[slot] * aff_all[slot, 1]
        tc = self.cfg.trace
        tier = (dict(num_steps=tc.steady_num_steps, budget=tc.steady_budget,
                     max_reach=tc.steady_max_reach) if steady else {})
        self.immatures, n_search, n_overflow = immature.trace_points_all_compact(
            self.immatures, target_planes,
            jnp.asarray(KRKi), jnp.asarray(Kt),
            jnp.asarray(a_rel), jnp.asarray(b_rel), self.cfg, **tier,
        )
        # no silent caps: overflowed (not-searched-this-frame) lanes are
        # accumulated on device and surface in the timing report
        self._trace_overflow_acc = (
            n_overflow if self._trace_overflow_acc is None
            else self._trace_overflow_acc + n_overflow)

    # ------------------------------------------------------------------
    # keyframe pipeline (FrontEnd.cpp:721-840)
    # ------------------------------------------------------------------

    def _make_keyframe(self, shell: FrameShell, pyr0: Pyramid, img1):
        """The keyframe pipeline, restructured around BUNDLED host pulls:
        each blocking pull stalls the host until the device drains, so
        every stage's host-needed values ride one tuple pull, and only
        ONE blocking pull remains on the KF critical path (bundle 3: BA
        gates + post-BA views + template starvation + scale-grid
        results). Immature counts ride the frame's tracker pull;
        activation is fully device-side including pool-row allocation;
        the tail bundle (point flags + marginalized exports) commits
        deferred at the next frame's tracker pull (flush_pending). The
        naive per-stage form took ~15 pulls per KF."""
        cfg = self.cfg
        self.flush_pending()        # no-op unless the track pull was skipped
        shell.is_kf = True
        self._frames_since_kf = 0   # trace tier: full-shape until steady
        self.kf_shells.append(shell)

        # ---- BUNDLE 1: pre-insert views + immature counts ------------------
        # counts normally arrive with the tracker pull of this same frame
        # (run() above stashes them keyed on the immatures pytree identity);
        # the explicit pull below only fires on trackless paths
        # (initialization handoff) or a stale views cache.
        st = self.ba_state
        counts = (self._track_imm_counts
                  if getattr(self, "_track_imm_counts_key", None)
                  is self.immatures else None)
        if getattr(self, "_views_cache_key", None) is not st:
            views_dev = ba.current_views(st)
            if counts is None:
                counts_dev = jnp.sum(self.immatures.valid, axis=1)
                pulled = jax.device_get((views_dev, counts_dev))
                counts = pulled[1]
            else:
                pulled = (jax.device_get(views_dev),)
            self._views_cache = pulled[0]
            self._views_cache_key = st
        elif counts is None:
            counts = jax.device_get(jnp.sum(self.immatures.valid, axis=1))
        imm_counts = {s: int(counts[s]) for s in self.imm_slots}

        with self.timers.span("trace"):
            self._trace_all(shell.T_wc, pyr0.data[0], shell.aff,
                            shell.exposure)

        # ---- flag frames for marginalization (FrontEndMarginalize.cpp:62) --
        flagged = self._flag_frames_for_marginalization(shell, imm_counts)

        # ---- insert the new KF into the window -----------------------------
        slot = self._free_slot()
        T_cw = np.linalg.inv(shell.T_wc).astype(np.float32)
        prev_newest = self._newest_slot()
        pre_views = self._views_cache      # pre-insert snapshot (bundle 1)
        n_active_before = int(np.asarray(pre_views[3]).sum())
        self.ba_state = ba.add_frame(
            self.ba_state, slot, self.num_kfs, T_cw, shell.aff,
            shell.exposure, pyr0.data[0],
        )
        self.slot_exposure[slot] = shell.exposure
        self.ba_state = self.ba_state._replace(
            energy_th=self.ba_state.energy_th.at[slot].set(
                self.ba_state.energy_th[prev_newest])
        )
        self.slot_stats[slot] = {"out": 0, "marg": 0}
        self.pyramids[slot] = pyr0
        self.scale_errors[slot] = -1.0
        kf_id = self.num_kfs
        self.num_kfs += 1

        # ---- activate candidate points (FrontEnd.cpp:341-500) --------------
        # (pull-free: gates, idepth LM and pool-row allocation on device)
        with self.timers.span("activate"):
            self._activate_points(slot, T_cw, pre_views, flagged)

        # ---- windowed BA (FrontEndOptimize.cpp:332) ------------------------
        n_active_frames = n_active_before + 1
        iters = cfg.ba.max_opt_iterations
        if n_active_frames < 3:
            iters = 20
        elif n_active_frames < 4:
            iters = 15
        scale_enabled = (cfg.scale_opt.accept_thres > 0 and
                         len(self.kf_shells) > cfg.scale_opt.min_kfs_before_scale)
        st_pre_ba = self.ba_state

        def run_ba_chain(compact_budget):
            """BA -> template -> speculative scale -> bundle-3 pull, as one
            retryable unit: the compact attempt's n_dropped rides the same
            pull, and a (rare) overflow redoes the chain full-shape."""
            with self.timers.span("dso_opt"):
                st, rmse_d, ok_d, hdd_d, ndrop_d = ba.optimize_keyframe(
                    st_pre_ba, cfg, iters, slot, compact_budget)

            with self.timers.span("template"):
                ti = ba.template_inputs(st, cfg, slot, hdd_d)
                tmpl = build_template(
                    ti[0], ti[1], ti[2], ti[3], pyr0.data[0][..., 0],
                    self.levels, self.budgets, valid=ti[4])
                pmask_count = jnp.sum(tmpl.pmask[0])

            scale_out = None
            if scale_enabled:
                with self.timers.span("scale_opt"):
                    pyr1 = build_pyramid(img1, self.levels)
                    scale_out = dispatch_scale_optimization(
                        tuple(pyr1.data), tmpl, self.intr0, self.intr1,
                        jnp.asarray(self.t_cam1_cam0), cfg, self.scale_state)

            # ---- BUNDLE 3: BA gates + views + template + scale -------------
            views2_dev = ba.current_views(st)
            bundle3 = [rmse_d, ok_d, views2_dev, pmask_count, ndrop_d]
            if scale_out is not None:
                bundle3.append((scale_out.scale, scale_out.error))
            return st, tmpl, scale_out, jax.device_get(tuple(bundle3))

        cb = cfg.ba.compact_budget
        cb = cb if 0 < cb < self.pool else None
        self.ba_state, tmpl, scale_out, pulled3 = run_ba_chain(cb)
        if cb is not None and int(pulled3[4]) > 0:
            # live points exceeded the compact budget: the compact BA
            # silently excluded some — redo full-shape (detected on the
            # same pull; costs one extra chain on a rare transient)
            self.ba_state, tmpl, scale_out, pulled3 = run_ba_chain(None)
        rmse = float(pulled3[0])

        # ---- init-failure / lost gates (FrontEnd.cpp:778-790) --------------
        gates = self.cfg.runtime.init_rmse_gates
        nk = len(self.kf_shells)
        if (nk == 2 and rmse > gates[0]) or (nk == 3 and rmse > gates[1]) or \
                (nk == 4 and rmse > gates[2]):
            self.init_failed = True
            return
        if not bool(pulled3[1]):
            self.is_lost = True
            return

        self._views_cache = pulled3[2]
        self._views_cache_key = self.ba_state
        self._refresh_kf_shells()
        shell.T_wc = self._kf_pose(slot)
        self.cur_pose = shell.T_wc

        # ---- adopt the template --------------------------------------------
        self.template = tmpl
        if int(pulled3[3]) < 8:
            # template starvation = effectively lost (the reference reaches
            # this as NaN tracking residuals on the next frame)
            self.is_lost = True
        self.template_kf_slot = slot
        aff = self._views_cache[1][slot]
        self.template_ref_aff = AffLight(jnp.float32(aff[0]), jnp.float32(aff[1]))
        self.template_ref_aff_np = np.asarray(aff[:2], np.float32)
        self.template_ref_exposure = jnp.float32(shell.exposure)
        self.template_ref_exposure_np = shell.exposure
        self.first_coarse_rmse = -1.0
        self.last_coarse_rmse = 1e9

        # ---- stereo scale decision (FrontEnd.cpp:975-1064) -----------------
        scale_error = -1.0
        if scale_out is not None:
            accepted, new_scale, scale_error, self.scale_state = \
                decide_scale_optimization(
                    np.asarray(pulled3[5][0]), np.asarray(pulled3[5][1]),
                    cfg, self.scale_state)
            if accepted:
                self._apply_scale(new_scale, slot)
        self.scale_errors[slot] = scale_error

        # ---- BUNDLE 4: point flags + new traces + marg exports -------------
        self._finalize_keyframe(flagged, slot, pyr0)

    # ------------------------------------------------------------------

    def flush_pending(self):
        """Commit a deferred keyframe tail (see _finalize_keyframe). No-op
        when nothing is pending. Must run before any host read of the
        tail's outputs — callers: the tracker pull (where the deferred
        pull hides behind the queued track program), the keyframe/
        non-keyframe paths, trajectory export, and checkpointing."""
        pending = self._pending_finalize
        if pending is not None:
            self._pending_finalize = None
            self._finalize_keyframe_commit(*pending)

    def _finalize_keyframe(self, flagged: List[int], new_slot: int,
                           pyr0: Pyramid):
        """Fused pipeline tail — flagPointsForRemoval + makeNewTraces +
        marginalizeFrame (FrontEnd.cpp:504-583, 824, 835-839) — around ONE
        device pull (bundle 4): a single linearization of the
        post-BA/post-scale state feeds point flagging, dso_error, and the
        marginalized-point exports, with the pixel-selector count and the
        per-flagged-slot level-color gathers riding the same pull. The
        views cache is patched host-side afterwards (the tail ops change
        only validity masks, never poses), keeping the per-frame tracking
        path pull-free.

        DEFERRED: the dispatch half runs here (device work queues, the
        bundle starts its device->host copy asynchronously, and the
        immature-slot updates — which the next frame's trace and counts
        need — dispatch eagerly); the pull + host bookkeeping half
        (_finalize_keyframe_commit) runs at the NEXT frame's tracker pull
        via flush_pending, so the bundle's pull hides behind the queued
        track program instead of extending the keyframe's critical path."""
        cfg = self.cfg
        st = self.ba_state

        # ---- dispatch all device work (async) ------------------------------
        lin = ba.linearize(st, cfg)
        n_good_dev = jnp.sum(lin.pair_good, axis=1)
        sel_map, sel_count = make_selection_map(
            pyr0.abs_grad[0], pyr0.abs_grad[1], pyr0.abs_grad[2], self.pot, cfg)
        # per-level colors for EVERY window slot's points, not just the
        # flagged ones: stay-host isOOB exports then carry full per-level
        # signatures too (closes the r4 center-color-only deviation,
        # PARITY/VERDICT r4 item 7). The extra gathers ride the same async
        # bundle copy, off the tracking critical path.
        color_gathers = {
            s: _gather_level_colors(tuple(self.pyramids[s].data), st.p_u, st.p_v)
            for s in self.pyramids
        }
        views_dev = ba.current_views(st)

        # new immature traces (FrontEnd.cpp:824, 936-962): the device ops
        # dispatch NOW (the next frame's trace transforms and candidate
        # counts consume the updated pytree); only the density feedback
        # (adapt_potential) waits for the pulled count in the commit half
        with self.timers.span("feature_detect"):
            self.immatures = immature.set_slot(
                self.immatures, jnp.int32(new_slot),
                immature.create_points(
                    pyr0.data[0], sel_map, self.imm_budget,
                    cfg.ba.outlier_th_sum_component))
            self.imm_slots.add(new_slot)
            if flagged:
                clear = np.zeros(self.n_slots, bool)
                clear[flagged] = True
                self.immatures = immature.clear_slots(
                    self.immatures, jnp.asarray(clear))
                for mslot in flagged:
                    self.imm_slots.discard(mslot)

        bundle = (
            views_dev,
            (st.p_u, st.p_v, st.p_idepth, n_good_dev, lin.Hdd,
             lin.pair_good, lin.pair_energy, st.p_color,
             st.p_num_good, st.p_last_res),
            sel_count,
            color_gathers,
        )
        # start the device->host copy without blocking
        jax.tree_util.tree_map(
            lambda a: a.copy_to_host_async()
            if hasattr(a, "copy_to_host_async") else None, bundle)
        self._pending_finalize = (bundle, lin, st, flagged, new_slot)

    def _finalize_keyframe_commit(self, bundle, lin, st, flagged: List[int],
                                  new_slot: int):
        """Pull + host-bookkeeping half of the keyframe tail; see
        _finalize_keyframe."""
        cfg = self.cfg
        assert st is self.ba_state, "BA state mutated while finalize pending"

        pulled = jax.device_get(bundle)
        views = pulled[0]
        (pu_a, pv_a, pid_a, n_good, Hdd, pair_good, pair_e, p_color,
         p_num_good, p_last_res) = pulled[1]
        got = int(pulled[2])
        colors_by_slot = pulled[3]
        p_valid, p_host = views[5], views[6]
        fx0, fy0, cx0, cy0 = views[2]

        # ---- flag + marginalize/drop points (FrontEnd.cpp:504-583) ---------
        with self.timers.span("point_marg"):
            host_flagged = np.isin(p_host, flagged)
            bad, leaving, marg, drop, rules = _flag_points_for_removal(
                p_valid, pid_a, n_good, Hdd, pair_good, p_num_good,
                p_last_res, host_flagged, flagged, cfg)
            removed = marg | drop
            for k, v in rules.items():
                self.removal_stats[k] = self.removal_stats.get(k, 0) + v
            for s in set(p_host[marg]):
                self.slot_stats.setdefault(int(s), {"out": 0, "marg": 0})[
                    "marg"] += int((marg & (p_host == s)).sum())
            for s in set(p_host[drop & p_valid]):
                self.slot_stats.setdefault(int(s), {"out": 0, "marg": 0})[
                    "out"] += int((drop & (p_host == s)).sum())
            if marg.any():
                # reuse the bundle-4 linearization (self.ba_state is still
                # the state `lin` was computed for)
                self.ba_state = ba.marginalize_points(
                    self.ba_state, jnp.asarray(marg), cfg, lin)
            if drop.any():
                self.ba_state = ba.drop_points(self.ba_state, jnp.asarray(drop))
            # loop-handler point export: Schur-marginalized subset only
            # (reference pointHessiansMarginalized, LoopHandler.cpp:166)
            # or, with densify_scans, every non-outlier point leaving the
            # window — weak-Hessian geometry still densifies the scans
            exp_mask = leaving if cfg.loop.densify_scans else marg
            # isOOB'd points whose host STAYS accumulate until the host
            # marginalizes (DSO host->pointHessiansMarginalized). Colors:
            # full per-level signatures from the host-slot gather that
            # rode this bundle (r4 shipped center-intensity-only here;
            # closed in r5 — the fallback remains for a slot whose
            # pyramid was somehow not gathered).
            stay = exp_mask & ~host_flagged
            if stay.any():
                for s in set(p_host[stay]):
                    m = stay & (p_host == s)
                    pid = np.maximum(pid_a[m], 1e-6)
                    pts_cam = np.stack(
                        [(pu_a[m] - cx0) / fx0 / pid,
                         (pv_a[m] - cy0) / fy0 / pid, 1.0 / pid], -1)
                    col = (colors_by_slot[s][m] if s in colors_by_slot
                           else p_color[m][:, 4:5])
                    self.removal_stats["stay_export"] = (
                        self.removal_stats.get("stay_export", 0) + int(m.sum()))
                    self._marg_export_acc.setdefault(int(s), []).append(
                        (pts_cam, col))
            self._last_marg_mask = exp_mask & host_flagged

        # ---- density feedback for the next KF's selection ------------------
        self.pot = adapt_potential(self.pot, got,
                                   cfg.ba.desired_immature_density)

        # ---- marginalize flagged frames (FrontEndMarginalize.cpp:148-215) --
        with self.timers.span("frame_marg"):
            for mslot in flagged:
                # dso_error: energy of residuals targeting the frame /
                # count^2, over residual pairs that survive point removal
                # (equivalent to re-linearizing after the drop: removed
                # points cover every pair a fresh linearization would
                # exclude). A NaN last_dso_error is the sequence-restart
                # marker set by the runtime (node.py) — the FIRST
                # marginalized KF of a new sequence exports dso_error=NaN
                # so the loop handler adds no odometry edge linking
                # unrelated sequences (FrontEndMarginalize.cpp:197-202).
                restart = math.isnan(self.last_dso_error)
                tgt = pair_good[:, mslot] & ~removed
                cnt = int(tgt.sum())
                if cnt > 0:
                    dso_error = float(pair_e[tgt, mslot].sum()) / cnt / cnt
                elif restart:
                    dso_error = 10e5          # the __init__ default
                else:
                    dso_error = 10.0 * self.last_dso_error
                self.last_dso_error = dso_error
                if restart:
                    dso_error = float("nan")

                sel = self._last_marg_mask & (p_host == mslot)
                pu = pu_a[sel]
                pv = pv_a[sel]
                pid = np.maximum(pid_a[sel], 1e-6)
                pts_cam = np.stack(
                    [(pu - cx0) / fx0 / pid, (pv - cy0) / fy0 / pid,
                     1.0 / pid], -1)
                if mslot in colors_by_slot and len(pu) > 0:
                    colors = colors_by_slot[mslot][sel]     # [K, L]
                else:
                    colors = p_color[sel][:, 4:5]
                # merge points isOOB-removed at earlier KF events while
                # this host stayed (accumulator; pad colors to width)
                acc = self._marg_export_acc.pop(mslot, None)
                if acc:
                    acc_pts = np.concatenate([a[0] for a in acc], 0)
                    acc_col = np.concatenate([a[1] for a in acc], 0)
                    L = colors.shape[1] if colors.size else acc_col.shape[1]
                    if acc_col.shape[1] < L:
                        acc_col = np.concatenate(
                            [acc_col] + [acc_col[:, -1:]] * (L - acc_col.shape[1]), 1)
                    elif colors.size and colors.shape[1] < acc_col.shape[1]:
                        colors = np.concatenate(
                            [colors] + [colors[:, -1:]]
                            * (acc_col.shape[1] - colors.shape[1]), 1)
                    pts_cam = np.concatenate([pts_cam, acc_pts], 0)
                    colors = (np.concatenate([colors, acc_col], 0)
                              if colors.size else acc_col)

                fid = int(views[4][mslot])
                k = fid - self.prev_kf_count
                shell = self.kf_shells[k] if 0 <= k < len(self.kf_shells) else None
                self.marginalized_queue.append(MarginalizedKF(
                    kf_id=fid,
                    incoming_id=shell.incoming_id if shell else -1,
                    timestamp=shell.timestamp if shell else 0.0,
                    T_wc=np.linalg.inv(views[0][mslot]),
                    dso_error=dso_error,
                    scale_error=self.scale_errors.get(mslot, -1.0),
                    pts_cam=pts_cam,
                    pts_colors=colors,
                    pyr=tuple(self.pyramids[mslot].data)
                        if mslot in self.pyramids else None,
                    exposure=self.slot_exposure.get(mslot, 1.0),
                ))
                self.ba_state = ba.marginalize_frame(
                    self.ba_state, jnp.int32(mslot))
                self.pyramids.pop(mslot, None)
                self.slot_stats.pop(mslot, None)
                self.scale_errors.pop(mslot, None)
                self.slot_exposure.pop(mslot, None)

        # ---- patch the views cache (validity only; poses untouched) --------
        fv = views[3].copy()
        for mslot in flagged:
            fv[mslot] = False
        self._views_cache = (views[0], views[1], views[2], fv, views[4],
                             views[5] & ~removed, views[6])
        self._views_cache_key = self.ba_state
        import os as _os
        if _os.environ.get("DSSLAM_CHECK_VIEWS_PATCH"):
            fresh = jax.device_get(ba.current_views(self.ba_state))
            ok_slots = np.asarray(fresh[3])
            c = self._views_cache
            np.testing.assert_allclose(c[0][ok_slots], fresh[0][ok_slots],
                                       err_msg="patch mismatch: T")
            np.testing.assert_allclose(c[1][ok_slots], fresh[1][ok_slots],
                                       err_msg="patch mismatch: aff")
            np.testing.assert_allclose(c[2], fresh[2],
                                       err_msg="patch mismatch: calib")
            assert (c[3] == fresh[3]).all(), "patch mismatch: frame_valid"
            assert (c[5] == np.asarray(fresh[5])).all(), "patch mismatch: p_valid"
            assert (c[6] == np.asarray(fresh[6])).all(), "patch mismatch: p_host"

    # ------------------------------------------------------------------

    def _flag_frames_for_marginalization(self, shell, imm_counts) -> List[int]:
        """FrontEndMarginalize.cpp:62-146. All inputs come from the
        bundle-1 views pull (no device sync here)."""
        cfg = self.cfg.ba
        slots = self._active_slots()
        if len(slots) < 2:
            return []
        newest = slots[-1]
        views = self._views_np()
        aff_all = views[1]
        p_valid, p_host = views[5], views[6]
        flagged: List[int] = []

        for s in slots:
            n_in = int((p_valid & (p_host == s)).sum())
            n_in += int(imm_counts.get(s, 0))
            n_out = self.slot_stats.get(s, {}).get("out", 0) + \
                self.slot_stats.get(s, {}).get("marg", 0)
            a_rel = math.exp(aff_all[newest, 0] - aff_all[s, 0]) * (
                self.slot_exposure.get(newest, 1.0)
                / max(self.slot_exposure.get(s, 1.0), 1e-9))
            if (n_in < cfg.min_points_remaining * (n_in + n_out)
                    or abs(math.log(max(a_rel, 1e-9))) > cfg.max_log_aff_fac_in_window) \
                    and len(slots) - len(flagged) > cfg.min_frames:
                flagged.append(s)

        # distance-score marginalization of one more frame
        if len(slots) - len(flagged) >= cfg.max_frames:
            fid = views[4]
            latest_id = fid[newest]
            poses = {s: self._kf_pose(s) for s in slots}
            best_score, best_slot = 1.0, None
            for s in slots:
                if fid[s] > latest_id - cfg.min_frame_age or fid[s] == 0 or s in flagged:
                    continue
                dist_score = 0.0
                for t in slots:
                    if t == s or fid[t] > latest_id - cfg.min_frame_age + 1:
                        continue
                    d = np.linalg.norm(poses[s][:3, 3] - poses[t][:3, 3])
                    dist_score += 1.0 / (1e-5 + d)
                d_latest = np.linalg.norm(poses[s][:3, 3] - poses[newest][:3, 3])
                dist_score *= -math.sqrt(max(d_latest, 1e-12))
                if dist_score < best_score:
                    best_score, best_slot = dist_score, s
            if best_slot is not None:
                flagged.append(best_slot)
        return flagged

    # ------------------------------------------------------------------

    def _activate_points(self, new_slot: int, T_cw_new: np.ndarray,
                         pre_views, flagged_slots=()):
        """FrontEnd.cpp:341-500: density-adaptive distance-map gating +
        batched 1-D idepth optimization + insertion into the point pool.
        Fully pull-free: distance map, per-candidate gates, idepth LM AND
        the pool-row allocation (_allocate_candidates) all run on device;
        the host contributes only the relative-warp matrices from the
        bundle-1 snapshot and the density-feedback threshold."""
        cfg = self.cfg
        want = cfg.ba.desired_point_density
        have = int(np.asarray(pre_views[5]).sum())
        d = self.current_min_act_dist
        if have < want * 0.66:
            d -= 0.8
        if have < want * 0.8:
            d -= 0.5
        elif have < want * 0.9:
            d -= 0.2
        elif have < want:
            d -= 0.1
        if have > want * 1.5:
            d += 0.8
        if have > want * 1.3:
            d += 0.5
        if have > want * 1.15:
            d += 0.2
        if have > want:
            d += 0.1
        self.current_min_act_dist = float(np.clip(d, 0.0, 4.0))

        # distance map from active points projected into the new KF (half
        # res): fully on device (the post-insert state already has the new
        # frame's pose)
        K = np.asarray(self.intr0.K(1), np.float32)  # level-1 intrinsics
        h2, w2 = self.intr0.h[1], self.intr0.w[1]
        st = self.ba_state
        dist_map = _halfres_distance_map(
            st, jnp.int32(new_slot), jnp.asarray(K), h2, w2)

        images = st.images
        frame_valid = st.frame_valid
        # device-side views for the jitted activation call: one dispatch
        views_dev = ba.current_views(st)
        T_cw_j, aff_j, calib_j = views_dev[0], views_dev[1], views_dev[2]

        # Phases: (1) ONE fused gate->compact->activate dispatch (cheap
        # gates on all [S, NI] lanes, the expensive idepth LM only on the
        # first act_budget survivors per slot — see _gate_compact_activate);
        # (2) ONE blocking pull of the stacked (ok, lane, drop) masks —
        # bundle 2; (3) host insertion bookkeeping, then ONE fused pool
        # scatter and ONE candidate-consumption update.
        slots_todo = [s for s in self.imm_slots if s != new_slot]
        if not slots_todo:
            return
        S = self.n_slots
        T_all_old = pre_views[0]
        K1i = np.linalg.inv(K)
        # host 4x4 math from the bundle-1 snapshot (old slots' poses have
        # not moved since) + the new KF's host-known pose
        KRKi1 = np.tile(np.eye(3, dtype=np.float32), (S, 1, 1))
        Kt1 = np.zeros((S, 3), np.float32)
        for slot in slots_todo:
            T_nh1 = T_cw_new @ np.linalg.inv(T_all_old[slot])
            KRKi1[slot] = K @ T_nh1[:3, :3] @ K1i
            Kt1[slot] = K @ T_nh1[:3, 3]
        host_flagged = np.zeros(S, bool)
        host_flagged[list(flagged_slots)] = True
        ok_d, idepth_d, lane_d, drop_d = _gate_compact_activate(
            self.immatures, dist_map,
            jnp.asarray(KRKi1), jnp.asarray(Kt1),
            jnp.float32(self.current_min_act_dist),
            jnp.asarray(host_flagged), images, frame_valid,
            T_cw_j, aff_j, calib_j, st.exposure,
            cfg, w2, h2, cfg.ba.act_budget)

        # allocate accepted candidates into free pool rows ON DEVICE
        # (_allocate_candidates emulates the former host loop exactly:
        # own segment first, ascending, then overflow into any free rows,
        # capped by remaining pool capacity — the pool is one shared
        # budget, the BA assembly groups by p_host via one-hot). This
        # keeps the whole activation stage pull-free (the former bundle-2
        # mask pull blocked once per KF).
        P = self.cfg.ba.max_points_per_frame
        participate = np.zeros(S, bool)
        participate[slots_todo] = True
        (src_slot, src_sub_lane, src_lane, dst_idx, host, valid,
         consumed) = _allocate_candidates(
            ok_d, lane_d, drop_d, st.p_valid, jnp.asarray(participate), P)
        self.ba_state = _insert_candidates_all(
            self.ba_state, self.immatures, idepth_d,
            src_slot, src_sub_lane, src_lane, dst_idx, valid, host)
        self.immatures = _consume_candidates(self.immatures, consumed)

    # ------------------------------------------------------------------

    def _refresh_kf_shells(self):
        """Push optimized window poses back into the shells
        (FrontEndOptimize.cpp:475-481)."""
        fid = self._views_np()[4]
        for s in self._active_slots():
            pose = self._kf_pose(s)
            k = int(fid[s]) - self.prev_kf_count
            if 0 <= k < len(self.kf_shells):
                self.kf_shells[k].T_wc = pose

    def _build_template(self, ref_slot: int, pyr_ref: Pyramid):
        """makeCoarseDepthL0 input prep (initialization paths; the keyframe
        pipeline runs the same chain inline in _make_keyframe with the BA
        loop's Hdd). One device program (ba.template_inputs) does the
        projection + idepth-hessian weighting; no host math."""
        ti = ba.template_inputs(self.ba_state, self.cfg, jnp.int32(ref_slot))
        self.template = build_template(
            ti[0], ti[1], ti[2], ti[3], pyr_ref.data[0][..., 0],
            self.levels, self.budgets, valid=ti[4],
        )
        # template starvation = effectively lost (the reference reaches this
        # as NaN tracking residuals on the next frame)
        if int(np.asarray(jnp.sum(self.template.pmask[0]))) < 8:
            self.is_lost = True
        self.template_kf_slot = ref_slot
        aff = self._views_np()[1][ref_slot]
        self.template_ref_aff = AffLight(jnp.float32(aff[0]), jnp.float32(aff[1]))
        self.template_ref_aff_np = np.asarray(aff[:2], np.float32)
        ref_exp = self.slot_exposure.get(ref_slot, 1.0)
        self.template_ref_exposure = jnp.float32(ref_exp)
        self.template_ref_exposure_np = ref_exp
        self.first_coarse_rmse = -1.0
        self.last_coarse_rmse = 1e9

    def _apply_scale(self, new_scale: float, newest_slot: int):
        """FrontEnd.cpp:1030-1055: rescale template, window idepths, and the
        newest KF's translation to its tracking reference."""
        s = float(new_scale)
        self.template = scale_template_idepth(self.template, jnp.float32(s))
        views = self._views_np()    # cached (bundle 3); pre-rescale poses
        st = self.ba_state
        new_idepth = jnp.where(st.p_valid, st.p_idepth / s, st.p_idepth)
        st = st._replace(p_idepth=new_idepth, p_idepth_zero=new_idepth)
        T_patched = views[0]
        # rescale newest KF translation relative to its tracking ref KF
        shell = self.kf_shells[-1]
        ref_kf = shell.tracking_ref_kf - self.prev_kf_count
        if 0 <= ref_kf < len(self.kf_shells) - 1:
            T_w_ref = self.kf_shells[ref_kf].T_wc
            T_ref_new = np.linalg.inv(T_w_ref) @ shell.T_wc
            T_ref_new[:3, 3] *= s
            shell.T_wc = (T_w_ref @ T_ref_new).astype(np.float32)
            T_cw = np.linalg.inv(shell.T_wc).astype(np.float32)
            st = st._replace(
                T_zero=st.T_zero.at[newest_slot].set(jnp.asarray(T_cw)),
                delta=st.delta.at[newest_slot, :6].set(0.0),
            )
            self.cur_pose = shell.T_wc
            T_patched = views[0].copy()
            T_patched[newest_slot] = T_cw
        self.ba_state = st
        # patch the views cache host-side: the rescale changes only the
        # newest slot's pose among the views fields (idepths are not in
        # them) — without this, the NEXT frame's _kf_pose pays a full
        # blocking views pull on every scale-accepted keyframe
        self._views_cache = (T_patched,) + tuple(views[1:])
        self._views_cache_key = self.ba_state

    def _make_new_traces(self, slot: int, pyr0: Pyramid):
        """makeNewTraces (FrontEnd.cpp:936-962) with density feedback.
        (Initialization path; the keyframe pipeline fuses this into
        bundle 4 of _finalize_keyframe.)"""
        cfg = self.cfg
        sel, count = make_selection_map(
            pyr0.abs_grad[0], pyr0.abs_grad[1], pyr0.abs_grad[2], self.pot, cfg
        )
        got = int(count)
        self.pot = adapt_potential(self.pot, got, cfg.ba.desired_immature_density)
        self.immatures = immature.set_slot(
            self.immatures, jnp.int32(slot),
            immature.create_points(pyr0.data[0], sel, self.imm_budget,
                                   cfg.ba.outlier_th_sum_component))
        self.imm_slots.add(slot)

