"""Unified typed configuration.

The reference spreads configuration over three tiers (SURVEY.md §5): ROS
launch params (reference src/main.cpp:271-312), DSO ``setting_*`` globals
mutated by presets/modes (main.cpp:75-132), and compile-time #defines
(LoopHandler.h:36-42, search_place.h:21-23, PoseEstimator.h:26-27,
icp.h:20, ScanContext.cpp:68-73, generate_spherical_points.h:23-25).
Here everything lives in one frozen dataclass tree so that a config is a
hashable static argument to jitted programs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# State-vector preconditioning scales (DSO util/NumType.h conventions).
# Tangent ordering everywhere: [tx, ty, tz, rx, ry, rz] (Sophus SE3::exp).
# The tracker preconditions increments by these before exp/update
# (reference TrackerAndScaler.cpp:541-545, 685-696).
SCALE_XI_TRANS = 1.0  # applied to tangent[0:3] ("SCALE_XI_ROT" in DSO naming)
SCALE_XI_ROT = 0.5    # applied to tangent[3:6] ("SCALE_XI_TRANS" in DSO naming)
SCALE_A = 10.0
SCALE_B = 1000.0
SCALE_F = 50.0
SCALE_C = 50.0
SCALE_IDEPTH = 1.0

# 8-pixel residual pattern (DSO "spread" staticPattern #8) used by the
# windowed BA, immature point trace, and point activation.
PATTERN_OFFSETS: Tuple[Tuple[int, int], ...] = (
    (0, -2), (-1, -1), (1, -1), (-2, 0),
    (0, 0), (2, 0), (-1, 1), (0, 2),
)
PATTERN_NUM = 8
PATTERN_PADDING = 2


@dataclass(frozen=True)
class TrackerConfig:
    """Coarse tracker / scale optimizer / loop pose estimator shared knobs."""

    pyr_levels: int = 5
    huber_th: float = 9.0                  # setting_huberTH
    coarse_cutoff_th: float = 20.0         # setting_coarseCutoffTH
    # LM iterations per level, fine->coarse (TrackerAndScaler.cpp:463)
    max_iterations: Tuple[int, ...] = (10, 20, 50, 50, 50)
    lambda_init: float = 0.01
    lambda_extrapolation_limit: float = 1e-3
    lambda_accept_factor: float = 0.5
    lambda_reject_factor: float = 4.0
    inc_break_norm: float = 1e-3
    # cutoff-doubling repeat while >60% of residuals saturate
    # (TrackerAndScaler.cpp:477-485)
    saturated_ratio_repeat: float = 0.6
    cutoff_repeat_max: float = 50.0
    re_track_threshold: float = 1.5        # setting_reTrackThreshold
    # affine optimization modes: >0 optimize with prior, 0 optimize free,
    # <0 fix at zero (main.cpp:120-127). Default launch mode=1 -> 0/0.
    affine_mode_a: float = 0.0
    affine_mode_b: float = 0.0
    # tracker failure gates (TrackerAndScaler.cpp:615-626)
    max_aff_a: float = 1.2
    max_aff_b: float = 200.0
    max_rel_aff_log_a: float = 1.5
    max_rel_aff_b: float = 200.0
    # number of pose candidates evaluated in the first (cheap) batch before
    # falling back to the 78 rotation perturbations (FrontEnd.cpp:132-186).
    rot_perturbation_deltas: Tuple[float, ...] = (0.02, 0.03, 0.04)
    # winner-selection policy over the candidate try-list:
    #  "staged" (default): 1 -> 5 -> 78 growing batches with early exit at
    #    batch granularity (one device program per stage);
    #  "serial": evaluate the FULL ordered list in one batch and emulate
    #    the reference's serial achievedRes-tightening walk over it
    #    (FrontEnd.cpp:200-247) — A/B harness / parity mode. The only
    #    non-emulated reference behavior is the mid-LM coarse-level abort
    #    (minResForAbort), which affects which tries finish, not how the
    #    finished residuals compare.
    winner_policy: str = "staged"


@dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe decision weights (FrontEnd.cpp:644-667; DSO settings)."""

    kf_global_weight: float = 1.0
    # DSO defaults are premultiplied by (640+480) and divided by (w+h) at
    # use-site; we store the raw weights.
    max_shift_weight_t: float = 0.04 * (640 + 480)
    max_shift_weight_r: float = 0.0 * (640 + 480)
    max_shift_weight_rt: float = 0.02 * (640 + 480)
    max_affine_weight: float = 2.0
    keyframes_per_second: float = 0.0      # 0 => heuristic decision


@dataclass(frozen=True)
class BAConfig:
    """Windowed photometric bundle adjustment (FrontEndOptimize.cpp)."""

    min_frames: int = 5                    # setting_minFrames
    max_frames: int = 7                    # setting_maxFrames
    max_opt_iterations: int = 6            # setting_maxOptIterations
    min_opt_iterations: int = 1            # setting_minOptIterations
    th_opt_iterations: float = 1.2         # setting_thOptIterations
    min_frame_age: int = 1                 # setting_minFrameAge
    desired_point_density: float = 2000.0  # setting_desiredPointDensity
    desired_immature_density: float = 1500.0
    outlier_th: float = 12.0 * 12.0        # setting_outlierTH (per pattern-pt x8)
    outlier_th_sum_component: float = 50.0 * 50.0
    frame_energy_th_n: float = 0.7         # setting_frameEnergyTHN (percentile)
    frame_energy_th_fac_median: float = 1.5
    frame_energy_th_const_weight: float = 0.5
    overall_energy_th_weight: float = 1.0
    huber_th: float = 9.0
    # priors (first KF / first iterations)
    initial_rot_prior: float = 1e11
    initial_trans_prior: float = 1e10
    initial_aff_a_prior: float = 1e14
    initial_aff_b_prior: float = 1e14
    initial_calib_hessian: float = 5e9
    idepth_fix_prior: float = 50.0 * 50.0
    # False: energy-gated LM accept (stable with exact gauge elimination);
    # True: DSO's force-accept scheme.
    solver_force_accept_step: bool = False
    marg_weight_fac: float = 0.25          # setting_margWeightFac = 0.5^2
    min_idepth_h_act: float = 100.0        # setting_minIdepthH_act
    min_idepth_h_marg: float = 50.0        # setting_minIdepthH_marg
    # isOOB / isInlierNew thresholds (DSO HessianBlocks.h, consumed by
    # flagPointsForRemoval, FrontEnd.cpp:538-541)
    min_good_active_res_for_marg: int = 3  # setting_minGoodActiveResForMarg
    min_good_res_for_marg: int = 4         # setting_minGoodResForMarg
    min_points_remaining: float = 0.05     # setting_minPointsRemaining
    # valid-row compaction budget for the windowed-BA programs (see
    # ba._compact_points): the pool is sized n_slots x max_points_per_frame
    # = 4096 but the window holds ~desired_point_density (~2000) live
    # points; routing the BA loop through a 2560-row compact view cuts its
    # gather-bound work by ~40%. Overflow (valid > budget) is detected on
    # device and the step redone full-shape. 0 disables compaction.
    compact_budget: int = 2560
    max_log_aff_fac_in_window: float = 0.7  # setting_maxLogAffFacInWindow
    # fixed array budgets (static shapes; replace dynamic vectors)
    max_points_per_frame: int = 512        # active points hosted per KF slot
    max_immature_per_frame: int = 1024
    # per-slot lane budget for the idepth-LM activation pass: the cheap
    # projection/distance gates run on ALL candidate lanes first, then the
    # 4-pass [lanes x window x 8px] gather program runs only on the first
    # `act_budget` gate-survivors per slot (in lane order, matching the
    # host's previous first-k insertion rule). Survivors beyond the budget
    # stay immature for a later keyframe — the same overflow policy the
    # shared point pool already applies. 256 >= the pool's per-slot segment
    # (max_points_per_frame / 2 typical steady-state churn), so it only
    # binds during bootstrap bursts.
    act_budget: int = 256


@dataclass(frozen=True)
class TraceConfig:
    """Immature point epipolar trace (DSO ImmaturePoint::traceOn)."""

    max_pix_search_frac: float = 0.027     # setting_maxPixSearch * (w+h)
    trace_slack_interval: float = 1.5
    trace_extra_slack_on_th: float = 1.2
    trace_gn_iterations: int = 3
    trace_step_size: float = 1.0
    trace_min_improvement_factor: float = 2.0
    trace_gn_threshold: float = 0.1
    min_trace_quality: float = 3.0         # setting_minTraceQuality
    outlier_th: float = 12.0 * 12.0
    # Uniform sample count over the (clamped) epipolar segment in the
    # production trace (trace_points_all_compact). DSO steps at
    # setting_trace_stepsize = 1 px over at most maxPixSearch =
    # 0.027 (W+H) ~ 43 px at KITTI res (~45 samples); 48 uniform samples
    # keep spacing under 1 px at the cap, and the 3-iteration GN refine
    # recovers sub-pixel either way. Cost is linear in the count.
    num_steps: int = 48
    # steady-state trace tier (see trace_points_all_compact's TIERED
    # note): on frames >= steady_after frames past the last keyframe,
    # the frontend dispatches the small (steady_budget x steady_num_steps)
    # program and defers lanes whose epipolar segment exceeds
    # steady_max_reach px to the next full dispatch. steady_max_reach <=
    # (steady_num_steps - 1) keeps sample spacing at DSO's 1 px. Set
    # steady_after = 0 to disable the tier (every frame full-shape).
    steady_after: int = 2
    steady_num_steps: int = 16
    steady_budget: int = 1024
    steady_max_reach: float = 15.0
    # Max lanes paying the epipolar SEARCH per trace dispatch (the window's
    # other ~7x1024 lanes are converged/OOB/skipped in steady state, and
    # the fixed-shape search pays 64 steps x 8 pattern taps on every lane).
    # Search-needing lanes beyond the
    # budget keep their previous interval one frame and trace next frame;
    # overflow is counted in the timing report (trace_overflow).
    search_budget: int = 2048


@dataclass(frozen=True)
class SelectorConfig:
    """Gradient-histogram pixel selector (DSO PixelSelector2)."""

    min_grad_hist_cut: float = 0.5         # setting_minGradHistCut
    min_grad_hist_add: float = 7.0         # setting_minGradHistAdd
    grad_down_weight_per_level: float = 0.75
    block_size: int = 32                   # histogram block for thresholds
    pot: int = 3                           # initial selection potential


@dataclass(frozen=True)
class ScaleOptConfig:
    """Stereo 1-DoF scale optimizer (FrontEnd.cpp:975-1064)."""

    # accept threshold; <0 disables scale opt entirely (odometry/DSO mode)
    accept_thres: float = 15.0             # scale_opt_thres param
    grid_guesses: Tuple[float, ...] = (0.1, 1.0, 5.0, 10.0, 15.0, 25.0, 30.0, 50.0)
    trapped_jump_thres: float = 0.5        # |scale-1| > 0.5 while trapped
    max_consecutive_fails: int = 5
    min_kfs_before_scale: int = 4          # skip until >4 KFs (FrontEnd.cpp:806)


@dataclass(frozen=True)
class LoopConfig:
    """Loop closure (LoopHandler.*, loop_detection/*, pose_estimation/*)."""

    lidar_range: float = 40.0              # <0 disables loop closure
    scan_context_thres: float = 0.33
    # scan generation (generate_spherical_points.h:23-25, 34-40)
    voxel_res: Tuple[float, float, float] = (1.0, 0.5, 1.0)
    orientation_trim_rad: float = 0.5
    # scan context (ScanContext.cpp:68-73)
    num_sectors: int = 60
    num_rings: int = 20
    # occupancy (binary) signatures instead of the reference's max-height:
    # measured 2x lower genuine-revisit distances on sparse photometric
    # clouds (see scancontext.generate docstring); max-height = False
    sc_binary_signature: bool = True
    # retrieval (search_place.h:21-23)
    knn: int = 3
    loop_margin: int = 100                 # insertion lag in frames
    ringkey_thres: float = 0.1
    # direct pose estimator gates (PoseEstimator.h:26-27, cpp:463-505)
    res_thres: float = 10.0
    inner_percent: float = 90.0
    # multi-seed direct alignment (pose_estimator.estimate_batch): yaw
    # perturbations of the primary seed, batched into ONE vmapped LM
    # dispatch — the tracker try-list idea (FrontEnd.cpp:132-186) applied
    # to loop closure. The PCA/ICP seed's dominant error mode is yaw
    # (Scan Context is a polar descriptor); a single-seed LM converges to
    # a nearby local minimum whose residual sits just above res_thres on
    # marginal revisits. Empty tuple = reference's single-seed behavior.
    seed_yaw_perturb_deg: Tuple[float, ...] = (3.0, -3.0, 6.0, -6.0)
    # icp (icp.h:20, 57-63)
    icp_thres: float = 1.5
    icp_max_iterations: int = 5
    icp_max_corr_dist: float = 2.0
    icp_transformation_eps: float = 0.01
    # pose graph edge weighting (LoopHandler.h:36-42)
    dso_error_scale: float = 5.0
    scale_error_scale: float = 0.1
    direct_error_scale: float = 0.1
    icp_error_scale: float = 1.0
    pose_r_weight: float = 1e4
    pgo_iterations: int = 25
    # fixed budgets
    max_scan_points: int = 4096
    max_loop_points: int = 2048            # sparse pts per loop frame
    # scan densification: export ALL non-outlier points leaving the window
    # to the loop handler's rolling cloud, not only the Schur-marginalized
    # subset (the reference uses pointHessiansMarginalized only,
    # LoopHandler.cpp:166-181). Weak-idepth-Hessian points still carry
    # plausible geometry, so the flag can only add scan density on scenes
    # where points fail the min_idepth_h_marg bar (texture-poor /
    # low-parallax). On the well-textured 80-frame synthetic loop demo it
    # is a measured NO-OP (every leaving point marginalizes; identical
    # scans and loops) — kept ON as a free robustness margin; False
    # restores exact reference behavior.
    densify_scans: bool = True
    # loop acceptance policy: False (default) = ICP refines the PCA seed,
    # direct photometric alignment (from ICP and odometry seeds) is the
    # acceptance gate whenever the current pyramid exists, ICP-only accept
    # limited to pyramid-less KFs (sparse-cloud ICP fitness alone verifies
    # wrong alignments; see PARITY.md). True = the reference's ordering
    # (LoopHandler.cpp:270-296): direct from the PCA seed only, else
    # ICP-only accept on fitness — A/B harness / parity mode.
    reference_acceptance: bool = False


@dataclass(frozen=True)
class RuntimeConfig:
    """Driver-level settings (main.cpp:212-265)."""

    sequence_gap_seconds: float = 10.0     # new-sequence detection
    quiet: bool = True
    multi_threading: bool = True           # loop thread on/off
    # initialization failure RMSE gates (FrontEnd.cpp:778-787)
    init_rmse_gates: Tuple[float, ...] = (25.0, 15.0, 10.0)
    # bootstrap selection: False = metric single-frame stereo init (this
    # build's default improvement); True = DSO-parity monocular
    # CoarseInitializer (FrontEnd.cpp:607-623) — combine with
    # scale_opt.accept_thres=-1 for full DSO mode
    mono_initializer: bool = False
    # give up and restart the mono initializer after this many frames
    # without a snap (DSO resets after 300; synthetic sequences are short)
    mono_init_max_frames: int = 40
    # live HTML viewer (viz/live.py; the Pangolin-GUI equivalent): path of
    # the self-refreshing live.html, "" = disabled
    live_view_path: str = ""
    # per-keyframe debug image dumps (viz/debug.py; TAS.cpp:338-449
    # idepth jets), "" = disabled
    debug_dump_dir: str = ""
    # goStepByStep (FrontEnd.cpp:689-700): wait for Enter between frames
    step_by_step: bool = False
    # pipelined tracking (frontend._process_pipelined): dispatch frame N's
    # track with a device-computed constant-motion candidate and consume
    # frame N-1's async-copied result afterward, hiding the per-frame
    # blocking host pull behind device work. Keyframe decisions
    # and lost detection lag one frame; KF/escalation/lost events flush the
    # pipeline synchronously. Ignored under winner_policy="serial".
    pipelined_tracking: bool = False


@dataclass(frozen=True)
class SLAMConfig:
    """Top-level config. `preset()`/`mode()` mirror main.cpp:75-132."""

    width: int = 1232
    height: int = 368
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    keyframe: KeyframeConfig = field(default_factory=KeyframeConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    trace: TraceConfig = field(default_factory=TraceConfig)
    selector: SelectorConfig = field(default_factory=SelectorConfig)
    scale_opt: ScaleOptConfig = field(default_factory=ScaleOptConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    photometric_mode: int = 1              # 0: calib, 1: none, 2: perfect

    def replace(self, **kw) -> "SLAMConfig":
        return dataclasses.replace(self, **kw)


def make_config(
    width: int,
    height: int,
    preset: int = 0,
    mode: int = 1,
    scale_opt_thres: float = 15.0,
    lidar_range: float = 40.0,
    scan_context_thres: float = 0.33,
) -> SLAMConfig:
    """Build a config the way the reference's ROS node does (main.cpp:75-132,
    293-308). preset 0 = default quality, preset 2 = fast; mode 0/1/2 =
    photometric calibration / none / perfect images."""
    if preset not in (0, 2):
        raise ValueError(f"preset={preset} is not supported (reference main.cpp:77-80)")

    ba = BAConfig()
    selector = SelectorConfig()
    tracker = TrackerConfig()

    if preset == 0:
        ba = dataclasses.replace(
            ba, desired_immature_density=1500.0, desired_point_density=2000.0,
            min_frames=5, max_frames=7, max_opt_iterations=6, min_opt_iterations=1,
            max_points_per_frame=512, max_immature_per_frame=1024,
        )
    elif preset == 2:
        ba = dataclasses.replace(
            ba, desired_immature_density=600.0, desired_point_density=800.0,
            min_frames=4, max_frames=6, max_opt_iterations=4, min_opt_iterations=1,
            max_points_per_frame=256, max_immature_per_frame=512,
        )

    if mode == 1:
        tracker = dataclasses.replace(tracker, affine_mode_a=0.0, affine_mode_b=0.0)
    elif mode == 2:
        tracker = dataclasses.replace(tracker, affine_mode_a=-1.0, affine_mode_b=-1.0)
        selector = dataclasses.replace(selector, min_grad_hist_add=3.0)
    elif mode == 0:
        # photometric calibration present: affine optimized with prior
        tracker = dataclasses.replace(tracker, affine_mode_a=1e12, affine_mode_b=1e8)

    return SLAMConfig(
        width=width,
        height=height,
        tracker=tracker,
        ba=ba,
        selector=selector,
        scale_opt=ScaleOptConfig(accept_thres=scale_opt_thres),
        loop=LoopConfig(lidar_range=lidar_range, scan_context_thres=scan_context_thres),
        photometric_mode=mode,
    )
