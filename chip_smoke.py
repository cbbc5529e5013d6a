#!/usr/bin/env python
"""Smoke test of the SLAM path on NVIDIA GPUs at KITTI resolution.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --multi   # four cards: the batched tracking step
                                   # sharded over Mesh('seq'), against the
                                   # same batch unsharded on one card

The configuration is the reference's KITTI setting:
``make_config(1232, 368, preset=0, mode=1)`` (2000 active points, 5-7
keyframes, 5 pyramid levels) with the loop stack at its reference defaults
(lidar_range=40, scan_context_thres=0.33). Frames come from the synthetic
renderer (io/synthetic.py), which gives exact ground truth.

Phases (each prints one line: compile seconds, run seconds, and every
comparison against its tolerance):

- hot_path:     track_candidate + optimize_scale_single on a 2000-point
                template; tracked pose vs the renderer's ground truth,
                scale vs 1 (the template's depths are exact).
- hb_vs_cpu:    the fused pose_residual_pass H/b at level 0 on the card vs
                the same pass on the CPU backend, identical inputs.
- distance_map: build_distance_map on the 184x616 half-res grid vs the
                numpy brute force (exact), plus its time on the card.
- e2e:          SLAMNode + LoopHandler over a 40-frame forward sequence,
                runtime config at its defaults; ATE vs ground truth.
- e2e_pipelined: the same with pipelined_tracking=True; ATE vs the first.
- loop_lap:     240-frame stadium revisit lap through SLAMNode with the
                threaded loop handler; the loop stages must run.
- pose_graph:   2048-node chain with a loop edge, dense vs CG solver.

The process exits non-zero if any phase fails, and before any phase when
JAX finds no GPU: no CPU run is reported under a GPU's name. The last line
of a passing run is ``{"ok": true, "device": {...}}``.

The CPU comparison runs in this same process on ``jax.devices("cpu")``, so
the CPU platform must stay visible: do not narrow ``JAX_PLATFORMS`` to
``cuda``. One process drives the card(s); nothing here starts another JAX
process (the one child, nvidia-smi, stays off the card's memory).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Callable, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Size:
    """Everything a phase sizes. FULL is the real configuration; tests run
    the phases at TINY on the CPU."""

    width: int = 1232
    height: int = 368
    levels: int = 5
    n_points: int = 2000          # preset-0 active point budget
    hot_iters: int = 30
    e2e_frames: int = 40
    lap_frames: int = 240
    lap_laps: float = 1.6
    lap_margin: int = 12          # lap is ~35 KFs end to end
    lap_required: Tuple[str, ...] = ("sc_generation", "search_sc",
                                     "direct_est")
    dm_points: int = 2000
    pg_nodes: int = 2048
    multi_batch: int = 8
    ba: Tuple[Tuple[str, float], ...] = ()   # BAConfig overrides


FULL = Size()
TINY = Size(
    width=320, height=96, levels=4, n_points=2000, hot_iters=2,
    e2e_frames=16, lap_frames=40, lap_laps=0.35, lap_margin=12,
    lap_required=("sc_generation",), dm_points=300, pg_nodes=128,
    multi_batch=4,
    ba=(("max_frames", 5), ("min_frames", 3), ("desired_point_density", 600.0),
        ("desired_immature_density", 450.0), ("max_points_per_frame", 128),
        ("max_immature_per_frame", 512)))

# tolerances, each with its reason
TRACK_TOL = 0.01        # tangent norm vs ground truth (tracker recipe)
SCALE_TOL = 0.03        # |s - 1| with exact template depths (scale-opt tests)
# H/b card vs CPU: same f32 math on identical inputs, sums taken in
# another order (~1e-6 over ~8000 template lanes). TF32 in a product would
# show ~1e-3, so 1e-4 separates the two.
HB_TOL = 1e-4
HB_TERMS_TOL = 0        # off the pixel grid no lane sits on a border test
ATE_FRAC = 0.02         # e2e ATE / path length (tests/test_frontend_e2e)
PIPE_FRAC = 0.03        # |ATE_pipelined - ATE| / path length
# dense LU vs PCG on the same GN problem: both solve each step's system
# to f32 precision, so the final poses agree to well under a centimetre
PG_TOL_M = 0.01
# sharded vs one card: same programs on the same card model; agreement
# far inside the tracking gate (TRACK_TOL)
MULTI_TOL = 1e-3


class Phase:
    """One phase's times, its checks against tolerances, and notes."""

    def __init__(self, name: str):
        self.name = name
        self.compile_s = float("nan")
        self.run_s = float("nan")
        self.checks: List[Tuple[str, float, float, bool]] = []
        self.notes: List[str] = []
        self.error = None

    def check(self, what: str, value, tol) -> None:
        value = float(value)
        self.checks.append((what, value, float(tol), bool(value <= tol)))

    def note(self, text: str) -> None:
        self.notes.append(text)

    @property
    def ok(self) -> bool:
        return (self.error is None and bool(self.checks)
                and all(c[3] for c in self.checks))

    def line(self) -> str:
        cmp = "; ".join(f"{w} {v:.3g} {'<=' if ok else '>'} {t:.3g}"
                        for w, v, t, ok in self.checks)
        out = (f"[{self.name}] {'ok' if self.ok else 'FAIL'} "
               f"compile_s={self.compile_s:.1f} run_s={self.run_s:.3f}"
               f" | {cmp}")
        if self.notes:
            out += " | " + "; ".join(self.notes)
        if self.error:
            out += f" | error: {self.error}"
        return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _config(sz: Size, **runtime):
    from direct_stereo_slam_tpu.config import make_config

    cfg = make_config(sz.width, sz.height, preset=0, mode=1)
    return cfg.replace(
        tracker=dataclasses.replace(cfg.tracker, pyr_levels=sz.levels),
        ba=dataclasses.replace(cfg.ba, **dict(sz.ba)),
        runtime=dataclasses.replace(cfg.runtime, **runtime))


def _intrinsics(ds, sz: Size):
    from direct_stereo_slam_tpu.geometry.camera import make_pyramid_intrinsics

    K = ds.K
    return make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                                   sz.width, sz.height, sz.levels)


def _tangent_err(T_est, T_gt) -> float:
    from direct_stereo_slam_tpu.geometry.lie import se3_log_np

    d = np.linalg.inv(np.asarray(T_gt, np.float64)) @ np.asarray(
        T_est, np.float64)
    return float(np.linalg.norm(se3_log_np(d)))


def _template_inputs(f0, sz: Size, seed: int = 0):
    """Random template points with the renderer's exact depths."""
    rng = np.random.RandomState(seed)
    us = rng.uniform(3, sz.width - 4, sz.n_points).astype(np.float32)
    vs = rng.uniform(3, sz.height - 4, sz.n_points).astype(np.float32)
    depth = np.asarray(f0["depth0"])[vs.astype(int), us.astype(int)]
    return us, vs, (1.0 / depth).astype(np.float32)


def _template(f0, sz: Size, seed: int = 0):
    import jax.numpy as jnp

    from direct_stereo_slam_tpu.models.depth_template import (
        build_template, default_budgets)

    us, vs, ids = _template_inputs(f0, sz, seed)
    return build_template(
        jnp.asarray(us), jnp.asarray(vs), jnp.asarray(ids),
        jnp.ones(sz.n_points, jnp.float32), jnp.asarray(f0["img0"]),
        sz.levels, default_budgets(sz.width, sz.height, sz.levels))


def _memory(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "n/a"
    mib = lambda n: f"{n / 2**20:.1f}"
    return (f"args {mib(m.argument_size_in_bytes)} MiB, "
            f"out {mib(m.output_size_in_bytes)} MiB, "
            f"temp {mib(m.temp_size_in_bytes)} MiB, "
            f"code {mib(m.generated_code_size_in_bytes)} MiB")


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_hot_path(p: Phase, sz: Size) -> None:
    import jax
    import jax.numpy as jnp

    from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset
    from direct_stereo_slam_tpu.models.scale_opt import optimize_scale_single
    from direct_stereo_slam_tpu.models.tracker import AffLight, track_candidate
    from direct_stereo_slam_tpu.ops.pyramid import build_pyramid

    cfg = _config(sz)
    ds = SyntheticStereoDataset(n_frames=2, width=sz.width, height=sz.height,
                                speed=0.4)
    f0, f1 = ds.frame(0), ds.frame(1)
    intr = _intrinsics(ds, sz)
    tmpl = _template(f0, sz)
    t10 = jnp.asarray(ds.t_cam1_cam0)
    zero = AffLight(jnp.float32(0.0), jnp.float32(0.0))
    one = jnp.float32(1.0)
    img_new = jax.device_put(f1["img0"])
    img_right = jax.device_put(f0["img1"])     # template frame's right view
    T_init = jnp.eye(4, dtype=jnp.float32)

    @jax.jit
    def frame_step(img, T0):
        pyr = build_pyramid(img, sz.levels)
        return track_candidate(tuple(pyr.data), tmpl, intr, cfg, T0,
                               zero, zero, one, one)

    @jax.jit
    def scale_step(img_r):
        # starts 20% off; the exact template depths put the optimum at 1
        pyr = build_pyramid(img_r, sz.levels)
        return optimize_scale_single(tuple(pyr.data), tmpl, intr, intr, t10,
                                     cfg, jnp.float32(1.2))

    def first():
        tr = frame_step(img_new, T_init)
        so = scale_step(img_right)
        return jax.block_until_ready((tr, so))

    (tr, so), p.compile_s = _timed(first)

    def warm():
        for i in range(sz.hot_iters):
            out = frame_step(img_new, T_init)
            if i % 3 == 0:
                s = scale_step(img_right)
        return jax.block_until_ready((out, s))

    _, p.run_s = _timed(warm)
    T_gt = np.linalg.inv(np.asarray(ds.poses[1], np.float64)) @ np.asarray(
        ds.poses[0], np.float64)
    p.check("track err", _tangent_err(np.asarray(tr.T), T_gt), TRACK_TOL)
    p.check("|scale-1|", abs(float(so.scale) - 1.0), SCALE_TOL)
    p.note(f"{sz.hot_iters / p.run_s:.1f} frames/s tracking + scale every "
           "3rd frame (info)")
    print(f"  memory track step: "
          f"{_memory(frame_step.lower(img_new, T_init).compile())}",
          flush=True)


def phase_hb_vs_cpu(p: Phase, sz: Size) -> None:
    import jax
    import jax.numpy as jnp

    from direct_stereo_slam_tpu.geometry.lie import se3_exp_np, se3_log_np
    from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset
    from direct_stereo_slam_tpu.ops.pyramid import build_pyramid
    from direct_stereo_slam_tpu.ops.residual_hb import pose_residual_pass

    cfg = _config(sz)
    cpu = jax.devices("cpu")[0]
    card = jax.devices()[0]
    ds = SyntheticStereoDataset(n_frames=2, width=sz.width, height=sz.height,
                                speed=0.4)
    f0, f1 = ds.frame(0), ds.frame(1)
    intr = _intrinsics(ds, sz)
    # identical inputs for both backends, built once on the CPU
    with jax.default_device(cpu):
        tmpl = _template(f0, sz)
        img = build_pyramid(jnp.asarray(f1["img0"]), sz.levels).data[0]
        args = jax.device_get((img, tmpl.pu[0], tmpl.pv[0], tmpl.pid[0],
                               tmpl.pcolor[0], tmpl.pmask[0]))
    Ki = jnp.asarray(intr.Ki(0), jnp.float32)
    tc = cfg.tracker
    # half the true motion: residuals and gradient are far from zero, and
    # warped points land off the pixel grid (under the identity warp the
    # template's integer pixel positions sit exactly on the border tests,
    # where one ulp flips a lane)
    T_gt = np.linalg.inv(np.asarray(ds.poses[1], np.float64)) @ np.asarray(
        ds.poses[0], np.float64)
    T = se3_exp_np(0.5 * se3_log_np(T_gt)).astype(np.float32)
    RKi = jnp.asarray(T[:3, :3] @ np.asarray(intr.Ki(0), np.float32))

    @jax.jit
    def hb(img, pu, pv, pid, pcolor, pmask):
        out = pose_residual_pass(
            img, pu, pv, pid, pcolor, pmask, RKi, Ki, jnp.asarray(T[:3, 3]),
            jnp.float32(1.0), jnp.float32(0.0), jnp.float32(0.0),
            intr.fx[0], intr.fy[0], intr.cx[0], intr.cy[0],
            tc.huber_th, jnp.float32(tc.coarse_cutoff_th))
        return out.H, out.b, out.stats.E, out.stats.num_terms

    def run_on(dev):
        with jax.default_matmul_precision("highest"):
            return jax.device_get(hb(*jax.device_put(args, dev)))

    out_card, p.compile_s = _timed(lambda: run_on(card))
    out_cpu, p.run_s = _timed(lambda: run_on(cpu))
    rel = lambda a, b: np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
    p.check("H rel", rel(out_card[0], out_cpu[0]), HB_TOL)
    p.check("b rel", rel(out_card[1], out_cpu[1]), HB_TOL)
    p.check("E rel", rel(out_card[2], out_cpu[2]), HB_TOL)
    p.check("terms diff", abs(float(out_card[3]) - float(out_cpu[3])),
            HB_TERMS_TOL)
    p.note(f"{int(out_cpu[3])} terms, run_s is the CPU pass")


def phase_distance_map(p: Phase, sz: Size) -> None:
    import jax
    import jax.numpy as jnp

    from direct_stereo_slam_tpu.ops.distance_map import (
        build_distance_map, reference_distance_map)

    h2, w2, n = sz.height // 2, sz.width // 2, sz.dm_points
    rng = np.random.RandomState(0)
    pu = rng.rand(n).astype(np.float32) * (w2 - 1)
    pv = rng.rand(n).astype(np.float32) * (h2 - 1)
    mask = rng.rand(n) < 0.9
    args = (jnp.asarray(pu), jnp.asarray(pv), jnp.asarray(mask))
    out, p.compile_s = _timed(
        lambda: build_distance_map(*args, h2, w2).block_until_ready())
    reps = 200

    def warm():
        for _ in range(reps):
            d = build_distance_map(*args, h2, w2)
        return d.block_until_ready()

    _, p.run_s = _timed(warm)
    # in-program cost: many transforms in one dispatch
    batch = 64
    many = jax.jit(jax.vmap(lambda a, b, c: build_distance_map(a, b, c, h2, w2)))
    bargs = [jnp.stack([x] * batch) for x in args]
    many(*bargs).block_until_ready()
    _, t_many = _timed(lambda: many(*bargs).block_until_ready())
    ref = reference_distance_map(pu, pv, mask, h2, w2)
    p.check("cells differing", int(np.sum(np.asarray(out) != ref)), 0)
    p.note(f"{h2}x{w2}, {n} points: {1e6 * p.run_s / reps:.1f} us per "
           f"call incl. dispatch, {1e6 * t_many / batch:.1f} us per "
           f"transform in a batch of {batch}")


def _device_frames(ds):
    import jax

    frames = []
    for i in range(len(ds)):
        f = ds.frame(i)
        frames.append((jax.device_put(f["img0"]), jax.device_put(f["img1"]),
                       float(f["timestamp"])))
    jax.block_until_ready(frames[-1][0])
    return frames


def _frame_ate(node, ds) -> float:
    est = np.stack([s.T_wc[:3, 3] for s in node.frontend.all_frames])
    gt = np.stack([np.asarray(T)[:3, 3] for T in ds.poses[:len(est)]])
    return float(np.sqrt(((est - gt) ** 2).sum(1).mean()))


def _e2e(p: Phase, sz: Size, pipelined: bool):
    from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset
    from direct_stereo_slam_tpu.runtime.eval import run_frames

    ds = SyntheticStereoDataset(n_frames=sz.e2e_frames, width=sz.width,
                                height=sz.height, speed=0.4)
    frames = _device_frames(ds)
    intr = _intrinsics(ds, sz)
    path = 0.4 * (sz.e2e_frames - 1)
    run = lambda cfg: run_frames(frames, cfg, intr, ds.t_cam1_cam0)
    node, _, _, p.compile_s = run(_config(sz))
    ate = _frame_ate(node, ds)
    if pipelined:
        cfg_p = _config(sz, pipelined_tracking=True)
        _, _, _, p.compile_s = run(cfg_p)
        node_p, _, _, p.run_s = run(cfg_p)
        ate_p = _frame_ate(node_p, ds)
        p.check("|ATE_pipe-ATE|/path", abs(ate_p - ate) / path, PIPE_FRAC)
        p.note(f"ATE {ate:.4f} m sync, {ate_p:.4f} m pipelined, "
               f"path {path:.1f} m; warm {sz.e2e_frames / p.run_s:.2f} "
               "frames/s pipelined (info)")
        return node_p
    node, _, _, p.run_s = run(_config(sz))
    p.check("ATE/path", _frame_ate(node, ds) / path, ATE_FRAC)
    p.note(f"ATE {ate:.4f} m over {path:.1f} m; warm "
           f"{sz.e2e_frames / p.run_s:.2f} frames/s (info); "
           f"{node.frontend.num_kfs} KFs")
    return node


def phase_e2e(p: Phase, sz: Size) -> None:
    from direct_stereo_slam_tpu.models import ba

    node = _e2e(p, sz, pipelined=False)
    fe = node.frontend
    cb = fe.cfg.ba.compact_budget
    cb = cb if 0 < cb < fe.pool else None
    lowered = ba.optimize_keyframe.lower(
        fe.ba_state, fe.cfg, fe.cfg.ba.max_opt_iterations, 0, cb)
    print(f"  memory BA step: {_memory(lowered.compile())}", flush=True)


def phase_e2e_pipelined(p: Phase, sz: Size) -> None:
    _e2e(p, sz, pipelined=True)


def phase_loop_lap(p: Phase, sz: Size) -> None:
    from direct_stereo_slam_tpu.io.synthetic import stadium_revisit_dataset
    from direct_stereo_slam_tpu.runtime.eval import run_frames, score_rows

    ds = stadium_revisit_dataset(sz.lap_frames, sz.width, sz.height,
                                 laps=sz.lap_laps)
    frames = _device_frames(ds)
    cfg = _config(sz)
    cfg = cfg.replace(loop=dataclasses.replace(
        cfg.loop, loop_margin=sz.lap_margin, icp_thres=0.25))
    run = lambda: run_frames(frames, cfg, _intrinsics(ds, sz),
                             ds.t_cam1_cam0, threaded_loop=True)
    _, cold, _, p.compile_s = run()
    node, handler, timers, p.run_s = run()
    for stage in sz.lap_required:
        p.check(f"{stage} missing", float(timers.count(stage) == 0), 0)
    gt = np.stack([np.asarray(T)[:3, 3] for T in ds.poses])
    ate_o = score_rows(handler.odometry_rows(), gt)
    ate_d = score_rows(handler.optimized_rows(), gt)
    errs = sorted(t[0] for t in handler.try_log)
    closures = handler.direct_loop_count + handler.icp_loop_count
    p.note(f"{closures} verified closures "
           f"({cold.direct_loop_count + cold.icp_loop_count} in the cold "
           f"lap), {len(errs)} direct tries, best_err "
           f"{errs[0] if errs else float('nan'):.2f} (gate "
           f"{cfg.loop.res_thres}), ATE sodso {ate_o} m, dslam {ate_d} m; "
           f"warm {sz.lap_frames / p.run_s:.2f} frames/s (info)")


def phase_pose_graph(p: Phase, sz: Size) -> None:
    import jax

    from direct_stereo_slam_tpu.io.synthetic import pose_chain_with_loop
    from direct_stereo_slam_tpu.loop import pose_graph

    poses, edges = pose_chain_with_loop(sz.pg_nodes)
    data = pose_graph.build_data(poses, edges, fixed_node=sz.pg_nodes - 1)
    n = sz.pg_nodes
    T_dense, p.compile_s = _timed(lambda: np.asarray(jax.block_until_ready(
        pose_graph.optimize(data, 25, 1.0, "dense"))))
    # CG needs about as many iterations as the chain is long
    T_cg, p.run_s = _timed(lambda: np.asarray(jax.block_until_ready(
        pose_graph.optimize(data, 25, 1.0, "cg", n))))
    # the loop handler's own setting: "auto" with 100 CG iterations
    T_auto = np.asarray(pose_graph.optimize(data, 25))
    gap = lambda T: np.linalg.norm(T_dense[:n, :3, 3] - T[:n, :3, 3], axis=1)
    p.check("max |p_dense-p_cg| m", gap(T_cg).max(), PG_TOL_M)
    moved = np.linalg.norm(T_dense[:n, :3, 3] - poses[:, :3, 3], axis=1)
    p.note(f"{n} nodes; dense moved nodes up to {moved.max():.3f} m; "
           f"solver='auto' (100 CG iterations) is {gap(T_auto).max():.4f} m "
           "from dense (info); compile_s/run_s are the dense/CG solves "
           "incl. compile")


def phase_multi(p: Phase, sz: Size, n_devices: int) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset
    from direct_stereo_slam_tpu.parallel.mesh import (
        make_batched_step, make_mesh, shard_batched_step)

    B = sz.multi_batch
    cfg = _config(sz)
    seqs = [SyntheticStereoDataset(
        n_frames=2, width=sz.width, height=sz.height,
        speed=0.25 + 0.05 * (i % 4), yaw_rate=0.004 * (i % 3))
        for i in range(B)]
    frames = [(ds.frame(0), ds.frame(1)) for ds in seqs]
    intr = _intrinsics(seqs[0], sz)
    tmpl = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[_template(f0, sz, seed=i) for i, (f0, _) in enumerate(frames)])
    img0 = jnp.stack([jnp.asarray(f1["img0"]) for _, f1 in frames])
    img1 = jnp.stack([jnp.asarray(f0["img1"]) for f0, _ in frames])
    T_init = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B, 4, 4))
    args = (img0, img1, tmpl, T_init)

    step = make_batched_step(intr, cfg, sz.levels)
    mesh = make_mesh(n_devices)
    sharded = shard_batched_step(step, mesh)
    single = jax.jit(step)
    # inputs placed once, as a batch evaluation keeps them: sequences
    # split over the mesh, or all on the first card
    on_mesh = jax.device_put(args, NamedSharding(mesh, PartitionSpec("seq")))
    one_card = jax.device_put(args, jax.devices()[0])

    out_s, p.compile_s = _timed(lambda: jax.block_until_ready(
        sharded(*on_mesh)))
    out_1, _ = _timed(lambda: jax.block_until_ready(single(*one_card)))

    def median_step(fn, xs, reps=10):
        return float(np.median([_timed(lambda: jax.block_until_ready(
            fn(*xs)))[1] for _ in range(reps)]))

    p.run_s = median_step(sharded, on_mesh)
    t_single = median_step(single, one_card)

    T_s, T_1 = np.asarray(out_s.T), np.asarray(out_1.T)
    s_s, s_1 = np.asarray(out_s.scale), np.asarray(out_1.scale)
    p.check("max T diff (tangent)",
            max(_tangent_err(T_s[b], T_1[b]) for b in range(B)), MULTI_TOL)
    p.check("max scale rel diff", np.max(np.abs(s_s - s_1) / np.abs(s_1)),
            MULTI_TOL)
    gt_err = max(_tangent_err(
        T_s[b], np.linalg.inv(np.asarray(ds.poses[1], np.float64))
        @ np.asarray(ds.poses[0], np.float64)) for b, ds in enumerate(seqs))
    p.check("max track err vs GT", gt_err, TRACK_TOL)
    p.check("max |scale-1|", np.max(np.abs(s_s - 1.0)), SCALE_TOL)
    p.note(f"B={B} over {n_devices} devices; median warm step "
           f"{p.run_s:.4f} s sharded vs {t_single:.4f} s on one card (info)")


PHASES: List[Tuple[str, Callable]] = [
    ("hot_path", phase_hot_path),
    ("hb_vs_cpu", phase_hb_vs_cpu),
    ("distance_map", phase_distance_map),
    ("e2e", phase_e2e),
    ("e2e_pipelined", phase_e2e_pipelined),
    ("loop_lap", phase_loop_lap),
    ("pose_graph", phase_pose_graph),
]


def run_phase(name: str, fn: Callable, *args) -> Phase:
    p = Phase(name)
    try:
        fn(p, *args)
    except Exception as e:  # a failed phase is reported; the rest still run
        traceback.print_exc()
        p.error = f"{type(e).__name__}: {e}"[:300]
    print(p.line(), flush=True)
    return p


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded batch phase")
    args = ap.parse_args(argv)

    import jax

    from direct_stereo_slam_tpu.utils.compile_cache import (
        setup_compilation_cache)
    from direct_stereo_slam_tpu.utils.device import (
        name_and_power_limit, require_gpus)

    need = 4 if args.multi else 1
    devs = require_gpus(need)
    print(f"compile cache: {setup_compilation_cache()}", flush=True)
    for line in name_and_power_limit():
        print(f"nvidia-smi: {line}", flush=True)
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}",
          flush=True)

    t0 = time.perf_counter()
    if args.multi:
        results = [run_phase("multi", phase_multi, FULL, need)]
    else:
        results = [run_phase(n, fn, FULL) for n, fn in PHASES]
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    failed = [r.name for r in results if not r.ok]
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
