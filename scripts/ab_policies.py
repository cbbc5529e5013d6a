"""A/B policy-drift harness (VERDICT r1 item 7).

Where this framework's control policies deliberately deviate from the
reference, this harness quantifies the drift on adversarial synthetic
sequences so the chosen defaults are justified by numbers, not vibes:

1. Winner selection over the tracking try-list: staged growing batches
   (1 -> 5 -> 78, early exit per batch; `tracker.winner_policy=
   "staged"`) vs the reference's serial achievedRes-tightening walk
   (`"serial"`, FrontEnd.cpp:198-248).
2. Windowed-BA step acceptance: energy-gated LM (default) vs the
   reference's `setting_forceAceptStep=true` (`ba.solver_force_accept_step`,
   FrontEndOptimize.cpp:427-449).
3. Loop acceptance: ICP-refined + photometric verification (default) vs
   the reference's direct-from-PCA-seed -> ICP-fitness-only fallback
   (`loop.reference_acceptance`, LoopHandler.cpp:270-296).

Scenarios: nominal forward motion, a brightness-jump sequence (exposure
steps mid-run exercise the affine gates), and the fast-rotation loop lap
(~5 deg/frame yaw — the try-list's reason to exist — with loop closure).

Run: `python scripts/ab_policies.py [--frames N] [--out results.md]`
(CPU; ~10-20 min cold). Results are recorded in PARITY.md's
"Policy A/B deltas" section.
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_scenario(name, n_frames):
    import jax.numpy as jnp
    from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset

    W, H = 320, 96
    if name == "fast_rotation":
        ds = SyntheticStereoDataset(n_frames=n_frames, width=W, height=H,
                                    trajectory="loop")
        gains = np.ones(n_frames)
    elif name == "brightness_jump":
        ds = SyntheticStereoDataset(n_frames=n_frames, width=W, height=H,
                                    trajectory="forward")
        gains = np.ones(n_frames)
        # exposure steps: x1.7 for the middle third, back down after
        gains[n_frames // 3: 2 * n_frames // 3] = 1.7
    else:  # nominal
        ds = SyntheticStereoDataset(n_frames=n_frames, width=W, height=H,
                                    trajectory="forward")
        gains = np.ones(n_frames)
    return ds, gains, W, H


def run_one(scenario, variant, n_frames, levels=4):
    import jax.numpy as jnp
    from direct_stereo_slam_tpu.config import make_config
    from direct_stereo_slam_tpu.geometry.camera import make_pyramid_intrinsics
    from direct_stereo_slam_tpu.loop.handler import LoopHandler
    from direct_stereo_slam_tpu.runtime.node import SLAMNode

    ds, gains, W, H = build_scenario(scenario, n_frames)
    cfg = make_config(W, H)
    cfg = cfg.replace(tracker=cfg.tracker.__class__(pyr_levels=levels))
    with_loop = scenario == "fast_rotation"
    if with_loop:
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, loop_margin=4))
    if variant == "serial_winner":
        cfg = cfg.replace(tracker=dataclasses.replace(
            cfg.tracker, winner_policy="serial"))
    elif variant == "force_accept":
        cfg = cfg.replace(ba=dataclasses.replace(
            cfg.ba, solver_force_accept_step=True))
    elif variant == "reference_loop":
        cfg = cfg.replace(loop=dataclasses.replace(
            cfg.loop, reference_acceptance=True))

    K = ds.K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                                   W, H, levels)
    handler = LoopHandler(cfg, intr, threaded=False) if with_loop else None
    node = SLAMNode(cfg, intr, intr, ds.t_cam1_cam0, loop_handler=handler)

    t0 = time.perf_counter()
    for i, f in enumerate(ds):
        g = float(gains[i])
        img0, img1 = f["img0"], f["img1"]
        if g != 1.0:
            img0 = jnp.clip(img0 * g, 0, 255)
            img1 = jnp.clip(img1 * g, 0, 255)
        node.process(img0, img1, f["timestamp"])
        if node.frontend.is_lost:
            break
    node.finish()
    dt = time.perf_counter() - t0

    fe = node.frontend
    est = np.stack([sh.T_wc[:3, 3] for sh in fe.all_frames]) \
        if fe.all_frames else np.zeros((1, 3))
    gt = ds.poses[:len(est), :3, 3]
    ate = float(np.sqrt(((est - gt) ** 2).sum(1).mean()))
    out = {
        "scenario": scenario, "variant": variant,
        "frames": len(fe.all_frames), "kfs": len(fe.kf_shells),
        "lost": fe.is_lost, "ate": ate,
        "endpoint": float(np.linalg.norm(est[-1] - gt[len(est) - 1])),
        "sec": dt,
    }
    if handler is not None:
        out["loops"] = handler.direct_loop_count + handler.icp_loop_count
        odo = {r[0]: np.array(r[1:4]) for r in handler.odometry_rows()}
        opt = {r[0]: np.array(r[1:4]) for r in handler.optimized_rows()}
        kf_gt = {sh.incoming_id: ds.poses[i][:3, 3]
                 for i, sh in enumerate(fe.all_frames) if sh.is_kf}
        common = [k for k in opt if k in kf_gt]
        if common:
            out["ate_sodso"] = float(np.sqrt(np.mean(
                [np.sum((odo[k] - kf_gt[k]) ** 2) for k in common])))
            out["ate_dslam"] = float(np.sqrt(np.mean(
                [np.sum((opt[k] - kf_gt[k]) ** 2) for k in common])))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true", default=True)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu") if args.cpu else None
    from direct_stereo_slam_tpu.utils.compile_cache import (
        setup_compilation_cache)
    setup_compilation_cache()

    grid = [
        ("nominal", ["baseline", "serial_winner", "force_accept"]),
        ("brightness_jump", ["baseline", "serial_winner", "force_accept"]),
        ("fast_rotation", ["baseline", "serial_winner", "force_accept",
                           "reference_loop"]),
    ]
    rows = []
    for scenario, variants in grid:
        for v in variants:
            r = run_one(scenario, v, args.frames)
            rows.append(r)
            print(f"[{scenario}/{v}] frames={r['frames']} kfs={r['kfs']} "
                  f"ate={r['ate']:.3f} end={r['endpoint']:.3f} "
                  f"lost={r['lost']} loops={r.get('loops', '-')} "
                  f"dslam={r.get('ate_dslam', float('nan')):.3f}",
                  flush=True)

    lines = [
        "| scenario | variant | frames | KFs | ATE (m) | endpoint (m) | "
        "lost | loops | dslam ATE |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['scenario']} | {r['variant']} | {r['frames']} | "
            f"{r['kfs']} | {r['ate']:.3f} | {r['endpoint']:.3f} | "
            f"{'yes' if r['lost'] else 'no'} | {r.get('loops', '—')} | "
            f"{r.get('ate_dslam', float('nan')):.3f} |")
    table = "\n".join(lines)
    print("\n" + table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table + "\n")


if __name__ == "__main__":
    main()
