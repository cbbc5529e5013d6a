#!/usr/bin/env python
"""Render a long synthetic stereo sequence into the KITTI odometry disk
layout, so the REAL-FORMAT ingestion path (PNG decode -> calib parse ->
stereo sync -> full pipeline) can be exercised at realistic length and
resolution without the actual KITTI download (BASELINE.md's documented
one-step follow-up).

Produces ``<out>/sequences/<seq>/{image_0,image_1}/NNNNNN.png``,
``times.txt``, ``calib.txt`` (P0/P1 rows; the reader derives fx/fy/cx/cy
and baseline = -P1[0,3]/fx, io/dataset.py:173-193) and
``<out>/poses/<seq>.txt`` (devkit 3x4 row-major ground truth) — exactly
what ``scripts/eval_kitti.py`` consumes.

The world is the box-rich loop room used by the bench's loop lap
(bench.py:405-423) on the r2 long-horizon trajectory (radius 8, 4.5
deg/frame yaw): with the reference-default loop_margin=100, revisits
past lap 1.25 close loops at the reference scan_context_thres=0.33.

Usage:
    python scripts/gen_longseq.py --out /tmp/kitti_synth \
        [--frames 320] [--width 1232] [--height 368] [--seq 00]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--seq", default="00")
    ap.add_argument("--frames", type=int, default=320)
    ap.add_argument("--width", type=int, default=1232)
    ap.add_argument("--height", type=int, default=368)
    ap.add_argument("--radius", type=float, default=8.0)
    ap.add_argument("--deg-per-frame", type=float, default=4.5)
    ap.add_argument("--fps", type=float, default=10.0)
    args = ap.parse_args()

    import jax.numpy as jnp
    from PIL import Image

    from direct_stereo_slam_tpu.io.synthetic import (
        SyntheticStereoDataset, default_scene, loop_trajectory)

    W, H, N = args.width, args.height, args.frames
    laps = args.deg_per_frame * N / 360.0

    # box-rich room, identical construction to bench.py's loop lap
    rngb = np.random.RandomState(7)
    centers = []
    while len(centers) < 14:
        c = rngb.uniform(-22, 22, 3)
        c[1] = rngb.uniform(-1.5, 0.5)
        c[2] = rngb.uniform(-14, 30)
        if np.hypot(c[0], c[2] - 8.0) < 4.0 or np.hypot(c[0], c[2] - 8.0) > 13.0:
            centers.append(c)
    scene = default_scene(wall_x=25.0, front_z=45.0, back_z=-25.0)
    scene = scene._replace(
        box_centers=jnp.asarray(np.stack(centers), jnp.float32),
        box_half=jnp.asarray(rngb.uniform(0.5, 2.0, (14, 3)), jnp.float32),
        box_phase=jnp.asarray(rngb.uniform(0, 6.28, (14, 2)), jnp.float32),
    )
    ds = SyntheticStereoDataset(n_frames=N, width=W, height=H, scene=scene)
    ds.poses = loop_trajectory(N, radius=args.radius, laps=laps, ease_in=8)

    seq_dir = os.path.join(args.out, "sequences", args.seq)
    os.makedirs(os.path.join(seq_dir, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(seq_dir, "image_1"), exist_ok=True)
    os.makedirs(os.path.join(args.out, "poses"), exist_ok=True)

    K = ds.K
    baseline = float(-ds.t_cam1_cam0[0, 3])
    P0 = np.zeros((3, 4))
    P0[:3, :3] = K
    P1 = P0.copy()
    P1[0, 3] = -K[0, 0] * baseline
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        for name, P in (("P0", P0), ("P1", P1)):
            f.write(name + ": " + " ".join(f"{v:.12e}" for v in P.ravel())
                    + "\n")

    times, pose_rows = [], []
    for i in range(N):
        fr = ds.frame(i)
        for cam, img in (("image_0", fr["img0"]), ("image_1", fr["img1"])):
            arr = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
            Image.fromarray(arr, mode="L").save(
                os.path.join(seq_dir, cam, f"{i:06d}.png"))
        times.append(i / args.fps)
        pose_rows.append(np.asarray(ds.poses[i])[:3, :4].ravel())
        if (i + 1) % 20 == 0:
            print(f"rendered {i + 1}/{N}", flush=True)

    np.savetxt(os.path.join(seq_dir, "times.txt"),
               np.asarray(times), fmt="%.6f")
    np.savetxt(os.path.join(args.out, "poses", f"{args.seq}.txt"),
               np.stack(pose_rows), fmt="%.9e")
    print("wrote", seq_dir)


if __name__ == "__main__":
    main()
