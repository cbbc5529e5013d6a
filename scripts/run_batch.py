#!/usr/bin/env python
"""Multi-sequence batched evaluation over a device mesh.

The multi-device story for this workload (SURVEY.md 2.3): SLAM
state is sequential per sequence, so scale-out is DATA PARALLELISM over
sequences — the reference's headless batch-eval scenario (BASELINE.json
config 5, KITTI 00-10) as one `shard_map` program over a `Mesh('seq')`.
Each device owns B/n sequences; no collectives sit on the per-frame path.

Examples:
    # 8 virtual CPU devices
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/run_batch.py --cpu --sequences 8 --frames 20

    # one GPU, 8 sequences batched on it
    python scripts/run_batch.py --devices 1 --sequences 8 --frames 20

    # four GPUs, 8 sequences sharded two per card
    python scripts/run_batch.py --devices 4 --sequences 8 --frames 20
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequences", type=int, default=8)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--devices", type=int, default=0,
                    help="mesh size (default: all available)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from direct_stereo_slam_tpu.config import make_config
    from direct_stereo_slam_tpu.geometry import lie
    from direct_stereo_slam_tpu.geometry.camera import make_pyramid_intrinsics
    from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset
    from direct_stereo_slam_tpu.models.depth_template import (
        build_template, default_budgets)
    from direct_stereo_slam_tpu.parallel.mesh import (
        make_batched_step, make_mesh, shard_batched_step)

    W, H, L, B = args.width, args.height, args.levels, args.sequences
    n_dev = args.devices or len(jax.devices())
    if B % n_dev != 0:
        raise SystemExit(f"--sequences {B} must divide the mesh size {n_dev}")

    cfg = make_config(W, H)
    cfg = cfg.replace(tracker=cfg.tracker.__class__(pyr_levels=L))

    # B sequences with different motion profiles over the same world
    print(f"rendering {B} sequences x {args.frames} frames ...", flush=True)
    seqs = [SyntheticStereoDataset(
        n_frames=args.frames, width=W, height=H,
        speed=0.25 + 0.05 * (i % 4), yaw_rate=0.004 * (i % 3))
        for i in range(B)]
    K = seqs[0].K
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, L)
    budgets = default_budgets(W, H, L)

    rng = np.random.RandomState(0)
    n_pts = 512

    def template_for(ds, i):
        f = ds.frame(i)
        us = rng.uniform(3, W - 4, n_pts).astype(np.float32)
        vs = rng.uniform(3, H - 4, n_pts).astype(np.float32)
        depth = np.asarray(f["depth0"])[vs.astype(int), us.astype(int)]
        return build_template(
            jnp.asarray(us), jnp.asarray(vs), jnp.asarray(1.0 / depth),
            jnp.ones(n_pts, jnp.float32), f["img0"], L, budgets), f

    mesh = make_mesh(n_dev)
    step = make_batched_step(intr, cfg, L)
    sharded = shard_batched_step(step, mesh)

    T_init = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B, 4, 4))
    errs_t, errs_r, t_total = [], [], 0.0
    for i in range(args.frames - 1):
        tmpl_fs = [template_for(ds, i) for ds in seqs]
        tmpl = jax.tree_util.tree_map(
            lambda *leaves: jnp.stack(leaves), *[t for t, _ in tmpl_fs])
        img0 = jnp.stack([jnp.asarray(ds.frame(i + 1)["img0"]) for ds in seqs])
        img1 = jnp.stack([jnp.asarray(ds.frame(i + 1)["img1"]) for ds in seqs])
        t0 = time.perf_counter()
        out = sharded(img0, img1, tmpl, T_init)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        if i > 0:          # first step pays the compile
            t_total += dt
        T_est = np.asarray(out.T)
        for b, ds in enumerate(seqs):
            T_gt = np.linalg.inv(ds.poses[i + 1]) @ ds.poses[i]
            d = np.asarray(lie.se3_log(jnp.asarray(
                np.linalg.inv(T_gt) @ T_est[b], np.float32)))
            errs_t.append(np.linalg.norm(d[:3]))
            errs_r.append(np.linalg.norm(d[3:]))

    steps_timed = max(args.frames - 2, 1)
    fps = steps_timed * B / max(t_total, 1e-9)
    print(f"devices {n_dev}  sequences {B}  frames {args.frames}")
    print(f"aggregate tracking throughput: {fps:.1f} frames/s "
          f"({fps / B:.1f} per sequence)")
    print(f"tracking error: median |t| {np.median(errs_t) * 100:.2f} cm, "
          f"median |w| {np.degrees(np.median(errs_r)):.3f} deg")


if __name__ == "__main__":
    main()
