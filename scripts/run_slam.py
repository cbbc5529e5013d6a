#!/usr/bin/env python
"""CLI driver — the reference's `slam_node` (src/main.cpp) as a command.

Examples:
    # synthetic smoke run (no dataset needed)
    python scripts/run_slam.py --synthetic --frames 40 --out /tmp/slam_out

    # KITTI odometry sequence
    python scripts/run_slam.py --kitti /data/kitti_odometry --seq 00 \
        --calib0 cams/kitti/0_2/camera0.txt --out /tmp/kitti00

Writes sodso.txt (odometry) and dslam.txt (loop-closed) in the reference's
`incoming_id x y z` format (LoopHandler.cpp:60-80), a trajectory plot, and
prints the per-stage timing table (main.cpp:181-201)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--trajectory", default="forward", choices=["forward", "loop"])
    ap.add_argument("--kitti", help="KITTI odometry root")
    ap.add_argument("--seq", default="00")
    ap.add_argument("--dir0")
    ap.add_argument("--dir1")
    ap.add_argument("--bag", help="rosbag v2.0 file (the reference's bag "
                    "replay path, main.cpp:320-345)")
    ap.add_argument("--ros-master", help="live mode: ROS1 master URI to "
                    "subscribe to --topic0/--topic1 over TCPROS (the "
                    "reference's message_filters path, main.cpp:347-362)")
    ap.add_argument("--ros-idle", type=float, default=5.0,
                    help="live mode: stop after this many seconds "
                    "without a synced pair")
    ap.add_argument("--topic0", default="/cam0/image_raw")
    ap.add_argument("--topic1", default="/cam1/image_raw")
    ap.add_argument("--calib0", help="DSO camera.txt for cam0")
    ap.add_argument("--calib1", help="DSO camera.txt for cam1")
    ap.add_argument("--t-stereo", help="T_stereo.yaml")
    ap.add_argument("--gamma0", help="DSO pcalib.txt for cam0")
    ap.add_argument("--gamma1")
    ap.add_argument("--vignette0", help="vignette image for cam0")
    ap.add_argument("--vignette1")
    ap.add_argument("--preset", type=int, default=0)
    ap.add_argument("--mode", type=int, default=1)
    ap.add_argument("--scale-opt-thres", type=float, default=15.0)
    ap.add_argument("--lidar-range", type=float, default=40.0)
    ap.add_argument("--scan-context-thres", type=float, default=0.33)
    ap.add_argument("--loop-margin", type=int, default=100,
                    help="KFs excluded from retrieval (reference default "
                    "100; lower it for short demo sequences)")
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--pipelined", action="store_true", default=False,
                    help="pipelined tracking: hide the per-frame tracker "
                         "pull behind the next frame's dispatch (opt-in; "
                         "the default is the reference-exact synchronous "
                         "frame ordering, matching the library default)")
    ap.add_argument("--no-pipelined", dest="pipelined", action="store_false",
                    help="synchronous per-frame tracking (reference-exact "
                         "frame ordering; the default)")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--out", default="./slam_out")
    ap.add_argument("--live", action="store_true",
                    help="write a self-refreshing <out>/live.html viewer "
                    "(trajectory + cloud + matched scans; open in a browser)")
    ap.add_argument("--debug-dir", default=None,
                    help="dump per-KF idepth jet images here")
    ap.add_argument("--step", action="store_true",
                    help="goStepByStep: wait for Enter between frames")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from direct_stereo_slam_tpu.config import make_config
    from direct_stereo_slam_tpu.geometry.camera import (
        make_pyramid_intrinsics, num_usable_levels)
    from direct_stereo_slam_tpu.loop.handler import LoopHandler
    from direct_stereo_slam_tpu.runtime.node import SLAMNode, write_trajectory
    from direct_stereo_slam_tpu.viz.export import plot_trajectories

    os.makedirs(args.out, exist_ok=True)

    gt = None
    undist0 = undist1 = None
    if args.synthetic:
        from direct_stereo_slam_tpu.io.synthetic import SyntheticStereoDataset
        ds = SyntheticStereoDataset(
            n_frames=args.frames, width=320, height=96,
            trajectory=args.trajectory)
        K = ds.K
        w, h = 320, 96
        t10 = ds.t_cam1_cam0
        gt = ds.poses[:, :3, 3]
    elif args.kitti:
        from direct_stereo_slam_tpu.io.dataset import KittiOdometryDataset
        ds = KittiOdometryDataset(args.kitti, args.seq)
        c = ds.calib
        f0 = ds.frame(0)
        h, w = f0["img0"].shape
        K = np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]], [0, 0, 1]])
        t10 = ds.t_cam1_cam0()
    else:
        from direct_stereo_slam_tpu.io.undistort import Undistorter
        from direct_stereo_slam_tpu.utils.calib import (
            build_rectified_camera, parse_gamma, parse_t_stereo, parse_vignette)
        if args.bag:
            from direct_stereo_slam_tpu.io.rosbag import replay_stereo_bag

            pairs = []
            replay_stereo_bag(args.bag, args.topic0, args.topic1,
                              lambda a, b: pairs.append(
                                  {"img0": a.data, "img1": b.data,
                                   "timestamp": a.stamp}))
            ds = pairs
        elif args.ros_master:
            ds = []          # frames arrive live (see the loop below)
        else:
            from direct_stereo_slam_tpu.io.dataset import StereoDirDataset
            ds = StereoDirDataset(args.dir0, args.dir1)
        cam0 = build_rectified_camera(args.calib0)
        cam1 = build_rectified_camera(args.calib1 or args.calib0)
        g0 = parse_gamma(args.gamma0) if args.gamma0 else None
        g1 = parse_gamma(args.gamma1) if args.gamma1 else (g0 if args.gamma0 else None)
        # vignette applies in the RAW image frame (pre-remap); in live
        # mode the raw size comes from the calibration file instead of a
        # first frame
        if args.ros_master and not args.bag:
            from direct_stereo_slam_tpu.utils.calib import parse_camera_file
            m0, _, _ = parse_camera_file(args.calib0)
            in_w, in_h = m0.in_w, m0.in_h
        else:
            f0 = ds[0] if args.bag else ds.frame(0)
            in_h, in_w = f0["img0"].shape
        v0 = parse_vignette(args.vignette0, in_w, in_h) if args.vignette0 else None
        v1 = parse_vignette(args.vignette1, in_w, in_h) if args.vignette1 else v0
        undist0 = Undistorter(cam0, binv=g0, vignette=v0)
        undist1 = Undistorter(cam1, binv=g1, vignette=v1)
        K = cam0.K
        w, h = cam0.w, cam0.h
        t10 = parse_t_stereo(args.t_stereo) if args.t_stereo else np.eye(4)

    # floor at 3: the pixel selector scores on three pyramid scales
    # (DSO PixelSelector likewise requires pyrLevelsUsed >= 3)
    levels = min(args.levels, max(3, num_usable_levels(w, h)))
    cfg = make_config(w, h, preset=args.preset, mode=args.mode,
                      scale_opt_thres=args.scale_opt_thres,
                      lidar_range=args.lidar_range,
                      scan_context_thres=args.scan_context_thres)
    cfg = cfg.replace(tracker=cfg.tracker.__class__(pyr_levels=levels))
    if args.loop_margin != cfg.loop.loop_margin:
        import dataclasses
        cfg = cfg.replace(loop=dataclasses.replace(
            cfg.loop, loop_margin=args.loop_margin))
    import dataclasses as _dc
    cfg = cfg.replace(runtime=_dc.replace(
        cfg.runtime,
        live_view_path=os.path.join(args.out, "live.html") if args.live else "",
        debug_dump_dir=args.debug_dir or "",
        step_by_step=args.step,
        pipelined_tracking=args.pipelined))
    intr = make_pyramid_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], w, h, levels)

    handler = LoopHandler(cfg, intr)
    node = SLAMNode(cfg, intr, intr, t10, loop_handler=handler,
                    undistorter0=undist0, undistorter1=undist1)

    import jax.numpy as jnp
    if args.ros_master and not args.bag:      # --bag takes precedence
        # live mode (reference main.cpp:347-362): subscribe to the two
        # image topics over TCPROS, ApproximateTime-sync, run until
        # --ros-idle seconds pass without a pair (or Ctrl-C)
        import threading

        from direct_stereo_slam_tpu.io.ros_transport import StereoTopicSource

        last = [None]
        count = [0]
        lock = threading.Lock()

        def cb(a, b):
            with lock:
                node.process(jnp.asarray(a.data), jnp.asarray(b.data),
                             a.stamp)
                count[0] += 1
                last[0] = __import__("time").time()
                if count[0] % 10 == 0:
                    print(f"[{count[0]}] kfs={node.frontend.num_kfs} "
                          f"loops={handler.direct_loop_count}"
                          f"+{handler.icp_loop_count}", flush=True)

        src = StereoTopicSource(args.ros_master, args.topic0, args.topic1, cb)
        import time as _time
        try:
            while True:
                _time.sleep(0.2)
                if last[0] is not None and \
                        _time.time() - last[0] > args.ros_idle:
                    break
        except KeyboardInterrupt:
            pass
        src.close()
        with lock:
            node.finish()
    else:
        n = len(ds)
        for i, f in enumerate(ds):
            node.process(jnp.asarray(f["img0"]), jnp.asarray(f["img1"]),
                         f["timestamp"], exposure=f.get("exposure", 1.0))
            if i % 10 == 0:
                print(f"[{i}/{n}] kfs={node.frontend.num_kfs} "
                      f"loops={handler.direct_loop_count}+{handler.icp_loop_count}",
                      flush=True)
        node.finish()

    write_trajectory(os.path.join(args.out, "sodso.txt"), handler.odometry_rows())
    write_trajectory(os.path.join(args.out, "dslam.txt"), handler.optimized_rows())
    so = np.array([r[1:] for r in handler.odometry_rows()])
    dl = np.array([r[1:] for r in handler.optimized_rows()])
    if len(so):
        try:
            plot_trajectories(os.path.join(args.out, "trajectory.png"),
                              [("sodso", so), ("dslam", dl)], gt=gt)
        except ImportError as e:     # matplotlib is optional
            print(f"trajectory plot skipped: {e}")

    print("\n************** Statistics (ms) ***************")
    print(node.timing_report())
    print(f"loop_count: {handler.direct_loop_count} (direct) + "
          f"{handler.icp_loop_count} (icp)")
    print(f"outputs in {args.out}")


if __name__ == "__main__":
    main()
