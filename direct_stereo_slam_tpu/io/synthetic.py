"""Synthetic stereo sequence generator with exact ground truth.

The reference validates against KITTI/Malaga rosbags (SURVEY.md §4); those
datasets are not available in this environment, so tests and benchmarks use
a procedurally-textured 3D scene rendered with exact geometry: a ground
plane, two side walls and a front wall, textured with a smooth
world-anchored multi-frequency pattern so photometric consistency across
views is exact. Any camera pose can be rendered with its exact depth map,
giving golden data for the tracker, scale optimizer, BA and loop closure.

Rendering is a jitted ray-cast (one plane-intersection per pixel per plane;
elementwise math, no gathers), fast enough to generate sequences on the fly.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import lie

# the renderer is the ground truth: its ray products stay in full f32
# (a GPU may otherwise run f32 products in TF32)
_HI = jax.lax.Precision.HIGHEST


class SyntheticScene(NamedTuple):
    """Axis-aligned planes (n . x = c) plus axis-aligned boxes. Camera
    convention: x right, y down, z forward (world = first camera frame).
    Boxes give the world distinctive local structure (occlusions, depth
    variety, asymmetric LiDAR scans for loop-closure tests)."""

    # plane normals [P, 3], offsets [P]
    normals: jnp.ndarray
    offsets: jnp.ndarray
    # texture phase offsets per plane [P, 2] to decorrelate the walls
    tex_phase: jnp.ndarray
    # boxes: centers [B, 3], half extents [B, 3], phases [B, 2]
    box_centers: jnp.ndarray
    box_half: jnp.ndarray
    box_phase: jnp.ndarray
    # global texture spatial-frequency scale. 1.0 = the historical
    # pattern (all tests/goldens). The default pattern's pixel-scale
    # intensity gradients are ~2x sharper than typical outdoor imagery;
    # a direct loop verifier sees residual = gradient x map-drift
    # misprojection, so on long synthetic laps the photometric floor
    # sits at the reference acceptance gate (measured ~11-13 vs
    # res_thres 10, with the aligner compressing contrast to slope
    # ~0.45). Loop-closure scenarios use ~0.6 for realistic smoothness.
    tex_freq: jnp.ndarray = None


def default_scene(
    ground_y: float = 1.5,
    wall_x: float = 8.0,
    front_z: float = 60.0,
    back_z: float = -20.0,
    ceil_y: float = -6.0,
    n_boxes: int = 0,
    box_seed: int = 0,
    box_area: float = 20.0,
) -> SyntheticScene:
    normals = jnp.array(
        [
            [0.0, 1.0, 0.0],   # ground (y = ground_y, below camera)
            [1.0, 0.0, 0.0],   # right wall x = +wall_x
            [-1.0, 0.0, 0.0],  # left wall  x = -wall_x -> -x = wall_x
            [0.0, 0.0, 1.0],   # front wall z = front_z
            [0.0, 0.0, -1.0],  # back wall  z = back_z
            [0.0, -1.0, 0.0],  # ceiling y = ceil_y
        ],
        dtype=jnp.float32,
    )
    offsets = jnp.array(
        [ground_y, wall_x, wall_x, front_z, -back_z, -ceil_y], dtype=jnp.float32
    )
    tex_phase = jnp.array(
        [[0.0, 0.0], [1.7, 0.4], [3.1, 2.2], [0.9, 4.0], [2.5, 1.1], [4.2, 3.3]],
        dtype=jnp.float32,
    )
    if n_boxes > 0:
        rng = np.random.RandomState(box_seed)
        centers = np.stack([
            rng.uniform(-box_area, box_area, n_boxes),
            rng.uniform(ground_y - 3.0, ground_y - 0.5, n_boxes),
            rng.uniform(-box_area * 0.5, box_area * 1.5, n_boxes),
        ], -1).astype(np.float32)
        half = rng.uniform(0.4, 2.5, (n_boxes, 3)).astype(np.float32)
        phase = rng.uniform(0, 6.28, (n_boxes, 2)).astype(np.float32)
    else:
        centers = np.zeros((1, 3), np.float32) + 1e6   # far away, never hit
        half = np.full((1, 3), 1e-3, np.float32)
        phase = np.zeros((1, 2), np.float32)
    return SyntheticScene(normals, offsets, tex_phase,
                          jnp.asarray(centers), jnp.asarray(half), jnp.asarray(phase))


def _loop_scene() -> SyntheticScene:
    """Scene sized for the default loop trajectory (ring centered (0, 8),
    radius 8): wide room + parallax boxes rejection-sampled off the ring
    (annulus [4, 13] around the ring center stays clear of the camera)."""
    rng = np.random.RandomState(7)
    centers = []
    while len(centers) < 14:
        c = rng.uniform(-22, 22, 3)
        c[1] = rng.uniform(-1.5, 0.5)
        c[2] = rng.uniform(-14, 30)
        if np.hypot(c[0], c[2] - 8.0) < 4.0 or np.hypot(c[0], c[2] - 8.0) > 13.0:
            centers.append(c)
    scene = default_scene(wall_x=25.0, front_z=45.0, back_z=-25.0)
    return scene._replace(
        box_centers=jnp.asarray(np.stack(centers), jnp.float32),
        box_half=jnp.asarray(rng.uniform(0.5, 2.0, (14, 3)), jnp.float32),
        box_phase=jnp.asarray(rng.uniform(0, 6.28, (14, 2)), jnp.float32),
    )


def _texture(p: jnp.ndarray, phase: jnp.ndarray, freq=None) -> jnp.ndarray:
    """World position [..., 3] + per-plane phase [..., 2] -> intensity.
    Multi-frequency smooth pattern, range ~[10, 245]. ``freq`` scales all
    spatial frequencies (SyntheticScene.tex_freq; None = 1.0)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    if freq is not None:
        x, y, z = x * freq, y * freq, z * freq
    a, b = phase[..., 0], phase[..., 1]
    # Frequencies kept low enough that bilinear resampling bias (which the
    # 8-pattern photometric BA is sensitive to on slanted planes) stays well
    # below the signal; raising them makes the synthetic world "sharper" but
    # biases all direct-alignment optima.
    val = (
        0.45 * jnp.sin(0.45 * x + 0.65 * z + a)
        + 0.30 * jnp.cos(0.85 * z - 0.4 * y + b)
        + 0.15 * jnp.sin(1.55 * x - 1.15 * y + 0.35 * z + a + b)
        + 0.10 * jnp.cos(3.05 * x + 2.65 * z - 0.55 * y + 2.0 * a)
    )
    return 128.0 + 115.0 * val


@partial(jax.jit, static_argnums=(3, 4))
def render(
    scene: SyntheticScene,
    T_wc: jnp.ndarray,       # [4, 4] camera-to-world
    K: jnp.ndarray,          # [3, 3]
    width: int,
    height: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (image [H, W] float32, depth [H, W] float32 camera-z depth)."""
    R = T_wc[:3, :3]
    o = T_wc[:3, 3]
    us, vs = jnp.meshgrid(
        jnp.arange(width, dtype=jnp.float32), jnp.arange(height, dtype=jnp.float32)
    )
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    d_cam = jnp.stack(
        [(us - cx) / fx, (vs - cy) / fy, jnp.ones_like(us)], axis=-1
    )  # [H, W, 3], z = 1 so camera depth = ray parameter t
    d_world = jnp.matmul(d_cam, R.T, precision=_HI)

    n = scene.normals          # [P, 3]
    c = scene.offsets          # [P]
    denom = jnp.matmul(d_world, n.T, precision=_HI)     # [H, W, P]
    numer = c[None, None, :] - jnp.matmul(o, n.T, precision=_HI)[None, None, :]
    t = jnp.where(jnp.abs(denom) > 1e-8, numer / denom, jnp.inf)
    t = jnp.where(t > 0.1, t, jnp.inf)
    t_hit = jnp.min(t, axis=-1)                          # [H, W]
    plane_idx = jnp.argmin(t, axis=-1)

    # boxes: slab-method ray-AABB intersection, nearest entry wins
    inv_d = 1.0 / jnp.where(jnp.abs(d_world) < 1e-9, 1e-9, d_world)  # [H,W,3]
    lo = scene.box_centers - scene.box_half              # [B, 3]
    hi = scene.box_centers + scene.box_half
    t_lo = (lo[None, None, :, :] - o[None, None, None, :]) * inv_d[:, :, None, :]
    t_hi = (hi[None, None, :, :] - o[None, None, None, :]) * inv_d[:, :, None, :]
    t_near = jnp.max(jnp.minimum(t_lo, t_hi), axis=-1)   # [H, W, B]
    t_far = jnp.min(jnp.maximum(t_lo, t_hi), axis=-1)
    box_hit = (t_near <= t_far) & (t_near > 0.1)
    t_box = jnp.where(box_hit, t_near, jnp.inf)
    t_box_min = jnp.min(t_box, axis=-1)                  # [H, W]
    box_idx = jnp.argmin(t_box, axis=-1)

    use_box = t_box_min < t_hit
    t_final = jnp.where(use_box, t_box_min, t_hit)
    p_world = o[None, None, :] + d_world * t_final[..., None]
    phase = jnp.where(
        use_box[..., None],
        scene.box_phase[box_idx],
        scene.tex_phase[plane_idx],
    )
    img = _texture(p_world, phase, scene.tex_freq)
    img = jnp.clip(img, 0.0, 255.0)
    depth = t_final  # camera z-depth since d_cam z == 1
    return img, depth


def kitti_like_intrinsics(width: int = 320, height: int = 96, f: float = 0.58):
    """Small KITTI-ish camera for tests; f is focal relative to width."""
    fx = f * width
    fy = fx
    cx = width / 2 - 0.5
    cy = height / 2 - 0.5
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]], dtype=np.float32)


def forward_trajectory(n_frames: int, speed: float = 0.3, yaw_rate: float = 0.0):
    """Simple constant-velocity trajectory: camera-to-world poses [N, 4, 4]."""
    poses = []
    T = np.eye(4, dtype=np.float32)
    for _ in range(n_frames):
        poses.append(T.copy())
        step = np.asarray(
            lie.se3_exp(
                jnp.array([0, 0, speed, 0, yaw_rate, 0], dtype=jnp.float32)
            )
        )
        T = T @ step
    return np.stack(poses)


def loop_trajectory(n_frames: int, radius: float = 12.0, laps: float = 1.0,
                    ease_in: int = 0):
    """Circular trajectory in the x-z plane; ``laps`` > 1 revisits earlier
    positions (same heading) for loop-closure tests. ``ease_in`` ramps the
    angular rate over the first frames (vehicles start from rest; a cold
    tracker has no motion model for frame 1)."""
    if ease_in > 0:
        w = np.minimum(1.0, (np.arange(n_frames) + 1) / ease_in)
        cum = np.concatenate([[0.0], np.cumsum(w)[:-1]])
        angles = laps * 2.0 * np.pi * cum / cum[-1] if cum[-1] > 0 else cum
    else:
        angles = laps * 2.0 * np.pi * np.arange(n_frames) / n_frames
    poses = []
    for i in range(n_frames):
        ang = angles[i]
        # camera position on circle, looking along the tangent
        cx_ = radius * np.sin(ang)
        cz_ = radius * (1.0 - np.cos(ang))
        yaw = ang
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]], dtype=np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = [cx_, 0.0, cz_]
        poses.append(T)
    return np.stack(poses)


def stadium_trajectory(n_frames: int, straight: float = 16.0,
                       radius: float = 7.0, laps: float = 1.25,
                       ease_in: int = 0):
    """Stadium (oval) trajectory in the x-z plane: two straights joined by
    half-circles; ``laps`` > 1 retraces the FIRST STRAIGHT with identical
    heading. This is the KITTI revisit geometry (straight-segment,
    same-direction re-drive) — a circle's revisits always carry a heading
    offset, which structurally caps the direct verifier's visible-point
    ratio on sparse photometric clouds (measured: inlier gate failed
    8/14 tries on the circle lap at best_err 8.4)."""
    P = 2.0 * straight + 2.0 * np.pi * radius
    total = laps * P
    if ease_in > 0:
        w = np.minimum(1.0, (np.arange(n_frames) + 1) / ease_in)
        cum = np.concatenate([[0.0], np.cumsum(w)[:-1]])
        s_arr = total * cum / cum[-1] if cum[-1] > 0 else cum
    else:
        s_arr = total * np.arange(n_frames) / n_frames
    L, r = straight, radius
    poses = []
    for s in np.mod(s_arr, P):
        if s < L:                                   # straight A, +z
            pos = np.array([0.0, 0.0, s]);           yaw = 0.0
        elif s < L + np.pi * r:                     # far half-circle
            th = (s - L) / r
            pos = np.array([r - r * np.cos(th), 0.0, L + r * np.sin(th)])
            yaw = th
        elif s < 2 * L + np.pi * r:                 # straight B, -z
            u = s - L - np.pi * r
            pos = np.array([2 * r, 0.0, L - u]);     yaw = np.pi
        else:                                       # near half-circle
            th = (s - 2 * L - np.pi * r) / r
            pos = np.array([r + r * np.cos(th), 0.0, -r * np.sin(th)])
            yaw = np.pi + th
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]],
                             dtype=np.float32)
        T[:3, 3] = pos
        poses.append(T)
    return np.stack(poses)


def dist_to_stadium_track(x, z, straight=16.0, radius=7.0):
    """Distance from plan-view point (x, z) to the stadium centerline
    (for keeping scene boxes off the track)."""
    # spine segment from (radius, 0) to (radius, straight)
    dz = np.clip(z, 0.0, straight)
    d_spine = np.hypot(x - radius, z - dz)
    return np.abs(d_spine - radius)


def pose_chain_with_loop(n: int, seed: int = 1):
    """A pose-graph problem: a noisy chain of n poses stepping 0.1 m along
    x, odometry edges with 1 mm noise, and one loop edge claiming the end
    sits 0.1 (n - 1) m from the start. Returns (poses [n, 4, 4] float32,
    edges [(a, b, Z, w_t, w_r)]) for loop.pose_graph.build_data."""
    rng = np.random.RandomState(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(1, n):
        poses[i] = poses[i - 1].copy()
        poses[i][:3, 3] += np.array([0.1, 0.0, 0.0]) + rng.normal(0, 0.002, 3)
    edges = []
    for i in range(1, n):
        Z = np.linalg.inv(poses[i]) @ poses[i - 1]
        Z[:3, 3] += rng.normal(0, 0.001, 3)
        edges.append((i, i - 1, Z.astype(np.float32), 1.0, 1e4))
    Zl = np.eye(4, dtype=np.float32)
    Zl[0, 3] = -0.1 * (n - 1)
    edges.append((n - 1, 0, Zl, 10.0, 1e4))
    return poses, edges


def stadium_revisit_dataset(n_frames: int = 240, width: int = 1232,
                            height: int = 368, laps: float = 1.6,
                            straight: float = 16.0, radius: float = 7.0):
    """Box-rich room driven on a stadium lap that re-drives its first
    straight with identical heading (KITTI's revisit geometry).

    At 240 frames and 1.6 laps the camera moves ~0.5 m/frame and turns
    4.1 deg/frame on the arcs. The retrace must reach segments whose first
    pass happened after the stereo scale trapped: scans recorded while
    scale_error < 0 never enter the Scan-Context database (reference
    bypass, LoopHandler.cpp:225-229), so a shorter retrace re-drives frames
    with no database counterpart. The texture is smoothed to pixel-scale
    realism for the direct verifier (SyntheticScene.tex_freq)."""
    rngb = np.random.RandomState(7)
    centers = []
    while len(centers) < 14:
        c = rngb.uniform(-22, 22, 3)
        c[1] = rngb.uniform(-1.5, 0.5)
        c[2] = rngb.uniform(-14, 30)
        if dist_to_stadium_track(c[0], c[2], straight, radius) > 3.5:
            centers.append(c)
    scene = default_scene(wall_x=25.0, front_z=45.0, back_z=-25.0)
    scene = scene._replace(
        box_centers=jnp.asarray(np.stack(centers), jnp.float32),
        box_half=jnp.asarray(rngb.uniform(0.5, 2.0, (14, 3)), jnp.float32),
        box_phase=jnp.asarray(rngb.uniform(0, 6.28, (14, 2)), jnp.float32),
        tex_freq=jnp.float32(0.6),
    )
    ds = SyntheticStereoDataset(n_frames=n_frames, width=width,
                                height=height, scene=scene)
    ds.poses = stadium_trajectory(n_frames, straight=straight, radius=radius,
                                  laps=laps, ease_in=8)
    return ds


class SyntheticStereoDataset:
    """Iterable stereo dataset: frames ((img0, img1), timestamp, gt pose).

    tfm_cam1_cam0 follows the reference convention: pose of cam0 in cam1
    frame (T_stereo, README.md:58); default KITTI-like baseline 0.54 m.
    """

    def __init__(
        self,
        n_frames: int = 60,
        width: int = 320,
        height: int = 96,
        baseline: float = 0.54,
        trajectory: str = "forward",
        speed: float = 0.3,
        fps: float = 10.0,
        scene: SyntheticScene | None = None,
        yaw_rate: float = 0.0,
    ):
        self.K = kitti_like_intrinsics(width, height)
        self.width, self.height = width, height
        if scene is not None:
            self.scene = scene
        elif trajectory == "loop":
            # the loop ring is centered (0, 8) radius 8: the forward scene's
            # walls at x = +-8 would sit ON the trajectory. Use a wide room
            # with parallax boxes placed off the ring.
            self.scene = _loop_scene()
        else:
            self.scene = default_scene()
        self.fps = fps
        if trajectory == "forward":
            self.poses = forward_trajectory(n_frames, speed, yaw_rate)
        elif trajectory == "loop":
            # ease_in: vehicles start from rest — a cold tracker has no
            # motion model for frame 1, so ramp the turn rate up. The lap
            # count is chosen to keep the sustained turn rate at ~5.5
            # deg/frame (the coarse tracker's constant-motion-model limit is
            # ~5.7); with >= ~75 frames the trajectory passes a full lap and
            # revisits, exercising loop closure.
            self.poses = loop_trajectory(n_frames, radius=8.0,
                                         laps=n_frames * 5.5 / 360.0,
                                         ease_in=8)
        else:
            raise ValueError(trajectory)
        self.t_cam1_cam0 = np.eye(4, dtype=np.float32)
        self.t_cam1_cam0[0, 3] = -baseline
        self.t_cam1_cam0[2, 3] = 1e-9  # reference numerical-stability quirk

    def __len__(self):
        return len(self.poses)

    def frame(self, i: int):
        # Renders on the default device and returns numpy, like a dataset
        # reader decoding files.
        T_w_c0 = jnp.asarray(np.asarray(self.poses[i]))
        # cam1-to-world = cam0-to-world @ (cam1-to-cam0)
        T_w_c1 = jnp.matmul(T_w_c0, jnp.asarray(
            np.linalg.inv(self.t_cam1_cam0)), precision=_HI)
        K = jnp.asarray(self.K)
        img0, depth0 = render(self.scene, T_w_c0, K, self.width, self.height)
        img1, _ = render(self.scene, T_w_c1, K, self.width, self.height)
        return {
            "img0": np.asarray(img0),
            "img1": np.asarray(img1),
            "depth0": np.asarray(depth0),
            "timestamp": i / self.fps,
            "pose_w_c0": self.poses[i],
            "incoming_id": i,
        }

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)
