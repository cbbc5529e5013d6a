"""Per-keyframe debug image dumps.

Runtime equivalents of the reference's online debug rendering: idepth jet
maps pushed to the viewer (TrackerAndScaler.cpp:338-449) and optional PNG
dumps (TAS.cpp:432-437). Enabled with cfg.runtime.debug_dump_dir; each new
keyframe writes ``kf_<id>_idepth.png`` (jet-colored template inverse depth
over the keyframe image)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np



def render_template_idepth(template, pyr0) -> np.ndarray:
    """Scatter the level-0 tracker template into a sparse idepth map and
    return the jet overlay as [H, W, 3] uint8 (the reference's KF
    depth-image pane, TrackerAndScaler.cpp:338-449). One bundled device
    pull of the level-0 template arrays."""
    import jax

    from .export import depth_image_rgb

    pu, pv, pid, mask = jax.device_get((
        template.pu[0], template.pv[0], template.pid[0], template.pmask[0]))
    img = np.asarray(pyr0.data[0][..., 0]) if pyr0 is not None else None
    h, w = (img.shape if img is not None
            else (int(pv.max()) + 2, int(pu.max()) + 2))
    idepth = np.zeros((h, w), np.float32)
    u = np.clip(np.round(pu).astype(int), 0, w - 1)
    v = np.clip(np.round(pv).astype(int), 0, h - 1)
    sel = mask & (pid > 0)
    idepth[v[sel], u[sel]] = pid[sel]
    # 2x2 dilation so single pixels are visible at full resolution
    d = np.maximum.reduce([
        idepth,
        np.roll(idepth, 1, 0), np.roll(idepth, 1, 1),
        np.roll(np.roll(idepth, 1, 0), 1, 1),
    ])
    return depth_image_rgb(d, image=img)


def dump_template_idepth(out_dir: str, kf_id: int, template, pyr0,
                         prefix: str = "kf"):
    """Write the jet overlay PNG (see render_template_idepth)."""
    rgb = render_template_idepth(template, pyr0)
    os.makedirs(out_dir, exist_ok=True)
    _write_rgb(os.path.join(out_dir, f"{prefix}_{kf_id:05d}_idepth.png"), rgb)

def _write_rgb(path: str, rgb: np.ndarray):
    from ..utils.imageio import write_rgb

    write_rgb(path, rgb)


def dump_tracking_residual(out_dir: str, frame_id: int, img_new: np.ndarray,
                           template, intr, T_ref_new: np.ndarray,
                           a_rel: float, b_rel: float,
                           prefix: str = "frame"):
    """Level-0 photometric residual image of the accepted tracking pose
    (the reference's debugPlotResiduals pushes,
    TrackerAndScaler.cpp:730-734): template points warped by the final
    pose, |I_new - a*color - b| scattered at the projected pixels over the
    new image, jet-colored by residual magnitude (red = large)."""
    import jax
    from .export import _jet

    pu, pv, pid, col, mask = jax.device_get((
        template.pu[0], template.pv[0], template.pid[0],
        template.pcolor[0], template.pmask[0]))
    img = np.asarray(img_new)
    h, w = img.shape
    fx, fy, cx, cy = (float(intr.fx[0]), float(intr.fy[0]),
                      float(intr.cx[0]), float(intr.cy[0]))
    X = np.stack([(pu - cx) / fx, (pv - cy) / fy, np.ones_like(pu)], -1)
    X = X / np.maximum(pid, 1e-9)[:, None]
    T = np.asarray(T_ref_new, np.float64)
    P = X @ T[:3, :3].T + T[:3, 3]
    z = P[:, 2]
    u = fx * P[:, 0] / np.maximum(z, 1e-9) + cx
    v = fy * P[:, 1] / np.maximum(z, 1e-9) + cy
    ok = mask & (pid > 0) & (z > 0) & (u >= 1) & (v >= 1) & \
        (u < w - 2) & (v < h - 2)
    ui = np.round(u).astype(int)
    vi = np.round(v).astype(int)
    r = np.zeros_like(pu)
    r[ok] = np.abs(img[vi[ok], ui[ok]] - (a_rel * col[ok] + b_rel))
    rgb = np.clip(img, 0, 255).astype(np.uint8)[..., None].repeat(3, -1)
    jet = _jet(np.clip(r / 30.0, 0, 1))       # 30 intensity units = red
    rgb[vi[ok], ui[ok]] = jet[ok]
    os.makedirs(out_dir, exist_ok=True)
    _write_rgb(os.path.join(out_dir, f"{prefix}_{frame_id:05d}_residual.png"),
               rgb)


def dump_window_stitch(out_dir: str, kf_id: int, frontend,
                       prefix: str = "kf"):
    """Tile every active window keyframe's image with its hosted active
    points overlaid (jet by inverse depth) — the reference's window-stitch
    debug plot (FrontEndDebugStuff.cpp:34-310)."""
    import jax
    import jax.numpy as jnp
    from .export import _jet

    st = frontend.ba_state
    slots = frontend._active_slots()
    if not slots:
        return
    pu, pv, pid, pvalid, phost = jax.device_get((
        st.p_u, st.p_v, st.p_idepth, st.p_valid, st.p_host))
    tiles = []
    for s in slots:
        pyr = frontend.pyramids.get(s)
        if pyr is None:
            continue
        img = np.asarray(pyr.data[0][..., 0])
        rgb = np.clip(img, 0, 255).astype(np.uint8)[..., None].repeat(3, -1)
        sel = pvalid & (phost == s) & (pid > 0)
        if sel.any():
            lo, hi = np.percentile(pid[sel], [5, 95])
            jet = _jet((pid - lo) / max(hi - lo, 1e-9))
            ui = np.clip(np.round(pu).astype(int), 0, rgb.shape[1] - 1)
            vi = np.clip(np.round(pv).astype(int), 0, rgb.shape[0] - 1)
            for dy in (0, 1):
                for dx in (0, 1):
                    rgb[np.clip(vi[sel] + dy, 0, rgb.shape[0] - 1),
                        np.clip(ui[sel] + dx, 0, rgb.shape[1] - 1)] = jet[sel]
        tiles.append(rgb)
    if not tiles:
        return
    # grid: up to 4 tiles per row
    per_row = min(4, len(tiles))
    rows = []
    for i in range(0, len(tiles), per_row):
        row = tiles[i:i + per_row]
        row += [np.zeros_like(tiles[0])] * (per_row - len(row))
        rows.append(np.concatenate(row, axis=1))
    grid = np.concatenate(rows, axis=0)
    os.makedirs(out_dir, exist_ok=True)
    _write_rgb(os.path.join(out_dir, f"{prefix}_{kf_id:05d}_window.png"), grid)
