"""Monocular bootstrap initializer.

Parity component for DSO's ``CoarseInitializer`` (external; reference call
sites FrontEnd.cpp:607-623, 842-934): two-frame direct alignment that
jointly optimizes the relative pose, affine brightness and a per-point
inverse-depth field, coarse-to-fine, with an "alpha" prior pulling idepths
toward 1 until the baseline is large enough ("snapped"), after which the
prior releases and depth converges from parallax. The stereo initializer
(models/initializer.py) is the default for stereo rigs — it is metric and
single-frame; this module covers mono-only (DSO-parity) operation and is
selected with ``cfg.runtime.mono_initializer``.

Array design: DSO's per-level point hierarchies (CoarseInitializer's
``points[lvl]`` with parent links + KNN regularization graphs) become
fixed-budget per-level point sets selected from each level's own gradient
map; each track_frame sweeps coarse-to-fine, blending idepths down the
parent links before optimizing a finer level (DSO ``propagateDown``), with
the per-point idepths eliminated by Schur complement inside one jitted
program per level and the post-snap KNN neighbor-median coupling standing
in for DSO's iR regularization (``optReg``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SLAMConfig
from ..geometry import lie
from ..geometry.camera import PyramidIntrinsics
from ..ops.interp import bilinear_gather
from ..ops.pyramid import Pyramid
from ..ops.select import make_selection_map

_HI = jax.lax.Precision.HIGHEST
_K_NN = 10


class MonoInitState(NamedTuple):
    """Per-level point hierarchies (tuples indexed by pyramid level; level
    coordinates are in THAT level's pixel units, unlike the flat level-0
    set of earlier revisions)."""

    u: Tuple[jnp.ndarray, ...]        # [N_l]
    v: Tuple[jnp.ndarray, ...]
    color: Tuple[jnp.ndarray, ...]    # [N_l] intensity at that level
    idepth: Tuple[jnp.ndarray, ...]   # [N_l]
    valid: Tuple[jnp.ndarray, ...]    # [N_l]
    knn: Tuple[jnp.ndarray, ...]      # [N_l, K] same-level neighbor indices
    parent: Tuple[jnp.ndarray, ...]   # [N_l] index into level l+1 points
    T: jnp.ndarray                    # [4, 4] first-to-current estimate
    snapped: jnp.ndarray              # bool
    snapped_count: jnp.ndarray        # frames tracked since snap
    resid0: jnp.ndarray               # [N_0] |photometric residual| at the
                                      # latest frame (inf = out of view)

    @property
    def levels(self) -> int:
        return len(self.u)


def _knn_graph(u, v, lane_ok, budget):
    """Fixed image-plane KNN graph (DSO CoarseInitializer::makeNN):
    invalid lanes / neighbors resolve to self so coupling is inert."""
    d2 = (u[:, None] - u[None, :]) ** 2 + (v[:, None] - v[None, :]) ** 2
    d2 = jnp.where(lane_ok[None, :], d2, jnp.inf)
    d2 = d2.at[jnp.arange(budget), jnp.arange(budget)].set(jnp.inf)
    _, knn = jax.lax.top_k(-d2, _K_NN)
    self_idx = jnp.broadcast_to(jnp.arange(budget)[:, None], (budget, _K_NN))
    nb_ok = lane_ok[knn] & lane_ok[:, None]
    return jnp.where(nb_ok, knn, self_idx)


def _grid_select(abs_grad_l, budget: int, min_grad: float = 1.0):
    """Coarse-level candidate selection: per-cell gradient argmax over a
    grid sized to the budget (the fixed-shape analog of DSO's in-level
    gridMaxSelection). Returns (u, v, lane_ok) with N == budget."""
    H, W = abs_grad_l.shape
    cx = max(1, int(np.ceil(np.sqrt(budget * W / max(H, 1)))))
    cy = max(1, int(np.ceil(budget / cx)))
    bh = max(1, int(np.ceil(H / cy)))
    bw = max(1, int(np.ceil(W / cx)))
    ph, pw = cy * bh, cx * bw
    g = jnp.pad(abs_grad_l, ((0, ph - H), (0, pw - W)), constant_values=-1.0)
    # mask borders (interp needs 3 px margin)
    ys = jax.lax.broadcasted_iota(jnp.int32, (ph, pw), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (ph, pw), 1)
    g = jnp.where((ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3), g, -1.0)
    blocks = g.reshape(cy, bh, cx, bw).transpose(0, 2, 1, 3).reshape(
        cy * cx, bh * bw)
    arg = jnp.argmax(blocks, axis=1)
    val = jnp.take_along_axis(blocks, arg[:, None], axis=1)[:, 0]
    by = jnp.arange(cy * cx) // cx
    bx = jnp.arange(cy * cx) % cx
    u = (bx * bw + arg % bw).astype(jnp.float32)
    v = (by * bh + arg // bw).astype(jnp.float32)
    ok = val > min_grad
    # pad/trim to the fixed budget
    n = cy * cx
    if n < budget:
        pad = budget - n
        u = jnp.concatenate([u, jnp.zeros(pad, jnp.float32)])
        v = jnp.concatenate([v, jnp.zeros(pad, jnp.float32)])
        ok = jnp.concatenate([ok, jnp.zeros(pad, bool)])
    else:
        u, v, ok = u[:budget], v[:budget], ok[:budget]
    return u, v, ok


def create(pyr0: Pyramid, cfg: SLAMConfig, budget: int = 1024,
           pot: int = 6) -> MonoInitState:
    """Select the per-level point hierarchies from the first frame
    (CoarseInitializer::setFirst): level 0 via the full pixel selector,
    coarser levels via per-cell gradient argmax; parent links connect each
    point to its nearest coarser-level point (for propagateDown)."""
    levels = pyr0.levels
    us, vs, cols, ids, oks, knns = [], [], [], [], [], []
    for lvl in range(levels):
        bud = max(64, budget >> lvl)
        if lvl == 0:
            sel, _ = make_selection_map(
                pyr0.abs_grad[0], pyr0.abs_grad[1], pyr0.abs_grad[2], pot,
                cfg)
            H, W = sel.shape
            ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
            xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
            good = (sel > 0) & (ys >= 3) & (ys < H - 3) & (xs >= 3) & (
                xs < W - 3)
            flat = good.reshape(-1)
            (idx,) = jnp.nonzero(flat, size=bud, fill_value=0)
            count = jnp.sum(flat)
            ok = jnp.arange(bud) < count
            u = (idx % W).astype(jnp.float32)
            v = (idx // W).astype(jnp.float32)
        else:
            u, v, ok = _grid_select(pyr0.abs_grad[lvl], bud)
        col = bilinear_gather(pyr0.data[lvl], u, v)[:, 0]
        us.append(u)
        vs.append(v)
        cols.append(col)
        ids.append(jnp.ones(bud, jnp.float32))
        oks.append(ok)
        knns.append(_knn_graph(u, v, ok, bud))

    parents = []
    for lvl in range(levels):
        if lvl == levels - 1:
            parents.append(jnp.arange(us[lvl].shape[0], dtype=jnp.int32))
            continue
        # nearest coarser-level point in that level's units
        cu = (us[lvl] + 0.5) / 2.0 - 0.5
        cv = (vs[lvl] + 0.5) / 2.0 - 0.5
        d2 = (cu[:, None] - us[lvl + 1][None, :]) ** 2 + (
            cv[:, None] - vs[lvl + 1][None, :]) ** 2
        d2 = jnp.where(oks[lvl + 1][None, :], d2, jnp.inf)
        parents.append(jnp.argmin(d2, axis=1).astype(jnp.int32))

    return MonoInitState(
        u=tuple(us), v=tuple(vs), color=tuple(cols), idepth=tuple(ids),
        valid=tuple(oks), knn=tuple(knns), parent=tuple(parents),
        T=jnp.eye(4, dtype=jnp.float32),
        snapped=jnp.bool_(False),
        snapped_count=jnp.int32(0),
        resid0=jnp.zeros(us[0].shape[0], jnp.float32),
    )


def _level_pass(img_l, ref_col, pu, pv, pid, pmask, Ki, fx, fy, cx, cy,
                T, aff, alpha_w, huber, iR=None, coup_w=0.0):
    """Residual + blocks for the joint (pose8, idepth[N]) system at one
    level. Returns (E, n, Hpp [8,8], bp [8], Hpd [N,8], Hdd [N], bd [N])."""
    Hh, Ww, _ = img_l.shape
    R = T[:3, :3]
    t = T[:3, 3]
    RKi = jnp.matmul(R, Ki, precision=_HI)
    xyz = jnp.stack([pu, pv, jnp.ones_like(pu)], -1)
    Kx = jnp.matmul(xyz, RKi.T, precision=_HI)
    pt = Kx + t[None, :] * pid[:, None]
    z = pt[:, 2]
    un = pt[:, 0] / z
    vn = pt[:, 1] / z
    Ku = fx * un + cx
    Kv = fy * vn + cy
    new_id = pid / z
    ok = pmask & (Ku > 2) & (Kv > 2) & (Ku < Ww - 3) & (Kv < Hh - 3) & (new_id > 0)
    hit = bilinear_gather(img_l, Ku, Kv)
    r = hit[:, 0] - (aff[0] * ref_col + aff[1])
    hw = jnp.where(jnp.abs(r) < huber, 1.0, huber / jnp.maximum(jnp.abs(r), 1e-9))
    w = jnp.where(ok, hw, 0.0)

    gx = hit[:, 1] * fx
    gy = hit[:, 2] * fy
    Jp = jnp.stack([
        new_id * gx,
        new_id * gy,
        -new_id * (un * gx + vn * gy),
        -(un * vn * gx + (1 + vn * vn) * gy),
        un * vn * gy + (1 + un * un) * gx,
        un * gy - vn * gx,
        -ref_col * jnp.ones_like(un),   # d r/d a (simple affine model a*I+b)
        -jnp.ones_like(un),
    ], -1)                               # [N, 8]
    # d(pt)/d id = t  =>  du_n/d id = (t0 - un t2)/z, dv_n/d id = (t1 - vn t2)/z
    Jd = gx * (t[0] - un * t[2]) / z + gy * (t[1] - vn * t[2]) / z

    E = jnp.sum(w * r * r) + alpha_w * jnp.sum(
        jnp.where(pmask, (pid - 1.0) ** 2, 0.0))
    n = jnp.sum(ok.astype(jnp.float32))
    Hpp = jnp.matmul((Jp * w[:, None]).T, Jp, precision=_HI)
    bp = jnp.matmul((Jp * w[:, None]).T, r[:, None], precision=_HI)[:, 0]
    Hpd = Jp * (w * Jd)[:, None]        # [N, 8] coupling rows
    Hdd = w * Jd * Jd + alpha_w
    bd = w * Jd * r + alpha_w * (pid - 1.0)
    if iR is not None:
        # KNN regularization toward the neighbor median iR (DSO
        # CoarseInitializer couplingWeight term, applied post-snap; iR is
        # held constant within an iteration like DSO's optReg)
        E = E + coup_w * jnp.sum(jnp.where(pmask, (pid - iR) ** 2, 0.0))
        Hdd = Hdd + coup_w
        bd = bd + coup_w * (pid - iR)
    return E, n, Hpp, bp, Hpd, Hdd, bd, r, ok


@partial(jax.jit, static_argnums=(2, 3))
def track_frame(
    state: MonoInitState,
    pyr_new_data: Tuple[jnp.ndarray, ...],
    intr: PyramidIntrinsics,
    cfg: SLAMConfig,
) -> MonoInitState:
    """One frame of initializer tracking (CoarseInitializer::trackFrame):
    coarse-to-fine over the per-level point hierarchies, blending idepths
    down the parent links before each finer level (propagateDown)."""
    levels = len(pyr_new_data)
    huber = cfg.tracker.huber_th
    T = state.T
    pids = list(state.idepth)
    aff = jnp.array([1.0, 0.0], jnp.float32)
    n0 = state.u[0].shape[0]
    alpha_w = jnp.where(state.snapped, 0.0, 150.0 * 150.0 / n0)
    # neighbor coupling replaces the alpha prior after the snap. Weight
    # swept on the synthetic lateral-motion benchmark: idepth-structure
    # IQR spread 6.6 (no coupling) -> 5.2 (w=10) -> 4.3 (w=50) -> 3.3
    # (w=200), but beyond ~50 the recovered translation direction starts
    # leaking into y (the mono tilt ambiguity absorbs the smoothing
    # pressure); 50 is the knee that keeps the pose intact.
    coup_w = jnp.where(state.snapped, jnp.float32(50.0), jnp.float32(0.0))

    for lvl in range(levels - 1, -1, -1):
        if lvl < levels - 1:
            # propagateDown (DSO CoarseInitializer.cpp): blend each point's
            # idepth with its coarser parent's (2:1, the reference's iR mix)
            par = pids[lvl + 1][state.parent[lvl]]
            par_ok = state.valid[lvl + 1][state.parent[lvl]]
            blended = (2.0 * pids[lvl] + par) / 3.0
            pids[lvl] = jnp.where(par_ok, blended, pids[lvl])

        pu, pv = state.u[lvl], state.v[lvl]
        ref_col = state.color[lvl]
        pmask = state.valid[lvl]
        knn = state.knn[lvl]
        Ki = jnp.asarray(intr.Ki(lvl), jnp.float32)
        img_l = pyr_new_data[lvl]
        fx, fy, cx, cy = intr.fx[lvl], intr.fy[lvl], intr.cx[lvl], intr.cy[lvl]

        def energy_of(T_, pid_, aff_):
            iR_ = jnp.median(pid_[knn], axis=1)
            E, n, *_ = _level_pass(
                img_l, ref_col, pu, pv, pid_, pmask,
                Ki, fx, fy, cx, cy, T_, aff_, alpha_w, huber,
                iR=iR_, coup_w=coup_w)
            return E, n

        def gn_iter(_, carry):
            T, pid, aff, lam, E_old = carry
            iR = jnp.median(pid[knn], axis=1)
            E, n, Hpp, bp, Hpd, Hdd, bd, _, _ = _level_pass(
                img_l, ref_col, pu, pv, pid, pmask,
                Ki, fx, fy, cx, cy, T, aff, alpha_w, huber,
                iR=iR, coup_w=coup_w)
            inv_Hdd = 1.0 / jnp.maximum(Hdd * (1 + lam), 1e-6)
            H_sc = Hpp - jnp.matmul(Hpd.T * inv_Hdd[None, :], Hpd, precision=_HI)
            b_sc = bp - jnp.matmul(Hpd.T, (inv_Hdd * bd)[:, None], precision=_HI)[:, 0]
            H_sc = H_sc + lam * jnp.diag(jnp.diag(H_sc)) + 1e-6 * jnp.eye(8)
            x = jnp.linalg.solve(H_sc, -b_sc)
            xd = inv_Hdd * (-bd - jnp.matmul(Hpd, x[:, None], precision=_HI)[:, 0])
            T_new = jnp.matmul(lie.se3_exp(x[:6]), T, precision=_HI)
            aff_new = aff + x[6:8] * jnp.array([0.01, 1.0])
            pid_new = jnp.clip(pid + xd, 1e-3, 50.0)
            E_new, n_new = energy_of(T_new, pid_new, aff_new)
            # LM accept gate (with a surviving-count guard, as in the BA)
            accept = (E_new < E_old) & (n_new > 0.5 * jnp.maximum(n, 1.0))
            sel = lambda a, b: jnp.where(accept, a, b)
            return (
                sel(T_new, T),
                jnp.where(accept, pid_new, pid),
                sel(aff_new, aff),
                jnp.where(accept, lam * 0.5, jnp.minimum(lam * 4.0, 1e3)),
                jnp.where(accept, E_new, E_old),
            )

        E0, _ = energy_of(T, pids[lvl], aff)
        T, pid_out, aff, _, _ = jax.lax.fori_loop(
            0, 6 if lvl > 0 else 10, gn_iter,
            (T, pids[lvl], aff, jnp.float32(0.1), E0))
        pids[lvl] = pid_out

    # snap detection on the finest level: enough translation AND a healthy
    # photometric fit (snapping on a diverged pose releases the alpha prior
    # onto garbage)
    pu, pv = state.u[0], state.v[0]
    knn0 = state.knn[0]
    iR0 = jnp.median(pids[0][knn0], axis=1)
    E_fin, n_fin, _, _, _, _, _, r0, ok0 = _level_pass(
        pyr_new_data[0], state.color[0], pu, pv, pids[0], state.valid[0],
        jnp.asarray(intr.Ki(0), jnp.float32),
        intr.fx[0], intr.fy[0], intr.cx[0], intr.cy[0],
        T, aff, alpha_w, huber, iR=iR0, coup_w=coup_w)
    mean_r2 = E_fin / jnp.maximum(n_fin, 1.0)
    snapped = state.snapped | (
        (jnp.linalg.norm(T[:3, 3]) > 0.12) & (mean_r2 < 150.0)
        & (n_fin > 0.3 * n0))
    snapped_count = jnp.where(snapped, state.snapped_count + 1, 0)
    # per-point photometric residual at the converged state (for the
    # export-quality gate in to_points — DSO keeps only isGood points)
    resid0 = jnp.where(ok0, jnp.abs(r0), jnp.inf)
    return state._replace(T=T, idepth=tuple(pids), snapped=snapped,
                          snapped_count=snapped_count, resid0=resid0)


def is_done(state: MonoInitState) -> bool:
    """DSO: initialize after tracking 5+ frames past the snap."""
    return bool(state.snapped) and int(state.snapped_count) >= 5


def to_points(state: MonoInitState):
    """Rescale to mean idepth 1 (the reference's monocular-arbitrary scale,
    FrontEnd.cpp:863-868) and emit the LEVEL-0 hierarchy as
    (u, v, idepth, rescaled pose, rescale) — DSO makes PointHessians from
    ``points[0]`` only, and only the isGood ones: points whose photometric
    residual at the final tracked frame is an outlier (> max(12, 2x the
    median survivor residual)) carry bad depth and are dropped here, which
    is what keeps the first window's BA energy inside the init RMSE gates."""
    resid = np.asarray(state.resid0)
    m = np.asarray(state.valid[0]) & np.isfinite(resid)
    if m.any():
        med = float(np.median(resid[m]))
        m = m & (resid < max(12.0, 2.0 * med))
    pid = np.asarray(state.idepth[0])
    if not m.any():
        return (np.zeros(0), np.zeros(0), np.zeros(0),
                np.asarray(state.T).copy(), 1.0)
    rescale = 1.0 / max(float(pid[m].mean()), 1e-6)
    T = np.asarray(state.T).copy()
    T[:3, 3] /= rescale          # first-to-new with rescaled translation
    return (
        np.asarray(state.u[0])[m], np.asarray(state.v[0])[m], pid[m] * rescale,
        T, rescale,
    )
