"""Stereo 1-DoF scale optimizer.

Equivalent of ``TrackerAndScaler::optimizeScale`` (reference
TrackerAndScaler.cpp:854-964) plus the FrontEnd-level accept/trap state
machine (FrontEnd.cpp:975-1064): coarse-to-fine LM over the single scale
parameter, projecting the tracker template into the second camera through
the fixed stereo extrinsics with scaled rotation term.

Batched: the grid search over 8 initial guesses (FrontEnd.cpp:995-1003)
is vmapped into one batched program instead of 8 serial optimizations; the
LM loop per level is a ``lax.while_loop``; the trap/untrap heuristics stay
on host (they are per-keyframe control flow).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SLAMConfig
from ..geometry.camera import PyramidIntrinsics
from ..ops.residual_hb import scale_residual_pass
from .depth_template import TrackerTemplate

_HI = jax.lax.Precision.HIGHEST


class ScaleOptResult(NamedTuple):
    scale: jnp.ndarray        # optimized scale
    error: jnp.ndarray        # sqrt(E/n) at finest level


def _optimize_scale_level(
    img1_l, pu, pv, pid, pcolor, pmask, R01Ki_l, Ki0_l, t01,
    fx1, fy1, cx1, cy1, scale0, max_iters, cfg: SLAMConfig,
):
    tc = cfg.tracker

    def run_pass(s, cutoff):
        return scale_residual_pass(
            img1_l, pu, pv, pid, pcolor, pmask, R01Ki_l, Ki0_l, t01, s,
            fx1, fy1, cx1, cy1, tc.huber_th, cutoff,
        )

    # cutoff-doubling pre-loop (cpp:875-883)
    def cut_cond(carry):
        repeat, out = carry
        return (out.stats.saturated_ratio > tc.saturated_ratio_repeat) & (
            repeat < tc.cutoff_repeat_max
        )

    def cut_body(carry):
        repeat, _ = carry
        repeat = repeat * 2.0
        return repeat, run_pass(scale0, tc.coarse_cutoff_th * repeat)

    out0 = run_pass(scale0, jnp.float32(tc.coarse_cutoff_th))
    # data-derived varying zero: keeps while_loop carry vma types equal under
    # jax.shard_map (see tracker._track_level); no-op otherwise
    zv = jnp.nan_to_num(out0.stats.E) * 0.0
    repeat, out0 = jax.lax.while_loop(cut_cond, cut_body, (zv + 1.0, out0))
    cutoff = tc.coarse_cutoff_th * repeat

    # LM loop (cpp:897-942)
    def cond(c):
        return (c["it"] < max_iters) & ~c["done"]

    def body(c):
        lam = c["lam"]
        Hl = c["H"] * (1.0 + lam)
        inc = -c["b"] / jnp.where(jnp.abs(Hl) < 1e-20, 1e-20, Hl)
        extrap = jnp.where(
            lam < tc.lambda_extrapolation_limit,
            jnp.sqrt(jnp.sqrt(tc.lambda_extrapolation_limit / lam)),
            1.0,
        )
        inc = inc * extrap
        # reject non-finite or over-large steps (cpp:907-908)
        inc = jnp.where(
            jnp.isfinite(inc) & (jnp.abs(inc) <= c["s"]), inc, 0.0
        )
        s_new = c["s"] + inc
        out = run_pass(s_new, cutoff)
        accept = (out.stats.E / jnp.maximum(out.stats.num_terms, 1.0)) < (
            c["E"] / jnp.maximum(c["n"], 1.0)
        )
        sel = lambda a, b: jnp.where(accept, a, b)
        return {
            "it": c["it"] + 1,
            "s": sel(s_new, c["s"]),
            "H": sel(out.H, c["H"]),
            "b": sel(out.b, c["b"]),
            "E": sel(out.stats.E, c["E"]),
            "n": sel(out.stats.num_terms, c["n"]),
            "lam": jnp.where(
                accept, lam * tc.lambda_accept_factor,
                jnp.maximum(lam * tc.lambda_reject_factor, tc.lambda_extrapolation_limit),
            ),
            # reference breaks on inc <= 1e-3 (signed! cpp:937); we use |inc|
            "done": jnp.abs(inc) <= tc.inc_break_norm,
        }

    init = {
        "it": jnp.int32(0), "s": scale0 + zv, "H": out0.H, "b": out0.b,
        "E": out0.stats.E, "n": out0.stats.num_terms,
        "lam": zv + tc.lambda_init, "done": zv > 1.0,
    }
    fin = jax.lax.while_loop(cond, body, init)
    return fin["s"], fin["E"], fin["n"], repeat


def optimize_scale_single(
    pyr1: Tuple[jnp.ndarray, ...],
    template: TrackerTemplate,
    intr0: PyramidIntrinsics,
    intr1: PyramidIntrinsics,
    t_cam1_cam0: jnp.ndarray,      # [4,4] stereo extrinsics (cam0 in cam1)
    cfg: SLAMConfig,
    scale0: jnp.ndarray,
) -> ScaleOptResult:
    """Full coarse-to-fine scale optimization for one initial guess,
    including the one-shot level repeat (cpp:947-950)."""
    levels = template.levels
    tc = cfg.tracker
    R01 = t_cam1_cam0[:3, :3]
    t01 = t_cam1_cam0[:3, 3]
    s = scale0
    err = jnp.float32(jnp.nan)
    have_repeated = jnp.bool_(False)

    for lvl in range(levels - 1, -1, -1):
        Ki0_l = jnp.asarray(intr0.Ki(lvl), dtype=jnp.float32)
        R01Ki_l = jnp.matmul(R01, Ki0_l, precision=_HI)
        args = (
            pyr1[lvl],
            template.pu[lvl], template.pv[lvl], template.pid[lvl],
            template.pcolor[lvl], template.pmask[lvl],
            R01Ki_l, Ki0_l, t01,
            intr1.fx[lvl], intr1.fy[lvl], intr1.cx[lvl], intr1.cy[lvl],
        )
        max_it = tc.max_iterations[min(lvl, len(tc.max_iterations) - 1)]
        s, E, n, repeat = _optimize_scale_level(*args, s, max_it, cfg)

        # 0/1-iteration while_loop instead of lax.cond (vma-safe under
        # jax.shard_map; skips the pass when not needed unbatched)
        need_repeat = (repeat > 1.0) & ~have_repeated

        def rep_body(c):
            s2, E2, n2, _ = _optimize_scale_level(*args, c[1], max_it, cfg)
            return (c[0] + 1, s2, E2, n2)

        _, s, E, n = jax.lax.while_loop(
            lambda c: need_repeat & (c[0] < 1), rep_body,
            (jnp.int32(0), s, E, n),
        )
        have_repeated = have_repeated | (repeat > 1.0)

        if lvl == 0:
            err = jnp.sqrt(E / jnp.maximum(n, 1.0))

    return ScaleOptResult(scale=s, error=err)


@partial(jax.jit, static_argnums=(3, 4, 6))
def optimize_scale_batch(
    pyr1: Tuple[jnp.ndarray, ...],
    template: TrackerTemplate,
    scales0: jnp.ndarray,          # [G] initial guesses
    intr0: PyramidIntrinsics,
    intr1: PyramidIntrinsics,
    t_cam1_cam0: jnp.ndarray,
    cfg: SLAMConfig,
) -> ScaleOptResult:
    fn = lambda s0: optimize_scale_single(
        pyr1, template, intr0, intr1, t_cam1_cam0, cfg, s0
    )
    return jax.vmap(fn)(scales0)


@dataclasses.dataclass
class ScaleState:
    """Host-side trap/untrap state machine (FrontEnd.cpp:975-1023). The
    reference keeps this in function-static variables that survive FrontEnd
    reinitialization; here it is an explicit object owned by the runtime."""

    trapped: bool = False
    consecutive_fails: int = 0


def dispatch_scale_optimization(
    pyr1,
    template: TrackerTemplate,
    intr0: PyramidIntrinsics,
    intr1: PyramidIntrinsics,
    t_cam1_cam0: jnp.ndarray,
    cfg: SLAMConfig,
    state: ScaleState,
) -> ScaleOptResult:
    """Device half of the scale optimization: enqueue the (possibly
    batched) scale LM and return the UNPULLED ScaleOptResult arrays so the
    caller can fold them into one bundled ``jax.device_get`` with the rest
    of the keyframe pipeline (one blocking pull instead of one per stage).
    Pair with ``decide_scale_optimization``."""
    so = cfg.scale_opt
    if state.trapped:
        guesses = jnp.asarray([1.0], jnp.float32)
    else:
        guesses = jnp.asarray(np.array(so.grid_guesses, np.float32))
    return optimize_scale_batch(
        tuple(pyr1), template, guesses, intr0, intr1, t_cam1_cam0, cfg,
    )


def decide_scale_optimization(
    scales: np.ndarray,
    errors: np.ndarray,
    cfg: SLAMConfig,
    state: ScaleState,
):
    """Host half: the reference's accept/trap/untrap state machine
    (FrontEnd.cpp:1010-1023) applied to already-pulled batch results.

    Returns (accepted: bool, scale: float, scale_error: float, state);
    ``scale_error < 0`` encodes rejection/disabled."""
    so = cfg.scale_opt
    ok = errors > 0
    if ok.any():
        best = int(np.argmin(np.where(ok, errors, np.inf)))
        new_scale = float(scales[best])
        scale_error = float(errors[best])
    else:
        new_scale, scale_error = 1.0, -1.0

    succeed = 0 <= scale_error < so.accept_thres
    # no sudden jumps once trapped (FrontEnd.cpp:1012-1016)
    if state.trapped and abs(new_scale - 1.0) > so.trapped_jump_thres:
        succeed = False
    state.consecutive_fails = 0 if succeed else state.consecutive_fails + 1
    if state.consecutive_fails > so.max_consecutive_fails:
        state.trapped = False
        scale_error = -1.0
    if succeed and not state.trapped:
        state.trapped = True
    return succeed, new_scale, scale_error, state


def run_scale_optimization(
    pyr1,
    template: TrackerTemplate,
    intr0: PyramidIntrinsics,
    intr1: PyramidIntrinsics,
    t_cam1_cam0: jnp.ndarray,
    cfg: SLAMConfig,
    state: ScaleState,
):
    """One keyframe's scale optimization with the reference's accept logic.

    Returns (accepted: bool, scale: float, scale_error: float, state).
    ``scale_error < 0`` encodes rejection/disabled (the downstream loop
    handler skips loop closure for such keyframes, LoopHandler.cpp:225-229).
    """
    if cfg.scale_opt.accept_thres < 0:
        return False, 1.0, -1.0, state
    out = dispatch_scale_optimization(
        pyr1, template, intr0, intr1, t_cam1_cam0, cfg, state)
    scales, errors = jax.device_get((out.scale, out.error))
    return decide_scale_optimization(
        np.asarray(scales), np.asarray(errors), cfg, state)
