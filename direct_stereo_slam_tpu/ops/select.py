"""Gradient-histogram pixel selector.

Functional equivalent of DSO's ``PixelSelector2::makeMaps`` (external DSO;
reference call site FrontEnd.cpp:940-941): per-block gradient thresholds
from a quantile + offset, then hierarchical per-potential-block winners at
three pyramid scales with per-level gradient down-weighting. The potential
(block size) is adapted by the host between keyframes to hit the desired
candidate density, exactly like DSO's feedback loop.

Block reductions are reshapes + max/argmax; thresholds use
a sorted-quantile per 32x32 block. Output is a dense [H, W] int8 map with
values {0, 1, 2, 4} = {unselected, level-0, level-1, level-2 selection}.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import SLAMConfig


def _block_quantile(x: jnp.ndarray, bs: int, q: float) -> jnp.ndarray:
    """Per-(bs x bs)-block quantile of x [H, W] -> [H/bs, W/bs] (H, W padded
    up internally)."""
    H, W = x.shape
    Hp = (H + bs - 1) // bs * bs
    Wp = (W + bs - 1) // bs * bs
    xp = jnp.full((Hp, Wp), jnp.nan, x.dtype).at[:H, :W].set(x)
    blocks = xp.reshape(Hp // bs, bs, Wp // bs, bs).transpose(0, 2, 1, 3)
    blocks = blocks.reshape(Hp // bs, Wp // bs, bs * bs)
    return jnp.nanquantile(blocks, q, axis=-1)


def _smooth3(x: jnp.ndarray) -> jnp.ndarray:
    """3x3 mean smoothing with edge clamping (DSO ths_smoothed)."""
    xp = jnp.pad(x, 1, mode="edge")
    out = jnp.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            out = out + xp[dy : dy + x.shape[0], dx : dx + x.shape[1]]
    return out / 9.0


def _block_max_mask(score: jnp.ndarray, p: int) -> jnp.ndarray:
    """Boolean mask marking the argmax of each p x p block of `score`
    (ties resolved to the first in row-major order); blocks whose max is
    <= 0 produce no selection."""
    H, W = score.shape
    Hp = (H + p - 1) // p * p
    Wp = (W + p - 1) // p * p
    sp = jnp.full((Hp, Wp), -jnp.inf, score.dtype).at[:H, :W].set(score)
    blocks = sp.reshape(Hp // p, p, Wp // p, p).transpose(0, 2, 1, 3).reshape(
        Hp // p, Wp // p, p * p
    )
    mx = jnp.max(blocks, axis=-1)
    am = jnp.argmax(blocks, axis=-1)
    sel = (jax.lax.broadcasted_iota(jnp.int32, blocks.shape, 2) == am[..., None]) & (
        mx[..., None] > 0
    )
    sel = sel.reshape(Hp // p, Wp // p, p, p).transpose(0, 2, 1, 3).reshape(Hp, Wp)
    return sel[:H, :W]


@partial(jax.jit, static_argnums=(3, 4))
def make_selection_map(
    abs_grad0: jnp.ndarray,    # [H, W] squared gradient at level 0
    abs_grad1: jnp.ndarray,    # [H/2, W/2]
    abs_grad2: jnp.ndarray,    # [H/4, W/4]
    pot: int,
    cfg: SLAMConfig,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (selection map [H, W] int8 with {0,1,2,4}, count)."""
    sc = cfg.selector
    H, W = abs_grad0.shape

    g0 = jnp.sqrt(abs_grad0)
    ths = _block_quantile(g0, sc.block_size, sc.min_grad_hist_cut) + sc.min_grad_hist_add
    ths = _smooth3(ths)
    # broadcast per-block threshold to pixels
    by = jnp.minimum(jnp.arange(H) // sc.block_size, ths.shape[0] - 1)
    bx = jnp.minimum(jnp.arange(W) // sc.block_size, ths.shape[1] - 1)
    th_pix = ths[by][:, bx]                        # [H, W]

    dw1 = sc.grad_down_weight_per_level
    dw2 = dw1 * dw1

    # level-0 winners per pot-block
    score0 = jnp.where(g0 > th_pix, abs_grad0, 0.0)
    sel0 = _block_max_mask(score0, pot)

    # level-1: consider only 2pot-blocks with no level-0 winner
    g1 = jnp.sqrt(abs_grad1)
    th1 = (th_pix * dw1)[::2, ::2][: g1.shape[0], : g1.shape[1]]
    score1 = jnp.where(g1 > th1, abs_grad1, 0.0)
    sel1_half = _block_max_mask(score1, pot)       # pot at half res = 2pot full
    # upsample to full res (winner marks its 2x2 top-left pixel)
    sel1 = jnp.zeros((H, W), bool)
    sel1 = sel1.at[0 : 2 * g1.shape[0] : 2, 0 : 2 * g1.shape[1] : 2].set(sel1_half)
    # suppress where the 2pot-block already has a level-0 selection
    block_has0 = _block_any(sel0, 2 * pot)
    sel1 = sel1 & ~block_has0

    # level-2 in 4pot blocks
    g2 = jnp.sqrt(abs_grad2)
    th2 = (th_pix * dw2)[::4, ::4][: g2.shape[0], : g2.shape[1]]
    score2 = jnp.where(g2 > th2, abs_grad2, 0.0)
    sel2_q = _block_max_mask(score2, pot)
    sel2 = jnp.zeros((H, W), bool)
    sel2 = sel2.at[0 : 4 * g2.shape[0] : 4, 0 : 4 * g2.shape[1] : 4].set(sel2_q)
    block_has01 = _block_any(sel0 | sel1, 4 * pot)
    sel2 = sel2 & ~block_has01

    out = (
        sel0.astype(jnp.int8)
        + 2 * (sel1 & ~sel0).astype(jnp.int8)
        + 4 * (sel2 & ~sel0 & ~sel1).astype(jnp.int8)
    )
    count = jnp.sum((out > 0).astype(jnp.int32))
    return out, count


def _block_any(mask: jnp.ndarray, p: int) -> jnp.ndarray:
    """[H, W] bool -> same shape, True everywhere in any p x p block that
    contains a True."""
    H, W = mask.shape
    Hp = (H + p - 1) // p * p
    Wp = (W + p - 1) // p * p
    mp = jnp.zeros((Hp, Wp), bool).at[:H, :W].set(mask)
    blocks = mp.reshape(Hp // p, p, Wp // p, p).any(axis=(1, 3))
    out = jnp.repeat(jnp.repeat(blocks, p, axis=0), p, axis=1)
    return out[:H, :W]


def adapt_potential(pot: int, got: int, want: float) -> int:
    """DSO's density feedback (PixelSelector2::makeMaps recursion budget):
    too few points -> smaller potential, too many -> larger."""
    if got < 0.25 * want:
        pot = max(pot - 2, 1)
    elif got < 0.8 * want:
        pot = max(pot - 1, 1)
    elif got > 4.0 * want:
        pot = pot + 2
    elif got > 1.25 * want:
        pot = pot + 1
    return min(pot, 16)
