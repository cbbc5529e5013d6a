"""Image pyramid construction (the reference's ``FrameHessian::makeImages``).

Produces per-level ``(I, dx, dy)`` planes: level 0 is the undistorted
intensity image; level ``l`` is the 2x2 average of level ``l-1``; gradients
are central differences computed on each level's intensity (DSO
HessianBlocks.cpp makeImages, called from reference FrontEnd.cpp:605, 680).
Also produces the squared-gradient magnitude used by the pixel selector.

The pyramid is built in one jitted program of reduce-window + slicing ops
(elementwise work, fused by XLA); levels are a tuple of arrays (static
shapes).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class Pyramid(NamedTuple):
    """Per-level planes. ``data[l]`` has shape [H_l, W_l, 3] = (I, dx, dy).
    ``abs_grad[l]`` is [H_l, W_l] squared gradient magnitude."""

    data: Tuple[jnp.ndarray, ...]
    abs_grad: Tuple[jnp.ndarray, ...]

    @property
    def levels(self) -> int:
        return len(self.data)


def _gradients(img: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Central differences; border pixels get zero gradient (the reference
    never samples within 2 px of the border).

    Implemented with pad+slice (layout-preserving ops) instead of
    ``.at[interior].set`` scatters, and border-zeroing via an iota mask."""
    h, w = img.shape
    xp = jnp.pad(img, 1)
    dx = 0.5 * (xp[1:-1, 2:] - xp[1:-1, :-2])
    dy = 0.5 * (xp[2:, 1:-1] - xp[:-2, 1:-1])
    col = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    dx = jnp.where((col > 0) & (col < w - 1), dx, 0.0)
    dy = jnp.where((row > 0) & (row < h - 1), dy, 0.0)
    return dx, dy


def _downsample2(img: jnp.ndarray) -> jnp.ndarray:
    """2x2 mean pool via reshape (one fused reduction instead of 4 strided
    slices)."""
    h, w = img.shape
    h2, w2 = h // 2, w // 2
    return img[: 2 * h2, : 2 * w2].reshape(h2, 2, w2, 2).mean(axis=(1, 3))


def build_pyramid(image: jnp.ndarray, levels: int) -> Pyramid:
    """image: [H, W] float32 intensity (0..255). Returns `levels` levels."""
    data = []
    abs_grad = []
    img = image
    for lvl in range(levels):
        if lvl > 0:
            img = _downsample2(img)
        dx, dy = _gradients(img)
        data.append(jnp.stack([img, dx, dy], axis=-1))
        abs_grad.append(dx * dx + dy * dy)
    return Pyramid(tuple(data), tuple(abs_grad))


# jit with static level count
build_pyramid_jit = jax.jit(build_pyramid, static_argnums=(1,))
