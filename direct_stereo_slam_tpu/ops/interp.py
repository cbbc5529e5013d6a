"""Bilinear interpolation of (I, dx, dy) planes — the inner-loop gather.

Equivalent of DSO ``getInterpolatedElement33/31`` (reference call sites:
TrackerAndScaler.cpp:790, 1106; PoseEstimator.cpp:237; LoopHandler.cpp:177).

Implemented as four XLA gathers over a flattened image with
precomputed linear indices; out-of-bounds lanes are clamped and must be
masked by the caller (the kernels all carry an explicit validity mask).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


# The sampling forms below were chosen for two gather regimes: few indices
# -> cost is per gather op, so 4 rows-of-C gathers win; many indices ->
# cost is per index, where gathers of scalar rows can beat rows-of-C. The
# scalar-row form needs planes-first [C, H, W] storage (transposing
# [H, W, 3] on the fly costs more than either). Callers with large index
# sets keep their images planes-first and use bilinear_gather_planes;
# everyone else uses bilinear_gather. Which form wins where on a GPU is
# still to be measured.


def bilinear_gather(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """img: [H, W, C] (channel-last); u, v: [...] pixel coords -> [..., C].

    Matches the reference's convention: sample at (u, v) interpolates the
    four pixels (ix, iy), (ix+1, iy), (ix, iy+1), (ix+1, iy+1) with
    fractional weights. Coordinates are clamped; callers mask invalid lanes.
    """
    H, W, C = img.shape
    u = jnp.clip(u, 0.0, W - 1.001)
    v = jnp.clip(v, 0.0, H - 1.001)
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    base = iy * W + ix
    fx = (u - ix)[..., None]
    fy = (v - iy)[..., None]
    flat = img.reshape(H * W, C)
    p00 = flat[base]
    p10 = flat[base + 1]
    p01 = flat[base + W]
    p11 = flat[base + W + 1]
    top = p00 * (1.0 - fx) + p10 * fx
    bot = p01 * (1.0 - fx) + p11 * fx
    return top * (1.0 - fy) + bot * fy


def bilinear_gather_planes(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """img: [C, H, W] (planes-first, contiguous); -> [..., C].

    Scalar-row gathers over channel-concatenated planes — the fast form for
    large index sets (BA linearization, epipolar traces, activation)."""
    C, H, W = img.shape
    u = jnp.clip(u, 0.0, W - 1.001)
    v = jnp.clip(v, 0.0, H - 1.001)
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    base = iy * W + ix
    fx = u - ix
    fy = v - iy
    flat = img.reshape(C * H * W)
    coff = (jnp.arange(C, dtype=jnp.int32) * (H * W)).reshape(
        (C,) + (1,) * base.ndim)
    idx = base[None, ...] + coff
    p00 = flat[idx]
    p10 = flat[idx + 1]
    p01 = flat[idx + W]
    p11 = flat[idx + W + 1]
    top = p00 + fx[None, ...] * (p10 - p00)
    bot = p01 + fx[None, ...] * (p11 - p01)
    return jnp.moveaxis(top + fy[None, ...] * (bot - top), 0, -1)


def bilinear_gather_scalar(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """img: [H, W]; returns [...] interpolated scalar."""
    return bilinear_gather(img[..., None], u, v)[..., 0]


def flat_take(arr1d: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Take from a rank-1 array with indices reshaped to [M, 128].

    This pins XLA to its fast vectorized-take lowering; see
    bilinear_take_plane's docstring for the measured pathology it avoids."""
    shp = idx.shape
    n = int(np.prod(shp)) if shp else 1
    pad = (-n) % 128
    i2 = jnp.pad(idx.reshape(-1), (0, pad)).reshape((n + pad) // 128, 128)
    return arr1d[i2].reshape(-1)[:n].reshape(shp)


def bilinear_take_plane(plane: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """img plane: [H, W]; u, v: [...] -> [...] interpolated scalar.

    Flat-1D formulation: the four corner reads are expressed as takes from a
    rank-1 operand with indices reshaped to [M, 128]. XLA's lowering of the
    generic N-d-index row gather above can be context-sensitive: the SAME
    4.2M-index trace-search gather has compiled to programs orders of
    magnitude apart depending on surrounding ops, vmap, and even runtime
    index distribution (converged epipolar traces cluster their sample
    positions). The rank-1 + [M, 128]-index form stayed fast in every
    context tried; use it for all large index sets."""
    H, W = plane.shape
    u = jnp.clip(u, 0.0, W - 1.001)
    v = jnp.clip(v, 0.0, H - 1.001)
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    base = iy * W + ix
    fx = u - ix
    fy = v - iy
    flat = plane.reshape(-1)
    p00 = flat_take(flat, base)
    p10 = flat_take(flat, base + 1)
    p01 = flat_take(flat, base + W)
    p11 = flat_take(flat, base + W + 1)
    top = p00 * (1.0 - fx) + p10 * fx
    bot = p01 * (1.0 - fx) + p11 * fx
    return top * (1.0 - fy) + bot * fy


def bilinear_take_channels(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """img: [H, W, C] channel-last; returns a C-tuple of [...] planes
    interpolated at (u, v) — the lowering-robust replacement for
    ``bilinear_gather`` at large index counts (bitwise-identical values).

    Channel-last [H, W, C] storage is kept: the per-channel flat take uses
    stride-C indices (base * C + c), which measured the same as contiguous
    plane takes — the [M, 128] index tiling, not operand layout, is what
    selects the fast path.

    Caveat (measured r3): bitwise-equal EAGERLY, but inside a larger jit the
    take form can FMA-fuse differently from the gather form, shifting last
    ulps. Most call sites are insensitive; the mono initializer's two-frame
    LM is NOT (swapping its gather flipped its e2e odometry test from 0.19 m
    to 0.81 m ATE) and its index sets are tiny — it stays on
    ``bilinear_gather``. Use take forms where index counts are large."""
    H, W, C = img.shape
    u = jnp.clip(u, 0.0, W - 1.001)
    v = jnp.clip(v, 0.0, H - 1.001)
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    base = (iy * W + ix) * C
    fx = u - ix
    fy = v - iy
    flat = img.reshape(-1)
    out = []
    for c in range(C):
        p00 = flat_take(flat, base + c)
        p10 = flat_take(flat, base + (C) + c)
        p01 = flat_take(flat, base + (W * C) + c)
        p11 = flat_take(flat, base + (W * C + C) + c)
        top = p00 * (1.0 - fx) + p10 * fx
        bot = p01 * (1.0 - fx) + p11 * fx
        out.append(top * (1.0 - fy) + bot * fy)
    return tuple(out)


def bilinear_gather_frames(images: jnp.ndarray, fidx: jnp.ndarray,
                           u: jnp.ndarray, v: jnp.ndarray):
    """images: [F, H, W, C]; fidx broadcastable to u/v; returns a C-tuple
    of planes sampled in frame ``fidx`` at (u, v) — ROW-GATHER form: four
    gathers of C-channel rows from the [F*H*W, C] flat view.

    Regime note: mid-size index sets (10k-300k — BA linearization at
    [NP, W, 8], activation at [lanes, W, 8]) are per-gather-op bound, so
    this form's 4 row gathers beat the flat-take form's 12 takes. The take
    form is kept for the trace's multi-million clustered index sets, where
    this row gather's lowering can be pathological; see
    bilinear_take_plane."""
    F, H, W, C = images.shape
    u = jnp.clip(u, 0.0, W - 1.001)
    v = jnp.clip(v, 0.0, H - 1.001)
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    fidx = jnp.broadcast_to(fidx, ix.shape)
    base = ((fidx * H) + iy) * W + ix
    fx = (u - ix)[..., None]
    fy = (v - iy)[..., None]
    flat = images.reshape(F * H * W, C)
    p00 = flat[base]
    p10 = flat[base + 1]
    p01 = flat[base + W]
    p11 = flat[base + W + 1]
    top = p00 * (1.0 - fx) + p10 * fx
    bot = p01 * (1.0 - fx) + p11 * fx
    out = top * (1.0 - fy) + bot * fy
    return tuple(out[..., c] for c in range(C))


def bilinear_take_frames(images: jnp.ndarray, fidx: jnp.ndarray,
                         u: jnp.ndarray, v: jnp.ndarray):
    """images: [F, H, W, C]; fidx int32 broadcastable to u/v shape; returns a
    C-tuple of planes sampled in frame ``fidx`` at (u, v). Folds the frame
    index into one rank-1 take instead of vmapping a per-frame gather (which
    hands XLA a batched gather it may lower pathologically)."""
    F, H, W, C = images.shape
    u = jnp.clip(u, 0.0, W - 1.001)
    v = jnp.clip(v, 0.0, H - 1.001)
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    fidx = jnp.broadcast_to(fidx, ix.shape)
    base = (((fidx * H) + iy) * W + ix) * C
    fx = u - ix
    fy = v - iy
    flat = images.reshape(-1)
    out = []
    for c in range(C):
        p00 = flat_take(flat, base + c)
        p10 = flat_take(flat, base + (C) + c)
        p01 = flat_take(flat, base + (W * C) + c)
        p11 = flat_take(flat, base + (W * C + C) + c)
        top = p00 * (1.0 - fx) + p10 * fx
        bot = p01 * (1.0 - fx) + p11 * fx
        out.append(top * (1.0 - fy) + bot * fy)
    return tuple(out)
