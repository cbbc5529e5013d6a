"""Batched SO(3)/SE(3) Lie-group operations in JAX.

Conventions match Sophus (used throughout the reference): SE(3) tangent is
``[tx, ty, tz, rx, ry, rz]`` (translation first), ``exp`` uses the V-matrix
(left Jacobian of SO(3)) for the translation part. Poses are represented as
4x4 homogeneous matrices (leading batch dims allowed). All functions are
jit/vmap-friendly with Taylor-series fallbacks near theta=0.

Used by the coarse tracker pose updates (reference TrackerAndScaler.cpp:550),
motion-model composition (FrontEnd.cpp:132-186), spherical-point trimming
(generate_spherical_points.h:34-40) and the pose graph (LoopHandler.cpp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from functools import partial

# 3x3 geometry math must be full f32: an unpinned f32 product may run at
# reduced precision (TF32 on a GPU).
_HI = jax.lax.Precision.HIGHEST
_mm = partial(jnp.matmul, precision=_HI)

# Taylor-series switch on theta^2. Must be generous in f32: (1 - cos t)
# underflows to exactly 0 for t < ~3e-4, which would poison the closed forms
# (observed as NaN in se3_log near identity). At t = 1e-2 the 2-term Taylor
# error is ~1e-10, far below f32 eps.
_EPS = 1e-4


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator. w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def _sinc_coeffs(theta_sq: jnp.ndarray):
    """Return (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3) with
    Taylor fallbacks (stable for small and moderate theta)."""
    theta = jnp.sqrt(jnp.maximum(theta_sq, 0.0))
    small = theta_sq < _EPS
    # guard against div-by-zero under jit
    safe_t2 = jnp.where(small, 1.0, theta_sq)
    safe_t = jnp.sqrt(safe_t2)
    t2 = theta_sq
    A = jnp.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, jnp.sin(safe_t) / safe_t)
    B = jnp.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0, (1.0 - jnp.cos(safe_t)) / safe_t2)
    C = jnp.where(
        small,
        1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0,
        (safe_t - jnp.sin(safe_t)) / (safe_t2 * safe_t),
    )
    return A, B, C


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues. w: (..., 3) -> (..., 3, 3)."""
    theta_sq = jnp.sum(w * w, axis=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    W = hat(w)
    W2 = _mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Inverse Rodrigues. R: (..., 3, 3) -> (..., 3). Safe near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    # antisymmetric part; its norm is sin(theta)
    w = 0.5 * jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    # NaN-safe-under-autodiff norm: freeze the argument of sqrt near zero so
    # the unselected branch of the `where` below cannot poison gradients
    # (jacfwd/grad flow through BOTH branches of jnp.where).
    sin_sq = jnp.sum(w * w, axis=-1)
    tiny = sin_sq < 1e-12
    sin_theta = jnp.sqrt(jnp.where(tiny, 1e-12, sin_sq))
    sin_theta = jnp.where(tiny, 0.0, sin_theta)
    # atan2 is well conditioned everywhere except theta ~ pi (handled below)
    theta = jnp.arctan2(sin_theta, cos_theta)
    small = theta < 1e-5
    near_pi = theta > jnp.pi - 1e-2
    sin_safe = jnp.where(jnp.abs(sin_theta) < 1e-10, 1.0, sin_theta)
    scale = jnp.where(small, 1.0 + theta**2 / 6.0, theta / sin_safe)
    w_generic = w * scale[..., None]
    # near pi: use diagonal formula w_i = theta * sqrt((R_ii - cos)/ (1-cos)),
    # signs from the antisymmetric part (or largest diagonal if degenerate).
    # freeze the ratio where the branch is unselected (gradient safety).
    one_minus_cos = jnp.where(near_pi, jnp.maximum(1.0 - cos_theta, 1e-12), 1.0)
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    ratio = jnp.where(
        near_pi[..., None],
        jnp.maximum((diag - cos_theta[..., None]) / one_minus_cos[..., None], 0.0),
        1.0,
    )
    axis_abs = jnp.sqrt(ratio)
    # recover signs from off-diagonal sums: sign(axis_i * axis_j) =
    # sign(R_ij + R_ji). Anchor the positive sign on the LARGEST |axis|
    # component (as in quaternion-from-matrix recovery) and derive the other
    # two from its pairwise sums — anchoring on a fixed component breaks
    # when that component is ~0 (both its pairwise sums vanish and the
    # remaining components' relative sign is lost, e.g. axis (0, y, -z)).
    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    s12 = R[..., 1, 2] + R[..., 2, 1]
    sgn = lambda s: jnp.where(s >= 0, 1.0, -1.0)
    ax0, ax1, ax2 = axis_abs[..., 0], axis_abs[..., 1], axis_abs[..., 2]
    anchor0 = jnp.stack([ax0, sgn(s01) * ax1, sgn(s02) * ax2], axis=-1)
    anchor1 = jnp.stack([sgn(s01) * ax0, ax1, sgn(s12) * ax2], axis=-1)
    anchor2 = jnp.stack([sgn(s02) * ax0, sgn(s12) * ax1, ax2], axis=-1)
    k = jnp.argmax(axis_abs, axis=-1)[..., None]
    axis = jnp.where(k == 0, anchor0, jnp.where(k == 1, anchor1, anchor2))
    # keep direction consistent with antisymmetric part where it is nonzero
    flip = jnp.sum(axis * w, axis=-1) < 0
    axis = jnp.where(flip[..., None], -axis, axis)
    w_pi = axis * theta[..., None]
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """xi: (..., 6) tangent [t, w] -> (..., 4, 4)."""
    t, w = xi[..., :3], xi[..., 3:]
    theta_sq = jnp.sum(w * w, axis=-1)
    A, B, C = _sinc_coeffs(theta_sq)
    W = hat(w)
    W2 = _mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    trans = jnp.einsum("...ij,...j->...i", V, t, precision=_HI)
    top = jnp.concatenate([R, trans[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """T: (..., 4, 4) -> (..., 6) tangent [t, w]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta_sq = jnp.sum(w * w, axis=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    W = hat(w)
    W2 = _mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    # V^{-1} = I - 1/2 W + (1/t^2)(1 - A/(2B)) W^2
    small = theta_sq < _EPS
    safe_t2 = jnp.where(small, 1.0, theta_sq)
    safe_B = jnp.where(jnp.abs(B) < 1e-12, 1.0, B)
    coef = jnp.where(small, 1.0 / 12.0 + theta_sq / 720.0, (1.0 - A / (2.0 * safe_B)) / safe_t2)
    Vinv = eye - 0.5 * W + coef[..., None, None] * W2
    u = jnp.einsum("...ij,...j->...i", Vinv, t, precision=_HI)
    return jnp.concatenate([u, w], axis=-1)


def se3_inverse(T: jnp.ndarray) -> jnp.ndarray:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    new_t = -jnp.einsum("...ij,...j->...i", Rt, t, precision=_HI)
    top = jnp.concatenate([Rt, new_t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=T.dtype), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def se3_identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.eye(4, dtype=dtype)


def transform_points(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply (..., 4, 4) to points (..., N, 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return jnp.einsum("...ij,...nj->...ni", R, pts, precision=_HI) + t[..., None, :]


def se3_adjoint(T: jnp.ndarray) -> jnp.ndarray:
    """Adjoint of SE(3) for tangent ordering [t, w]: (..., 6, 6).

    Adj = [[R, hat(t) R], [0, R]] — maps tangents between frames; used by the
    windowed BA to chain relative-pose Jacobians to absolute frame states
    (the array equivalent of DSO's EnergyFunctional adjoints)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = _mm(hat(t), R)
    zeros = jnp.zeros_like(R)
    top = jnp.concatenate([R, tR], axis=-1)
    bottom = jnp.concatenate([zeros, R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


# ---------------------------------------------------------------------------
# Host (numpy, float64) variants of the SE(3) maps.
#
# The per-frame motion-model bookkeeping runs on the HOST between device
# programs; calling the jnp versions there would execute ~100 tiny eager
# device ops per frame, where numpy takes well under a millisecond.
# These mirror se3_exp/se3_log above in float64.
# ---------------------------------------------------------------------------


def _np_sinc_coeffs(theta_sq: float):
    import numpy as _np

    if theta_sq < 1e-10:
        t2 = theta_sq
        return (1.0 - t2 / 6.0 + t2 * t2 / 120.0,
                0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0)
    t = float(_np.sqrt(theta_sq))
    return (_np.sin(t) / t,
            (1.0 - _np.cos(t)) / theta_sq,
            (t - _np.sin(t)) / (theta_sq * t))


def _np_hat(w):
    import numpy as _np

    return _np.array([
        [0.0, -w[2], w[1]],
        [w[2], 0.0, -w[0]],
        [-w[1], w[0], 0.0],
    ])


def so3_log_np(R):
    """Inverse Rodrigues, numpy float64, safe near 0 and pi (same branch
    structure as so3_log)."""
    import numpy as _np

    R = _np.asarray(R, _np.float64)
    cos_theta = float(_np.clip((_np.trace(R) - 1.0) * 0.5, -1.0, 1.0))
    w = 0.5 * _np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]])
    sin_theta = float(_np.linalg.norm(w))
    theta = float(_np.arctan2(sin_theta, cos_theta))
    if theta < 1e-7:
        return w
    if theta > _np.pi - 1e-3:
        one_minus_cos = max(1.0 - cos_theta, 1e-12)
        axis_abs = _np.sqrt(_np.maximum(
            (_np.diag(R) - cos_theta) / one_minus_cos, 0.0))
        s = _np.array([R[0, 1] + R[1, 0], R[0, 2] + R[2, 0],
                       R[1, 2] + R[2, 1]])          # s01, s02, s12
        sgn = lambda x: 1.0 if x >= 0 else -1.0
        k = int(_np.argmax(axis_abs))
        axis = axis_abs.copy()
        if k == 0:
            axis[1] *= sgn(s[0]); axis[2] *= sgn(s[1])
        elif k == 1:
            axis[0] *= sgn(s[0]); axis[2] *= sgn(s[2])
        else:
            axis[0] *= sgn(s[1]); axis[1] *= sgn(s[2])
        if float(axis @ w) < 0:
            axis = -axis
        return axis / max(float(_np.linalg.norm(axis)), 1e-12) * theta
    return w * (theta / sin_theta)


def se3_exp_np(xi):
    """(6,) tangent [t, w] -> (4, 4), numpy float64."""
    import numpy as _np

    xi = _np.asarray(xi, _np.float64)
    t, w = xi[:3], xi[3:]
    A, B, C = _np_sinc_coeffs(float(w @ w))
    W = _np_hat(w)
    W2 = W @ W
    T = _np.eye(4)
    T[:3, :3] = _np.eye(3) + A * W + B * W2
    T[:3, 3] = (_np.eye(3) + B * W + C * W2) @ t
    return T


def se3_log_np(T):
    """(4, 4) -> (6,) tangent [t, w], numpy float64."""
    import numpy as _np

    T = _np.asarray(T, _np.float64)
    w = so3_log_np(T[:3, :3])
    theta_sq = float(w @ w)
    A, B, _ = _np_sinc_coeffs(theta_sq)
    W = _np_hat(w)
    W2 = W @ W
    if theta_sq < 1e-10:
        coef = 1.0 / 12.0 + theta_sq / 720.0
    else:
        coef = (1.0 - A / (2.0 * B)) / theta_sq
    Vinv = _np.eye(3) - 0.5 * W + coef * W2
    return _np.concatenate([Vinv @ T[:3, 3], w])
