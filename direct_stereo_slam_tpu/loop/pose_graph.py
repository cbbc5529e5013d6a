"""SE(3) pose-graph optimization.

Equivalent of the reference's g2o glue (LoopHandler.cpp:43-51, 101-142):
vertices = keyframe poses (camToWorld), edges = odometry + loop constraints
with Huber robust kernel, block-diagonal information matrices built from
the dso/scale/pose error heuristics (LoopHandler.h:50-64), the *newest*
vertex fixed (cpp:137 — the past bends, the present stays), 25 LM
iterations per loop event.

Per-edge residuals r = log(Z^-1 T_a^-1 T_b) and their Jacobians via
vmapped forward-mode autodiff through the Lie ops. Two solver backends
(graphs are bucketed to fixed sizes):

- "dense": Hessian scatter-added into [6N, 6N], LU solve. Memory grows as
  (6N)^2 floats (38 MB at 512 nodes, 604 MB at 2048) and the solve as N^3.
- "cg": matrix-free block-Jacobi-preconditioned conjugate gradients — Hx
  is two gathers + two scatter-adds over the per-edge 12x12 blocks (O(E)
  memory), so graphs scale far past the dense path.

"auto" takes the dense path up to 512 nodes and CG beyond. Both solve the
same damped GN step; chip_smoke.py checks that they agree at 2048 nodes."""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import lie

_HI = jax.lax.Precision.HIGHEST


class PoseGraphData(NamedTuple):
    """Fixed-size (bucketed) problem arrays."""

    T_wc: jnp.ndarray        # [N, 4, 4] initial node poses
    node_valid: jnp.ndarray  # [N]
    edge_a: jnp.ndarray      # [E] node index (the "cur" side)
    edge_b: jnp.ndarray      # [E] node index (the "from"/matched side)
    edge_Z: jnp.ndarray      # [E, 4, 4] measurement: expected T_a^-1 T_b
    edge_w_t: jnp.ndarray    # [E] translation information weight
    edge_w_r: jnp.ndarray    # [E] rotation information weight
    edge_valid: jnp.ndarray  # [E]
    fixed_node: jnp.ndarray  # scalar index


def _edge_residual(T_a, T_b, Z):
    return lie.se3_log(
        jnp.matmul(jnp.matmul(lie.se3_inverse(Z), lie.se3_inverse(T_a),
                              precision=_HI), T_b, precision=_HI))


def _edge_res_jac(T_a, T_b, Z):
    """Residual + Jacobians wrt right-multiplied tangents of (a, b)."""
    def f(xi_ab):
        Ta = jnp.matmul(T_a, lie.se3_exp(xi_ab[:6]), precision=_HI)
        Tb = jnp.matmul(T_b, lie.se3_exp(xi_ab[6:]), precision=_HI)
        return _edge_residual(Ta, Tb, Z)

    r = _edge_residual(T_a, T_b, Z)
    J = jax.jacfwd(f)(jnp.zeros(12, jnp.float32))   # [6, 12]
    return r, J


def _edge_system(data: PoseGraphData, T, huber_delta):
    """Per-edge Gauss-Newton blocks at the current poses.
    Returns (Hblk [E,12,12], bblk [E,12])."""
    Ta = T[data.edge_a]
    Tb = T[data.edge_b]
    r, J = jax.vmap(_edge_res_jac)(Ta, Tb, data.edge_Z)   # [E,6], [E,6,12]

    # block-diagonal information: translation w_t, rotation w_r
    info = jnp.concatenate([
        jnp.broadcast_to(data.edge_w_t[:, None], (r.shape[0], 3)),
        jnp.broadcast_to(data.edge_w_r[:, None], (r.shape[0], 3)),
    ], axis=1)                                             # [E, 6]
    chi2 = jnp.sum(info * r * r, axis=1)
    hw = jnp.where(chi2 <= huber_delta**2, 1.0,
                   huber_delta / jnp.sqrt(jnp.maximum(chi2, 1e-12)))
    w = info * (hw * data.edge_valid.astype(jnp.float32))[:, None]

    Jw = J * w[:, :, None]
    Hblk = jnp.einsum("eki,ekj->eij", Jw, J, precision=_HI)
    bblk = jnp.einsum("eki,ek->ei", Jw, r, precision=_HI)
    return Hblk, bblk


def _free_mask(data: PoseGraphData):
    idx = jnp.arange(data.T_wc.shape[0])
    return data.node_valid & (idx != data.fixed_node)


def _solve_dense(data, Hblk, bblk, lam):
    """Materialized [6N, 6N] LU solve (fine into the low thousands)."""
    N = data.T_wc.shape[0]
    H = jnp.zeros((N, 6, N, 6), jnp.float32)
    b = jnp.zeros((N, 6), jnp.float32)
    ea, eb = data.edge_a, data.edge_b
    H = H.at[ea, :, ea, :].add(Hblk[:, :6, :6])
    H = H.at[ea, :, eb, :].add(Hblk[:, :6, 6:])
    H = H.at[eb, :, ea, :].add(Hblk[:, 6:, :6])
    H = H.at[eb, :, eb, :].add(Hblk[:, 6:, 6:])
    b = b.at[ea].add(bblk[:, :6])
    b = b.at[eb].add(bblk[:, 6:])

    Hd = H.reshape(6 * N, 6 * N)
    bd = b.reshape(6 * N)

    # fix the newest vertex + invalid nodes: eliminate their variables
    free = jnp.repeat(_free_mask(data), 6)
    Hd = jnp.where(free[:, None] & free[None, :], Hd, 0.0)
    # light LM damping on free vars; unit diagonal keeps fixed vars solvable
    Hd = Hd + jnp.diag(jnp.where(free, lam, 1.0))
    Hd = Hd + 1e-6 * jnp.eye(6 * N, dtype=jnp.float32)
    bd = jnp.where(free, bd, 0.0)
    return jnp.linalg.solve(Hd, -bd).reshape(N, 6)


def _solve_cg(data, Hblk, bblk, lam, cg_iters):
    """Matrix-free block-Jacobi-preconditioned CG: the graph Hessian is
    never materialized — Hx is two gathers + two scatter-adds over the
    edge blocks (O(E) memory), so pose graphs scale far past the dense
    path's [6N, 6N] limit. Solves the FREE subsystem (fixed/invalid nodes
    pinned to zero update), matching _solve_dense."""
    N = data.T_wc.shape[0]
    ea, eb = data.edge_a, data.edge_b
    free = _free_mask(data).astype(jnp.float32)[:, None]    # [N, 1]
    damp = lam + 1e-6

    b = jnp.zeros((N, 6), jnp.float32)
    b = b.at[ea].add(bblk[:, :6])
    b = b.at[eb].add(bblk[:, 6:])
    b = -b * free

    def Hx(x):
        x = x * free
        xa, xb = x[ea], x[eb]
        ya = (jnp.einsum("eij,ej->ei", Hblk[:, :6, :6], xa, precision=_HI)
              + jnp.einsum("eij,ej->ei", Hblk[:, :6, 6:], xb, precision=_HI))
        yb = (jnp.einsum("eij,ej->ei", Hblk[:, 6:, :6], xa, precision=_HI)
              + jnp.einsum("eij,ej->ei", Hblk[:, 6:, 6:], xb, precision=_HI))
        y = jnp.zeros((N, 6), jnp.float32)
        y = y.at[ea].add(ya)
        y = y.at[eb].add(yb)
        return (y + damp * x) * free

    # block-Jacobi preconditioner: per-node 6x6 diagonal blocks
    D = jnp.zeros((N, 6, 6), jnp.float32)
    D = D.at[ea].add(Hblk[:, :6, :6])
    D = D.at[eb].add(Hblk[:, 6:, 6:])
    D = D + damp * jnp.eye(6, dtype=jnp.float32)[None]
    Dinv = jnp.linalg.inv(D)

    def Minv(x):
        return jnp.einsum("nij,nj->ni", Dinv, x, precision=_HI) * free

    x0 = jnp.zeros((N, 6), jnp.float32)
    r0 = b                       # b - Hx(0)
    z0 = Minv(r0)
    dot = lambda p, q: jnp.sum(p * q)

    def cg_body(c):
        x, r, z, p, rz, it = c
        Hp = Hx(p)
        alpha = rz / jnp.maximum(dot(p, Hp), 1e-20)
        x = x + alpha * p
        r = r - alpha * Hp
        z = Minv(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-20)
        p = z + beta * p
        return x, r, z, p, rz_new, it + 1

    def cg_cond(c):
        _, r, _, _, _, it = c
        return (it < cg_iters) & (dot(r, r) > 1e-10 * jnp.maximum(dot(b, b), 1e-20))

    x, *_ = jax.lax.while_loop(
        cg_cond, cg_body, (x0, r0, z0, z0, dot(r0, z0), jnp.int32(0)))
    return x


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def optimize(data: PoseGraphData, iterations: int = 25,
             huber_delta: float = 1.0, solver: str = "auto",
             cg_iters: int = 100) -> jnp.ndarray:
    """Returns optimized [N, 4, 4] poses. solver: "dense" (LU on the
    materialized system), "cg" (matrix-free block-Jacobi PCG), or "auto"
    (dense up to 512 nodes, CG beyond)."""
    N = data.T_wc.shape[0]
    if solver == "auto":
        solver = "dense" if N <= 512 else "cg"

    def gn_iter(carry, _):
        T, lam = carry
        Hblk, bblk = _edge_system(data, T, huber_delta)
        if solver == "cg":
            x = _solve_cg(data, Hblk, bblk, lam, cg_iters)
        else:
            x = _solve_dense(data, Hblk, bblk, lam)
        T_new = jnp.matmul(T, lie.se3_exp(x), precision=_HI)
        return (T_new, lam), None

    (T_fin, _), _ = jax.lax.scan(
        gn_iter, (data.T_wc, jnp.float32(1e-4)), None, length=iterations)
    return T_fin


def next_bucket(n: int) -> int:
    """Static problem sizes so jit caches stay small."""
    b = 16
    while b < n:
        b *= 2
    return b


def build_data(
    poses_wc: np.ndarray,       # [n, 4, 4]
    edges,                      # list of (a, b, Z [4,4], w_t, w_r)
    fixed_node: int,
) -> PoseGraphData:
    n = len(poses_wc)
    N = next_bucket(n)
    E = next_bucket(max(len(edges), 1))
    T = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    T[:n] = poses_wc
    node_valid = np.zeros(N, bool)
    node_valid[:n] = True
    ea = np.zeros(E, np.int32)
    eb = np.zeros(E, np.int32)
    Z = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    wt = np.zeros(E, np.float32)
    wr = np.zeros(E, np.float32)
    ev = np.zeros(E, bool)
    for i, (a, b, z, w_t, w_r) in enumerate(edges):
        ea[i], eb[i] = a, b
        Z[i] = z
        wt[i], wr[i] = w_t, w_r
        ev[i] = True
    return PoseGraphData(
        T_wc=jnp.asarray(T), node_valid=jnp.asarray(node_valid),
        edge_a=jnp.asarray(ea), edge_b=jnp.asarray(eb), edge_Z=jnp.asarray(Z),
        edge_w_t=jnp.asarray(wt), edge_w_r=jnp.asarray(wr),
        edge_valid=jnp.asarray(ev), fixed_node=jnp.int32(fixed_node),
    )
