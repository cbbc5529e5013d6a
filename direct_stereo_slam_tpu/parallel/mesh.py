"""Multi-device execution: data-parallel batch evaluation over sequences.

The reference is a single-process shared-memory system (SURVEY.md §2.3);
SLAM state is inherently sequential, so the multi-device story is
data parallelism over *sequences/configs* (BASELINE.json config 5: headless
batch eval over KITTI 00-10): each device runs an independent sequence's
per-frame step; within a device the point/candidate axes stay batched.

``batched_tracking_step`` is the fleet-style "training step": B sequences'
tracker templates + new frames -> tracked poses + stereo scale, jitted over
a ``Mesh('seq')`` with `shard_map` so each device owns B/n sequences and no
cross-device collectives sit on the per-frame critical path (an all-gather
of the tiny pose outputs crosses the device links only at the epoch
boundary).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SLAMConfig
from ..geometry.camera import PyramidIntrinsics
from ..models.depth_template import TrackerTemplate
from ..models.tracker import AffLight, track_candidate
from ..models.scale_opt import optimize_scale_single
from ..ops.pyramid import build_pyramid

_HI = jax.lax.Precision.HIGHEST


class BatchedStepOut(NamedTuple):
    T: jnp.ndarray          # [B, 4, 4] tracked ref->new poses
    res: jnp.ndarray        # [B] finest-level residuals
    scale: jnp.ndarray      # [B] optimized stereo scale
    scale_err: jnp.ndarray  # [B]


def make_batched_step(intr: PyramidIntrinsics, cfg: SLAMConfig, levels: int):
    """Returns step(batch) -> BatchedStepOut for one frame of B sequences.

    batch: dict with img0 [B, H, W], img1 [B, H, W], template (TrackerTemplate
    with leading batch dim on every leaf), T_init [B, 4, 4]."""

    def step(img0, img1, template, T_init):
        # PLAIN vmap over per-sequence pyramid planes, not the "folded"
        # form (close over [B, Hl, Wl, 3] stacks, sample each lane through
        # one rank-1 flat take), whose take path pays its per-op overheads
        # times B (bench.py batch sweep measures both).
        def one_sequence(pyr0_data, pyr1_data, z_src, template, T_init):
            # derive scalars from per-shard data: under shard_map's
            # varying-axes checking (jax>=0.8), replicated literals in
            # while_loop carries clash with shard-varying outputs
            z = z_src * 0.0
            zero = AffLight(z, z)
            one = z + 1.0
            tr = track_candidate(
                pyr0_data, template, intr, cfg, T_init, zero, zero, one, one
            )
            t10 = jnp.eye(4, dtype=jnp.float32).at[0, 3].set(-0.54)
            so = optimize_scale_single(
                pyr1_data, template, intr, intr, t10, cfg, jnp.float32(1.0)
            )
            return BatchedStepOut(
                T=tr.T, res=tr.res_per_level[0], scale=so.scale,
                scale_err=so.error
            )

        pyr0s = jax.vmap(lambda im: build_pyramid(im, levels))(img0)
        pyr1s = jax.vmap(lambda im: build_pyramid(im, levels))(img1)
        return jax.vmap(one_sequence, in_axes=(0, 0, 0, 0, 0))(
            tuple(pyr0s.data), tuple(pyr1s.data), img0[:, 0, 0],
            template, T_init
        )

    return step


def shard_batched_step(step_fn, mesh: Mesh):
    """Shard the batched step over the 'seq' mesh axis with shard_map: every
    leaf is partitioned on its leading (sequence) dimension."""
    spec = P("seq")

    def sharded(img0, img1, template, T_init):
        fn = jax.shard_map(
            step_fn, mesh=mesh,
            in_specs=(spec, spec, jax.tree_util.tree_map(lambda _: spec, template),
                      spec),
            out_specs=BatchedStepOut(T=spec, res=spec, scale=spec, scale_err=spec),
        )
        return fn(img0, img1, template, T_init)

    return jax.jit(sharded)


def shard_ba_optimize(cfg: SLAMConfig, mesh: Mesh, iterations: int = 2):
    """Shard windowed-BA optimization over the 'seq' mesh axis: a batch of
    B independent BA windows (BAState with a leading batch dim on every
    leaf) solves as vmap(ba.optimize) inside shard_map — each device owns
    B/n windows, no collectives on the solve path. This is the keyframe
    "training step" counterpart of the per-frame tracking step above."""
    from ..models import ba as ba_mod

    def step(states):
        def one(st):
            st2, rmse, ok = ba_mod.optimize(st, cfg, iterations)
            return st2, rmse, ok
        return jax.vmap(one)(states)

    spec = P("seq")

    def sharded(states):
        in_spec = jax.tree_util.tree_map(lambda _: spec, states)
        fn = jax.shard_map(
            step, mesh=mesh,
            in_specs=(in_spec,),
            out_specs=(in_spec, spec, spec),
        )
        return fn(states)

    return jax.jit(sharded)


def shard_candidate_retrack(intr: PyramidIntrinsics, cfg: SLAMConfig,
                            mesh: Mesh):
    """Shard ONE sequence's candidate re-track stage (the 78-perturbation
    batch, FrontEnd.cpp:165-186) over the mesh: the new frame's pyramid and
    the tracker template are replicated, the candidate poses are partitioned
    on their leading axis, and the winner is chosen from an `all_gather` of
    the tiny per-candidate (res, ok) outputs — the only collective.
    Returns step(pyr_new, template, T_cands [C,4,4]) ->
    (res0 [C], ok [C], winner scalar)."""
    from ..models.tracker import track_candidate

    def local_track(pyr_new, template, T_cands):
        def one(T0):
            z = T_cands[0, 0, 0] * 0.0      # varying zero for carried scalars
            zero = AffLight(z, z)
            one_ = z + 1.0
            out = track_candidate(
                tuple(pyr_new), template, intr, cfg, T0, zero, zero, one_, one_
            )
            return out.res_per_level[0], out.ok
        res0, ok = jax.vmap(one)(T_cands)
        res_all = jax.lax.all_gather(res0, "seq", tiled=True)   # [C]
        ok_all = jax.lax.all_gather(ok, "seq", tiled=True)      # [C]
        masked = jnp.where(ok_all & jnp.isfinite(res_all), res_all, jnp.inf)
        # all_gather output stays vma-varying, so the (identical) winner is
        # emitted per-device and stitched with P('seq'): callers read [0]
        winner = jnp.argmin(masked)
        return res0, ok, winner[None]

    rep = P()
    var = P("seq")

    def sharded(pyr_new, template, T_cands):
        fn = jax.shard_map(
            local_track, mesh=mesh,
            in_specs=(
                jax.tree_util.tree_map(lambda _: rep, tuple(pyr_new)),
                jax.tree_util.tree_map(lambda _: rep, template),
                var,
            ),
            out_specs=(var, var, var),
        )
        return fn(tuple(pyr_new), template, T_cands)

    return jax.jit(sharded)


def shard_scale_grid(intr0: PyramidIntrinsics, intr1: PyramidIntrinsics,
                     cfg: SLAMConfig, mesh: Mesh):
    """Shard the 8-guess scale-opt grid (FrontEnd.cpp:995-1003) over the
    mesh: one (or more) initial guesses per device, replicated pyramid +
    template, all_gather of the scalar (scale, error) pairs, best-error
    winner replicated to every device."""
    from ..models.scale_opt import optimize_scale_single

    def local_opt(pyr1, template, t_cam1_cam0, scales0):
        def one(s0):
            return optimize_scale_single(
                tuple(pyr1), template, intr0, intr1, t_cam1_cam0, cfg, s0
            )
        out = jax.vmap(one)(scales0)
        s_all = jax.lax.all_gather(out.scale, "seq", tiled=True)
        e_all = jax.lax.all_gather(out.error, "seq", tiled=True)
        best = jnp.argmin(jnp.where(e_all > 0, e_all, jnp.inf))
        # per-device (identical) winner, stitched with P('seq'); read [0]
        return s_all[best][None], e_all[best][None]

    rep = P()
    var = P("seq")

    def sharded(pyr1, template, t_cam1_cam0, scales0):
        fn = jax.shard_map(
            local_opt, mesh=mesh,
            in_specs=(
                jax.tree_util.tree_map(lambda _: rep, tuple(pyr1)),
                jax.tree_util.tree_map(lambda _: rep, template),
                rep, var,
            ),
            out_specs=(var, var),
        )
        return fn(tuple(pyr1), template, t_cam1_cam0, scales0)

    return jax.jit(sharded)


def shard_posegraph_optimize(mesh: Mesh, iterations: int = 25,
                             huber_delta: float = 1.0, cg_iters: int = 100):
    """Distributed pose-graph Gauss-Newton: node poses replicated, EDGES
    sharded over the mesh. Each device linearizes its own edge slice and
    scatter-adds partial gradient / block-Jacobi / Hessian-vector products
    into the full node vector; a `psum` over the mesh completes every CG
    matvec (the collective pattern of a distributed sparse solver). Scales
    the matrix-free PCG of loop/pose_graph.py past one device's edge budget.

    Returns step(data: PoseGraphData) -> [N, 4, 4] with edge arrays padded
    to a multiple of the mesh size."""
    from ..loop import pose_graph as pg

    def local_solve(T_wc, node_valid, fixed_node, ea, eb, Z, wt, wr, ev):
        N = T_wc.shape[0]
        freef = (node_valid & (jnp.arange(N) != fixed_node)).astype(
            jnp.float32)[:, None]                              # [N, 1]

        def gn_iter(carry, _):
            T, lam = carry
            local = pg.PoseGraphData(
                T_wc=T, node_valid=node_valid, edge_a=ea, edge_b=eb,
                edge_Z=Z, edge_w_t=wt, edge_w_r=wr, edge_valid=ev,
                fixed_node=fixed_node)
            Hblk, bblk = pg._edge_system(local, T, huber_delta)
            damp = lam + 1e-6

            b = jnp.zeros((N, 6), jnp.float32)
            b = b.at[ea].add(bblk[:, :6])
            b = b.at[eb].add(bblk[:, 6:])
            b = -jax.lax.psum(b, "seq") * freef

            def Hx(x):
                x = x * freef
                xa, xb = x[ea], x[eb]
                ya = (jnp.einsum("eij,ej->ei", Hblk[:, :6, :6], xa,
                                 precision=_HI)
                      + jnp.einsum("eij,ej->ei", Hblk[:, :6, 6:], xb,
                                   precision=_HI))
                yb = (jnp.einsum("eij,ej->ei", Hblk[:, 6:, :6], xa,
                                 precision=_HI)
                      + jnp.einsum("eij,ej->ei", Hblk[:, 6:, 6:], xb,
                                   precision=_HI))
                y = jnp.zeros((N, 6), jnp.float32)
                y = y.at[ea].add(ya)
                y = y.at[eb].add(yb)
                return (jax.lax.psum(y, "seq") + damp * x) * freef

            D = jnp.zeros((N, 6, 6), jnp.float32)
            D = D.at[ea].add(Hblk[:, :6, :6])
            D = D.at[eb].add(Hblk[:, 6:, 6:])
            D = jax.lax.psum(D, "seq") + damp * jnp.eye(
                6, dtype=jnp.float32)[None]
            Dinv = jnp.linalg.inv(D)
            Minv = lambda x: jnp.einsum(
                "nij,nj->ni", Dinv, x, precision=_HI) * freef

            x0 = jnp.zeros((N, 6), jnp.float32)
            z0 = Minv(b)
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
                return x, r, z, z + beta * p, rz_new, it + 1

            def cg_cond(c):
                _, r, _, _, _, it = c
                return (it < cg_iters) & (
                    dot(r, r) > 1e-10 * jnp.maximum(dot(b, b), 1e-20))

            x, *_ = jax.lax.while_loop(
                cg_cond, cg_body, (x0, b, z0, z0, dot(b, z0), jnp.int32(0)))

            return (jnp.matmul(T, _se3_exp_batch(x), precision=_HI), lam), None

        (T_fin, _), _ = jax.lax.scan(
            gn_iter, (T_wc, jnp.float32(1e-4)), None, length=iterations)
        return T_fin

    from ..geometry import lie

    def _se3_exp_batch(x):
        return jax.vmap(lie.se3_exp)(x)

    rep = P()
    var = P("seq")

    def sharded(data):
        fn = jax.shard_map(
            local_solve, mesh=mesh,
            in_specs=(rep, rep, rep, var, var, var, var, var, var),
            out_specs=rep,
        )
        return fn(data.T_wc, data.node_valid, data.fixed_node,
                  data.edge_a, data.edge_b, data.edge_Z,
                  data.edge_w_t, data.edge_w_r, data.edge_valid)

    return jax.jit(sharded)


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(
                f"make_mesh: requested {n_devices} devices but only "
                f"{len(devs)} visible ({devs[0].platform}); force a virtual "
                f"CPU platform (xla_force_host_platform_device_count) first"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("seq",))
