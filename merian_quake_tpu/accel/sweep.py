"""Cluster sweep: the GPU ray-traversal kernel (Pallas, Triton route).

One program traces a block of ``ray_block`` rays against the whole
triangle soup, which stays in device memory in the cluster-major SoA
layout of ``AccelScene.tri_soa`` (v0, e1, e2 rows of 64 triangles; at
313k triangles about 11 MB, so it lives in the H100's 50 MB L2). A loop
over clusters inside the kernel:

1. slab-tests the block's rays against the cluster AABB, clipped to each
   ray's running best ``t`` (nearest) or ``t_max`` (any-hit);
2. only if some ray can reach the box, and some triangle of the cluster
   carries the requested mask bit, runs Möller–Trumbore on the
   ``ray_block × 64`` pairs with the oracle's arithmetic and conventions
   (``accel/intersect.intersect_oracle``): backface culling with
   ``det < -1e-9``, ``u, v ≥ 0``, ``u + v ≤ 1``, ``t_min < t ≤ t_max``;
3. folds the result into the running ``(t, tri, u, v)`` (nearest, ties
   to the lowest triangle index like the oracle) or the occlusion flag
   (any-hit, which stops a block once every ray is occluded).

There is no matrix product here, so the tensor cores (and TF32) never
touch the result. f32 division is the card's fast division, so ``t``,
``u`` and ``v`` can differ from the oracle in the last bits; hits on a
shared edge or at an exact ``t`` tie may then pick the other triangle.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..models.types import CLUSTER_SIZE
from .build import AccelScene

BIG = 3e38  # miss distance (the oracle's _BIG)
DET_EPS = 1e-9
# rays per program and warps per program: 32 x 4 measured fastest on an
# H100 (primary and bounce rays; 128 x 4 spills registers)
RAY_BLOCK = 32
NUM_WARPS = 4
# AABB slack: absolute (world units) + relative to the box's coordinates,
# so rounding in the slab test never culls a cluster that holds a hit
_PAD_ABS = 1e-3
_PAD_REL = 1e-5


def _safe_inv(x):
    """1/x with |x| clamped away from 0 (no inf·0 NaNs in the slab)."""
    tiny = 1e-20
    return 1.0 / jnp.where(jnp.abs(x) < tiny, jnp.where(x < 0, -tiny, tiny), x)


def _kernel(rays_ref, box_ref, cmask_ref, soa_ref, tmask_ref, *out_refs,
            bit: int, any_hit: bool):
    n_clusters = cmask_ref.shape[0]
    ox, oy, oz, dx, dy, dz, tmin, tmax = (rays_ref[k, :] for k in range(8))
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    # rays with an empty interval take no part (padding, dead lanes)
    idle = tmax <= tmin
    lane = jnp.arange(CLUSTER_SIZE, dtype=jnp.int32)[None, :]

    def reaches(c, limit):
        """bool[RB]: the ray's [tmin, limit] segment meets cluster c."""
        lo = [box_ref[k, c] for k in range(3)]
        hi = [box_ref[k + 3, c] for k in range(3)]
        tn, tf = tmin, limit
        for o_, i_, l_, h_ in zip((ox, oy, oz), (ix, iy, iz), lo, hi):
            t0 = (l_ - o_) * i_
            t1 = (h_ - o_) * i_
            tn = jnp.maximum(tn, jnp.minimum(t0, t1))
            tf = jnp.minimum(tf, jnp.maximum(t0, t1))
        return tn <= tf

    def pairs(c):
        """(ok, t, u, v) over (RB, 64): oracle Möller–Trumbore."""
        row = lambda k: soa_ref[c, k, :][None, :]
        v0x, v0y, v0z = row(0), row(1), row(2)
        e1x, e1y, e1z = row(3), row(4), row(5)
        e2x, e2y, e2z = row(6), row(7), row(8)
        m = ((tmask_ref[c, :] & bit) != 0)[None, :]
        Dx, Dy, Dz = dx[:, None], dy[:, None], dz[:, None]
        px = Dy * e2z - Dz * e2y
        py = Dz * e2x - Dx * e2z
        pz = Dx * e2y - Dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        front = det < -DET_EPS
        inv_det = 1.0 / jnp.where(front, det, -1.0)
        tx = ox[:, None] - v0x
        ty = oy[:, None] - v0y
        tz = oz[:, None] - v0z
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (Dx * qx + Dy * qy + Dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = (
            front & m & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > tmin[:, None]) & (t <= tmax[:, None])
        )
        return ok, t, u, v

    def wanted(c):
        return (cmask_ref[c] & bit) != 0

    def some(x):
        return jnp.max(x.astype(jnp.int32)) > 0

    def not_done(carry):
        c, done = carry[0], carry[1]
        return (c < n_clusters) & (jnp.min(done.astype(jnp.int32)) == 0)

    if any_hit:
        (occ_ref,) = out_refs

        def visit(c, occ):
            ok = pairs(c)[0]
            return occ | (jnp.max(ok.astype(jnp.int32), axis=1) > 0)

        def body(carry):
            c, done, occ = carry
            go = wanted(c) & some(reaches(c, tmax) & ~done)
            occ = lax.cond(go, visit, lambda c_, o_: o_, c, occ)
            return c + 1, idle | occ, occ

        occ0 = jnp.zeros_like(idle)
        _, _, occ = lax.while_loop(not_done, body, (0, idle, occ0))
        occ_ref[...] = occ.astype(jnp.int32)
        return

    t_ref, tri_ref, u_ref, v_ref = out_refs

    def visit(c, best):
        bt, btri, bu, bv = best
        ok, t, u, v = pairs(c)
        t_m = jnp.where(ok, t, BIG)
        tj = jnp.min(t_m, axis=1)
        j = jnp.argmin(t_m, axis=1).astype(jnp.int32)
        sel = lane == j[:, None]
        uj = jnp.sum(jnp.where(sel, u, 0.0), axis=1)
        vj = jnp.sum(jnp.where(sel, v, 0.0), axis=1)
        better = tj < bt
        return (
            jnp.where(better, tj, bt),
            jnp.where(better, c * CLUSTER_SIZE + j, btri),
            jnp.where(better, uj, bu),
            jnp.where(better, vj, bv),
        )

    def body(carry):
        c, done, best = carry
        go = wanted(c) & some(reaches(c, jnp.minimum(best[0], tmax)) & ~done)
        best = lax.cond(go, visit, lambda c_, b_: b_, c, best)
        return c + 1, done, best

    zero = jnp.zeros_like(tmin)
    best0 = (zero + BIG, jnp.full(tmin.shape, -1, jnp.int32), zero, zero)
    _, _, (bt, btri, bu, bv) = lax.while_loop(
        not_done, body, (0, idle, best0)
    )
    t_ref[...] = bt
    tri_ref[...] = btri
    u_ref[...] = bu
    v_ref[...] = bv


def _padded_boxes(lo, hi):
    """f32[8, C]: AABB rows lo xyz, hi xyz (padded), two zero rows."""
    pad = _PAD_ABS + _PAD_REL * jnp.maximum(jnp.abs(lo), jnp.abs(hi))
    box = jnp.concatenate([lo - pad, hi + pad, jnp.zeros_like(lo[:, :2])], 1)
    return box.T


@functools.partial(
    jax.jit,
    static_argnames=("bit", "any_hit", "ray_block", "interpret"),
)
def _sweep(accel: AccelScene, o, d, t_min, t_max, *, bit, any_hit,
           ray_block, interpret):
    n = o.shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    pad = (-n) % ray_block
    rays = jnp.concatenate(
        [o.T, d.T, t_min[None], t_max[None]], axis=0
    ).astype(jnp.float32)
    if pad:  # padding rays have t_max < t_min: idle
        fill = jnp.zeros((8, pad), jnp.float32).at[7].set(-1.0)
        rays = jnp.concatenate([rays, fill], axis=1)
    n_pad = n + pad
    nc = accel.num_clusters
    box = _padded_boxes(accel.cluster_lo, accel.cluster_hi)
    tmask = accel.tri_mask.reshape(nc, CLUSTER_SIZE)
    full = lambda shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))
    vec = pl.BlockSpec((ray_block,), lambda i: (i,))
    f32 = jax.ShapeDtypeStruct((n_pad,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((n_pad,), jnp.int32)
    out_shape = [i32] if any_hit else [f32, i32, f32, f32]
    outs = pl.pallas_call(
        functools.partial(_kernel, bit=bit, any_hit=any_hit),
        out_shape=out_shape,
        grid=(n_pad // ray_block,),
        in_specs=[
            pl.BlockSpec((8, ray_block), lambda i: (0, i)),
            full(box.shape),
            full(accel.cluster_mask.shape),
            full(accel.tri_soa.shape),
            full(tmask.shape),
        ],
        out_specs=[vec] * len(out_shape),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="cluster_sweep_any" if any_hit else "cluster_sweep",
    )(rays, box, accel.cluster_mask, accel.tri_soa, tmask)
    return tuple(x[:n] for x in outs)


def _interpret_default(interpret):
    return jax.default_backend() != "gpu" if interpret is None else interpret


def sweep_nearest(accel: AccelScene, o, d, t_min, t_max, *, bit: int,
                  ray_block: int = RAY_BLOCK, interpret: bool | None = None):
    """Nearest masked hit per ray: (t f32[N], tri i32[N], u, v).

    Misses give ``t = BIG`` and ``tri = -1``. ``interpret`` defaults to
    True off the GPU (the Pallas interpreter; tests run it on the CPU).
    """
    return _sweep(accel, o, d, t_min, t_max, bit=bit, any_hit=False,
                  ray_block=ray_block, interpret=_interpret_default(interpret))


def sweep_any(accel: AccelScene, o, d, t_min, t_max, *, bit: int,
              ray_block: int = RAY_BLOCK, interpret: bool | None = None):
    """bool[N]: some masked triangle is hit with t in (t_min, t_max]."""
    (occ,) = _sweep(accel, o, d, t_min, t_max, bit=bit, any_hit=True,
                    ray_block=ray_block, interpret=_interpret_default(interpret))
    return occ != 0
