"""Ray–scene intersection with the alpha-test any-hit loop.

Semantics mirror the reference trace core (raytrace.glsl:82-119):

- backface culling with the reference's normal convention
  n = cross(v2-v0, v1-v0) → front-facing iff det < 0,
- nearest candidate hit,
- committed hits on ``needs_alpha`` triangles sample the albedo
  texture's alpha channel; texel alpha < ALPHA_THRESHOLD rejects the
  hit and re-traces from just past it, at most MAX_INTERSECTIONS times.

Two traversals compute it. On the GPU, the cluster sweep
(``accel/sweep.py``, a Pallas kernel on the Triton route) skips every
cluster no ray of a block can reach. Everywhere else, and as the
reference the sweep is tested against, ``intersect_oracle`` tests every
ray against every triangle (pure JAX, O(N_rays × T)).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models import atlas as atlas_mod
from ..models import materials
from . import sweep
from .build import MASK_ALPHA, MASK_CANDIDATE, MASK_OCCLUDER, AccelScene

_BIG = jnp.float32(sweep.BIG)
_DET_EPS = sweep.DET_EPS
_ADVANCE = 1e-3  # re-trace offset past a rejected surface (quake units)


class HitRecord(NamedTuple):
    t: jnp.ndarray  # f32[N] hit distance (T_MAX-ish if miss)
    tri: jnp.ndarray  # i32[N] triangle index, -1 = miss
    u: jnp.ndarray  # f32[N] barycentric weight of v1
    v: jnp.ndarray  # f32[N] barycentric weight of v2

    @property
    def hit(self) -> jnp.ndarray:
        return self.tri >= 0


def use_sweep() -> bool:
    """True where the cluster sweep kernel runs (the GPU); the oracle
    runs everywhere else."""
    return jax.default_backend() == "gpu"


def _sort_order(o: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Ray order for the sweep: direction octant + dominant-axis pair in
    the high bits (rays of one block share signs and a main axis), then
    the origin's Morton code (locality)."""
    lo = jnp.min(o, axis=0)
    ext = jnp.maximum(jnp.max(o, axis=0) - lo, 1e-3)
    q = jnp.clip((o - lo) / ext * 255.0, 0.0, 255.0).astype(jnp.uint32)

    def spread(v):
        v = (v | (v << 16)) & jnp.uint32(0x030000FF)
        v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
        v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
        v = (v | (v << 2)) & jnp.uint32(0x09249249)
        return v

    morton = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    pos = (d >= 0).astype(jnp.uint32)
    octant = pos[:, 0] | (pos[:, 1] << 1) | (pos[:, 2] << 2)
    ad = jnp.abs(d)
    axis = (ad[:, 0] > ad[:, 2]).astype(jnp.uint32) | (
        (ad[:, 1] > ad[:, 2]).astype(jnp.uint32) << 1
    )
    key = (octant << 26) | (axis << 24) | (morton & jnp.uint32(0xFFFFFF))
    return jnp.argsort(key)


def intersect(
    accel: AccelScene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    t_min,
    t_max,
    chunk: int = 128,
    mask: int = MASK_CANDIDATE,
) -> HitRecord:
    """Nearest front-facing hit on triangles carrying a ``mask`` bit.

    o, d: f32[N, 3]. The cluster sweep on the GPU, ``intersect_oracle``
    elsewhere (``chunk`` is the oracle's triangle slice).
    """
    if use_sweep():
        return HitRecord(*sweep.sweep_nearest(accel, o, d, t_min, t_max,
                                              bit=mask))
    return intersect_oracle(accel, o, d, t_min, t_max, chunk=chunk,
                            mask=mask)


def intersect_oracle(
    accel: AccelScene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    t_min,
    t_max,
    chunk: int = 128,
    ray_block: int = 1 << 16,
    mask: int = MASK_CANDIDATE,
) -> HitRecord:
    """Dense reference: every ray against every triangle.

    A ``lax.scan`` over ``chunk``-triangle slices keeps a running
    min-reduction. Large ray batches are processed in sequential blocks
    of ``ray_block`` rays (lax.map) to bound the (rays × chunk)
    intermediate working set.
    """
    n_rays = o.shape[0]
    if n_rays > ray_block:
        t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n_rays,))
        t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n_rays,))
        pad = (-n_rays) % ray_block
        if pad:
            o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
            d = jnp.concatenate([d, jnp.ones((pad, 3), d.dtype)])
            t_min = jnp.concatenate([t_min, jnp.zeros((pad,))])
            t_max = jnp.concatenate([t_max, jnp.full((pad,), -1.0)])
        nb = o.shape[0] // ray_block
        blocks = lambda x, s: x.reshape((nb, ray_block) + s)
        out = jax.lax.map(
            lambda xs: intersect_oracle(
                accel, xs[0], xs[1], xs[2], xs[3], chunk=chunk,
                ray_block=ray_block, mask=mask,
            ),
            (blocks(o, (3,)), blocks(d, (3,)), blocks(t_min, ()), blocks(t_max, ())),
        )
        flat = HitRecord(*[x.reshape(-1)[:n_rays] for x in out])
        return flat
    scene = accel.scene
    T = scene.num_tris
    # T is always a CLUSTER_SIZE multiple but need not be divisible by
    # the requested chunk (e.g. 576 tris, chunk 128): fall back to the
    # gcd so every CLUSTER_SIZE-padded scene chunks exactly.
    chunk = math.gcd(min(chunk, T), T)
    n_chunks = T // chunk
    assert n_chunks * chunk == T, (T, chunk)

    v0 = scene.v0.reshape(n_chunks, chunk, 3)
    v1 = scene.v1.reshape(n_chunks, chunk, 3)
    v2 = scene.v2.reshape(n_chunks, chunk, 3)
    cand = ((accel.tri_mask & mask) != 0).reshape(n_chunks, chunk)
    base = (jnp.arange(n_chunks, dtype=jnp.int32) * chunk)

    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), o.shape[:-1])
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), o.shape[:-1])

    def body(carry, xs):
        best_t, best_tri, best_u, best_v = carry
        cv0, cv1, cv2, cc, cbase = xs
        e1 = cv1 - cv0  # (C, 3)
        e2 = cv2 - cv0
        # (N, C, 3) broadcasts
        pvec = jnp.cross(d[:, None, :], e2[None, :, :])
        det = jnp.sum(e1[None] * pvec, axis=-1)  # (N, C)
        front = det < -_DET_EPS
        inv_det = 1.0 / jnp.where(front, det, -1.0)
        tvec = o[:, None, :] - cv0[None]
        u = jnp.sum(tvec * pvec, axis=-1) * inv_det
        qvec = jnp.cross(tvec, e1[None, :, :])
        v = jnp.sum(d[:, None, :] * qvec, axis=-1) * inv_det
        t = jnp.sum(e2[None] * qvec, axis=-1) * inv_det
        ok = (
            front
            & cc[None]
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > t_min[:, None])
            & (t <= t_max[:, None])
        )
        t_m = jnp.where(ok, t, _BIG)
        j = jnp.argmin(t_m, axis=-1)  # (N,)
        n_idx = jnp.arange(o.shape[0])
        tj = t_m[n_idx, j]
        better = tj < best_t
        best_tri = jnp.where(better, cbase + j.astype(jnp.int32), best_tri)
        best_u = jnp.where(better, u[n_idx, j], best_u)
        best_v = jnp.where(better, v[n_idx, j], best_v)
        best_t = jnp.where(better, tj, best_t)
        return (best_t, best_tri, best_u, best_v), None

    n = o.shape[0]
    init = (
        jnp.full((n,), _BIG),
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,)),
        jnp.zeros((n,)),
    )
    (bt, btri, bu, bv), _ = jax.lax.scan(body, init, (v0, v1, v2, cand, base))
    return HitRecord(t=bt, tri=btri, u=bu, v=bv)


def _hit_uv(accel: AccelScene, hr: HitRecord) -> jnp.ndarray:
    """Interpolated texture UV at the hit (st * barycentrics)."""
    tri = jnp.maximum(hr.tri, 0)
    st = jnp.take(accel.scene.st, tri, axis=0)  # (N, 3, 2)
    w0 = (1.0 - hr.u - hr.v)[..., None]
    return st[:, 0] * w0 + st[:, 1] * hr.u[..., None] + st[:, 2] * hr.v[..., None]


def trace_nearest(
    accel: AccelScene,
    tex,
    o: jnp.ndarray,
    d: jnp.ndarray,
    t_min,
    t_max,
    max_intersections: int = materials.MAX_INTERSECTIONS,
    chunk: int = 128,
    sort_rays: bool = False,
    mask: int = MASK_CANDIDATE,
) -> HitRecord:
    """Nearest *accepted* hit: runs the alpha-test re-trace loop.

    ``tex``: TextureAtlas (None skips alpha testing entirely — a single
    intersect sweep with no re-trace loop; callers pass None when the
    static SceneFeatures.has_alpha_tris flag says no triangle can ever
    alpha-reject, compiling out ~40% of the trace cost).

    ``sort_rays`` (incoherent bounce rays): on the sweep path the rays
    are traced in octant/Morton order, so that a block's rays share
    clusters, and the results are put back in the caller's order.
    """
    n = o.shape[0]
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    if sort_rays and use_sweep():
        order = _sort_order(o, d)
        hr = trace_nearest(
            accel, tex, o[order], d[order], t_min[order], t_max[order],
            max_intersections, chunk, mask=mask,
        )
        return HitRecord(*[jnp.zeros_like(x).at[order].set(x) for x in hr])
    if tex is None:
        return intersect(accel, o, d, t_min, t_max, chunk=chunk, mask=mask)

    def cond(state):
        i, active, _, _ = state
        return jnp.logical_and(i < max_intersections, jnp.any(active))

    def body(state):
        i, active, cur_tmin, result = state
        hr = intersect(accel, o, d, cur_tmin, t_max, chunk=chunk, mask=mask)
        tri = jnp.maximum(hr.tri, 0)
        needs = jnp.take(accel.needs_alpha, tri) & hr.hit
        uv = _hit_uv(accel, hr)
        texnum = jnp.take(accel.scene.texnum, tri)
        a = atlas_mod.sample_nearest(tex, texnum, uv)[..., 3]
        reject = needs & (a < materials.ALPHA_THRESHOLD)
        accept = active & ~reject
        result = HitRecord(
            t=jnp.where(accept, hr.t, result.t),
            tri=jnp.where(accept, hr.tri, result.tri),
            u=jnp.where(accept, hr.u, result.u),
            v=jnp.where(accept, hr.v, result.v),
        )
        cur_tmin = jnp.where(reject & active, hr.t + _ADVANCE, cur_tmin)
        return i + 1, active & reject, cur_tmin, result

    init_result = HitRecord(
        t=jnp.full((n,), _BIG),
        tri=jnp.full((n,), -1, jnp.int32),
        u=jnp.zeros((n,)),
        v=jnp.zeros((n,)),
    )
    state = (0, jnp.ones((n,), bool), t_min, init_result)
    _, _, _, result = jax.lax.while_loop(cond, body, state)
    return result


def trace_visibility(
    accel: AccelScene,
    tex,
    from_pos: jnp.ndarray,
    to_pos: jnp.ndarray,
    offset: float = 1e-3,
    chunk: int = 128,
) -> jnp.ndarray:
    """Visibility between points; sky hits count as visible
    (raytrace.glsl:122-145).

    Sweep path: an any-hit sweep over the occluder triangles (not sky,
    not alpha-tested), whose blocks stop once every ray is occluded;
    then the alpha-tested triangles alone are resolved exactly by the
    nearest + alpha-loop trace. Without ``tex`` the alpha-tested
    triangles occlude like opaque ones, as on the oracle path. One
    divergence from the oracle: a surface BEHIND a sky polygon still
    occludes (the oracle commits the nearer sky hit and calls the ray
    visible) — real maps keep sky as the outermost shell, so no such
    surface exists.
    """
    wo = to_pos - from_pos
    dist = jnp.linalg.norm(wo, axis=-1)
    d = wo / jnp.maximum(dist, 1e-20)[..., None]
    t_max = jnp.maximum(offset, dist - 2.0 * offset)
    if use_sweep():
        if tex is None:
            return ~sweep.sweep_any(accel, from_pos, d, offset, t_max,
                                    bit=MASK_OCCLUDER | MASK_ALPHA)
        occ = sweep.sweep_any(accel, from_pos, d, offset, t_max,
                              bit=MASK_OCCLUDER)
        hr = trace_nearest(accel, tex, from_pos, d, offset, t_max,
                           chunk=chunk, mask=MASK_ALPHA)
        return ~occ & ~hr.hit
    hr = trace_nearest(accel, tex, from_pos, d, offset, t_max, chunk=chunk)
    flags = jnp.take(accel.scene.flags, jnp.maximum(hr.tri, 0))
    sky = flags == materials.MAT_FLAGS_SKY
    return jnp.logical_or(~hr.hit, sky)
