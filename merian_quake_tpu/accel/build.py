"""Host-side acceleration build: triangle classes + clusters.

Replaces the reference's BLAS/TLAS build (DeviceASBuilder,
quake_node.cpp:985-1012). Instead of a pointer tree we produce:

- per-triangle acceptance class for the any-hit loop (see
  ``raytrace.glsl:95-119``): padding/never-accept triangles are removed
  from candidacy entirely; triangles whose texture has transparent
  texels are flagged ``needs_alpha`` so only those trigger re-tracing.
  The classes are bits of one mask word per triangle (``MASK_*``), so
  nearest-hit, shadow and alpha-only traces differ only in which bit
  they test;
- a median-split triangle order with per-cluster AABBs, and the
  cluster-major SoA triangle layout the GPU sweep reads
  (accel/sweep.py).

Rebuild cost is O(T log T) numpy per worldspawn; the live path keeps
the static order and rewrites only a dynamic cluster suffix per frame.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import materials
from ..models.types import CLUSTER_SIZE, Scene, TextureAtlas

# triangle mask bits (AccelScene.tri_mask / cluster_mask)
MASK_CANDIDATE = 1  # nearest-hit candidate (raytrace.glsl:95-119 class)
MASK_OCCLUDER = 2  # shadow-ray occluder: candidate, not sky, not alpha
MASK_ALPHA = 4  # candidate whose texture alpha decides the hit

_BIG = np.float32(1e30)  # empty-cluster AABB sentinel (lo = +BIG, hi = -BIG)


class AccelScene(NamedTuple):
    """Scene + intersection metadata (leading dim T or C = T / 64, in
    cluster order)."""

    scene: Scene
    tri_mask: jnp.ndarray  # i32[T] MASK_* bits
    cluster_mask: jnp.ndarray  # i32[C] OR of the cluster's tri_mask
    cluster_lo: jnp.ndarray  # f32[C, 3] AABB min over candidates
    cluster_hi: jnp.ndarray  # f32[C, 3] AABB max over candidates
    tri_soa: jnp.ndarray  # f32[C, 9, CLUSTER_SIZE] rows v0, e1, e2 (xyz)
    tri_attr: jnp.ndarray  # f32[T, 40] packed shading attributes (one
    # gather per hit instead of ~12 — see trace.ATTR_* layout)

    @property
    def num_clusters(self) -> int:
        return self.cluster_lo.shape[0]

    @property
    def candidate(self) -> jnp.ndarray:
        """bool[T] participates in nearest-hit intersection."""
        return (self.tri_mask & MASK_CANDIDATE) != 0

    @property
    def needs_alpha(self) -> jnp.ndarray:
        """bool[T] a committed hit requires the texture alpha test."""
        return (self.tri_mask & MASK_ALPHA) != 0


def texture_alpha_flags(atlas: TextureAtlas) -> np.ndarray:
    """bool[MAX_TEX]: texture contains texels below ALPHA_THRESHOLD."""
    data = np.asarray(atlas.data, np.float32)
    table = np.asarray(atlas.table)
    out = np.zeros((table.shape[0],), bool)
    for i, (x, y, w, h) in enumerate(table):
        if w == 0:
            continue
        region = data[y : y + h, x : x + w, 3]
        out[i] = bool((region < materials.ALPHA_THRESHOLD).any())
    return out


def _morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave 10 bits per axis → 30-bit Morton code."""

    def _spread(v):
        v = v.astype(np.uint64) & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return _spread(x) | (_spread(y) << 1) | (_spread(z) << 2)


def _reorder_scene(scene: Scene, perm: np.ndarray) -> Scene:
    return Scene(*[jnp.asarray(np.asarray(a)[perm]) for a in scene])


def _median_split_perm(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    candidate: np.ndarray,
    valid: np.ndarray,
    chunk: int = CLUSTER_SIZE,
) -> np.ndarray:
    """Cluster-aligned recursive median-split triangle order.

    Top-down BVH-leaf construction (longest-axis median split, snapped
    to CLUSTER_SIZE multiples so leaves coincide with the sweep's
    clusters). Compared to Morton chunking this yields clusters with no
    spatial straddle between space-filling-curve jumps — tighter AABBs,
    fewer cluster visits per ray block. Same ranking contract as the
    Morton path: candidates first, then alpha-only valid triangles, then
    padding.
    """
    cent = ((v0 + v1 + v2) / 3.0).astype(np.float32)
    rank = np.where(candidate, 0, np.where(valid, 1, 2))
    cand_idx = np.nonzero(rank == 0)[0]
    out: list[np.ndarray] = []

    def split(idx: np.ndarray) -> None:
        if idx.shape[0] <= chunk:
            out.append(idx)
            return
        c = cent[idx]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        srt = idx[np.argsort(c[:, ax], kind="stable")]
        n = idx.shape[0]
        # split at the CLUSTER_SIZE multiple nearest the median, keeping
        # both halves non-empty (the global tail may be a short leaf)
        k = int(round((n // 2) / chunk)) * chunk
        k = max(chunk, min(((n - 1) // chunk) * chunk, k))
        split(srt[:k])
        split(srt[k:])

    split(cand_idx)
    return np.concatenate(
        out + [np.nonzero(rank == 1)[0], np.nonzero(rank == 2)[0]]
    )


def _cluster_aabbs(v0, v1, v2, mask) -> tuple[np.ndarray, np.ndarray]:
    """Per-cluster AABB over the masked triangles (empty → +BIG/-BIG)."""
    from ..utils import native

    aabbs = native.cluster_aabbs(v0, v1, v2, mask, CLUSTER_SIZE)
    if aabbs is not None:
        return aabbs
    c = v0.shape[0] // CLUSTER_SIZE
    pts = np.stack([v0, v1, v2], axis=1).reshape(c, CLUSTER_SIZE * 3, 3)
    cm = np.repeat(mask.reshape(c, CLUSTER_SIZE), 3, axis=1)
    lo = np.where(cm[..., None], pts, _BIG).min(axis=1)
    hi = np.where(cm[..., None], pts, -_BIG).max(axis=1)
    return lo.astype(np.float32), hi.astype(np.float32)


def _sweep_tables(v0, v1, v2, candidate, needs_alpha, flags):
    """(tri_mask i32[T], cluster_mask i32[C], tri_soa f32[C, 9, 64])."""
    sky = flags == materials.MAT_FLAGS_SKY
    mask = (
        np.where(candidate, MASK_CANDIDATE, 0)
        | np.where(candidate & ~sky & ~needs_alpha, MASK_OCCLUDER, 0)
        | np.where(candidate & needs_alpha, MASK_ALPHA, 0)
    ).astype(np.int32)
    c = v0.shape[0] // CLUSTER_SIZE
    cmask = np.bitwise_or.reduce(mask.reshape(c, CLUSTER_SIZE), axis=1)
    # e1/e2 in f32 exactly as the oracle forms them (v1 - v0, v2 - v0)
    rows = np.concatenate([v0, v1 - v0, v2 - v0], axis=1)  # (T, 9)
    soa = rows.reshape(c, CLUSTER_SIZE, 9).transpose(0, 2, 1)
    return mask, cmask.astype(np.int32), np.ascontiguousarray(soa, np.float32)


def _tri_attr(sc, tex_px: np.ndarray) -> np.ndarray:
    """f32[T, 40] shading attributes (trace._A_* column layout)."""
    t = np.asarray(sc.v0).shape[0]
    attr = np.zeros((t, 40), np.float32)
    attr[:, 0:3] = np.asarray(sc.v0)
    attr[:, 3:6] = np.asarray(sc.v1)
    attr[:, 6:9] = np.asarray(sc.v2)
    attr[:, 9:12] = np.asarray(sc.pv0)
    attr[:, 12:15] = np.asarray(sc.pv1)
    attr[:, 15:18] = np.asarray(sc.pv2)
    attr[:, 18:24] = np.asarray(sc.st).reshape(t, 6)
    attr[:, 24] = np.asarray(sc.texnum)
    attr[:, 25] = np.asarray(sc.fb_texnum)
    attr[:, 26] = np.asarray(sc.gloss_texnum)
    attr[:, 27] = np.asarray(sc.flags)
    attr[:, 28:31] = np.asarray(sc.solid_albedo)
    attr[:, 31:34] = np.asarray(sc.solid_emission)
    attr[:, 34] = np.asarray(sc.normal_texnum)
    # texel density (texels per world unit) for ray-cone mip selection
    st = np.asarray(sc.st)
    sd0 = st[:, 1] - st[:, 0]
    sd1 = st[:, 2] - st[:, 0]
    uv_area = 0.5 * np.abs(sd0[:, 0] * sd1[:, 1] - sd0[:, 1] * sd1[:, 0])
    e1 = np.asarray(sc.v1) - np.asarray(sc.v0)
    e2 = np.asarray(sc.v2) - np.asarray(sc.v0)
    w_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    attr[:, 35] = np.sqrt(
        uv_area * tex_px / np.maximum(w_area, 1e-9)
    ).astype(np.float32)
    return attr


def _tex_px(atlas: TextureAtlas | None, texnum: np.ndarray) -> np.ndarray:
    if atlas is None:
        return np.full(texnum.shape, 64.0 * 64.0)
    table = np.asarray(atlas.table)
    px = np.maximum(table[:, 2] * table[:, 3], 1).astype(np.float64)
    return px[np.clip(texnum, 0, len(px) - 1)]


def build_accel(scene: Scene, atlas: TextureAtlas | None = None) -> AccelScene:
    v0 = np.asarray(scene.v0)
    v1 = np.asarray(scene.v1)
    v2 = np.asarray(scene.v2)
    valid = np.asarray(scene.valid)
    flags = np.asarray(scene.flags)
    alpha = np.asarray(scene.alpha)
    texnum = np.asarray(scene.texnum)

    # --- acceptance classes (raytrace.glsl:95-119 semantics) ---
    # flags 1..6 (lava..waterfall incl. sky): always accepted.
    flag_opaque = (flags > 0) & (flags < 7)
    has_override = alpha >= 0.0
    override_accept = has_override & (alpha >= materials.ALPHA_THRESHOLD)
    override_reject = has_override & (alpha < materials.ALPHA_THRESHOLD)
    if atlas is not None:
        tex_has_alpha = texture_alpha_flags(atlas)[np.clip(texnum, 0, None)]
    else:
        tex_has_alpha = np.zeros_like(valid)
    needs_alpha = valid & ~flag_opaque & ~has_override & tex_has_alpha
    candidate = valid & ~override_reject & (
        flag_opaque | override_accept | ~has_override
    )

    # --- triangle order: cluster-aligned median split (default) or
    # Morton chunks (MQ_CLUSTER=morton; native fast path) ---
    from ..utils import native

    if os.environ.get("MQ_CLUSTER", "median") == "median":
        perm = _median_split_perm(v0, v1, v2, candidate, valid)
    else:
        perm = native.morton_perm(v0, v1, v2, candidate, valid)
    if perm is None:
        cent = (v0 + v1 + v2) / 3.0
        lo = cent.min(axis=0)
        hi = cent.max(axis=0)
        ext = np.maximum(hi - lo, 1e-6)
        q = np.clip(((cent - lo) / ext * 1023.0), 0, 1023).astype(np.uint64)
        codes = _morton3(q[:, 0], q[:, 1], q[:, 2])
        # candidates first (by Morton), then alpha-only, then padding
        rank = np.where(candidate, 0, np.where(valid, 1, 2)).astype(np.uint64)
        perm = np.lexsort((codes, rank))
    scene = _reorder_scene(scene, perm)
    candidate = candidate[perm]
    needs_alpha = needs_alpha[perm]

    v0 = np.asarray(scene.v0)
    v1 = np.asarray(scene.v1)
    v2 = np.asarray(scene.v2)
    lo_c, hi_c = _cluster_aabbs(v0, v1, v2, candidate)
    mask, cmask, soa = _sweep_tables(
        v0, v1, v2, candidate, needs_alpha, np.asarray(scene.flags)
    )
    attr = _tri_attr(scene, _tex_px(atlas, np.asarray(scene.texnum)))
    return AccelScene(
        scene=scene,
        tri_mask=jnp.asarray(mask),
        cluster_mask=jnp.asarray(cmask),
        cluster_lo=jnp.asarray(lo_c.astype(np.float32)),
        cluster_hi=jnp.asarray(hi_c.astype(np.float32)),
        tri_soa=jnp.asarray(soa),
        tri_attr=jnp.asarray(attr),
    )


class LiveAccel(NamedTuple):
    """Incrementally-updatable AccelScene for the live game path.

    The reference rebuilds dynamic entity geometry every frame and
    REFITS its BLAS/TLAS (quake_node.cpp:896-1012, DeviceASBuilder
    update_geometry_f32_u32). This struct freezes the static accel once
    and appends a fixed-capacity DYNAMIC cluster suffix: per frame only
    the suffix's SoA rows, masks, cluster AABBs and shading attrs are
    recomputed (numpy over ≤ a few thousand triangles) and written into
    the device tables by one donated jit (refresh_dynamic) — per-frame
    cost is O(dynamic), not O(map).
    """

    accel: AccelScene  # full tables: static prefix + dynamic suffix
    n_static: int  # static triangle rows (cluster-aligned)
    dyn_cap: int  # dynamic capacity (cluster-aligned)
    tex_alpha: np.ndarray  # bool[MAX_TEX] texture-has-alpha
    atlas: TextureAtlas  # texel counts for the mip density column


def build_accel_live(
    bundle, dyn_cap: int = 4096
) -> LiveAccel:
    """One-time static build + dynamic-suffix allocation.

    ``bundle``: SceneBundle of the STATIC map. ``dyn_cap`` must be the
    GameState dynamic_capacity, rounded here to a cluster multiple.
    """
    scene, atlas = bundle.scene, bundle.atlas
    dyn_cap = -(-dyn_cap // CLUSTER_SIZE) * CLUSTER_SIZE
    acc = build_accel(scene, atlas)
    t0 = acc.scene.num_tris
    ncd = dyn_cap // CLUSTER_SIZE

    def pad(a, n, fill=0):
        a = jnp.asarray(a)
        return jnp.concatenate(
            [a, jnp.full((n,) + a.shape[1:], fill, a.dtype)]
        )

    sc = acc.scene
    new_scene = sc._replace(
        **{f: pad(getattr(sc, f), dyn_cap) for f in sc._fields if f != "alpha"},
        alpha=pad(sc.alpha, dyn_cap, -1.0),
    )
    acc2 = AccelScene(
        scene=new_scene,
        tri_mask=pad(acc.tri_mask, dyn_cap),
        cluster_mask=pad(acc.cluster_mask, ncd),
        cluster_lo=pad(acc.cluster_lo, ncd, _BIG),
        cluster_hi=pad(acc.cluster_hi, ncd, -_BIG),
        tri_soa=pad(acc.tri_soa, ncd),
        tri_attr=pad(acc.tri_attr, dyn_cap),
    )
    return LiveAccel(
        accel=acc2,
        n_static=t0,
        dyn_cap=dyn_cap,
        tex_alpha=texture_alpha_flags(atlas),
        atlas=atlas,
    )


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _apply_dyn(t0: int, acc: AccelScene, u: dict) -> AccelScene:
    """Row-write the dynamic suffix (triangles from t0) of every table."""
    c0 = t0 // CLUSTER_SIZE

    def put(tab, rows, at):
        return jax.lax.dynamic_update_slice_in_dim(
            tab, rows.astype(tab.dtype), at, axis=0
        )

    sc = acc.scene
    scene_rows = dict(
        v0=u["v0"], v1=u["v1"], v2=u["v2"], pv0=u["pv0"], pv1=u["pv1"],
        pv2=u["pv2"], st=u["st"], texnum=u["texnum"], fb_texnum=u["fb"],
        flags=u["flags"], solid_albedo=u["salb"], solid_emission=u["semm"],
        valid=u["valid"],
    )
    new_scene = sc._replace(
        **{f: put(getattr(sc, f), r, t0) for f, r in scene_rows.items()}
    )
    return AccelScene(
        scene=new_scene,
        tri_mask=put(acc.tri_mask, u["mask"], t0),
        cluster_mask=put(acc.cluster_mask, u["cmask"], c0),
        cluster_lo=put(acc.cluster_lo, u["lo"], c0),
        cluster_hi=put(acc.cluster_hi, u["hi"], c0),
        tri_soa=put(acc.tri_soa, u["soa"], c0),
        tri_attr=put(acc.tri_attr, u["attr"], t0),
    )


def refresh_dynamic(la: LiveAccel, dyn: dict) -> LiveAccel:
    """Per-frame dynamic-suffix refresh (≈ BLAS refit + re-upload).

    ``dyn``: GameState.extract_dynamic()'s block. Host cost is numpy
    over ``dyn_cap`` triangles; device cost is one donated jit that
    row-writes the suffix of every table in place.
    """
    cap = la.dyn_cap
    pad = cap - dyn["v"].shape[0]
    pd = (
        (lambda a: np.concatenate(
            [a, np.zeros((pad,) + a.shape[1:], a.dtype)]
        ))
        if pad
        else (lambda a: a)
    )
    v0, v1, v2 = pd(dyn["v"][:, 0]), pd(dyn["v"][:, 1]), pd(dyn["v"][:, 2])
    pv0, pv1, pv2 = (
        pd(dyn["prev"][:, 0]), pd(dyn["prev"][:, 1]), pd(dyn["prev"][:, 2])
    )
    valid = pd(dyn["valid"])
    flags = pd(dyn["flags"])
    tex = pd(dyn["tex"])
    uv = pd(dyn["uv"])

    flag_opaque = (flags > 0) & (flags < 7)
    needs_alpha = (
        valid & ~flag_opaque & la.tex_alpha[np.clip(tex, 0, None)]
    )
    mask, cmask, soa = _sweep_tables(v0, v1, v2, valid, needs_alpha, flags)
    lo, hi = _cluster_aabbs(v0, v1, v2, valid)
    dsc = Scene(
        v0=v0, v1=v1, v2=v2, pv0=pv0, pv1=pv1, pv2=pv2, st=uv, texnum=tex,
        fb_texnum=pd(dyn["fb"]), normal_texnum=np.zeros_like(tex),
        gloss_texnum=np.zeros_like(tex), flags=flags,
        alpha=np.full(tex.shape, -1.0, np.float32),
        solid_albedo=pd(dyn["salb"]), solid_emission=pd(dyn["semm"]),
        valid=valid,
    )
    attr = _tri_attr(dsc, _tex_px(la.atlas, tex))
    upd = dict(
        v0=v0, v1=v1, v2=v2, pv0=pv0, pv1=pv1, pv2=pv2,
        st=uv, texnum=tex, fb=dsc.fb_texnum, flags=flags,
        salb=dsc.solid_albedo, semm=dsc.solid_emission, valid=valid,
        mask=mask, cmask=cmask, lo=lo, hi=hi, soa=soa, attr=attr,
    )
    return la._replace(accel=_apply_dyn(la.n_static, la.accel, upd))


def scene_features(scene: Scene, uniforms=None, atlas=None):
    """Derive static SceneFeatures from host scene data.

    Pass the atlas to resolve ``has_alpha_tris`` exactly (same formula
    as build_accel's needs_alpha); without it the flag stays at its
    conservative True default, keeping the alpha re-trace loop in the
    compiled kernels.
    """
    from ..models.types import SceneFeatures
    from ..models import materials as mats

    flags = np.asarray(scene.flags)
    valid = np.asarray(scene.valid)
    warp = (
        (flags >= mats.WARP_FLAG_MIN) & (flags <= mats.WARP_FLAG_MAX) & valid
    ).any()
    sky_mode = "none"
    if uniforms is not None:
        if int(np.asarray(uniforms.sky_classic)[0]) >= 0:
            sky_mode = "classic"
        elif int(np.asarray(uniforms.sky_cube).max()) >= 0:
            sky_mode = "cubemap"
    emis = (
        (flags == mats.MAT_FLAGS_SPRITE)
        | (flags == mats.MAT_FLAGS_TELE)
        | (flags == mats.MAT_FLAGS_WATERFALL)
    ) & valid
    has_alpha_tris = True
    if atlas is not None:
        alpha = np.asarray(scene.alpha)
        texnum = np.asarray(scene.texnum)
        flag_opaque = (flags > 0) & (flags < 7)
        has_override = alpha >= 0.0
        tex_has_alpha = texture_alpha_flags(atlas)[np.clip(texnum, 0, None)]
        has_alpha_tris = bool(
            (valid & ~flag_opaque & ~has_override & tex_has_alpha).any()
        )
    return SceneFeatures(
        sky_mode=sky_mode,
        has_alpha_tris=has_alpha_tris,
        has_fb=bool(((np.asarray(scene.fb_texnum) > 0) & valid).any()),
        has_gloss=bool(((np.asarray(scene.gloss_texnum) > 0) & valid).any()),
        has_warp=bool(warp),
        has_emissive_tex=bool(emis.any()),
        has_normalmap=bool(
            ((np.asarray(scene.normal_texnum) > 0) & valid).any()
        ),
    )
