"""Texture atlas: host-side packing + device-side sampling.

Replacement of the reference's 4096-slot descriptor array of
sampled images (``img_tex[MAX_GLTEXTURES]``, gbuffer.comp:34): one big
2D atlas plus a rect table, sampled with vectorized gathers. sRGB decode
and the reference's pow(1/1.2) albedo transform (raytrace.glsl:289) are
folded in at pack time so the device sees linear radiometric values.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops import color as color_ops
from .types import TextureAtlas
from . import materials


def pack_textures(
    textures: list[np.ndarray],
    srgb: list[bool] | None = None,
    max_textures: int = materials.MAX_GLTEXTURES,
    dtype=jnp.float32,
    mip_levels: int = 4,
) -> TextureAtlas:
    """Shelf-pack RGBA uint8 (or float) textures into one atlas.

    ``textures[i]`` becomes texture id i (id 0 should be a 1×1 white
    dummy — the reference treats texnum 0 as 'none' in several places).
    Returns a TextureAtlas with linear float data.
    """
    if len(textures) == 0:
        textures = [np.full((1, 1, 4), 255, np.uint8)]
    if len(textures) > max_textures:
        raise ValueError(f"{len(textures)} textures > {max_textures}")
    if srgb is None:
        srgb = [True] * len(textures)

    norm = []
    for t, is_srgb in zip(textures, srgb):
        t = np.asarray(t)
        if t.ndim == 2:
            t = t[..., None].repeat(4, axis=-1)
        if t.shape[-1] == 3:
            t = np.concatenate([t, np.full(t.shape[:-1] + (1,), 255, t.dtype)], -1)
        if t.dtype == np.uint8:
            t = t.astype(np.float32) / 255.0
        t = t.astype(np.float32)
        if is_srgb:
            rgb = np.asarray(color_ops.srgb_to_linear(jnp.asarray(t[..., :3])))
            # reference samples textures then applies pow(1/1.2)
            rgb = np.power(np.clip(rgb, 0.0, 1.0), 1.0 / 1.2)
            t = np.concatenate([rgb, t[..., 3:4]], -1)
        norm.append(t)

    # Shelf packing, tallest first (stable order preserved via index
    # sort). Rects are aligned to 2^mip_levels so downsampled levels
    # never bleed across texture boundaries.
    align = 1 << mip_levels
    order = sorted(range(len(norm)), key=lambda i: -norm[i].shape[0])
    atlas_w = 1
    total_area = sum(t.shape[0] * t.shape[1] for t in norm)
    while atlas_w * atlas_w < total_area * 1.3:
        atlas_w *= 2
    atlas_w = max(atlas_w, max(t.shape[1] for t in norm))
    # round atlas_w up to pow2
    w = 1
    while w < atlas_w:
        w *= 2
    atlas_w = w

    up = lambda v: -(-v // align) * align
    table = np.zeros((max_textures, 4), np.int32)
    placements = {}
    x = y = shelf_h = 0
    for i in order:
        t = norm[i]
        th, tw = t.shape[:2]
        if x + up(tw) > atlas_w:
            y += up(shelf_h)
            x = 0
            shelf_h = 0
        placements[i] = (x, y)
        table[i] = (x, y, tw, th)
        shelf_h = max(shelf_h, th)
        x += up(tw)
    atlas_h = y + up(shelf_h)
    atlas_h = max(-(-atlas_h // 8) * 8, align)

    data = np.zeros((atlas_h, atlas_w, 4), np.float32)
    for i, t in enumerate(norm):
        px, py = placements[i]
        data[py : py + t.shape[0], px : px + t.shape[1]] = t

    # mip chain by 2x2 box filter of the aligned atlas; texture regions
    # stay separated thanks to the 2^mip_levels rect alignment
    mips = []
    cur = data
    for _ in range(mip_levels):
        h2, w2 = cur.shape[0] // 2, cur.shape[1] // 2
        if h2 < 1 or w2 < 1:
            break
        cur = cur[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, 4).mean((1, 3))
        mips.append(jnp.asarray(cur, dtype))

    flat = np.concatenate(
        [np.asarray(data).reshape(-1, 4)]
        + [np.asarray(m).reshape(-1, 4) for m in mips]
    )
    return TextureAtlas(
        data=jnp.asarray(data, dtype),
        table=jnp.asarray(table),
        mips=tuple(mips),
        flat=jnp.asarray(flat, dtype),
    )


def _gather_texels(atlas: TextureAtlas, tx, ty):
    flat = atlas.data.reshape(-1, 4)
    idx = ty * atlas.width + tx
    return jnp.take(flat, idx, axis=0).astype(jnp.float32)


def sample_nearest(atlas: TextureAtlas, texnum, uv):
    """Point-sample with GL_REPEAT wrap. texnum i32[...], uv f32[..., 2]."""
    rect = jnp.take(atlas.table, jnp.clip(texnum, 0, atlas.table.shape[0] - 1), axis=0)
    x, y, w, h = rect[..., 0], rect[..., 1], rect[..., 2], rect[..., 3]
    w = jnp.maximum(w, 1)
    h = jnp.maximum(h, 1)
    u = uv[..., 0] - jnp.floor(uv[..., 0])
    v = uv[..., 1] - jnp.floor(uv[..., 1])
    tx = x + jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    ty = y + jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    return _gather_texels(atlas, tx, ty)


def sample_bilinear(atlas: TextureAtlas, texnum, uv):
    """Bilinear sample with GL_REPEAT wrap within the texture's rect."""
    rect = jnp.take(atlas.table, jnp.clip(texnum, 0, atlas.table.shape[0] - 1), axis=0)
    x, y, w, h = rect[..., 0], rect[..., 1], rect[..., 2], rect[..., 3]
    w = jnp.maximum(w, 1)
    h = jnp.maximum(h, 1)
    wf = w.astype(jnp.float32)
    hf = h.astype(jnp.float32)
    u = uv[..., 0] - jnp.floor(uv[..., 0])
    v = uv[..., 1] - jnp.floor(uv[..., 1])
    fx = u * wf - 0.5
    fy = v * hf - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]

    def _wrap(c, n):
        return jnp.mod(c.astype(jnp.int32), n)

    x0i = _wrap(x0, w)
    x1i = _wrap(x0 + 1, w)
    y0i = _wrap(y0, h)
    y1i = _wrap(y0 + 1, h)
    c00 = _gather_texels(atlas, x + x0i, y + y0i)
    c10 = _gather_texels(atlas, x + x1i, y + y0i)
    c01 = _gather_texels(atlas, x + x0i, y + y1i)
    c11 = _gather_texels(atlas, x + x1i, y + y1i)
    top = c00 * (1 - ax) + c10 * ax
    bot = c01 * (1 - ax) + c11 * ax
    return top * (1 - ay) + bot * ay


def sample_mip(atlas: TextureAtlas, texnum, uv, lod):
    """Nearest-mip sampling by per-ray level-of-detail (≈ textureGrad
    at the first hit, raytrace.glsl:232-245 — ray-cone flavored).

    ONE gather from the concatenated flat mip chain: per-level offsets
    and strides are STATIC (from the level shapes), selected per ray
    with a cheap where-chain — the old per-level sampling loop paid one
    multi-million-row gather per level.
    """
    levels = atlas.num_levels
    if levels == 1 or atlas.flat is None:
        return sample_nearest(atlas, texnum, uv)
    li = jnp.clip(jnp.round(lod).astype(jnp.int32), 0, levels - 1)
    rect = jnp.take(
        atlas.table, jnp.clip(texnum, 0, atlas.table.shape[0] - 1), axis=0
    )
    # per-lane level shift of the rect (vector shift amounts are fine)
    x = rect[..., 0] >> li
    y = rect[..., 1] >> li
    w = jnp.maximum(rect[..., 2] >> li, 1)
    h = jnp.maximum(rect[..., 3] >> li, 1)
    u = uv[..., 0] - jnp.floor(uv[..., 0])
    v = uv[..., 1] - jnp.floor(uv[..., 1])
    tx = x + jnp.clip((u * w.astype(jnp.float32)).astype(jnp.int32), 0, w - 1)
    ty = y + jnp.clip((v * h.astype(jnp.float32)).astype(jnp.int32), 0, h - 1)

    shapes = [atlas.data.shape] + [m.shape for m in atlas.mips]
    off = 0
    off_l = jnp.zeros_like(li)
    stride_l = jnp.full_like(li, shapes[0][1])
    for l, s in enumerate(shapes):
        if l > 0:
            off_l = jnp.where(li == l, off, off_l)
            stride_l = jnp.where(li == l, s[1], stride_l)
        off += s[0] * s[1]
    idx = off_l + ty * stride_l + tx
    return jnp.take(atlas.flat, idx, axis=0).astype(jnp.float32)


def sample(atlas: TextureAtlas, texnum, uv, bilinear: bool = True):
    if bilinear:
        return sample_bilinear(atlas, texnum, uv)
    return sample_nearest(atlas, texnum, uv)
