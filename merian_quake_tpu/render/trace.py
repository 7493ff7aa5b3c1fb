"""Full trace + hit shading: the heart of every integrator.

Branchless JAX equivalent of /root/reference/res/shader/raytrace.glsl's
``trace_ray(throughput, contribution, hit)`` (lines 154-313): nearest
accepted hit via the accel layer, homogeneous-fog transmittance on the
throughput, procedural sky (sun glow + classic scrolling 2-layer sky or
cubemap) on miss/sky-flag hits, quake UV warp for lava/slime/tele/water,
material decode (solid color, waterfall, sprite/tele, fullbright
emission with the ldr_to_hdr boost), motion vectors from prev-frame
vertices. Every branch is a masked select over the full ray batch.

Cost notes: per-hit attributes come from ONE packed gather of
accel.tri_attr (f32[T, 40]) instead of ~12 per-field gathers, and the
scene's static SceneFeatures flags compile out unused paths (sky
layers, fullbright/gloss texture fetches, UV warp) — under XLA a
"branch" is evaluated for every lane, so a scene without sky textures
must not pay for sky sampling.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..accel.build import AccelScene
from ..accel.intersect import HitRecord, trace_nearest
from ..models import atlas as atlas_mod
from ..models import materials
from ..models.types import SceneFeatures, TextureAtlas, Uniforms
from ..ops import color as color_ops
from ..ops import linalg, transmittance as trans_ops, vmf
from .hit import Hit

T_MAX = materials.T_MAX

# tri_attr column layout (accel/build.py)
_A_V0, _A_V1, _A_V2 = slice(0, 3), slice(3, 6), slice(6, 9)
_A_PV0, _A_PV1, _A_PV2 = slice(9, 12), slice(12, 15), slice(15, 18)
_A_ST = slice(18, 24)
_A_TEX, _A_FB, _A_GLOSS, _A_FLAGS = 24, 25, 26, 27
_A_SOLID_ALB, _A_SOLID_EMM = slice(28, 31), slice(31, 34)
_A_NORMAL = 34
_A_TEXEL_DENSITY = 35


_SKY_BAKE_N = 256


def _classic_sky(atlas: TextureAtlas, uniforms: Uniforms, w: jnp.ndarray):
    """Classic scrolling two-layer Quake sky (raytrace.glsl:36-43).

    Cost note: the color is a function of q = w.xy/|w.z| alone and
    is PERIODIC in q with period 1 (both layers scroll rigidly), so it
    is baked onto a 256² grid over one period — 65k lanes of the full
    two-layer bilinear math, CSE'd to once per frame across every
    trace_ray call — and each ray pays ONE row gather instead of the
    ~10 (2 × bilinear + rect) the direct evaluation costs on every
    lane of every segment.
    256² samples one sky-period at 4× the 64² source resolution, so
    the nearest-neighbor lookup stays at bilinear quality; the sky
    compresses toward the horizon (|w.z| → 0) where the quantization
    is far below noise level."""
    t = uniforms.cl_time * 0.12
    nb = _SKY_BAKE_N
    qx = (jnp.arange(nb, dtype=jnp.float32) + 0.5) / nb
    qg = jnp.stack(jnp.meshgrid(qx, qx, indexing="ij"), axis=-1).reshape(
        -1, 2
    )  # (nb², 2) one period of q, [x, y]
    st = 0.5 + qg
    bck = atlas_mod.sample_bilinear(
        atlas, uniforms.sky_classic[0], st + 0.5 * t
    )
    fnt = atlas_mod.sample_bilinear(atlas, uniforms.sky_classic[1], st + t)
    tex = bck[..., :3] * (1.0 - fnt[..., 3:4]) + fnt[..., :3] * fnt[..., 3:4]
    baked = 10.0 * (jnp.exp2(3.5 * tex) - 1.0)  # (nb², 3)

    q = jnp.stack([w[..., 0], w[..., 1]], axis=-1) / jnp.maximum(
        jnp.abs(w[..., 2]), 1e-4
    )[..., None]
    qf = q - jnp.floor(q)
    xi = jnp.clip((qf[..., 0] * nb).astype(jnp.int32), 0, nb - 1)
    yi = jnp.clip((qf[..., 1] * nb).astype(jnp.int32), 0, nb - 1)
    return jnp.take(baked, xi * nb + yi, axis=0)


_CUBE_BAKE_N = 512


def _cubemap_sky_baked(atlas: TextureAtlas, uniforms: Uniforms, w):
    """Cubemap sky via a per-frame octahedral bake (one gather/ray).

    Same cost structure as the classic-sky bake: the direct six-face
    bilinear sample costs ~6 row gathers on every lane of every
    segment; here the skybox is resampled once per frame onto a 512²
    octahedral direction map (262k lanes, CSE'd across trace calls)
    and each ray pays one gather. 512² octa ≈ 210² per face — above
    the typical Quake skybox face resolution; deviation is a
    resampling blur, documented vs raytrace.glsl:45-59."""
    from ..ops import octahedral

    nb = _CUBE_BAKE_N
    gx = (jnp.arange(nb, dtype=jnp.float32) + 0.5) / nb * 2.0 - 1.0
    uv = jnp.stack(jnp.meshgrid(gx, gx, indexing="ij"), axis=-1).reshape(
        -1, 2
    )
    dirs = octahedral.from_oct(uv)  # (nb², 3) unit directions
    baked = _cubemap_sky(atlas, uniforms, dirs)  # (nb², 3)

    e = octahedral.to_oct(w)  # [-1, 1]²
    xi = jnp.clip(((e[..., 0] * 0.5 + 0.5) * nb).astype(jnp.int32), 0, nb - 1)
    yi = jnp.clip(((e[..., 1] * 0.5 + 0.5) * nb).astype(jnp.int32), 0, nb - 1)
    return jnp.take(baked, xi * nb + yi, axis=0)


def _cubemap_sky(atlas: TextureAtlas, uniforms: Uniforms, w: jnp.ndarray):
    """Six-face skybox sample (raytrace.glsl:45-59)."""
    ax, ay, az = jnp.abs(w[..., 0]), jnp.abs(w[..., 1]), jnp.abs(w[..., 2])
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    side_x = jnp.where(x >= 0, 0, 1)
    side_y = jnp.where(y >= 0, 2, 3)
    side_z = jnp.where(z >= 0, 4, 5)
    side = jnp.where(
        (ax >= ay) & (ax >= az),
        side_x,
        jnp.where(ay >= az, side_y, side_z),
    )
    safe = lambda a: jnp.maximum(a, 1e-4)
    # select chains, not take_along_axis: 6 wheres fuse into the
    # elementwise graph, an M-row gather does not
    su = jnp.where(
        side <= 1, jnp.where(side == 0, -y, y),
        jnp.where(side == 2, x, jnp.where(side == 3, -x, -y)),
    )
    sv = jnp.where(side == 4, x, jnp.where(side == 5, -x, -z))
    den = safe(jnp.where(side <= 1, ax, jnp.where(side <= 3, ay, az)))
    st = 0.5 + 0.5 * jnp.stack([su, sv], -1) / den[..., None]
    sc = uniforms.sky_cube
    texnum = jnp.where(
        side <= 1, jnp.where(side == 0, sc[0], sc[1]),
        jnp.where(
            side <= 3, jnp.where(side == 2, sc[2], sc[3]),
            jnp.where(side == 4, sc[4], sc[5]),
        ),
    )
    col = atlas_mod.sample_bilinear(atlas, jnp.maximum(texnum, 0), st)[..., :3]
    return jnp.where((texnum >= 0)[..., None], col, 0.0)


def get_sky(
    atlas: TextureAtlas,
    uniforms: Uniforms,
    w: jnp.ndarray,
    sky_mode: str = "cubemap",
):
    """Sky radiance for direction w (raytrace.glsl get_sky, :25-60).

    ``sky_mode`` is STATIC: 'classic' REPLACES the sun glow (`emm =`,
    raytrace.glsl:43), 'cubemap' ADDS to it (:57), 'none' = sun only.
    """
    if sky_mode == "classic":
        return _classic_sky(atlas, uniforms, w)
    sun_glow = 0.5 * jnp.power(
        0.5 * (1.0 + linalg.dot(uniforms.sun_w, w)), 4.0
    )
    sun_disc = 5.0 * vmf.pdf(w, uniforms.sun_w, 3000.0)
    sun_color = jnp.minimum(uniforms.sun_color, materials.MAX_SUN_COLOR)
    emm = (sun_glow + sun_disc)[..., None] * sun_color
    if sky_mode == "cubemap":
        return emm + _cubemap_sky_baked(atlas, uniforms, w)
    return emm


def _warp_uv(uv: jnp.ndarray, cl_time, flags: jnp.ndarray) -> jnp.ndarray:
    """Quake turbulent texture warp for lava/slime/tele/water + waves."""
    warp = (flags >= materials.WARP_FLAG_MIN) & (flags <= materials.WARP_FLAG_MAX)
    t = cl_time
    swap = uv[..., ::-1]
    warped = uv + 0.125 * jnp.sin(2.0 * jnp.pi * swap + t)
    water = flags == materials.MAT_FLAGS_WATER
    waves = 0.05 * jnp.sin(4.0 * jnp.pi * swap + 1.7 * t)
    warped = warped + jnp.where(water[..., None], waves, 0.0)
    return jnp.where(warp[..., None], warped, uv)


class TraceResult(NamedTuple):
    throughput: jnp.ndarray  # f32[N, 3] medium transmittance along segment
    contribution: jnp.ndarray  # f32[N, 3] emission found (× throughput)
    hit: Hit
    hitrec: HitRecord
    flags: jnp.ndarray  # i32[N] material flags at the hit (NONE on miss)
    t: jnp.ndarray  # f32[N] ray parameter of the hit (T_MAX on sky/miss)


def trace_ray(
    accel: AccelScene,
    atlas: TextureAtlas,
    uniforms: Uniforms,
    pos: jnp.ndarray,
    wi: jnp.ndarray,
    bilinear: bool = False,
    chunk: int = 128,
    pixel_cone=None,
    sort_rays: bool = False,
    features: SceneFeatures = SceneFeatures(
        sky_mode="cubemap", has_fb=True, has_gloss=True, has_warp=True,
        has_emissive_tex=True, has_normalmap=True,
    ),
    active=None,
) -> TraceResult:
    """Trace from ``pos`` along ``wi`` and shade the hit.

    ``features`` (static) compiles out unused material paths; the
    all-on default is always correct, scene-derived flags are faster
    (accel.build.scene_features). ``pixel_cone`` (tan of the per-pixel
    angular radius) enables ray-cone mip selection on the albedo/
    emission fetches — the first-hit textureGrad path of the reference
    (raytrace.glsl:232-245), with cones instead of ray differentials.
    """
    alpha_tex = atlas if features.has_alpha_tris else None
    # ``active`` (bool[N] or None): dead (masked) rays trace with
    # t_max = -1 — they register no hits and take no part in their
    # sweep block's cluster tests. Callers
    # must already be masking dead rays' results (this only makes them
    # uniformly MISS instead of computing a discarded hit).
    t_max = T_MAX if active is None else jnp.where(active, T_MAX, -1.0)
    hr = trace_nearest(
        accel, alpha_tex, pos, wi, 0.0, t_max, chunk=chunk,
        sort_rays=sort_rays,
    )
    n = pos.shape[0]
    tri = jnp.maximum(hr.tri, 0)
    t_hit = jnp.where(hr.hit, hr.t, T_MAX)

    throughput = jnp.broadcast_to(
        trans_ops.transmittance(t_hit, uniforms.mu_t, uniforms.volume_max_t)[
            ..., None
        ],
        (n, 3),
    )

    # ---- ONE packed attribute gather ----
    attr = jnp.take(accel.tri_attr, tri, axis=0)  # (N, 40)
    flags = jnp.where(hr.hit, attr[:, _A_FLAGS].astype(jnp.int32), 0)
    is_sky = jnp.logical_or(~hr.hit, flags == materials.MAT_FLAGS_SKY)

    v0, v1, v2 = attr[:, _A_V0], attr[:, _A_V1], attr[:, _A_V2]
    w0 = (1.0 - hr.u - hr.v)[..., None]
    wu = hr.u[..., None]
    wv = hr.v[..., None]
    hit_pos = v0 * w0 + v1 * wu + v2 * wv
    prev_pos = (
        attr[:, _A_PV0] * w0 + attr[:, _A_PV1] * wu + attr[:, _A_PV2] * wv
    )
    geo_n = linalg.normalize(jnp.cross(v2 - v0, v1 - v0))

    st = attr[:, _A_ST].reshape(n, 3, 2)
    uv = st[:, 0] * w0 + st[:, 1] * wu + st[:, 2] * wv
    if features.has_warp:
        uv = _warp_uv(uv, uniforms.cl_time, flags)

    texnum = attr[:, _A_TEX].astype(jnp.int32)
    use_mips = pixel_cone is not None and atlas.num_levels > 1
    if use_mips:
        cos_i = jnp.abs(linalg.dot(geo_n, wi))
        footprint = (
            t_hit
            * pixel_cone
            * attr[:, _A_TEXEL_DENSITY]
            / jnp.maximum(cos_i, 0.1)
        )
        lod = jnp.log2(jnp.maximum(footprint, 1.0))
        albedo_tex = atlas_mod.sample_mip(atlas, texnum, uv, lod)[..., :3]
    else:
        albedo_tex = atlas_mod.sample(atlas, texnum, uv, bilinear=bilinear)[
            ..., :3
        ]

    # ---- tangent-space normal maps (brush models, raytrace.glsl:249-274) ----
    normal = geo_n
    if features.has_normalmap:
        nm_texnum = attr[:, _A_NORMAL].astype(jnp.int32)
        tn = (
            atlas_mod.sample(atlas, jnp.maximum(nm_texnum, 0), uv, bilinear=False)[
                ..., :3
            ]
            - 0.5
        ) * 2.0
        # tangent frame from the UV parameterization:
        # dudv0 = v2-v0, dudv1 = v1-v0; st_dudv = (st2-st0, st1-st0)
        dudv0 = v2 - v0
        dudv1 = v1 - v0
        sd0 = st[:, 2] - st[:, 0]
        sd1 = st[:, 1] - st[:, 0]
        st_det = sd0[:, 0] * sd1[:, 1] - sd1[:, 0] * sd0[:, 1]
        ok_det = jnp.abs(st_det) > 1e-8
        inv_det = 1.0 / jnp.where(ok_det, st_det, 1.0)
        du = linalg.normalize(
            (sd1[:, 1:2] * dudv0 - sd0[:, 1:2] * dudv1) * inv_det[:, None]
        )
        dv = -linalg.normalize(
            (-sd1[:, 0:1] * dudv0 + sd0[:, 0:1] * dudv1) * inv_det[:, None]
        )
        du = jnp.where(ok_det[:, None], du, dudv0)
        dv = jnp.where(ok_det[:, None], dv, dudv1)
        perturbed = linalg.normalize(
            du * tn[:, 0:1] + dv * tn[:, 1:2] + geo_n * tn[:, 2:3]
        )
        # Keller et al. [2017] reflection workaround
        r = linalg.reflect(wi, perturbed)
        below = linalg.dot(r, geo_n) < 0.0
        fixed = linalg.normalize(
            -wi
            + linalg.normalize(
                r - geo_n * linalg.dot(geo_n, r)[..., None]
            )
        )
        perturbed = jnp.where(below[:, None], fixed, perturbed)
        normal = jnp.where((nm_texnum > 0)[:, None], perturbed, geo_n)

    # ---- material decode ----
    roughness = jnp.full((n,), materials.DEFAULT_ROUGHNESS)
    roughness = jnp.where(
        flags == materials.MAT_FLAGS_WATER, materials.WATER_ROUGHNESS, roughness
    )
    if features.has_gloss:
        gloss_texnum = attr[:, _A_GLOSS].astype(jnp.int32)
        gloss = atlas_mod.sample(
            atlas, jnp.maximum(gloss_texnum, 0), uv, bilinear=False
        )[..., 0]
        roughness = jnp.where(gloss_texnum > 0, gloss, roughness)

    solid = flags == materials.MAT_FLAGS_SOLID
    waterfall = flags == materials.MAT_FLAGS_WATERFALL
    sprite_tele = (flags == materials.MAT_FLAGS_SPRITE) | (
        flags == materials.MAT_FLAGS_TELE
    )

    albedo = albedo_tex
    albedo = jnp.where(solid[..., None], attr[:, _A_SOLID_ALB], albedo)
    emission = jnp.zeros((n, 3))
    emission = jnp.where(solid[..., None], attr[:, _A_SOLID_EMM], emission)
    if features.has_emissive_tex:
        boosted = color_ops.ldr_to_hdr(albedo_tex)
        albedo = jnp.where(sprite_tele[..., None], boosted, albedo)
        emission = jnp.where(waterfall[..., None], albedo_tex, emission)
        emission = jnp.where(sprite_tele[..., None], boosted, emission)
    if features.has_fb:
        fb_texnum = attr[:, _A_FB].astype(jnp.int32)
        if use_mips:
            fb_col = atlas_mod.sample_mip(
                atlas, jnp.maximum(fb_texnum, 0), uv, lod
            )[..., :3]
        else:
            fb_col = atlas_mod.sample(
                atlas, jnp.maximum(fb_texnum, 0), uv, bilinear=bilinear
            )[..., :3]
        fb_emission = color_ops.ldr_to_hdr(fb_col)
        default_mat = ~(solid | waterfall | sprite_tele | is_sky)
        has_fb = default_mat & (fb_texnum > 0) & (fb_emission.max(axis=-1) > 0.0)
        emission = jnp.where(has_fb[..., None], fb_emission, emission)
        albedo = jnp.where(has_fb[..., None], fb_emission, albedo)

    # ---- sky ----
    sky_col = get_sky(atlas, uniforms, wi, sky_mode=features.sky_mode)
    albedo = jnp.where(is_sky[..., None], sky_col, albedo)
    emission = jnp.where(is_sky[..., None], sky_col, emission)
    sky_pos = pos + wi * T_MAX
    hit_pos = jnp.where(is_sky[..., None], sky_pos, hit_pos)
    prev_pos = jnp.where(is_sky[..., None], sky_pos, prev_pos)
    if not features.has_normalmap:
        normal = geo_n
    normal = jnp.where(is_sky[..., None], -wi, normal)
    geo_n = jnp.where(is_sky[..., None], -wi, geo_n)

    contribution = throughput * emission

    hit = Hit(
        pos=hit_pos,
        prev_pos=prev_pos,
        wi=wi,
        normal=normal,
        geo_normal=geo_n,
        albedo=albedo,
        roughness=roughness,
    )
    return TraceResult(
        throughput=throughput,
        contribution=contribution,
        hit=hit,
        hitrec=hr,
        flags=jnp.where(is_sky & hr.hit, materials.MAT_FLAGS_SKY, flags),
        t=jnp.where(is_sky, T_MAX, t_hit),
    )
