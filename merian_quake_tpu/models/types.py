"""Core scene/uniform types (JAX pytrees with static shapes).

Design: the reference feeds its kernels 16 instance-local buffer pairs
(vtx/prev_vtx/idx/ext, quake_node.hpp:181-193) plus a 4096-entry texture
array. We flatten everything to ONE world-space triangle soup in
structure-of-arrays form, padded to a static size — instances are a
host-side concept (the game layer concatenates per-model triangles each
frame and the array shape stays constant across frames so nothing
recompiles). The packed ``VertexExtraData`` bitfields
(scene_info.glsl.h:7-15) are unpacked into SoA int/float lanes.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from . import materials

# Triangles are grouped into fixed-size clusters for the two-level
# intersection structure (accel/). Scene arrays are padded to a multiple.
CLUSTER_SIZE = 64


class TextureAtlas(NamedTuple):
    """All scene textures packed into one 2D atlas with a mip chain.

    ``data``: f32[H, W, 4] linear RGBA level 0 (sRGB decode and the
    reference's pow(1/1.2) albedo boost folded in at build time,
    raytrace.glsl:289). ``mips``: tuple of coarser levels (level l has
    dimensions >> l; rects are 2^levels-aligned so levels never bleed
    across texture boundaries). ``table``: i32[MAX_TEX, 4] =
    (x, y, w, h) per texture id at level 0; w == 0 marks unused.
    """

    data: jnp.ndarray
    table: jnp.ndarray
    mips: tuple = ()
    # all levels' texels concatenated row-major, (sum_l H_l*W_l, 4) —
    # lets mip sampling be ONE gather (per-level offsets/strides are
    # static, derived from the shapes; see atlas.sample_mip)
    flat: jnp.ndarray | None = None

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def num_levels(self) -> int:
        return 1 + len(self.mips)


class Scene(NamedTuple):
    """World-space triangle soup + materials for one frame (device SoA).

    All arrays share leading dim T (padded, multiple of CLUSTER_SIZE).
    Padding triangles have ``valid == False`` and degenerate vertices.
    """

    v0: jnp.ndarray  # f32[T, 3]
    v1: jnp.ndarray
    v2: jnp.ndarray
    pv0: jnp.ndarray  # previous-frame positions (motion vectors)
    pv1: jnp.ndarray
    pv2: jnp.ndarray
    st: jnp.ndarray  # f32[T, 3, 2] per-corner UVs
    texnum: jnp.ndarray  # i32[T] albedo texture id (atlas table index)
    fb_texnum: jnp.ndarray  # i32[T] fullbright/emission texture (0 = none)
    normal_texnum: jnp.ndarray  # i32[T] tangent normal map (0 = none)
    gloss_texnum: jnp.ndarray  # i32[T] roughness map (0 = none)
    flags: jnp.ndarray  # i32[T] MAT_FLAGS_*
    alpha: jnp.ndarray  # f32[T]; < 0 → use texture alpha (ref enc 0)
    solid_albedo: jnp.ndarray  # f32[T, 3] for MAT_FLAGS_SOLID
    solid_emission: jnp.ndarray  # f32[T, 3]
    valid: jnp.ndarray  # bool[T]

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]


class Uniforms(NamedTuple):
    """Per-frame uniform data (≈ UniformData, scene_info.glsl.h:17-37)."""

    cam_x: jnp.ndarray  # f32[3] camera position
    cam_w: jnp.ndarray  # f32[3] forward
    cam_u: jnp.ndarray  # f32[3] up
    prev_cam_x: jnp.ndarray
    prev_cam_w: jnp.ndarray
    prev_cam_u: jnp.ndarray
    fov_tan_half: jnp.ndarray  # f32[] tan of half horizontal fov
    mu_t: jnp.ndarray  # f32[] fog extinction
    mu_s: jnp.ndarray  # f32[3] fog scattering
    volume_max_t: jnp.ndarray  # f32[] fog truncation distance
    cl_time: jnp.ndarray  # f32[] game time
    time_diff: jnp.ndarray  # f32[] cl_time - prev cl_time (1 if paused)
    frame: jnp.ndarray  # u32[]
    sun_w: jnp.ndarray  # f32[3] sun direction (toward the sun)
    sun_color: jnp.ndarray  # f32[3]
    sky_classic: jnp.ndarray  # i32[2] (back, front) texture ids; -1 = cubemap
    sky_cube: jnp.ndarray  # i32[6] cubemap face ids (rt,lf,bk,ft,up,dn)
    player: jnp.ndarray  # u32[] PLAYER_FLAGS_*


def default_uniforms(
    cam_x=(0.0, 0.0, 0.0),
    cam_w=(1.0, 0.0, 0.0),
    cam_u=(0.0, 0.0, 1.0),
    fov_deg=90.0,
    mu_t=0.0,
    mu_s=(0.0, 0.0, 0.0),
    volume_max_t=1000.0,
    cl_time=0.0,
    time_diff=1.0,
    frame=0,
    sun_w=(0.577, 0.577, 0.577),
    sun_color=(0.0, 0.0, 0.0),
    sky_classic=(-1, -1),
    sky_cube=(-1, -1, -1, -1, -1, -1),
    player=0,
    prev_cam=None,
) -> Uniforms:
    f3 = lambda v: jnp.asarray(v, jnp.float32)
    cam = (f3(cam_x), f3(cam_w), f3(cam_u))
    prev = tuple(f3(v) for v in prev_cam) if prev_cam is not None else cam
    return Uniforms(
        cam_x=cam[0],
        cam_w=cam[1],
        cam_u=cam[2],
        prev_cam_x=prev[0],
        prev_cam_w=prev[1],
        prev_cam_u=prev[2],
        fov_tan_half=jnp.float32(np.tan(np.deg2rad(fov_deg) / 2.0)),
        mu_t=jnp.float32(mu_t),
        mu_s=f3(mu_s),
        volume_max_t=jnp.float32(volume_max_t),
        cl_time=jnp.float32(cl_time),
        time_diff=jnp.float32(time_diff),
        frame=jnp.uint32(frame),
        sun_w=f3(sun_w) / jnp.linalg.norm(f3(sun_w)),
        sun_color=f3(sun_color),
        sky_classic=jnp.asarray(sky_classic, jnp.int32),
        sky_cube=jnp.asarray(sky_cube, jnp.int32),
        player=jnp.uint32(player),
    )


class SceneFeatures(NamedTuple):
    """Static scene capability flags — compiled into the kernels.

    The GLSL reference branches per-thread on these (cheap on GPUs);
    under XLA every branch is evaluated for every lane, so a scene
    without sky textures must not pay for sky sampling. Derived from
    the host-side scene data (accel.build.scene_features); changing a
    flag recompiles (≈ the reference's macro-driven pipeline rebuild).
    """

    sky_mode: str = "none"  # none | classic | cubemap
    has_alpha_tris: bool = True  # any triangles needing texture alpha test
    has_fb: bool = False  # any fullbright emission textures
    has_gloss: bool = False  # any gloss/roughness maps
    has_warp: bool = False  # any lava/slime/tele/water UV warp
    has_emissive_tex: bool = True  # any sprite/tele/waterfall surfaces
    has_normalmap: bool = False  # any tangent-space normal maps


class RenderConfig(NamedTuple):
    """Static (compile-time) render settings — jit static argument.

    Equivalent of the reference's shader-macro knobs
    (render_mcpg.cpp:137-185): changing one recompiles the kernel,
    exactly like the reference's pipeline rebuild on property change.
    """

    width: int = 640
    height: int = 360
    spp: int = 1
    max_path_length: int = 3
    seed: int = 1337
    integrator: str = "pt"  # pt (= reference_mode, mcpg.comp:59-65) | mcpg
    denoise: bool = False  # SVGF + TAA + FXAA real-time path
    max_intersections: int = materials.MAX_INTERSECTIONS
    # nearest is the perf default (XLA texel gathers are expensive and
    # Quake textures are chunky); the reference uses bilinear+mips
    bilinear: bool = False
    features: "SceneFeatures" = SceneFeatures()


def build_scene_from_soup(
    v0,
    v1,
    v2,
    st=None,
    texnum=None,
    fb_texnum=None,
    normal_texnum=None,
    gloss_texnum=None,
    flags=None,
    alpha=None,
    solid_albedo=None,
    solid_emission=None,
    pv0=None,
    pv1=None,
    pv2=None,
    pad_to=None,
) -> Scene:
    """Host-side (numpy) scene assembly with padding to CLUSTER_SIZE."""
    v0 = np.asarray(v0, np.float32)
    n = v0.shape[0]

    def _default(x, shape, dtype, fill=0):
        if x is None:
            return np.full(shape, fill, dtype)
        return np.asarray(x, dtype)

    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    pv0 = _default(pv0, v0.shape, np.float32) if pv0 is not None else v0.copy()
    pv1 = _default(pv1, v1.shape, np.float32) if pv1 is not None else v1.copy()
    pv2 = _default(pv2, v2.shape, np.float32) if pv2 is not None else v2.copy()
    st = _default(st, (n, 3, 2), np.float32)
    texnum = _default(texnum, (n,), np.int32)
    fb_texnum = _default(fb_texnum, (n,), np.int32)
    normal_texnum = _default(normal_texnum, (n,), np.int32)
    gloss_texnum = _default(gloss_texnum, (n,), np.int32)
    flags = _default(flags, (n,), np.int32)
    alpha = _default(alpha, (n,), np.float32, fill=-1.0)
    solid_albedo = _default(solid_albedo, (n, 3), np.float32)
    solid_emission = _default(solid_emission, (n, 3), np.float32)
    valid = np.ones((n,), bool)

    t_pad = pad_to if pad_to is not None else max(
        CLUSTER_SIZE, -(-n // CLUSTER_SIZE) * CLUSTER_SIZE
    )
    if t_pad < n:
        raise ValueError(f"pad_to={t_pad} < triangle count {n}")
    pad = t_pad - n

    def _pad(x, fill=0.0):
        if pad == 0:
            return x
        width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, width, constant_values=fill)

    return Scene(
        v0=jnp.asarray(_pad(v0)),
        v1=jnp.asarray(_pad(v1)),
        v2=jnp.asarray(_pad(v2)),
        pv0=jnp.asarray(_pad(pv0)),
        pv1=jnp.asarray(_pad(pv1)),
        pv2=jnp.asarray(_pad(pv2)),
        st=jnp.asarray(_pad(st)),
        texnum=jnp.asarray(_pad(texnum)),
        fb_texnum=jnp.asarray(_pad(fb_texnum)),
        normal_texnum=jnp.asarray(_pad(normal_texnum)),
        gloss_texnum=jnp.asarray(_pad(gloss_texnum)),
        flags=jnp.asarray(_pad(flags)),
        alpha=jnp.asarray(_pad(alpha, fill=-1.0)),
        solid_albedo=jnp.asarray(_pad(solid_albedo)),
        solid_emission=jnp.asarray(_pad(solid_emission)),
        valid=jnp.asarray(_pad(valid, fill=False)),
    )
