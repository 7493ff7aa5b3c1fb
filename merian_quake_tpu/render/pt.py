"""Unidirectional path tracer (the reference's REFERENCE_MODE).

Implements exactly the guided-integrator skeleton of
/root/reference/res/shader/render_mcpg/mcpg.comp with
MERIAN_QUAKE_REFERENCE_MODE == 1 (lines 38-210): per-pixel xorshift32
streams seeded by pcg4d16(pixel, frame, seed), SURFACE_SPP paths of at
most MAX_PATH_LENGTH segments continued by GGX+diffuse BSDF sampling,
path termination on found emission / dead throughput, contribution
f/p with NaN/Inf rejection, and (luminance²) second-moment output in
the alpha channel. Divergent per-pixel loops become fixed-trip masked
lane updates.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..accel.build import AccelScene
from ..models.types import RenderConfig, TextureAtlas, Uniforms
from ..ops import bsdf, color as color_ops, linalg, rng as rng_ops
from . import layout
from .gbuffer import GBufferOutput
from .hit import Hit, decompress_hit
from .trace import trace_ray


def _where_hit(mask, a: Hit, b: Hit) -> Hit:
    m3 = mask[..., None]
    return Hit(
        pos=jnp.where(m3, a.pos, b.pos),
        prev_pos=jnp.where(m3, a.prev_pos, b.prev_pos),
        wi=jnp.where(m3, a.wi, b.wi),
        normal=jnp.where(m3, a.normal, b.normal),
        geo_normal=jnp.where(m3, a.geo_normal, b.geo_normal),
        albedo=jnp.where(m3, a.albedo, b.albedo),
        roughness=jnp.where(mask, a.roughness, b.roughness),
    )


def render_pt(
    accel: AccelScene,
    atlas: TextureAtlas,
    uniforms: Uniforms,
    config: RenderConfig,
    gbuf: GBufferOutput,
    y0=0,
    rows: int | None = None,
) -> jnp.ndarray:
    """Returns irradiance image f32[rows, W, 4] (rgb irr, a second moment).

    ``y0``/``rows`` select the image-row slab (pixel-grid sharding unit);
    RNG streams are seeded with absolute pixel coordinates so sharded
    and single-device renders are bit-identical.
    """
    W, H = config.width, config.height
    rows = H if rows is None else rows
    n = W * rows
    pxi, pyi = layout.gen_pixels(W, rows, y0=y0)
    state0 = rng_ops.seed_pixel(pxi, pyi, uniforms.frame, config.seed)

    first_hit = decompress_hit(gbuf.hits)
    # mcpg.comp:43 — skip pixels whose first hit has (near) zero albedo
    pixel_live = (first_hit.albedo >= 1e-7).any(axis=-1)

    def one_sample(state):
        cur = first_hit
        throughput = jnp.ones((n, 3))
        f = jnp.zeros((n, 3))
        p = jnp.ones((n,))
        done = ~pixel_live

        def segment(carry, _):
            state, cur, throughput, f, p, done = carry
            state, u3 = rng_ops.uniform3(state)
            alpha = bsdf.roughness_to_alpha(cur.roughness)
            wo = bsdf.sample(cur.wi, cur.normal, alpha, u3)
            wodotn = linalg.dot(wo, cur.normal)
            below = (wodotn <= 1e-3) | (linalg.dot(wo, cur.geo_normal) <= 1e-3)
            active = ~done & ~below
            wo_p = bsdf.pdf(cur.wi, wo, cur.normal, alpha)

            # trace next segment (origin pulled back, mcpg.comp:144)
            origin = cur.pos - cur.wi * 1e-3
            res = trace_ray(
                accel, atlas, uniforms, origin, wo,
                bilinear=config.bilinear, features=config.features,
                sort_rays=True, active=active,
            )

            micro = bsdf.eval_times_cos(cur.wi, wo, cur.normal, alpha)
            new_thr = throughput * micro[..., None]
            new_f = new_thr * res.contribution
            new_p = p * wo_p
            new_thr = new_thr * res.throughput * res.hit.albedo

            # commit updates only on active lanes
            throughput = jnp.where(active[..., None], new_thr, throughput)
            f = jnp.where(active[..., None], new_f, f)
            p = jnp.where(active, new_p, p)
            cur = _where_hit(active, res.hit, cur)

            # termination (mcpg.comp:188-189)
            dead = (throughput < 1e-7).all(axis=-1) | (f > 1e-7).any(axis=-1)
            done = done | below | dead
            return (state, cur, throughput, f, p, done), None

        (state, cur, throughput, f, p, done), _ = jax.lax.scan(
            segment,
            (state, cur, throughput, f, p, done),
            None,
            length=max(config.max_path_length - 1, 0),
        )
        contrib = f / jnp.maximum(p, 1e-30)[..., None]
        ok = jnp.isfinite(contrib).all(axis=-1)
        contrib = jnp.where((ok & pixel_live)[..., None], contrib, 0.0)
        lum = color_ops.yuv_luminance(contrib)
        return state, contrib, lum * lum

    def spp_body(carry, _):
        state, irr, m2 = carry
        state, contrib, l2 = one_sample(state)
        return (state, irr + contrib, m2 + l2), None

    init = (state0, jnp.zeros((n, 3)), jnp.zeros((n,)))
    (state, irr, m2), _ = jax.lax.scan(spp_body, init, None, length=config.spp)
    if config.spp > 0:
        irr = irr / config.spp
        m2 = m2 / config.spp
    return layout.flat_to_image(
        jnp.concatenate([irr, m2[..., None]], axis=-1), W, rows
    )
