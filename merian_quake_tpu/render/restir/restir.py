"""ReSTIR DI pass pipeline: generate → temporal → spatial → shade.

Port of res/shader/render_restir/restir_di_{generate_samples_bsdf,
temporal_reuse,spatial_reuse,shade}.comp and the host pass sequence
(renderer_restir.cpp:206-250). Defaults mirror renderer_restir.hpp:
106-128. The prev-frame reservoir/gbuffer delayed inputs
(renderer_restir.hpp:71-84) live in ReSTIRState.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ...accel.build import AccelScene
from ...models.types import RenderConfig, TextureAtlas, Uniforms
from ...ops import bsdf, color as color_ops, linalg, rng as rng_ops
from .. import layout
from ..gbuffer import GBufferOutput
from ..hit import Hit, decompress_hit
from ..trace import trace_ray
from . import reservoir as rsv
from .reservoir import Reservoir


class ReSTIRConfig(NamedTuple):
    """Static knobs (≈ spec constants, renderer_restir.hpp:106-128)."""

    spp: int = 1
    apply_mv: bool = False
    spatial_reuse_iterations: int = 1
    temporal_clamp_m: int = 32 * 20
    boiling_filter_strength: float = 0.0
    temporal_normal_reject_cos: float = 0.96
    temporal_depth_reject: float = 0.1
    spatial_normal_reject_cos: float = 0.96
    spatial_depth_reject: float = 0.1
    spatial_radius: float = 30.0
    temporal_bias_correction: int = 0  # 0 none, 1 basic, 2 raytraced
    spatial_bias_correction: int = 0
    visibility_shade: bool = True


class ReSTIRState(NamedTuple):
    """Delayed (prev-frame) graph inputs."""

    reservoirs: Reservoir  # finalized reservoirs of the previous frame
    prev_normal: jnp.ndarray  # f32[N, 3]
    prev_linear_z: jnp.ndarray  # f32[N]


def init_restir_state(width: int, height: int) -> ReSTIRState:
    n = width * height
    return ReSTIRState(
        reservoirs=rsv.reservoir_init(n),
        prev_normal=jnp.zeros((n, 3)),
        prev_linear_z=jnp.full((n,), 1e30),
    )


def target_pdf(y_pos, y_normal, y_radiance, surf: Hit):
    """restir_di_target_pdf (restir_di_common.glsl:7-18)."""
    d = y_pos - surf.pos
    dist2 = jnp.maximum(jnp.sum(d * d, axis=-1), 1e-12)
    wo = d / jnp.sqrt(dist2)[..., None]
    wodotn = linalg.dot(wo, surf.normal)
    alpha = bsdf.roughness_to_alpha(surf.roughness)
    f = bsdf.eval_times_cos(surf.wi, wo, surf.normal, alpha)
    geo = jnp.maximum(linalg.dot(y_normal, -wo), 0.0) / dist2
    p = geo * f * color_ops.yuv_luminance(y_radiance)
    return jnp.where(wodotn > 0.0, p, 0.0)


def _reproj_valid(n_a, n_b, cos_thresh, z_a, vel_z, z_b, reject):
    """merian-shaders/reprojection.glsl-style validity gate."""
    n_ok = linalg.dot(n_a, n_b) >= cos_thresh
    z_ok = jnp.abs(z_b - (z_a + vel_z)) <= reject * jnp.maximum(
        jnp.maximum(z_a, z_b), 1e-3
    )
    return n_ok & z_ok


# test hook: force the full-plane gather path under sharding (A/B vs halo)
FORCE_GATHER = False


def _seed(px, py, frame, pass_idx, seed):
    return rng_ops.seed_pixel(px, py, frame * jnp.uint32(4) + jnp.uint32(pass_idx), seed)


def render_restir(
    accel: AccelScene,
    atlas: TextureAtlas,
    uniforms: Uniforms,
    config: RenderConfig,
    rcfg: ReSTIRConfig,
    rstate: ReSTIRState,
    gbuf: GBufferOutput,
    y0=0,
    rows: int | None = None,
    shard_ctx=None,
):
    """ReSTIR DI over image rows [y0, y0+rows). Returns
    (irradiance[rows,W,4], new ReSTIRState slabs).

    Under sharding (``shard_ctx``), cross-pixel reads — the previous
    frame's reservoirs/geometry (temporal reuse at motion-vector
    targets), the post-temporal reservoirs + current geometry (spatial
    neighbors within the 30 px radius), and the 8×8 boiling-filter tile
    means — come from all-gathered full images; generation, reuse math,
    shading and the visibility rays stay per-local-pixel, so the result
    matches single-device (tested)."""
    W, H = config.width, config.height
    rows = H if rows is None else rows
    n = W * rows
    pxf, pyf = layout.gen_pixels(W, rows, y0=y0)
    gf = (
        (lambda x: x)
        if shard_ctx is None
        else (lambda x: shard_ctx.gather_flat(x, W))
    )

    # ---- cross-shard neighbor access (VERDICT r2 #6): when the slab
    # can carry the reuse radius, boundary-row HALO EXCHANGE replaces
    # the full-plane all_gathers — per-device ICI traffic drops from
    # O(H·W·fields) to O(r_halo·W·fields). Targets beyond the ±r_halo
    # apron reject reuse (ok=False), a documented divergence from the
    # gathered path that only bites at >r_halo rows of frame motion.
    r_halo = int(max(rcfg.spatial_radius + 1, 16))
    use_halo = (
        shard_ctx is not None
        and not FORCE_GATHER
        and rows < H
        and r_halo <= rows
    )

    def _halo_reader(cols):
        metas = []
        packed = []
        for c in cols:
            ci = c[:, None] if c.ndim == 1 else c
            metas.append((c.dtype, c.ndim, ci.shape[1]))
            packed.append(
                ci
                if ci.dtype == jnp.int32
                else jax.lax.bitcast_convert_type(ci, jnp.int32)
            )
        tab = jnp.concatenate(packed, axis=1)
        img = layout.flat_to_image(tab, W, rows)
        pad = shard_ctx.halo_pad(img, r_halo)

        def read(px_t, py_t):
            ly = py_t - (shard_ctx.y0 - r_halo)
            ok = (ly >= 0) & (ly < rows + 2 * r_halo)
            lyc = jnp.clip(ly, 0, rows + 2 * r_halo - 1)
            rows_v = pad[lyc, px_t]  # (n, C)
            outs = []
            o = 0
            for dt, nd, k in metas:
                v = rows_v[:, o : o + k]
                o += k
                if dt != jnp.int32:
                    v = jax.lax.bitcast_convert_type(v, dt)
                outs.append(v[:, 0] if nd == 1 else v)
            return outs, ok

        return read

    surf = decompress_hit(gbuf.hits)
    pixel_live = (surf.albedo >= 1e-7).any(axis=-1)
    normal = layout.image_to_flat(gbuf.normal, W, rows)
    linear_z = layout.image_to_flat(gbuf.linear_z, W, rows)
    vel_z = layout.image_to_flat(gbuf.z_vel, W, rows)

    # ---------- pass 1: generate (BSDF candidates) ----------
    rng = _seed(pxf, pyf, uniforms.frame, 0, config.seed)
    r = rsv.reservoir_init(n)
    for _ in range(rcfg.spp):
        rng, u3 = rng_ops.uniform3(rng)
        alpha = bsdf.roughness_to_alpha(surf.roughness)
        wo = bsdf.sample(surf.wi, surf.normal, alpha, u3)
        wodotn = linalg.dot(wo, surf.normal)
        ok = (
            pixel_live
            & (wodotn > 1e-3)
            & (linalg.dot(wo, surf.geo_normal) > 1e-3)
        )
        origin = surf.pos - surf.wi * 1e-3
        res = trace_ray(
            accel, atlas, uniforms, origin, wo,
            bilinear=config.bilinear, features=config.features,
        )
        nh = res.hit
        d2 = jnp.maximum(jnp.sum(jnp.square(nh.pos - surf.pos), -1), 1e-12)
        geo = jnp.maximum(linalg.dot(nh.normal, -wo), 0.0) / d2
        p_sample = geo * bsdf.pdf(surf.wi, wo, surf.normal, alpha)
        p_tgt = target_pdf(nh.pos, nh.normal, res.contribution, surf)
        rng, r, _ = rsv.add_sample(
            r,
            rng,
            ok & (p_sample > 0.0),
            nh.pos,
            nh.normal,
            (nh.pos - nh.prev_pos) / uniforms.time_diff,
            jnp.full((n,), uniforms.cl_time),
            res.contribution,
            jnp.full((n,), rsv.FLAG_VALID, jnp.uint32),
            p_sample,
            p_tgt,
        )
    r = rsv.finalize(r)

    # ---------- pass 2: temporal reuse ----------
    rng = _seed(pxf, pyf, uniforms.frame, 1, config.seed)
    cur = r
    r = rsv.reservoir_init(n)
    rng, r, _ = rsv.combine_finalized(r, rng, cur, cur.p_target)

    mv = layout.image_to_flat(gbuf.mv, W, rows)
    ppx = jnp.round(pxf.astype(jnp.float32) + mv[:, 0]).astype(jnp.int32)
    ppy = jnp.round(pyf.astype(jnp.float32) + mv[:, 1]).astype(jnp.int32)
    inb = (ppx >= 0) & (ppx < W) & (ppy >= 0) & (ppy < H)
    pidx = layout.index_of(
        jnp.clip(ppx, 0, W - 1), jnp.clip(ppy, 0, H - 1), W, H
    )

    if use_halo:
        read_t = _halo_reader(
            list(rstate.reservoirs)
            + [rstate.prev_normal, rstate.prev_linear_z,
               surf.pos, surf.normal, surf.wi, surf.roughness]
        )
        tvals, ok_h = read_t(
            jnp.clip(ppx, 0, W - 1), jnp.clip(ppy, 0, H - 1)
        )
        prev = Reservoir(*tvals[:9])
        prev_n = tvals[9]
        prev_z = tvals[10]
        import types as _types

        prev_surf = _types.SimpleNamespace(
            pos=tvals[11], normal=tvals[12], wi=tvals[13],
            roughness=tvals[14],
        )
        inb = inb & ok_h
    else:
        prev_normal_f = gf(rstate.prev_normal)
        prev_z_f = gf(rstate.prev_linear_z)
        prev_res_f = Reservoir(*[gf(x) for x in rstate.reservoirs])
        prev_n = jnp.take(prev_normal_f, pidx, axis=0)
        prev_z = jnp.take(prev_z_f, pidx)
        prev = Reservoir(*[jnp.take(x, pidx, axis=0) for x in prev_res_f])
        prev_surf = None
    tvalid = (
        inb
        & (uniforms.frame > 0)
        & _reproj_valid(
            normal, prev_n, rcfg.temporal_normal_reject_cos,
            linear_z, vel_z, prev_z, rcfg.temporal_depth_reject,
        )
    )
    if rcfg.apply_mv:
        dt = (uniforms.cl_time - prev.y_T)[..., None]
        prev = prev._replace(
            y_pos=prev.y_pos + prev.y_mv * dt,
            y_T=jnp.full((n,), uniforms.cl_time),
        )
    if rcfg.temporal_clamp_m > 0:
        prev = prev._replace(M=jnp.minimum(prev.M, rcfg.temporal_clamp_m))
    p_tgt_prev = target_pdf(prev.y_pos, prev.y_normal, prev.y_radiance, surf)
    rng, combined, sel_prev = rsv.combine_finalized(
        r, rng, prev, p_tgt_prev, mask=tvalid
    )
    # lanes that early-return in the reference keep the current-only
    # reservoir (finalized below with M from `cur` only)
    if rcfg.temporal_bias_correction == 0:
        out = rsv.finalize(combined)
    else:
        pi = combined.p_target
        pi_sum = combined.p_target * cur.M.astype(jnp.float32)
        if prev_surf is None:
            surf_full = Hit(*[gf(x) for x in surf])
            prev_surf = Hit(*[jnp.take(x, pidx, axis=0) for x in surf_full])
        temporal_p = target_pdf(
            combined.y_pos, combined.y_normal, combined.y_radiance, prev_surf
        )
        if rcfg.temporal_bias_correction == 2:
            from ...accel.intersect import trace_visibility

            vis = trace_visibility(
                accel,
                atlas if config.features.has_alpha_tris else None,
                surf.pos,
                combined.y_pos,
            )
            temporal_p = jnp.where(vis, temporal_p, 0.0)
        temporal_p = jnp.where(tvalid, temporal_p, 0.0)
        pi = jnp.where(sel_prev, temporal_p, pi)
        pi_sum = pi_sum + temporal_p * prev.M.astype(jnp.float32)
        out = rsv.finalize_custom(combined, pi, pi_sum)
    r = out

    # boiling filter: per-8×8-tile mean (the reference's subgroup ==
    # its 8×8 workgroup, restir_di_temporal_reuse.comp:39-70)
    if rcfg.boiling_filter_strength > 1e-6:
        # GLOBAL 8×8 tile means (tiles align to image row 0, so shard
        # slabs gather the full weight image and slice their rows)
        mult = 10.0 / rcfg.boiling_filter_strength - 9.0
        wimg = layout.flat_to_image(gf(r.w), W, H)
        th, tw = H // 8, W // 8
        tiles = wimg[: th * 8, : tw * 8].reshape(th, 8, tw, 8)
        cnt = (tiles > 0).sum((1, 3)).astype(jnp.float32)
        mean = tiles.sum((1, 3)) / jnp.maximum(cnt, 1.0)
        mean_full = jnp.repeat(jnp.repeat(mean, 8, 0), 8, 1)
        pad_h, pad_w = H - th * 8, W - tw * 8
        mean_full = jnp.pad(mean_full, ((0, pad_h), (0, pad_w)), mode="edge")
        mean_rows = jax.lax.dynamic_slice_in_dim(mean_full, y0, rows, 0)
        boiling = r.w > layout.image_to_flat(mean_rows, W, rows) * mult
        r = rsv.discard(r, boiling)

    # ---------- pass 3: spatial reuse ----------
    rng = _seed(pxf, pyf, uniforms.frame, 2, config.seed)
    spatial_in = r
    if use_halo:
        read_s = _halo_reader(
            list(spatial_in)
            + [normal, linear_z,
               surf.pos, surf.normal, surf.wi, surf.roughness]
        )
        sp_full = normal_full = z_full = surf_full_s = None
    else:
        sp_full = (
            spatial_in
            if shard_ctx is None
            else Reservoir(*[gf(x) for x in spatial_in])
        )
        normal_full = gf(normal)
        z_full = gf(linear_z)
    r = rsv.reservoir_init(n)
    rng, r, _ = rsv.combine_finalized(r, rng, spatial_in, spatial_in.p_target)
    neighbors = []
    sel_idx = jnp.full((n,), -1, jnp.int32)
    for i in range(rcfg.spatial_reuse_iterations):
        rng, u2 = rng_ops.uniform2(rng)
        nx = jnp.round(
            pxf.astype(jnp.float32) + rcfg.spatial_radius * (2 * u2[:, 0] - 1)
        ).astype(jnp.int32)
        ny = jnp.round(
            pyf.astype(jnp.float32) + rcfg.spatial_radius * (2 * u2[:, 1] - 1)
        ).astype(jnp.int32)
        inb_s = (nx >= 0) & (nx < W) & (ny >= 0) & (ny < H)
        nx_c = jnp.clip(nx, 0, W - 1)
        ny_c = jnp.clip(ny, 0, H - 1)
        if use_halo:
            svals, ok_s = read_s(nx_c, ny_c)
            nb = Reservoir(*svals[:9])
            nb_normal = svals[9]
            nb_z = svals[10]
            import types as _types

            nb_surf = _types.SimpleNamespace(
                pos=svals[11], normal=svals[12], wi=svals[13],
                roughness=svals[14],
            )
            inb_s = inb_s & ok_s
        else:
            nidx = layout.index_of(nx_c, ny_c, W, H)
            nb = Reservoir(*[jnp.take(x, nidx, axis=0) for x in sp_full])
            nb_normal = jnp.take(normal_full, nidx, axis=0)
            nb_z = jnp.take(z_full, nidx)
            nb_surf = None if shard_ctx is None else nidx
        nvalid = inb_s & _reproj_valid(
            normal,
            nb_normal,
            rcfg.spatial_normal_reject_cos,
            linear_z,
            vel_z,
            nb_z,
            rcfg.spatial_depth_reject,
        )
        p_tgt_nb = target_pdf(nb.y_pos, nb.y_normal, nb.y_radiance, surf)
        rng, r, took = rsv.combine_finalized(r, rng, nb, p_tgt_nb, mask=nvalid)
        sel_idx = jnp.where(took, i, sel_idx)
        neighbors.append((nb_surf if use_halo else None, nx_c, ny_c,
                          nvalid, nb.M))
    if rcfg.spatial_bias_correction == 0 or rcfg.spatial_reuse_iterations == 0:
        r = rsv.finalize(r)
    else:
        pi = r.p_target
        pi_sum = r.p_target * spatial_in.M.astype(jnp.float32)
        surf_full_s = Hit(*[gf(x) for x in surf]) if not use_halo else None
        for i, (nb_surf_h, nx_c, ny_c, nvalid, nb_m) in enumerate(neighbors):
            if use_halo:
                nb_surf = nb_surf_h
            else:
                nidx = layout.index_of(nx_c, ny_c, W, H)
                nb_surf = Hit(
                    *[jnp.take(x, nidx, axis=0) for x in surf_full_s]
                )
            sp = target_pdf(r.y_pos, r.y_normal, r.y_radiance, nb_surf)
            if rcfg.spatial_bias_correction == 2:
                from ...accel.intersect import trace_visibility

                vis = trace_visibility(
                    accel,
                    atlas if config.features.has_alpha_tris else None,
                    nb_surf.pos,
                    r.y_pos,
                )
                sp = jnp.where(vis, sp, 0.0)
            sp = jnp.where(nvalid, sp, 0.0)
            pi = jnp.where(sel_idx == i, sp, pi)
            pi_sum = pi_sum + sp * nb_m.astype(jnp.float32)
        r = rsv.finalize_custom(r, pi, pi_sum)

    # ---------- pass 4: shade ----------
    yvalid = rsv.valid(r) & pixel_live
    d = r.y_pos - surf.pos
    dist_y = jnp.sqrt(jnp.maximum(jnp.sum(d * d, -1), 1e-12))
    wo = d / dist_y[..., None]
    if rcfg.visibility_shade:
        # occlusion-only visibility (any-hit sweep on the GPU) — the
        # reference's shade-time shadow ray (restir_di.comp); replaces
        # an earlier full nearest trace whose hit was used only for a
        # distance comparison
        from ...accel.intersect import trace_visibility

        vis = trace_visibility(
            accel,
            atlas if config.features.has_alpha_tris else None,
            surf.pos,
            r.y_pos,
        )
        occluded = yvalid & ~vis
        r = rsv.discard(r, occluded)
        yvalid = yvalid & ~occluded
    alpha = bsdf.roughness_to_alpha(surf.roughness)
    micro = bsdf.eval_times_cos(surf.wi, wo, surf.normal, alpha)
    w_ok = jnp.isfinite(r.w)
    irr = jnp.where(
        (yvalid & w_ok)[..., None],
        micro[..., None]
        * r.y_radiance
        * r.w[..., None]
        * (jnp.maximum(linalg.dot(r.y_normal, -wo), 0.0) / jnp.square(dist_y))[
            ..., None
        ],
        0.0,
    )
    lum = color_ops.yuv_luminance(irr)
    img = layout.flat_to_image(
        jnp.concatenate([irr, (lum * lum)[..., None]], -1), W, rows
    )

    new_state = ReSTIRState(
        reservoirs=r, prev_normal=normal, prev_linear_z=linear_z
    )
    return img, new_state
