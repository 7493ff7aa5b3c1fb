"""Simple frame driver: gbuffer → integrator → accumulate → post.

The minimum end-to-end slice (SURVEY.md §7 step 4). The declarative
frame graph (graph/) layers the full default_config.json pipeline on
top; this driver is the hand-wired equivalent of the reference's
default connection set for still-camera reference renders.

``frame_core`` renders an image-row slab [y0, y0+rows) so the same code
runs single-device (full image) and under ``shard_map`` with the pixel
grid sharded across a device mesh (parallel/render.py); cross-shard
terms (auto-exposure log-mean) are abstracted behind ``mean_fn``.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .accel.build import AccelScene, build_accel
from .models.procedural import SceneBundle
from .models.types import RenderConfig, TextureAtlas, Uniforms
from .post.accumulate import accumulate, accumulate_reprojected
from .post.tonemap import tonemap_reinhard_extended
from .ops import color as color_ops
from .render.gbuffer import render_gbuffer
from .render.pt import render_pt


class FrameState(NamedTuple):
    """Device state threaded across frames (≈ the reference's history
    images held by Accumulate self-loop connections, plus the learned
    guiding state for the MCPG integrator)."""

    accum_irradiance: jnp.ndarray  # f32[H, W, 4] path irradiance
    accum_direct: jnp.ndarray  # f32[H, W, 4] first-hit emission
    accum_albedo: jnp.ndarray  # f32[H, W, 4]
    iteration: jnp.ndarray  # i32[]
    mcpg: object = None  # MCPGState when integrator == "mcpg"
    volume: object = None  # VolumeState when mcpg volume is enabled
    accum_volume: object = None  # f32[H, W, 4] accumulated volume radiance
    restir: object = None  # ReSTIRState when integrator == "restir"
    ssmm: object = None  # SSMMState when integrator == "ssmm"
    svgf: object = None  # SVGFState when config.denoise
    taa_prev: object = None  # f32[H, W, 3] previous LDR (TAA history)
    accum_volume_len: object = None  # f32[H, W] volume accum history len
    volume_svgf: object = None  # SVGFState for the volume denoiser


def init_state(config: RenderConfig, mcpg_config=None) -> FrameState:
    H, W = config.height, config.width
    mcpg_state = None
    restir_state = None
    ssmm_state = None
    volume_state = None
    accum_volume = None
    accum_volume_len = None
    volume_svgf = None
    if config.integrator == "mcpg":
        from .render.mcpg import MCPGConfig, init_mcpg_state

        mcpg_cfg = mcpg_config or MCPGConfig()
        mcpg_state = init_mcpg_state(mcpg_cfg)
        if mcpg_cfg.volume is not None:
            from .render.mcpg.volume import init_volume_state

            volume_state = init_volume_state(config, mcpg_cfg.volume)
            accum_volume = jnp.zeros((H, W, 4))
            accum_volume_len = jnp.zeros((H, W))
            if config.denoise:
                from .post.svgf import init_svgf_state

                volume_svgf = init_svgf_state(H, W)
    elif config.integrator == "restir":
        from .render.restir import init_restir_state

        restir_state = init_restir_state(W, H)
    elif config.integrator == "ssmm":
        from .render.ssmm import init_ssmm_state

        ssmm_state = init_ssmm_state(W, H)
    svgf_state = None
    taa_prev = None
    if config.denoise:
        from .post.svgf import init_svgf_state

        svgf_state = init_svgf_state(H, W)
        taa_prev = jnp.zeros((H, W, 3))
    return FrameState(
        accum_irradiance=jnp.zeros((H, W, 4)),
        accum_direct=jnp.zeros((H, W, 4)),
        accum_albedo=jnp.zeros((H, W, 4)),
        iteration=jnp.zeros((), jnp.int32),
        mcpg=mcpg_state,
        volume=volume_state,
        accum_volume=accum_volume,
        restir=restir_state,
        ssmm=ssmm_state,
        svgf=svgf_state,
        taa_prev=taa_prev,
        accum_volume_len=accum_volume_len,
        volume_svgf=volume_svgf,
    )


def frame_core(
    accel: AccelScene,
    atlas: TextureAtlas,
    uniforms: Uniforms,
    config: RenderConfig,
    state: FrameState,
    y0=0,
    rows: int | None = None,
    mean_fn=lambda x: x,
    mcpg_config=None,
    gather_fn=lambda x, groups=1: x,
    shard_ctx=None,
    _gbuf=None,
    _surf=None,
    _vol=None,
):
    """One frame over an image-row slab. ``mean_fn`` reduces a local
    scalar mean to the global mean (lax.pmean under shard_map);
    ``gather_fn`` concatenates per-shard guiding-update queues across
    the mesh (lax.all_gather) so every device applies the GLOBAL update
    set to its replica of the guiding state — replicas stay bit-
    identical without sharding the 2.4 GB state itself. ``shard_ctx``
    (post.sharded.ShardCtx) switches the denoise chain to its
    halo-exchange variants; required when denoise runs under
    shard_map."""
    rows = config.height if rows is None else rows
    gbuf = (
        _gbuf
        if _gbuf is not None
        else render_gbuffer(accel, atlas, uniforms, config, y0=y0, rows=rows)
    )
    new_mcpg = state.mcpg
    new_restir = state.restir
    new_ssmm = state.ssmm
    new_volume = state.volume
    new_accum_volume = state.accum_volume
    new_accum_volume_len = state.accum_volume_len
    vol_mv = None
    if config.integrator == "mcpg":
        from .render.mcpg.surface import SurfaceResult, render_mcpg_surface
        from .render.mcpg.updates import compact_queues, queue_gidx

        res = (
            _surf
            if _surf is not None
            else render_mcpg_surface(
                accel,
                atlas,
                uniforms,
                config,
                mcpg_config,
                state.mcpg,
                gbuf,
                y0=y0,
                rows=rows,
            )
        )
        irr = res.irradiance
        # queues are COMPACTED per shard BEFORE the cross-shard gather
        # (compact_queues): only live prefix rows ride the ICI, and the
        # replay is keyed by carried GLOBAL row indices so the result
        # is concat-order-invariant
        n_shards = shard_ctx.n if shard_ctx is not None else 1
        W, H = config.width, config.height
        surf_groups = max(config.spp, 1) * max(config.max_path_length - 1, 1)
        gidx = (
            res.gidx
            if res.gidx is not None
            else queue_gidx(
                res.updates.data.shape[0], surf_groups, W, rows, y0, H
            )
        )
        # live-lane compaction makes each segment's queue rows past its
        # static budget DEAD padding (surface pads the compacted
        # emissions back to ns rows) — slice them off here so the
        # downstream class-sorts/gathers in compact_queues run on
        # Σbudgets rows instead of segments·ns. In overflow frames the
        # full-width fallback can emit beyond the budget; those rows
        # drop like the reference's full per-cell queues
        # (grid.h:23-35) — render output stays exact, guiding just
        # learns from fewer samples that frame.
        from .render.mcpg.surface import _seg_budgets

        segs_n = max(config.max_path_length - 1, 0)
        ns_q = W * rows * max(config.spp, 1)
        buds = _seg_budgets(mcpg_config, segs_n, ns_q)
        if any(b < ns_q for b in buds) and res.gidx is not None:
            sl = lambda x: jnp.concatenate(
                [
                    x[s * ns_q : s * ns_q + b]
                    for s, b in enumerate(buds)
                ]
            )
            res = res._replace(
                updates=jax.tree.map(sl, res.updates),
                lc_samples=jax.tree.map(sl, res.lc_samples),
                zeros=jax.tree.map(sl, res.zeros),
            )
            gidx = sl(gidx)
        if mcpg_config.volume is not None:
            from .render.mcpg.volume import (
                apply_dist_updates, compact_dist, render_volume,
            )

            vol_img, vol_mv, new_volume, vres = (
                _vol
                if _vol is not None
                else render_volume(
                    accel, atlas, uniforms, config, mcpg_config,
                    mcpg_config.volume, state.mcpg, state.volume, gbuf,
                    y0=y0, rows=rows,
                    gather_img_fn=(
                        shard_ctx.gather_rows if shard_ctx is not None
                        else (lambda x: x)
                    ),
                )
            )
            vgroups = max(mcpg_config.volume.volume_spp, 1)
            cat = lambda a, b: jax.tree.map(
                lambda x, y: jnp.concatenate([x, y]), a, b
            )
            gidx_vol = queue_gidx(
                vres.updates.data.shape[0], vgroups, W, rows, y0, H
            )
            gidx = jnp.concatenate(
                [gidx, gidx_vol + surf_groups * H * W]
            )
            res = SurfaceResult(
                irradiance=res.irradiance,
                updates=cat(res.updates, vres.updates),
                lc_samples=cat(res.lc_samples, vres.lc_samples),
                zeros=cat(res.zeros, vres.zeros),
            )
            dq = compact_dist(
                vres.dist, state.volume.dist_mc.sum_w.size, gidx_vol,
                n_shards,
            )
            dq = gather_fn(dq, 1)
            new_volume = new_volume._replace(
                dist_mc=apply_dist_updates(state.volume.dist_mc, dq)
            )
            # volume accumulate WITH volume-mv reprojection (the
            # reference's volume accum takes the volume_mv input,
            # default_config.json:289-310) — under any camera motion
            # the reprojected history tracks the fog instead of
            # ghosting (tested: test_volume_reprojected_accumulate)
            new_accum_volume, new_accum_volume_len = accumulate_reprojected(
                state.accum_volume, state.accum_volume_len, vol_img,
                vol_mv,
                gather_fn=(
                    shard_ctx.gather_rows if shard_ctx is not None
                    else (lambda x: x)
                ),
                y0=y0, rows=rows if shard_ctx is not None else None,
            )
        from .render.mcpg.updates import apply_updates_compact

        cq = compact_queues(res, mcpg_config, gidx, gidx, n_shards=n_shards)
        cq = jax.tree.map(lambda x: gather_fn(x, 1), cq)
        new_mcpg = apply_updates_compact(
            jnp.uint32(config.seed), state.mcpg, cq, uniforms, mcpg_config
        )
    elif config.integrator == "restir":
        from .render.restir import ReSTIRConfig, render_restir

        assert rows == config.height or shard_ctx is not None, (
            "restir spatial reuse needs the full frame or a shard_ctx"
        )
        irr, new_restir = render_restir(
            accel,
            atlas,
            uniforms,
            config,
            mcpg_config or ReSTIRConfig(),
            state.restir,
            gbuf,
            y0=y0,
            rows=rows,
            shard_ctx=shard_ctx,
        )
    elif config.integrator == "ssmm":
        from .render.ssmm import SSMMConfig, render_ssmm

        assert rows == config.height or shard_ctx is not None, (
            "ssmm neighborhood reads need the full frame or a shard_ctx"
        )
        irr, new_ssmm = render_ssmm(
            accel,
            atlas,
            uniforms,
            config,
            mcpg_config or SSMMConfig(),
            state.ssmm,
            gbuf,
            y0=y0,
            rows=rows,
            shard_ctx=shard_ctx,
        )
    else:
        irr = render_pt(accel, atlas, uniforms, config, gbuf, y0=y0, rows=rows)
    if config.denoise:
        # the denoise beauty path reads none of the plain accumulators
        # (SVGF integrates its own history); skip their three
        # full-image blends instead of carrying dead bandwidth
        # (VERDICT r2 weak #6)
        acc_irr = state.accum_irradiance
        acc_dir = state.accum_direct
        acc_alb = state.accum_albedo
    else:
        acc_irr = accumulate(state.accum_irradiance, irr, state.iteration)
        acc_dir = accumulate(
            state.accum_direct, gbuf.irradiance, state.iteration
        )
        acc_alb = accumulate(
            state.accum_albedo, gbuf.albedo, state.iteration
        )
    new_state = FrameState(
        accum_irradiance=acc_irr,
        accum_direct=acc_dir,
        accum_albedo=acc_alb,
        iteration=state.iteration + 1,
        mcpg=new_mcpg,
        volume=new_volume,
        accum_volume=new_accum_volume,
        restir=new_restir,
        ssmm=new_ssmm,
        accum_volume_len=new_accum_volume_len,
        volume_svgf=state.volume_svgf,
    )
    # beauty path (reference wiring, default_config.json:3-372):
    # renderer irradiance → accumulate → SVGF(+albedo remodulate) →
    # add direct emission → exposure → tonemap → TAA → FXAA
    if config.denoise:
        if shard_ctx is not None:
            from functools import partial

            from .post.sharded import fxaa_sharded, svgf_sharded, taa_sharded

            svgf = partial(svgf_sharded, shard_ctx)
            taa = partial(taa_sharded, shard_ctx)
            fxaa = partial(fxaa_sharded, shard_ctx)
        else:
            from .post.fxaa import fxaa
            from .post.svgf import svgf
            from .post.taa import taa

        new_svgf, filtered = svgf(
            state.svgf,
            irr[..., :3],
            irr[..., 3],
            gbuf.mv,
            gbuf.normal,
            gbuf.linear_z,
            gbuf.z_grad,
            gbuf.albedo[..., :3],
        )
        beauty_hdr = filtered + gbuf.irradiance[..., :3]
        if new_state.accum_volume is not None:
            # SECOND SVGF instance on the volume path (the reference's
            # volume denoiser, default_config.json:328-372,675-698):
            # reprojection follows the VOLUME motion vectors, albedo is
            # all-ones (the reference's 'one' Color node)
            new_vol_svgf, vol_filtered = svgf(
                state.volume_svgf,
                new_state.accum_volume[..., :3],
                new_state.accum_volume[..., 3],
                vol_mv,
                gbuf.normal,
                gbuf.linear_z,
                gbuf.z_grad,
                jnp.ones_like(new_state.accum_volume[..., :3]),
            )
            beauty_hdr = beauty_hdr + vol_filtered
            new_state = new_state._replace(volume_svgf=new_vol_svgf)
        lum = color_ops.yuv_luminance(beauty_hdr)
        log_mean = mean_fn(jnp.mean(jnp.log(lum + 1e-4)))
        scale = 0.18 / jnp.maximum(jnp.exp(log_mean), 1e-4)
        ldr = tonemap_reinhard_extended(beauty_hdr * scale)
        ldr = taa(state.taa_prev, ldr, gbuf.mv)
        new_state = new_state._replace(svgf=new_svgf, taa_prev=ldr)
        ldr = fxaa(ldr)
    else:
        beauty_hdr = (
            new_state.accum_irradiance[..., :3]
            * jnp.maximum(new_state.accum_albedo[..., :3], 0.0)
            + new_state.accum_direct[..., :3]
        )
        if new_state.accum_volume is not None:
            beauty_hdr = beauty_hdr + new_state.accum_volume[..., :3]
        # auto exposure (key / log-average luminance, merian Exposure node)
        lum = color_ops.yuv_luminance(beauty_hdr)
        log_mean = mean_fn(jnp.mean(jnp.log(lum + 1e-4)))
        scale = 0.18 / jnp.maximum(jnp.exp(log_mean), 1e-4)
        ldr = tonemap_reinhard_extended(beauty_hdr * scale)
    outputs = {
        "hdr": beauty_hdr,
        "ldr": ldr,
        "irradiance": irr,
        "gbuffer": gbuf,
    }
    if vol_mv is not None:
        outputs["volume"] = vol_img
        outputs["volume_mv"] = vol_mv
    return new_state, outputs


@partial(jax.jit, static_argnames=("config", "mcpg_config"))
def render_frame(
    accel: AccelScene,
    atlas: TextureAtlas,
    uniforms: Uniforms,
    config: RenderConfig,
    state: FrameState,
    mcpg_config=None,
):
    """One full frame on a single device. Returns (new_state, outputs)."""
    return frame_core(
        accel, atlas, uniforms, config, state, mcpg_config=mcpg_config
    )


@partial(jax.jit, static_argnames=("config",))
def _stage_gbuffer(accel, atlas, uniforms, config):
    return render_gbuffer(accel, atlas, uniforms, config)


@partial(jax.jit, static_argnames=("config", "mcpg_config"))
def _stage_surface(accel, atlas, uniforms, config, mcpg_config, mc, gbuf):
    from .render.mcpg.surface import render_mcpg_surface

    return render_mcpg_surface(
        accel, atlas, uniforms, config, mcpg_config, mc, gbuf
    )


@partial(jax.jit, static_argnames=("config", "mcpg_config"))
def _stage_volume(accel, atlas, uniforms, config, mcpg_config, mc, vol, gbuf):
    from .render.mcpg.volume import render_volume

    return render_volume(
        accel, atlas, uniforms, config, mcpg_config, mcpg_config.volume,
        mc, vol, gbuf,
    )


@partial(jax.jit, static_argnames=("config", "mcpg_config"))
def _stage_rest(accel, atlas, uniforms, config, state, mcpg_config, gbuf,
                surf, vol):
    return frame_core(
        accel, atlas, uniforms, config, state, mcpg_config=mcpg_config,
        _gbuf=gbuf, _surf=surf, _vol=vol,
    )


def render_frame_staged(
    accel: AccelScene,
    atlas: TextureAtlas,
    uniforms: Uniforms,
    config: RenderConfig,
    state: FrameState,
    mcpg_config=None,
):
    """One frame as FOUR separately-jitted stages (single device).

    Mathematically identical to render_frame (same ops, the jit
    boundaries only materialize stage outputs in device memory;
    equivalence-tested). Smaller programs compile separately, which
    shortens the first-frame latency where compile time grows faster
    than program size; whether that holds for the GPU compiler is not
    measured yet. Non-mcpg integrators and shard_map paths keep the
    monolithic driver."""
    if config.integrator != "mcpg":
        return render_frame(
            accel, atlas, uniforms, config, state, mcpg_config
        )
    gbuf = _stage_gbuffer(accel, atlas, uniforms, config)
    surf = _stage_surface(
        accel, atlas, uniforms, config, mcpg_config, state.mcpg, gbuf
    )
    vol = None
    if mcpg_config is not None and mcpg_config.volume is not None:
        vol = _stage_volume(
            accel, atlas, uniforms, config, mcpg_config, state.mcpg,
            state.volume, gbuf,
        )
    return _stage_rest(
        accel, atlas, uniforms, config, state, mcpg_config, gbuf, surf, vol
    )


def render_sequence(
    bundle: SceneBundle,
    config: RenderConfig,
    frames: int = 1,
    mcpg_config=None,
):
    """Render `frames` frames of a static scene, returning final outputs."""
    if mcpg_config is None:
        if config.integrator == "mcpg":
            from .render.mcpg import MCPGConfig

            mcpg_config = MCPGConfig()
        elif config.integrator == "restir":
            from .render.restir import ReSTIRConfig

            mcpg_config = ReSTIRConfig()
        elif config.integrator == "ssmm":
            from .render.ssmm import SSMMConfig

            mcpg_config = SSMMConfig()
    accel = build_accel(bundle.scene, bundle.atlas)
    from .accel.build import scene_features

    config = config._replace(
        features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    )
    state = init_state(config, mcpg_config)
    uniforms = bundle.uniforms
    outputs = None
    for i in range(frames):
        uniforms = uniforms._replace(frame=jnp.uint32(i))
        state, outputs = render_frame(
            accel, bundle.atlas, uniforms, config, state, mcpg_config
        )
    return state, outputs
