"""Benchmark: flagship MCPG frame plus map-scale, production and live rows.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "detail": {...}}

Matches the BASELINE.md headline setup as closely as procedural content
allows: 1920×1080, MCPG integrator, max path length 3, on a ~17k-
triangle scene (ad_azad-class triangle count). Cold and steady-state
frame times are reported separately (the guiding-maturity transient
moves the headline); a second scene (~280k tris), the reference's
default-quality guiding config and the live 313k-triangle dungeon loop
follow. Every time ends at ``jax.block_until_ready``.
"""
from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp


def _bench_phases(bundle, accel, config, mcfg, phases, timed=3):
    """Render one warm sequence, timing `timed` frames at each phase
    boundary. ``phases``: dict name -> start frame index. Returns
    {name: seconds/frame}. A single sequence measures cold and
    steady-state behavior of the SAME state trajectory."""
    from merian_quake_tpu.renderer import init_state, render_frame

    state = init_state(config, mcfg)
    uniforms = bundle.uniforms
    out = {}
    frame = 0
    for _ in range(2):  # compile + settle
        uniforms = uniforms._replace(frame=jnp.uint32(1000 + frame))
        state, outputs = render_frame(
            accel, bundle.atlas, uniforms, config, state, mcfg
        )
        jax.block_until_ready(outputs)
    state = init_state(config, mcfg)  # reset: phase 0 is truly cold
    for name, start in sorted(phases.items(), key=lambda kv: kv[1]):
        while frame < start:
            uniforms = uniforms._replace(frame=jnp.uint32(frame))
            state, outputs = render_frame(
                accel, bundle.atlas, uniforms, config, state, mcfg
            )
            frame += 1
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for _ in range(timed):
            uniforms = uniforms._replace(frame=jnp.uint32(frame))
            state, outputs = render_frame(
                accel, bundle.atlas, uniforms, config, state, mcfg
            )
            frame += 1
        jax.block_until_ready(outputs)
        out[name] = (time.perf_counter() - t0) / timed
    return out


def main():
    from merian_quake_tpu.accel.build import build_accel, scene_features
    from merian_quake_tpu.models.procedural import city
    from merian_quake_tpu.models.types import RenderConfig
    from merian_quake_tpu.render.mcpg import MCPGConfig
    from merian_quake_tpu.render.mcpg.config import production_config
    from merian_quake_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    width, height, spp, mpl = 1920, 1080, 2, 3
    smoke = bool(os.environ.get("MQ_BENCH_SMOKE"))
    if smoke:
        # script-logic smoke test (tiny shapes, every row exercised):
        # validates the bench PATHS without the ~1080p compile bill
        width, height = 192, 108
    bundle = city()
    accel = build_accel(bundle.scene, bundle.atlas)
    config = RenderConfig(
        width=width,
        height=height,
        spp=spp,
        max_path_length=mpl,
        integrator="mcpg",
        features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas),
    )

    # one warm sequence, timed at three guiding-maturity phases:
    # cold (frame 2: chains empty, defensive/BSDF-heavy rays), the
    # r1-r3-continuity point (frame 12), steady state (frame 28)
    mcfg = MCPGConfig()
    if os.environ.get("MQ_SURF_BUDGET"):
        # live-lane compaction A/B knob: e.g. MQ_SURF_BUDGET=0.75,0.5 —
        # compiles a larger program
        mcfg = mcfg._replace(
            surf_live_budget=tuple(
                float(x)
                for x in os.environ["MQ_SURF_BUDGET"].split(",")
            )
        )
    ph = _bench_phases(
        bundle, accel, config, mcfg,
        {"cold": 2, "warm12": 12, "steady": 28}, timed=4,
    )
    dt = ph["warm12"]  # headline continuity with earlier rounds

    # reference default quality: 33.6M MC states + 4M light cache +
    # 2 spp volume single scattering w/ distance guiding
    # (default_config.json:626-660, render_mcpg.hpp:137-150)
    prod = production_config()
    dt_prod = _bench_phases(
        bundle, accel, config, prod, {"warm6": 6}, timed=3
    )["warm6"]

    # map-scale scene (~280k tris): the triangle count AD-class maps
    # have (BASELINE configs 4-5); light config
    mega = city(n_buildings=2500 if smoke else 28000, seed=11)
    accel_m = build_accel(mega.scene, mega.atlas)
    config_m = config._replace(
        features=scene_features(mega.scene, mega.uniforms, mega.atlas)
    )
    dt_mega = _bench_phases(
        mega, accel_m, config_m, mcfg, {"warm6": 6}, timed=3
    )["warm6"]

    # LIVE map-scale row: the FULL per-frame
    # loop — native game step (QuakeC monsters) + entity extraction +
    # incremental accel refresh (BLAS-refit equivalent) + render — on
    # the AD-scale dungeon (~290k tris, ~200 lights), the path real
    # AD-class maps take (quake_node.cpp:896-1012 under entity load)
    import time as _time

    from merian_quake_tpu.accel.build import (
        build_accel_live, refresh_dynamic,
    )
    from merian_quake_tpu.game.bigmap import make_bigmap
    from merian_quake_tpu.renderer import init_state, render_frame

    live, _d = make_bigmap(grid=3, monsters=4) if smoke else make_bigmap()
    la = build_accel_live(
        live.gs.static_bundle, dyn_cap=live.gs.dynamic_capacity
    )
    feats_live = scene_features(
        live.gs.static_bundle.scene, live.gs.static_bundle.uniforms,
        live.gs.static_bundle.atlas,
    )._replace(has_alpha_tris=True, has_fb=True, has_emissive_tex=True)
    cfg_live = config._replace(features=feats_live)
    state_live = init_state(cfg_live, mcfg)
    n_live_tris = int(la.accel.scene.num_tris)
    dt_step = dt_refresh = 0.0
    for i in range(7):
        t0 = _time.perf_counter()
        dyn, uniforms_live = live.step_dynamic(
            dt=1.0 / 30.0, forward=120.0, yaw=25.0 + 2.0 * i
        )
        t1 = _time.perf_counter()
        la = refresh_dynamic(la, dyn)
        t2 = _time.perf_counter()
        state_live, out_live = render_frame(
            la.accel, live.gs.static_bundle.atlas, uniforms_live,
            cfg_live, state_live, mcfg,
        )
        jax.block_until_ready(out_live)
        if i >= 4:  # steady frames only
            dt_step += t1 - t0
            dt_refresh += t2 - t1
    t0 = _time.perf_counter()
    timed_live = 3
    for i in range(timed_live):
        dyn, uniforms_live = live.step_dynamic(
            dt=1.0 / 30.0, forward=120.0, yaw=40.0 + 2.0 * i
        )
        la = refresh_dynamic(la, dyn)
        state_live, out_live = render_frame(
            la.accel, live.gs.static_bundle.atlas, uniforms_live,
            cfg_live, state_live, mcfg,
        )
    jax.block_until_ready(out_live)
    dt_live = (_time.perf_counter() - t0) / timed_live

    # ray segments per frame: 1 primary + spp × (mpl - 1) bounce rays
    rays = width * height * (1 + spp * (mpl - 1))
    rays_prod = rays + width * height * prod.volume.volume_spp
    mrays_per_s = rays / dt / 1e6
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "mcpg_ray_throughput_1080p_17k_tris_single_chip",
                "value": round(mrays_per_s, 2),
                "unit": "Mrays/s",
                "detail": {
                    "frame_ms": round(dt * 1000, 2),
                    "cold_frame_ms": round(ph["cold"] * 1000, 2),
                    "steady_frame_ms": round(ph["steady"] * 1000, 2),
                    "steady_mrays_per_s": round(
                        rays / ph["steady"] / 1e6, 2
                    ),
                    "resolution": f"{width}x{height}",
                    "spp": spp,
                    "max_path_length": mpl,
                    "integrator": "mcpg",
                    "scene": "procedural city (~17k tris, sky+sun+emissives)",
                    "triangles": int(accel.scene.num_tris),
                    "device": {
                        "platform": dev.platform,
                        "kind": dev.device_kind,
                        "count": len(jax.devices()),
                    },
                    "map_scale": {
                        "frame_ms": round(dt_mega * 1000, 2),
                        "mrays_per_s": round(rays / dt_mega / 1e6, 2),
                        "triangles": int(accel_m.scene.num_tris),
                    },
                    "live_scale": {
                        "frame_ms": round(dt_live * 1000, 2),
                        "mrays_per_s": round(rays / dt_live / 1e6, 2),
                        "triangles": n_live_tris,
                        "game_step_ms": round(dt_step / 3 * 1000, 2),
                        "accel_refresh_ms": round(
                            dt_refresh / 3 * 1000, 2
                        ),
                        "path": (
                            "live dungeon: QuakeC step + extraction + "
                            "dynamic accel refresh + render"
                        ),
                    },
                    "production_scale": {
                        "frame_ms": round(dt_prod * 1000, 2),
                        "mrays_per_s": round(rays_prod / dt_prod / 1e6, 2),
                        "mc_states": prod.mc_total_size,
                        "light_cache": prod.lc_size,
                        "volume_spp": prod.volume.volume_spp,
                        "dist_guide_p": prod.volume.dist_guide_p,
                    },
                },
            }
        )
    )


if __name__ == "__main__":
    main()
