#!/usr/bin/env python3
"""Smoke run of the renderer's main path on NVIDIA GPUs, at full width.

    python chip_smoke.py              # one card: phases 1-4
    python chip_smoke.py --devices 4  # four cards: phase 5 only

1. Device check: every JAX device is a GPU (no CPU fallback).
2. Traversal: the cluster sweep kernel, compiled for the card, against
   the dense oracle (``accel.intersect.intersect_oracle``) — all 1080p
   primary rays plus ~4M cosine-sampled bounce rays on the 17k-triangle
   ``city``, and 256k rays on the 281k-triangle ``city(28000, seed=11)``;
   nearest and any-hit, with both sides' times.
3. The flagship frame: ``city``, 1920×1080 MCPG, 2 spp, path length 3,
   default ``MCPGConfig``, 8 frames through ``renderer.render_frame``.
4. The live loop at 1080p on ``game.bigmap.make_bigmap()`` (313k
   triangles, 32 monsters): QuakeC step + ``accel.build.refresh_dynamic``
   + ``render_frame``, 4 frames.
5. (``--devices N`` only) ``parallel.render.render_frame_sharded`` over
   ``make_mesh(N)`` at 1080p MCPG against single-device ``render_frame``.

Every phase must pass; a failure exits non-zero. Numbers are printed
beside the card's name and power limit. The last stdout line is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

TOL_AGREE = 0.9999  # share of rays on which sweep and oracle agree
T_RTOL, T_ATOL = 1e-5, 1e-3
WIDTH, HEIGHT = 1920, 1080
MEGA = dict(n_buildings=28000, seed=11)  # the 281k-triangle city
MEGA_RAYS = (512, 256)  # primary image; as many bounce rays follow
BIGMAP = {}  # make_bigmap() arguments: the full 313k-triangle dungeon


def card() -> str:
    """'name, power limit' of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0].strip()


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def wall(fn, *args, reps: int = 3):
    """(result, first-call s, median ms of ``reps`` warm calls)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, first, 1e3 * statistics.median(ts)


def device_check(n: int):
    devs = jax.devices()
    check(len(devs) >= n, f"need {n} GPUs, JAX sees {len(devs)}")
    check(
        all(d.platform == "gpu" for d in devs),
        f"JAX devices are not GPUs: {[d.platform for d in devs]}",
    )
    return devs


def primary_rays(uniforms, width, height):
    from merian_quake_tpu.ops import camera
    from merian_quake_tpu.render import layout

    px, py = layout.gen_pixels(width, height)
    d = camera.ray_dir(
        px.astype(jnp.float32), py.astype(jnp.float32), width, height,
        uniforms.cam_u, uniforms.cam_w, uniforms.fov_tan_half,
    )
    return jnp.broadcast_to(uniforms.cam_x, d.shape), d


@jax.jit
def bounce_rays(accel, o, d, t, tri, key):
    """Cosine-sampled bounce rays from the hits of (o, d); rays whose
    parent missed get an empty interval (t_max = -1), as dead lanes do
    in the integrators."""
    hit = tri >= 0
    soa = accel.tri_soa.transpose(0, 2, 1).reshape(-1, 9)
    e = jnp.take(soa, jnp.maximum(tri, 0), axis=0)
    n = jnp.cross(e[:, 3:6], e[:, 6:9])
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    n = jnp.where(jnp.sum(n * d, -1, keepdims=True) > 0, -n, n)
    p = o + jnp.where(hit, t, 0.0)[:, None] * d + 1e-2 * n
    u1, u2 = jax.random.uniform(key, (2,) + t.shape)
    r, phi = jnp.sqrt(u1), 2.0 * jnp.pi * u2
    a = jnp.where(jnp.abs(n[:, :1]) > 0.9, jnp.array([0.0, 1.0, 0.0]),
                  jnp.array([1.0, 0.0, 0.0]))
    b1 = jnp.cross(n, a)
    b1 = b1 / jnp.linalg.norm(b1, axis=-1, keepdims=True)
    b2 = jnp.cross(n, b1)
    w = (r * jnp.cos(phi))[:, None] * b1 + (r * jnp.sin(phi))[:, None] * b2
    w = w + jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))[:, None] * n
    return p, w, jnp.where(hit, 1e4, -1.0)


def compare_nearest(name, got, ref, tag):
    kt, ktri = np.asarray(got[0]), np.asarray(got[1])
    rt, rtri = np.asarray(ref.t), np.asarray(ref.tri)
    kh, rh = ktri >= 0, rtri >= 0
    both = kh & rh
    t_bad = both & ~(np.abs(kt - rt) <= T_ATOL + T_RTOL * np.abs(rt))
    ties = both & (ktri != rtri) & ~t_bad
    bad = int((kh != rh).sum() + t_bad.sum())
    agree = 1.0 - bad / kt.size
    log(
        f"  {name}: rays={kt.size} hits={int(rh.sum())} "
        f"hit_mismatch={int((kh != rh).sum())} t_out_of_tol={int(t_bad.sum())} "
        f"tri_ties={int(ties.sum())} agreement={agree:.6f} [{tag}]"
    )
    check(agree >= TOL_AGREE, f"{name}: sweep/oracle agreement {agree}")


def compare_any(name, occ, ref_occ, near_t, t_max, tag):
    """``near_t``: the oracle's nearest hit; a horizon that close to it is
    a tie."""
    occ, ref_occ = np.asarray(occ), np.asarray(ref_occ)
    tie = np.abs(np.asarray(near_t) - t_max) <= T_ATOL + T_RTOL * np.abs(t_max)
    diff = occ != ref_occ
    bad = int((diff & ~tie).sum())
    agree = 1.0 - bad / occ.size
    log(
        f"  {name}: rays={occ.size} occluded={int(ref_occ.sum())} "
        f"mismatch={int(diff.sum())} on_ties={int((diff & tie).sum())} "
        f"agreement={agree:.6f} [{tag}]"
    )
    check(agree >= TOL_AGREE, f"{name}: any-hit agreement {agree}")


def phase_traversal(tag):
    from merian_quake_tpu.accel import build_accel, sweep
    from merian_quake_tpu.accel.build import MASK_CANDIDATE, MASK_OCCLUDER
    from merian_quake_tpu.accel.intersect import intersect_oracle
    from merian_quake_tpu.models.procedural import city

    @jax.jit
    def oracle(accel, o, d, t_min, t_max, mask):
        return intersect_oracle(accel, o, d, t_min, t_max, mask=mask)

    nearest = jax.jit(lambda acc, o, d, t0, t1: sweep.sweep_nearest(
        acc, o, d, t0, t1, bit=MASK_CANDIDATE))
    anyhit = jax.jit(lambda acc, o, d, t0, t1: sweep.sweep_any(
        acc, o, d, t0, t1, bit=MASK_OCCLUDER))
    mask_c = jnp.int32(MASK_CANDIDATE)
    mask_o = jnp.int32(MASK_OCCLUDER)

    def run(label, acc, o, d, t_min, t_max, key):
        got, first, ms = wall(nearest, acc, o, d, t_min, t_max)
        log(f"  {label} nearest: sweep first call {first:.2f} s, "
            f"{ms:.3f} ms [{tag}]")
        # the oracle has no matmul; "highest" only pins that down
        with jax.default_matmul_precision("highest"):
            ref, ofirst, oms = wall(oracle, acc, o, d, t_min, t_max, mask_c,
                                    reps=1)
        log(f"  {label} nearest: oracle first call {ofirst:.2f} s, "
            f"{oms:.3f} ms, sweep speedup x{oms / ms:.1f} [{tag}]")
        compare_nearest(f"{label} nearest", got, ref, tag)
        # any-hit horizons around the nearest hit: half occluded
        u = jax.random.uniform(key, t_max.shape, minval=0.5, maxval=1.5)
        th = jnp.where(ref.tri >= 0, ref.t * u, 1e4)
        occ, first, ms = wall(anyhit, acc, o, d, t_min, th)
        with jax.default_matmul_precision("highest"):
            ref_o, _, oms = wall(oracle, acc, o, d, t_min, th, mask_o, reps=1)
        log(f"  {label} any-hit: sweep {ms:.3f} ms, oracle {oms:.3f} ms, "
            f"speedup x{oms / ms:.1f} [{tag}]")
        compare_any(f"{label} any-hit", occ, ref_o.hit, ref.t,
                    np.asarray(th), tag)
        return got

    key = jax.random.PRNGKey(0)
    bundle = city()
    acc = build_accel(bundle.scene, bundle.atlas)
    log(f" city: {acc.scene.num_tris} triangles, {acc.num_clusters} clusters")
    o, d = primary_rays(bundle.uniforms, WIDTH, HEIGHT)
    n = o.shape[0]
    zero = jnp.zeros((n,), jnp.float32)
    far = jnp.full((n,), 1e4, jnp.float32)
    hit = run(f"city {WIDTH}x{HEIGHT} primary", acc, o, d, zero, far, key)
    o2 = jnp.concatenate([o, o])  # 2 bounce rays per pixel
    d2 = jnp.concatenate([d, d])
    t2 = jnp.concatenate([hit[0], hit[0]])
    tri2 = jnp.concatenate([hit[1], hit[1]])
    bo, bd, bt = bounce_rays(acc, o2, d2, t2, tri2, jax.random.PRNGKey(1))
    run("city bounce", acc, bo, bd, jnp.zeros_like(bt), bt,
        jax.random.PRNGKey(2))
    del acc, o, d, o2, d2, bo, bd

    mega = city(**MEGA)
    acc = build_accel(mega.scene, mega.atlas)
    log(f" city({MEGA}): {acc.scene.num_tris} triangles, "
        f"{acc.num_clusters} clusters")
    o, d = primary_rays(mega.uniforms, *MEGA_RAYS)
    zero = jnp.zeros((o.shape[0],), jnp.float32)
    hit = jax.block_until_ready(nearest(acc, o, d, zero, zero + 1e4))
    bo, bd, bt = bounce_rays(acc, o, d, hit[0], hit[1], jax.random.PRNGKey(3))
    o = jnp.concatenate([o, bo])
    d = jnp.concatenate([d, bd])
    t_max = jnp.concatenate([zero + 1e4, bt])
    run(f"city({MEGA['n_buildings']}) {o.shape[0] // 2**10}k",
        acc, o, d, jnp.zeros_like(t_max), t_max,
        jax.random.PRNGKey(4))


def flagship_config(bundle, **kw):
    from merian_quake_tpu.accel.build import scene_features
    from merian_quake_tpu.models.types import RenderConfig

    return RenderConfig(
        width=WIDTH, height=HEIGHT, spp=2, max_path_length=3, integrator="mcpg",
        features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas),
        **kw,
    )


def finite(out) -> bool:
    return bool(jnp.isfinite(out["ldr"]).all() & jnp.isfinite(out["hdr"]).all())


def phase_frame(tag, png):
    from merian_quake_tpu.accel import build_accel
    from merian_quake_tpu.models.procedural import city
    from merian_quake_tpu.render.mcpg import MCPGConfig
    from merian_quake_tpu.renderer import init_state, render_frame
    from merian_quake_tpu.utils.image import save_png

    bundle = city()
    accel = build_accel(bundle.scene, bundle.atlas)
    config, mcfg = flagship_config(bundle), MCPGConfig()
    state = init_state(config, mcfg)
    times = []
    for i in range(8):
        u = bundle.uniforms._replace(frame=jnp.uint32(i))
        t0 = time.perf_counter()
        state, out = render_frame(accel, bundle.atlas, u, config, state, mcfg)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    check(finite(out), "city frame: non-finite output")
    check(int(state.iteration) == 8, f"iteration {int(state.iteration)} != 8")
    warm = 1e3 * statistics.median(times[1:])
    log(f"  city {WIDTH}x{HEIGHT} MCPG: cold {times[0]:.1f} s (compile + frame), "
        f"warm {warm:.2f} ms/frame (median of 7), "
        f"ldr mean {float(out['ldr'].mean()):.4f} [{tag}]")
    save_png(png, np.asarray(out["ldr"]))
    log(f"  wrote {png}")


def phase_live(tag):
    from merian_quake_tpu.accel.build import (
        build_accel_live, refresh_dynamic, scene_features,
    )
    from merian_quake_tpu.game.bigmap import make_bigmap
    from merian_quake_tpu.models.types import RenderConfig
    from merian_quake_tpu.render.mcpg import MCPGConfig
    from merian_quake_tpu.renderer import init_state, render_frame

    live, _ = make_bigmap(**BIGMAP)
    sb = live.gs.static_bundle
    la = build_accel_live(sb, dyn_cap=live.gs.dynamic_capacity)
    feats = scene_features(sb.scene, sb.uniforms, sb.atlas)._replace(
        has_alpha_tris=True, has_fb=True, has_emissive_tex=True
    )
    config = RenderConfig(
        width=WIDTH, height=HEIGHT, spp=2, max_path_length=3,
        integrator="mcpg", features=feats,
    )
    mcfg = MCPGConfig()
    state = init_state(config, mcfg)
    log(f" bigmap: {la.accel.scene.num_tris} triangles")
    for i in range(4):
        t0 = time.perf_counter()
        dyn, uniforms = live.step_dynamic(
            dt=1.0 / 30.0, forward=120.0, yaw=25.0 + 2.0 * i
        )
        t1 = time.perf_counter()
        la = refresh_dynamic(la, dyn)
        jax.block_until_ready(la.accel)
        t2 = time.perf_counter()
        state, out = render_frame(
            la.accel, sb.atlas, uniforms, config, state, mcfg
        )
        jax.block_until_ready(out)
        t3 = time.perf_counter()
        check(finite(out), f"live frame {i}: non-finite output")
        log(f"  live frame {i}: game step {1e3 * (t1 - t0):.2f} ms, "
            f"refresh {1e3 * (t2 - t1):.2f} ms, render {1e3 * (t3 - t2):.2f} ms"
            f"{' (incl. compile)' if i == 0 else ''}, "
            f"dynamic tris {int(dyn['valid'].sum())} [{tag}]")
    check(int(state.iteration) == 4, f"iteration {int(state.iteration)} != 4")


def phase_sharded(n, tag):
    from merian_quake_tpu.accel import build_accel
    from merian_quake_tpu.models.procedural import city
    from merian_quake_tpu.parallel.render import (
        init_state_sharded, make_mesh, render_frame_sharded,
    )
    from merian_quake_tpu.render.mcpg import MCPGConfig
    from merian_quake_tpu.renderer import init_state, render_frame

    bundle = city()
    accel = build_accel(bundle.scene, bundle.atlas)
    mcfg = MCPGConfig()
    mesh = make_mesh(n)
    check(len(set(mesh.devices.flat)) == n, "mesh devices are not distinct")
    for denoise in (False, True):
        # frame 0 is compared (as in tests/test_parallel.py: later MCPG
        # frames amplify last-bit differences through the learned
        # guiding state); frames 1-3 time the sharded step
        config = flagship_config(bundle, denoise=denoise)
        u = bundle.uniforms
        s1, out1 = render_frame(
            accel, bundle.atlas, u, config, init_state(config, mcfg), mcfg
        )
        sn = init_state_sharded(mesh, config, mcfg)
        times = []
        for i in range(4):
            u = bundle.uniforms._replace(frame=jnp.uint32(i))
            t0 = time.perf_counter()
            sn, ldr, hdr = render_frame_sharded(
                mesh, accel, bundle.atlas, u, config, sn, mcfg
            )
            jax.block_until_ready((ldr, hdr))
            times.append(time.perf_counter() - t0)
            if i == 0:
                dh = np.abs(np.asarray(hdr) - np.asarray(out1["hdr"]))
                dl = np.abs(np.asarray(ldr) - np.asarray(out1["ldr"]))
        held = {s.device for s in hdr.addressable_shards}
        check(held == set(mesh.devices.flat), "output not spread over mesh")
        rows = {s.data.shape[0] for s in hdr.addressable_shards}
        check(rows == {HEIGHT // n}, f"shard rows {rows}")
        peaks = [
            (d.memory_stats() or {}).get("peak_bytes_in_use", 0) / 2**30
            for d in mesh.devices.flat
        ]
        log(f"  sharded x{n} denoise={denoise}: first call {times[0]:.1f} s, "
            f"warm {1e3 * statistics.median(times[1:]):.2f} ms/frame; frame 0 "
            f"vs single device: hdr bit-identical {bool((dh == 0).all())} "
            f"(max |diff| {dh.max():.3g}), ldr max |diff| {dl.max():.3g}, "
            f"ldr share > 1e-3 {(dl > 1e-3).mean():.5f}; peak GiB/device "
            f"{[round(p, 2) for p in peaks]} [{tag}]")
        if denoise:  # tests/test_parallel.py: sharded denoise tolerances
            check((dl > 1e-3).mean() < 0.02 and dl.max() < 0.1,
                  "sharded denoise ldr outside tolerance")
        else:  # a last-bit difference can reroute a few 3-bounce paths
            check((dl > 1e-3).mean() < 0.01 and dl.mean() < 1e-4,
                  "sharded ldr differs from single device")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="N > 1: run only the N-card sharded frame phase")
    ap.add_argument("--png", default=os.path.join(
        tempfile.gettempdir(), "chip_smoke_city.png"))
    args = ap.parse_args()

    devs = device_check(args.devices)
    tag = card()
    log(f"card: {tag}")
    log(f"phase 1 device check: OK, {len(devs)} x {devs[0].device_kind} "
        f"[{tag}]")

    from merian_quake_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    if args.devices > 1:
        log(f"phase 5 sharded {WIDTH}x{HEIGHT} MCPG on {args.devices} cards")
        phase_sharded(args.devices, tag)
    else:
        log("phase 2 traversal: cluster sweep vs oracle")
        phase_traversal(tag)
        log(f"phase 3 city {WIDTH}x{HEIGHT} MCPG frame")
        phase_frame(tag, args.png)
        log(f"phase 4 live bigmap loop at {WIDTH}x{HEIGHT}")
        phase_live(tag)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
