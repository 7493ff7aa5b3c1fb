"""Pixel-grid sharding: sharded render must match single-device exactly."""
import jax
import numpy as np

from merian_quake_tpu.accel.build import build_accel
from merian_quake_tpu.models.procedural import cornell_box
from merian_quake_tpu.models.types import RenderConfig
from merian_quake_tpu.parallel.render import (
    init_state_sharded,
    make_mesh,
    render_frame_sharded,
)
from merian_quake_tpu.renderer import init_state, render_frame

import pytest

# compile-heavy integration tier: run with the full suite (pytest tests/);
# the core tier is pytest -m 'not slow'
pytestmark = pytest.mark.slow


def test_sharded_matches_single_device():
    assert len(jax.devices()) >= 8
    bundle = cornell_box()
    accel = build_accel(bundle.scene, bundle.atlas)
    config = RenderConfig(width=48, height=32, spp=1, max_path_length=3)

    state_1 = init_state(config)
    state_1, out_1 = render_frame(
        accel, bundle.atlas, bundle.uniforms, config, state_1
    )

    mesh = make_mesh(8)
    state_8 = init_state_sharded(mesh, config)
    state_8, ldr_8, hdr_8 = render_frame_sharded(
        mesh, accel, bundle.atlas, bundle.uniforms, config, state_8
    )

    np.testing.assert_allclose(
        np.asarray(ldr_8), np.asarray(out_1["ldr"]), atol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(state_8.accum_irradiance),
        np.asarray(state_1.accum_irradiance),
        atol=2e-6,
    )


def test_dryrun_multichip_entrypoint():
    import sys, pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import __graft_entry__ as g

    g.dryrun_multichip(4)


def test_sharded_denoise_matches_single_device():
    """The full beauty pipeline (SVGF temporal + à-trous halos + TAA +
    FXAA) under shard_map must match single-device: halo rows are the
    neighbors' true rows, image borders replicate (clamp semantics),
    reprojection gathers the same full history. The CONTINUOUS chain
    (svgf state, pre-FXAA hdr) is compared tightly; the final ldr is
    allowed rare local flips where FXAA's discrete edge branches
    amplify f32 reassociation noise between the two XLA programs (the
    same effect appears between jitted and eager single-device runs)."""
    import jax.numpy as jnp

    bundle = cornell_box()
    accel = build_accel(bundle.scene, bundle.atlas)
    # 64 rows / 8 shards = 8-row slabs: à-trous steps 1 and 2 use halo
    # exchange, steps 4+ exercise the gather-and-slice fallback
    config = RenderConfig(
        width=48, height=64, spp=1, max_path_length=2, denoise=True
    )

    state_1 = init_state(config)
    mesh = make_mesh(8)
    state_8 = init_state_sharded(mesh, config)
    u = bundle.uniforms
    for i in range(3):  # multiple frames: temporal/TAA history in play
        u = u._replace(frame=jnp.uint32(i))
        state_1, out_1 = render_frame(accel, bundle.atlas, u, config, state_1)
        state_8, ldr_8, hdr_8 = render_frame_sharded(
            mesh, accel, bundle.atlas, u, config, state_8
        )
    np.testing.assert_allclose(
        np.asarray(hdr_8), np.asarray(out_1["hdr"]), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(state_8.svgf.irr), np.asarray(state_1.svgf.irr), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(state_8.svgf.history_len),
        np.asarray(state_1.svgf.history_len),
    )
    ldr_d = np.abs(np.asarray(ldr_8) - np.asarray(out_1["ldr"]))
    assert (ldr_d > 1e-3).mean() < 0.02, (ldr_d > 1e-3).mean()
    assert ldr_d.max() < 0.1, ldr_d.max()


def test_sharded_mcpg_volume_matches_single_device():
    """MCPG + single-scattering volume under shard_map: distance-MC
    queue all-gathered and replayed identically, forward projection on
    the gathered depth image — matches single-device."""
    import jax.numpy as jnp

    from merian_quake_tpu.accel.build import scene_features
    from merian_quake_tpu.render.mcpg import MCPGConfig
    from merian_quake_tpu.render.mcpg.volume import VolumeConfig

    bundle = cornell_box()
    accel = build_accel(bundle.scene, bundle.atlas)
    uniforms = bundle.uniforms._replace(
        mu_t=jnp.float32(0.004), mu_s=jnp.full((3,), 0.0032)
    )
    config = RenderConfig(
        width=48, height=16, spp=1, max_path_length=2, integrator="mcpg",
        features=scene_features(bundle.scene, uniforms, bundle.atlas),
    )
    mcfg = MCPGConfig(
        mc_adaptive_size=1 << 12, mc_static_size=1 << 10, lc_size=1 << 12,
        volume=VolumeConfig(volume_spp=2, dist_guide_p=0.5),
    )
    mesh = make_mesh(8)
    st8 = init_state_sharded(mesh, config, mcfg)
    st1 = init_state(config, mcfg)
    u = uniforms
    for i in range(2):
        u = u._replace(frame=jnp.uint32(i))
        st8, ldr8, hdr8 = render_frame_sharded(
            mesh, accel, bundle.atlas, u, config, st8, mcfg
        )
        st1, out1 = render_frame(accel, bundle.atlas, u, config, st1, mcfg)
    np.testing.assert_allclose(
        np.asarray(ldr8), np.asarray(out1["ldr"]), atol=3e-5
    )
    np.testing.assert_allclose(
        np.asarray(st8.volume.dist_mc.sum_w),
        np.asarray(st1.volume.dist_mc.sum_w),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(st8.volume.volume_depth),
        np.asarray(st1.volume.volume_depth),
        atol=1e-3,
    )
    np.testing.assert_allclose(
        np.asarray(st8.accum_volume),
        np.asarray(st1.accum_volume),
        atol=3e-5,
    )
    # the volume really contributed (fog in-scatter non-zero)
    assert float(np.asarray(st8.accum_volume)[..., :3].max()) > 0.0


def test_sharded_restir_matches_single_device():
    """ReSTIR DI under shard_map: temporal reuse against the gathered
    previous frame, spatial neighbors + boiling tiles from gathered
    full images — matches single-device."""
    import jax.numpy as jnp

    from merian_quake_tpu.accel.build import scene_features
    from merian_quake_tpu.render.restir import ReSTIRConfig

    bundle = cornell_box()
    accel = build_accel(bundle.scene, bundle.atlas)
    config = RenderConfig(
        width=48, height=32, spp=1, integrator="restir",
        features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas),
    )
    rcfg = ReSTIRConfig(
        spatial_reuse_iterations=2,
        temporal_bias_correction=1,
        spatial_bias_correction=1,
        boiling_filter_strength=0.5,
        spatial_radius=8.0,
    )
    mesh = make_mesh(8)
    st8 = init_state_sharded(mesh, config, rcfg)
    st1 = init_state(config, rcfg)
    u = bundle.uniforms
    for i in range(3):  # temporal reuse crosses shard borders via mv
        u = u._replace(frame=jnp.uint32(i))
        st8, ldr8, hdr8 = render_frame_sharded(
            mesh, accel, bundle.atlas, u, config, st8, rcfg
        )
        st1, out1 = render_frame(accel, bundle.atlas, u, config, st1, rcfg)
    np.testing.assert_allclose(
        np.asarray(ldr8), np.asarray(out1["ldr"]), atol=3e-5
    )
    # reservoir weights: RIS accept thresholds are discrete — f32
    # reassociation between the two XLA programs may flip a handful of
    # stochastic reuse decisions (the image above still matches)
    w8 = np.asarray(st8.restir.reservoirs.w)
    w1 = np.asarray(st1.restir.reservoirs.w)
    close = np.abs(w8 - w1) <= 1e-4 + 1e-4 * np.abs(w1)
    assert close.mean() > 0.99, close.mean()
    assert float(np.asarray(st8.restir.reservoirs.M).max()) > 1


def test_sharded_ssmm_matches_single_device():
    """SSMM under shard_map: exact global proposal roll via ppermute,
    gathered previous-state neighborhood — matches single-device."""
    import jax.numpy as jnp

    from merian_quake_tpu.accel.build import scene_features
    from merian_quake_tpu.render.ssmm import SSMMConfig

    bundle = cornell_box()
    accel = build_accel(bundle.scene, bundle.atlas)
    config = RenderConfig(
        width=48, height=32, spp=2, integrator="ssmm",
        features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas),
    )
    scfg = SSMMConfig()
    mesh = make_mesh(8)
    st8 = init_state_sharded(mesh, config, scfg)
    st1 = init_state(config, scfg)
    u = bundle.uniforms
    for i in range(3):
        u = u._replace(frame=jnp.uint32(i))
        st8, ldr8, hdr8 = render_frame_sharded(
            mesh, accel, bundle.atlas, u, config, st8, scfg
        )
        st1, out1 = render_frame(accel, bundle.atlas, u, config, st1, scfg)
    np.testing.assert_allclose(
        np.asarray(ldr8), np.asarray(out1["ldr"]), atol=3e-5
    )
    np.testing.assert_allclose(
        np.asarray(st8.ssmm.sum_w), np.asarray(st1.ssmm.sum_w), atol=1e-4
    )
    assert float(np.asarray(st8.ssmm.sum_w).max()) > 0.0


def test_sharded_mcpg_matches_single_device():
    """Full MCPG training step over the mesh: all-gathered update
    queues keep the replicated guiding state bit-identical."""
    import jax.numpy as jnp

    from merian_quake_tpu.accel.build import scene_features
    from merian_quake_tpu.render.mcpg import MCPGConfig

    bundle = cornell_box()
    accel = build_accel(bundle.scene, bundle.atlas)
    config = RenderConfig(
        width=48, height=16, spp=1, max_path_length=2, integrator="mcpg",
        features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas),
    )
    mcfg = MCPGConfig(mc_adaptive_size=1 << 12, mc_static_size=1 << 10,
                      lc_size=1 << 12)
    mesh = make_mesh(8)
    st8 = init_state_sharded(mesh, config, mcfg)
    st1 = init_state(config, mcfg)
    u = bundle.uniforms
    for i in range(1):
        u = u._replace(frame=jnp.uint32(i))
        st8, ldr8, hdr8 = render_frame_sharded(
            mesh, accel, bundle.atlas, u, config, st8, mcfg
        )
        st1, out1 = render_frame(accel, bundle.atlas, u, config, st1, mcfg)
    np.testing.assert_allclose(
        np.asarray(ldr8), np.asarray(out1["ldr"]), atol=3e-5
    )
    np.testing.assert_allclose(
        np.asarray(st8.mcpg.mc.sum_w),
        np.asarray(st1.mcpg.mc.sum_w),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(st8.mcpg.lc.irr), np.asarray(st1.mcpg.lc.irr), atol=1e-5
    )


def test_restir_halo_matches_gather_and_single_device():
    """VERDICT r2 #6: the sharded ReSTIR neighbor reads use boundary-row
    halo exchange (not full-plane gathers) when the slab can carry the
    reuse radius. With a static camera (motion within the apron) the
    halo path must match both the gathered path and single-device."""
    import jax
    import jax.numpy as jnp

    from merian_quake_tpu.accel.build import scene_features
    from merian_quake_tpu.render.restir import ReSTIRConfig
    from merian_quake_tpu.render.restir import restir as restir_mod

    bundle = cornell_box()
    accel = build_accel(bundle.scene, bundle.atlas)
    config = RenderConfig(
        width=48, height=128, spp=1, integrator="restir",
        features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas),
    )
    rcfg = ReSTIRConfig(
        spatial_reuse_iterations=2,
        temporal_bias_correction=1,
        spatial_bias_correction=1,
        spatial_radius=4.0,  # r_halo = 16 = rows at 8 shards
    )
    mesh = make_mesh(8)

    def run_sharded():
        st8 = init_state_sharded(mesh, config, rcfg)
        u = bundle.uniforms
        for i in range(2):
            u = u._replace(frame=jnp.uint32(i))
            st8, ldr8, hdr8 = render_frame_sharded(
                mesh, accel, bundle.atlas, u, config, st8, rcfg
            )
        return np.asarray(ldr8), np.asarray(st8.restir.reservoirs.w)

    assert restir_mod.FORCE_GATHER is False
    ldr_h, w_h = run_sharded()  # halo path (rows=16 >= r_halo=16)
    restir_mod.FORCE_GATHER = True
    jax.clear_caches()  # FORCE_GATHER is read at trace time
    try:
        ldr_g, w_g = run_sharded()
    finally:
        restir_mod.FORCE_GATHER = False
        jax.clear_caches()
    np.testing.assert_allclose(ldr_h, ldr_g, atol=3e-5)
    close = np.abs(w_h - w_g) <= 1e-4 + 1e-4 * np.abs(w_g)
    assert close.mean() > 0.99, close.mean()

    st1 = init_state(config, rcfg)
    u = bundle.uniforms
    for i in range(2):
        u = u._replace(frame=jnp.uint32(i))
        st1, out1 = render_frame(accel, bundle.atlas, u, config, st1, rcfg)
    np.testing.assert_allclose(
        ldr_h, np.asarray(out1["ldr"]), atol=3e-5
    )
