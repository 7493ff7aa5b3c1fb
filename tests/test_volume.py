"""Volume single-scattering tests."""
import jax.numpy as jnp
import numpy as np

from merian_quake_tpu.models.procedural import get_scene
from merian_quake_tpu.models.types import RenderConfig
from merian_quake_tpu.render.mcpg import MCPGConfig
from merian_quake_tpu.render.mcpg.volume import VolumeConfig, _normal_dist
from merian_quake_tpu.renderer import render_sequence

import pytest

# compile-heavy integration tier: run with the full suite (pytest tests/);
# the core tier is pytest -m 'not slow'
pytestmark = pytest.mark.slow


def _run(mu_t, frames=3, seed=1337, spp=1):
    cfg = RenderConfig(width=40, height=24, spp=1, integrator="mcpg", seed=seed)
    mcfg = MCPGConfig(volume=VolumeConfig(volume_spp=spp))
    bundle = get_scene("box")
    u = bundle.uniforms._replace(
        mu_t=jnp.float32(mu_t), mu_s=jnp.full((3,), mu_t * 0.8)
    )
    bundle = bundle._replace(uniforms=u)
    return render_sequence(bundle, cfg, frames=frames, mcpg_config=mcfg)


def test_volume_scales_with_fog_density():
    st0, _ = _run(0.0)
    st1, _ = _run(0.0004)
    st2, _ = _run(0.0008)
    v0 = float(np.asarray(st0.accum_volume[..., :3]).mean())
    v1 = float(np.asarray(st1.accum_volume[..., :3]).mean())
    v2 = float(np.asarray(st2.accum_volume[..., :3]).mean())
    assert v0 == 0.0
    assert v2 > v1 > 0.0
    # optically thin (mu_t·z ≈ 0.1..0.25): in-scatter ≈ linear in mu_s
    assert 1.4 < v2 / v1 < 2.9, (v1, v2)


def test_volume_finite_and_depth_learned():
    st, out = _run(0.004, frames=6)
    vol = np.asarray(st.accum_volume)
    assert np.isfinite(vol).all()
    depth = np.asarray(st.volume.volume_depth)
    lz = np.asarray(out["gbuffer"].linear_z)
    # expected scatter depth lies within (0, surface depth]
    assert (depth > 0).all()
    assert (depth <= lz + 1.0).all()
    # distance chains learn where scattering found light
    assert int((np.asarray(st.volume.dist_mc.sum_w) > 0).sum()) > 0


def test_normal_dist_regularizer():
    sw = jnp.asarray([2.0])
    mm = jnp.asarray([[2.0 * 100.0, 2.0 * (100.0**2 + 25.0)]])  # mu=100 var=25
    mu, sigma = _normal_dist(sw, jnp.asarray([1000]), mm)
    np.testing.assert_allclose(float(mu[0]), 100.0, rtol=1e-5)
    np.testing.assert_allclose(float(sigma[0]), 5.0, rtol=0.01)
    # tiny N → prior dominates → sigma pulled toward 0.2/0.2 scale
    mu2, sigma2 = _normal_dist(sw, jnp.asarray([0]), mm)
    assert float(sigma2[0]) < 2.0


def test_volume_reprojected_accumulate_beats_plain_under_motion():
    """VERDICT r2 #4: the volume accumulate follows volume motion
    vectors (default_config.json:298-304). With a translating camera,
    reprojected accumulation of the captured per-frame volume images
    must track the fog field better than a plain (ghosting) blend."""
    import jax

    from merian_quake_tpu.accel.build import build_accel, scene_features
    from merian_quake_tpu.models.procedural import cornell_box
    from merian_quake_tpu.post.accumulate import accumulate_reprojected
    from merian_quake_tpu.renderer import init_state, render_frame

    bundle = cornell_box()
    cfg = RenderConfig(
        width=48, height=32, spp=1, integrator="mcpg", seed=7,
        max_path_length=2,
    )
    mcfg = MCPGConfig(
        mc_adaptive_size=1 << 10, mc_static_size=1 << 8, lc_size=1 << 10,
        volume=VolumeConfig(volume_spp=2),
    )
    accel = build_accel(bundle.scene, bundle.atlas)
    u0 = bundle.uniforms._replace(
        mu_t=jnp.float32(0.004), mu_s=jnp.full((3,), 0.0032)
    )
    cfg = cfg._replace(features=scene_features(bundle.scene, u0, bundle.atlas))

    # camera slides sideways (+y) 12 units/frame
    def cam_at(i):
        return u0.cam_x + jnp.asarray([0.0, 12.0 * i, 0.0])

    frames = 5
    state = init_state(cfg, mcfg)
    vols, mvs = [], []
    for i in range(frames):
        u = u0._replace(
            cam_x=cam_at(i), prev_cam_x=cam_at(i - 1),
            frame=jnp.uint32(i),
        )
        state, out = render_frame(
            accel, bundle.atlas, u, cfg, state, mcpg_config=mcfg
        )
        vols.append(np.asarray(out["volume"]))
        mvs.append(np.asarray(out["volume_mv"]))

    # unbiased estimate of the FINAL camera's volume field
    truth = np.zeros_like(vols[0][..., :3])
    n_ref = 6
    for j in range(n_ref):
        # fresh state + distinct frame index = independent RNG stream
        # with the same compiled executable (seed would be a static
        # recompile)
        st = init_state(cfg, mcfg)
        u = u0._replace(
            cam_x=cam_at(frames - 1), prev_cam_x=cam_at(frames - 1),
            frame=jnp.uint32(1000 + 37 * j),
        )
        st, out = render_frame(
            accel, bundle.atlas, u, cfg, st, mcpg_config=mcfg
        )
        truth += np.asarray(out["volume"])[..., :3] / n_ref

    plain = np.mean([v[..., :3] for v in vols], axis=0)
    acc = jnp.zeros_like(jnp.asarray(vols[0]))
    n = jnp.zeros(vols[0].shape[:2])
    for v, mv in zip(vols, mvs):
        acc, n = accumulate_reprojected(acc, n, jnp.asarray(v), jnp.asarray(mv))
    repro = np.asarray(acc)[..., :3]

    err_plain = float(np.abs(plain - truth).mean())
    err_repro = float(np.abs(repro - truth).mean())
    assert err_repro < err_plain, (err_repro, err_plain)
