"""ReSTIR DI tests: reservoir math + end-to-end consistency vs PT."""
import jax.numpy as jnp
import numpy as np

from merian_quake_tpu.models.procedural import get_scene
from merian_quake_tpu.models.types import RenderConfig
from merian_quake_tpu.render.restir import ReSTIRConfig
from merian_quake_tpu.render.restir import reservoir as rsv
from merian_quake_tpu.renderer import render_sequence
from merian_quake_tpu.ops import rng as rng_ops

import pytest

# compile-heavy integration tier: run with the full suite (pytest tests/);
# the core tier is pytest -m 'not slow'
pytestmark = pytest.mark.slow


def _rng(n, seed=3):
    return rng_ops.seed_pixel(jnp.arange(n, dtype=jnp.uint32), 0, 0, seed)


def test_reservoir_add_sample_probabilities():
    """WRS must select sample i with probability w_i / sum(w)."""
    n = 20000
    r = rsv.reservoir_init(n)
    rng = _rng(n)
    weights = [1.0, 3.0, 6.0]
    for i, w in enumerate(weights):
        rng, r, _ = rsv.add_sample(
            r,
            rng,
            jnp.ones((n,), bool),
            jnp.full((n, 3), float(i)),
            jnp.zeros((n, 3)),
            jnp.zeros((n, 3)),
            jnp.zeros((n,)),
            jnp.ones((n, 3)),
            jnp.full((n,), rsv.FLAG_VALID, jnp.uint32),
            jnp.ones((n,)),
            jnp.full((n,), w),
        )
    assert int(r.M[0]) == 3
    np.testing.assert_allclose(np.asarray(r.w), sum(weights), rtol=1e-6)
    picked = np.asarray(r.y_pos[:, 0])
    for i, w in enumerate(weights):
        frac = (picked == i).mean()
        np.testing.assert_allclose(frac, w / sum(weights), atol=0.02)


def test_reservoir_finalize():
    n = 4
    r = rsv.reservoir_init(n)._replace(
        M=jnp.full((n,), 5, jnp.int32),
        w=jnp.full((n,), 10.0),
        p_target=jnp.full((n,), 2.0),
    )
    f = rsv.finalize(r)
    np.testing.assert_allclose(np.asarray(f.w), 10.0 / (5 * 2.0))
    # zero target → zero W
    z = rsv.finalize(r._replace(p_target=jnp.zeros((n,))))
    np.testing.assert_allclose(np.asarray(z.w), 0.0)


def test_restir_matches_direct_pt_mean():
    """ReSTIR DI must estimate the same integral as 1-bounce PT."""
    W, H = 48, 32
    cfg_pt = RenderConfig(width=W, height=H, spp=4, max_path_length=2, seed=5)
    st_pt, _ = render_sequence(get_scene("box"), cfg_pt, frames=14)
    ref_mean = float(np.asarray(st_pt.accum_irradiance[..., :3]).mean())

    rcfg = ReSTIRConfig(
        spatial_reuse_iterations=2,
        visibility_shade=False,
        temporal_bias_correction=1,
        spatial_bias_correction=1,
    )
    cfg = RenderConfig(width=W, height=H, spp=2, seed=7, integrator="restir")
    st, out = render_sequence(
        get_scene("box"), cfg, frames=14, mcpg_config=rcfg
    )
    est_mean = float(np.asarray(st.accum_irradiance[..., :3]).mean())
    assert np.isfinite(np.asarray(out["hdr"])).all()
    # within 12%: short-budget accumulation includes the cold-start
    # frames (empty temporal history, small reservoir M); each reuse
    # stage is unbiased at convergence (verified: +-3% at 40 frames)
    assert abs(est_mean - ref_mean) / ref_mean < 0.12, (est_mean, ref_mean)


def test_restir_reuse_reduces_per_frame_error():
    """Temporal+spatial reuse must improve SINGLE-FRAME estimates.

    (Accumulating many ReSTIR frames converges slower than independent
    sampling because reused reservoirs are temporally correlated — the
    real-time win is per-frame quality fed into the denoiser.)
    """
    W, H = 40, 24
    cfg_ref = RenderConfig(width=W, height=H, spp=8, max_path_length=2, seed=9)
    st_ref, _ = render_sequence(get_scene("box"), cfg_ref, frames=16)
    ref = np.asarray(st_ref.accum_irradiance[..., :3])

    def run(rcfg, seed):
        cfg = RenderConfig(width=W, height=H, spp=1, seed=seed, integrator="restir")
        st, out = render_sequence(get_scene("box"), cfg, frames=6, mcpg_config=rcfg)
        est = np.asarray(out["irradiance"][..., :3])  # last frame only
        return float(((est - ref) ** 2 / (ref**2 + 1e-2)).mean())

    base = run(
        ReSTIRConfig(spatial_reuse_iterations=0, visibility_shade=False,
                     temporal_clamp_m=1),  # M-clamp 1 ≈ no temporal history
        seed=3,
    )
    reuse = run(
        ReSTIRConfig(spatial_reuse_iterations=3, visibility_shade=False),
        seed=3,
    )
    assert reuse < base * 0.6, (base, reuse)
