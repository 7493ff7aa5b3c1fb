"""SSMM tests: chain update math + end-to-end variance reduction."""
import jax.numpy as jnp
import numpy as np

from merian_quake_tpu.models.procedural import get_scene
from merian_quake_tpu.models.types import RenderConfig
from merian_quake_tpu.render.ssmm import SSMMConfig, init_ssmm_state
from merian_quake_tpu.render.ssmm.ssmm import _state_add, _state_new, _state_vmf
from merian_quake_tpu.renderer import render_sequence

import pytest

# compile-heavy integration tier: run with the full suite (pytest tests/);
# the core tier is pytest -m 'not slow'
pytestmark = pytest.mark.slow

CFG = SSMMConfig()


def test_state_add_learns_direction():
    s = _state_new(4)
    x = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 0.0]), (4, 3))
    y = jnp.broadcast_to(jnp.asarray([100.0, 0.0, 0.0]), (4, 3))
    d = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (4, 3))
    for _ in range(20):
        s = _state_add(s, x, jnp.full((4,), 2.0), d, y, CFG)
    mu, kappa = _state_vmf(s, x, CFG)
    np.testing.assert_allclose(np.asarray(mu[0]), [1.0, 0.0, 0.0], atol=1e-4)
    assert float(kappa[0]) > 50.0  # consistent samples → sharp lobe
    assert int(s.N[0]) == 20


def test_state_add_mixed_directions_low_kappa():
    s = _state_new(1)
    x = jnp.zeros((1, 3))
    for i in range(40):
        sign = 1.0 if i % 2 == 0 else -1.0
        y = jnp.asarray([[0.0, sign * 100.0, 1.0]])
        d = jnp.asarray([[0.0, sign, 0.0]])
        s = _state_add(s, x, jnp.ones((1,)), d, y, CFG)
    _, kappa = _state_vmf(s, x, CFG)
    assert float(kappa[0]) < 5.0  # alternating targets → diffuse lobe


def test_ssmm_end_to_end_unbiased_and_lower_noise():
    W, H = 40, 24
    cfg_pt = RenderConfig(width=W, height=H, spp=4, max_path_length=2, seed=5)
    st_pt, _ = render_sequence(get_scene("box"), cfg_pt, frames=12)
    ref = np.asarray(st_pt.accum_irradiance[..., :3])

    cfg = RenderConfig(width=W, height=H, spp=2, seed=7, integrator="ssmm")
    st, out = render_sequence(get_scene("box"), cfg, frames=12)
    est = np.asarray(st.accum_irradiance[..., :3])
    assert np.isfinite(est).all()
    # mean within 15% (the reference's SMIS denominator is conservative
    # when spp < smis_group_size, darkening slightly — mirrored here)
    assert abs(est.mean() - ref.mean()) / ref.mean() < 0.15
    # guiding beats plain PT at equal spp on relMSE
    cfg_b = RenderConfig(width=W, height=H, spp=2, max_path_length=2, seed=7)
    st_b, _ = render_sequence(get_scene("box"), cfg_b, frames=12)
    base = np.asarray(st_b.accum_irradiance[..., :3])
    rel = lambda e: float(((e - ref) ** 2 / (ref**2 + 1e-2)).mean())
    assert rel(est) < rel(base), (rel(est), rel(base))
    # learned state persists
    assert float(np.asarray(st.ssmm.sum_w).max()) > 0.0
