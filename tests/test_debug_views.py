"""Debug visualization tests (mcpg.comp:212-277; ReSTIR selector)."""
import jax.numpy as jnp
import numpy as np
import pytest

from merian_quake_tpu.accel.build import build_accel, scene_features
from merian_quake_tpu.models.procedural import cornell_box
from merian_quake_tpu.models.types import RenderConfig
from merian_quake_tpu.render.mcpg import MCPGConfig
from merian_quake_tpu.renderer import init_state, render_frame

import pytest

# compile-heavy integration tier: run with the full suite (pytest tests/);
# the core tier is pytest -m 'not slow'
pytestmark = pytest.mark.slow


def _render(integrator, frames=2):
    bundle = cornell_box()
    accel = build_accel(bundle.scene, bundle.atlas)
    config = RenderConfig(
        width=48, height=32, spp=1, max_path_length=3,
        integrator=integrator,
        features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas),
    )
    mcfg = (
        MCPGConfig(mc_adaptive_size=1 << 10, mc_static_size=1 << 8,
                   lc_size=1 << 10)
        if integrator == "mcpg" else None
    )
    state = init_state(config, mcfg)
    uniforms = bundle.uniforms
    for i in range(frames):
        uniforms = uniforms._replace(frame=jnp.uint32(i))
        state, outputs = render_frame(
            accel, bundle.atlas, uniforms, config, state, mcfg
        )
    return config, mcfg, state, uniforms, outputs


@pytest.fixture(scope="module")
def mcpg_run():
    return _render("mcpg")


@pytest.fixture(scope="module")
def restir_run():
    return _render("restir")


@pytest.mark.parametrize("selector", range(9))
def test_mcpg_debug_views(mcpg_run, selector):
    from merian_quake_tpu.render.mcpg.debug import render_mcpg_debug

    config, mcfg, state, uniforms, outputs = mcpg_run
    img = np.asarray(
        render_mcpg_debug(
            selector, uniforms, config, mcfg, state.mcpg,
            outputs["gbuffer"], outputs["irradiance"],
        )
    )
    assert img.shape == (config.height, config.width, 3)
    assert np.isfinite(img).all(), f"view {selector} not finite"


def test_mcpg_debug_views_nontrivial(mcpg_run):
    """After training frames the guiding-state views must be non-zero
    (the box light is learnable from every visible surface)."""
    from merian_quake_tpu.render.mcpg.debug import render_mcpg_debug

    config, mcfg, state, uniforms, outputs = mcpg_run
    for selector in (1, 4):  # learned sum_w, irradiance
        img = np.asarray(
            render_mcpg_debug(
                selector, uniforms, config, mcfg, state.mcpg,
                outputs["gbuffer"], outputs["irradiance"],
            )
        )
        assert img.max() > 0.0, f"view {selector} all-zero"


def test_mcpg_debug_bad_selector(mcpg_run):
    from merian_quake_tpu.render.mcpg.debug import render_mcpg_debug

    config, mcfg, state, uniforms, outputs = mcpg_run
    with pytest.raises(ValueError, match="unknown debug selector"):
        render_mcpg_debug(
            99, uniforms, config, mcfg, state.mcpg,
            outputs["gbuffer"], outputs["irradiance"],
        )


@pytest.mark.parametrize("selector", range(5))
def test_restir_debug_views(restir_run, selector):
    from merian_quake_tpu.render.restir.debug import render_restir_debug

    config, _, state, _, outputs = restir_run
    img = np.asarray(
        render_restir_debug(selector, config, state.restir, outputs["gbuffer"])
    )
    assert img.shape == (config.height, config.width, 3)
    assert np.isfinite(img).all(), f"view {selector} not finite"
    if selector in (0, 2):  # W / radiance carry signal after 2 frames
        assert img.max() > 0.0
