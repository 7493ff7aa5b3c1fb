"""The sharded frame is traced and compiled once, not once per frame."""
import jax
import jax.numpy as jnp
import numpy as np

from merian_quake_tpu.accel import build_accel
from merian_quake_tpu.models.procedural import cornell_box
from merian_quake_tpu.models.types import RenderConfig
from merian_quake_tpu.parallel import render as prender


def test_sharded_step_is_built_once():
    bundle = cornell_box()
    accel = build_accel(bundle.scene, bundle.atlas)
    config = RenderConfig(width=16, height=8, spp=1, max_path_length=2)
    mesh = prender.make_mesh(2)
    state = prender.init_state_sharded(mesh, config)
    before = prender._sharded_step.cache_info().misses
    for i in range(3):
        u = bundle.uniforms._replace(frame=jnp.uint32(i))
        state, ldr, _ = prender.render_frame_sharded(
            mesh, accel, bundle.atlas, u, config, state
        )
    assert prender._sharded_step.cache_info().misses == before + 1
    step = prender._sharded_step(mesh, prender._state_specs(state))
    assert step._cache_size() == 1  # one trace for all three frames
    assert int(jax.device_get(state.iteration)) == 3
    assert np.isfinite(np.asarray(ldr)).all()
