"""Frame-graph tests: topology, delayed edges, config IO, equivalence."""
import json

import jax.numpy as jnp
import numpy as np
import pytest

from merian_quake_tpu.accel.build import build_accel
from merian_quake_tpu.graph import Graph, InputSpec, Node
from merian_quake_tpu.graph.graph import register_node_type
from merian_quake_tpu.graph.nodes import GraphContext, default_pt_graph_config
from merian_quake_tpu.models.procedural import cornell_box
from merian_quake_tpu.models.types import RenderConfig
from merian_quake_tpu.renderer import init_state, render_frame

import pytest

# compile-heavy integration tier: run with the full suite (pytest tests/);
# the core tier is pytest -m 'not slow'
pytestmark = pytest.mark.slow


@register_node_type
class _ConstNode(Node):
    TYPE = "_const"

    def outputs(self):
        return ["out"]

    def process(self, ctx, state, **kw):
        return state, {"out": jnp.full((2, 2), float(self.props.get("v", 1.0)))}


@register_node_type
class _AddOneNode(Node):
    TYPE = "_addone"

    def inputs(self):
        return [InputSpec("src")]

    def outputs(self):
        return ["out"]

    def process(self, ctx, state, src):
        return state, {"out": src + 1.0}


@register_node_type
class _DelayNode(Node):
    TYPE = "_delay"

    def inputs(self):
        return [InputSpec("now"), InputSpec("prev", delay=1, optional=True)]

    def outputs(self):
        return ["out"]

    def process(self, ctx, state, now, prev):
        prev = jnp.zeros_like(now) if prev is None else prev
        return state, {"out": now + prev}


def test_toposort_and_dataflow():
    g = Graph()
    g.add_node(_ConstNode("c", {"v": 2.0}))
    g.add_node(_AddOneNode("p1"))
    g.add_node(_AddOneNode("p2"))
    g.connect("c", "out", "p1", "src")
    g.connect("p1", "out", "p2", "src")
    st = g.init_state()
    st, out = g.run(st)
    np.testing.assert_allclose(np.asarray(out[("p2", "out")]), 4.0)


def test_cycle_without_delay_rejected():
    g = Graph()
    g.add_node(_AddOneNode("a"))
    g.add_node(_AddOneNode("b"))
    g.connect("a", "out", "b", "src")
    g.connect("b", "out", "a", "src")
    with pytest.raises(ValueError, match="cycle"):
        st = g.init_state()
        g.run(st)


def test_delayed_edge_reads_previous_frame():
    g = Graph()
    g.add_node(_ConstNode("c", {"v": 3.0}))
    g.add_node(_DelayNode("d"))
    g.connect("c", "out", "d", "now")
    g.connect("d", "out", "d", "prev")  # self-loop via delay (history)
    st = g.init_state()
    st, out1 = g.run(st)
    np.testing.assert_allclose(np.asarray(out1[("d", "out")]), 3.0)
    st, out2 = g.run(st)
    np.testing.assert_allclose(np.asarray(out2[("d", "out")]), 6.0)
    st, out3 = g.run(st)
    np.testing.assert_allclose(np.asarray(out3[("d", "out")]), 9.0)


def test_config_roundtrip(tmp_path):
    cfg = default_pt_graph_config()
    g = Graph.from_config(cfg)
    path = str(tmp_path / "graph.json")
    g.store(path)
    with open(path) as f:
        cfg2 = json.load(f)
    g2 = Graph.from_config(cfg2)
    assert set(g2.nodes) == set(g.nodes)
    assert g2.connections == g.connections
    assert g2.to_config() == g.to_config()


def test_graph_matches_handwired_renderer():
    """The default graph must reproduce renderer.frame_core exactly."""
    bundle = cornell_box()
    config = RenderConfig(width=48, height=32, spp=1, max_path_length=3)
    accel = build_accel(bundle.scene, bundle.atlas)
    ctx = GraphContext(accel=accel, atlas=bundle.atlas, config=config)
    g = Graph.from_config(default_pt_graph_config(), ctx)
    gstate = g.init_state()

    fstate = init_state(config)
    uniforms = bundle.uniforms
    for i in range(2):
        uniforms = uniforms._replace(frame=jnp.uint32(i))
        gstate, out = g.run(gstate, {"uniforms": uniforms})
        fstate, fout = render_frame(accel, bundle.atlas, uniforms, config, fstate)
    np.testing.assert_allclose(
        np.asarray(out[("tonemap", "out")]),
        np.asarray(fout["ldr"]),
        atol=1e-5,
    )


def test_flagship_graph_matches_handwired_denoise_path():
    """The flagship default graph (MCPG + SVGF + add + exposure +
    tonemap + TAA + FXAA + HUD passthrough) must reproduce
    renderer.frame_core's denoise path exactly
    (/root/reference/res/default_config.json topology)."""
    from merian_quake_tpu.graph.nodes import flagship_graph_config
    from merian_quake_tpu.render.mcpg import MCPGConfig

    bundle = cornell_box()
    mcfg = MCPGConfig(
        mc_adaptive_size=1 << 10, mc_static_size=1 << 8, lc_size=1 << 10
    )
    config = RenderConfig(
        width=48, height=32, spp=1, max_path_length=3,
        integrator="mcpg", denoise=True,
    )
    accel = build_accel(bundle.scene, bundle.atlas)
    ctx = GraphContext(
        accel=accel, atlas=bundle.atlas, config=config, mcpg_config=mcfg
    )
    g = Graph.from_config(flagship_graph_config(), ctx)
    gstate = g.init_state()

    # compare against the EAGER frame_core: the graph is bit-identical
    # to it (the jitted variant differs by XLA fusion reassociation,
    # which FXAA's discrete edge branches then amplify locally)
    from merian_quake_tpu.renderer import frame_core

    fstate = init_state(config, mcfg)
    uniforms = bundle.uniforms
    for i in range(3):
        uniforms = uniforms._replace(frame=jnp.uint32(i))
        gstate, out = g.run(gstate, {"uniforms": uniforms})
        fstate, fout = frame_core(
            accel, bundle.atlas, uniforms, config, fstate, mcpg_config=mcfg
        )
    np.testing.assert_array_equal(
        np.asarray(out[("hud", "out")]), np.asarray(fout["ldr"])
    )
    np.testing.assert_array_equal(
        np.asarray(out[("add", "out")]), np.asarray(fout["hdr"])
    )


def test_image_write_pow2_trigger(tmp_path):
    """Power-of-2 iteration writer (default_config.json:536-567)."""
    import os

    from merian_quake_tpu.graph.nodes import ImageWriteNode

    node = ImageWriteNode(
        "w", {"path": str(tmp_path / "f_{i}.png"), "trigger": "pow2"}
    )
    state = node.init_state(None)
    img = jnp.zeros((4, 4, 3))
    for i in range(9):
        state, _ = node.process(None, state, img)
    written = sorted(os.listdir(tmp_path))
    assert written == ["f_1.png", "f_2.png", "f_4.png", "f_8.png"], written


def test_hud_color_bluenoise_nodes():
    from merian_quake_tpu.game.hud import HudState
    from merian_quake_tpu.graph.nodes import (
        ColorNode, HudNode, LDRImageNode,
    )

    cfg = RenderConfig(width=32, height=16)
    ctx = GraphContext(accel=None, atlas=None, config=cfg)
    color = ColorNode("one", {"color": [1.0, 0.5, 0.25, 1.0]})
    _, out = color.process(ctx, None)
    assert out["out"].shape == (16, 32, 4)
    np.testing.assert_allclose(np.asarray(out["out"][0, 0]), [1.0, 0.5, 0.25, 1.0])

    bn = LDRImageNode("blue_noise", {"size": 32})
    st = bn.init_state(ctx)
    _, out = bn.process(ctx, st)
    noise = np.asarray(out["out"])
    assert noise.shape == (32, 32, 4)
    # rank-normalized: every channel exactly covers (0, 1)
    assert abs(noise.mean() - 0.5) < 1e-3

    hud = HudNode("hud", {})
    src = jnp.ones((16, 32, 3)) * 0.5
    _, out = hud.process(ctx, None, src, None, None)
    np.testing.assert_allclose(np.asarray(out["out"]), 0.5)  # passthrough
    _, out = hud.process(
        ctx, None, src, jnp.full((16, 32), 100.0), HudState(health=50.0)
    )
    assert not np.allclose(np.asarray(out["out"]), 0.5)  # bars drawn


def test_compiled_graph_matches_eager():
    bundle = cornell_box()
    config = RenderConfig(width=48, height=32, spp=1, max_path_length=2)
    from merian_quake_tpu.accel.build import build_accel as _ba

    accel = _ba(bundle.scene, bundle.atlas)
    ctx = GraphContext(accel=accel, atlas=bundle.atlas, config=config)
    g = Graph.from_config(default_pt_graph_config(), ctx)
    step = g.compile()
    se = g.init_state()
    sj = g.init_state()
    uniforms = bundle.uniforms
    for i in range(2):
        uniforms = uniforms._replace(frame=jnp.uint32(i))
        se, oe = g.run(se, {"uniforms": uniforms})
        sj, oj = step(sj, {"uniforms": uniforms})
    np.testing.assert_allclose(
        np.asarray(oj[("tonemap", "out")]),
        np.asarray(oe[("tonemap", "out")]),
        atol=1e-6,
    )
