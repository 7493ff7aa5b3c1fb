"""Live-game bridge tests: the packaged arena mod simulated end-to-end
through LiveGame (the reference's QuakeNode seam, SURVEY.md §2.1/§2.5).
"""
import numpy as np
import pytest

from merian_quake_tpu.game.host import QuakeHost, WorldHulls
from merian_quake_tpu.game.live import ClientParticles, angle_vectors
from merian_quake_tpu.game.mod import (
    BALL_MDL, WALKER_MDL, arena_hulls, build_progs, make_arena,
)


@pytest.fixture(scope="module")
def arena():
    return make_arena(dynamic_capacity=512)


def _edict_by_model(live, name):
    names = live.host.model_names
    snap = live.host.snapshot()
    for i in range(len(snap.origins)):
        if names[int(snap.modelindex[i])] == name:
            return int(snap.edict_ids[i]), snap.origins[i]
    return -1, None


def test_room_with_boxes_collision():
    hulls = arena_hulls()
    host = QuakeHost(max_edicts=64)
    host.load_progs(build_progs())
    host.load_world(hulls)
    host.spawn("{\n\"classname\" \"worldspawn\"\n}", client=False)
    # point trace into the first block (300-390, 290-380, 0-120) stops
    frac, endpos, normal, _ = host.trace(
        (256, 335, 60), (420, 335, 60)
    )
    assert frac < 1.0
    assert abs(endpos[0] - 300.0) < 0.5
    assert normal[0] == -1.0
    # trace over the block passes
    frac2, _, _, _ = host.trace((256, 335, 200), (420, 335, 200))
    assert frac2 == 1.0
    # room walls still solid
    frac3, endpos3, _, _ = host.trace((256, 256, 60), (900, 256, 60))
    assert frac3 < 1.0 and abs(endpos3[0] - 512.0) < 0.5


def test_angle_vectors_quake_convention():
    fwd, right, up = angle_vectors((0.0, 0.0, 0.0))
    np.testing.assert_allclose(fwd, [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(up, [0, 0, 1], atol=1e-6)
    # +yaw turns left (counter-clockwise)
    fwd, _, _ = angle_vectors((0.0, 90.0, 0.0))
    np.testing.assert_allclose(fwd, [0, 1, 0], atol=1e-6)
    # +pitch looks down
    fwd, _, _ = angle_vectors((90.0, 0.0, 0.0))
    np.testing.assert_allclose(fwd, [0, 0, -1], atol=1e-6)


def test_arena_simulates(arena):
    live = arena
    h0 = live.host.player_state().health
    assert h0 == 100.0
    scene, uniforms = live.step(1.0 / 30.0)
    ball0 = _edict_by_model(live, BALL_MDL)[1].copy()
    for _ in range(30):
        scene, uniforms = live.step(1.0 / 30.0)
    # ball fell / got kicked (BOUNCE physics ran)
    ball1 = _edict_by_model(live, BALL_MDL)[1]
    assert np.abs(ball1 - ball0).max() > 1.0
    # ball stays inside the room
    assert 12.0 - 0.5 <= ball1[2] <= 256.0
    # walker patrols (STEP + walkmove)
    _, worg = _edict_by_model(live, WALKER_MDL)
    assert worg is not None
    # player grounded at spawn height
    ps = live.host.player_state()
    assert abs(ps.origin[2] - 24.0) < 2.0


def test_live_scene_and_camera(arena):
    live = arena
    scene, uniforms = live.step(1.0 / 30.0, yaw=45.0)
    ps = live.host.player_state()
    np.testing.assert_allclose(
        np.asarray(uniforms.cam_x), ps.origin + ps.view_ofs, atol=1e-5
    )
    fwd = np.asarray(uniforms.cam_w)
    np.testing.assert_allclose(
        fwd, [np.cos(np.radians(45)), np.sin(np.radians(45)), 0], atol=1e-5
    )
    # dynamic triangles present beyond the static soup
    n_static = live.gs.static_bundle.scene.num_tris
    valid = np.asarray(scene.valid)
    assert valid[n_static:].sum() > 0


def test_walker_animates_and_moves(arena):
    live = arena
    eid, o0 = _edict_by_model(live, WALKER_MDL)
    f_seen = set()
    for _ in range(40):
        live.step(1.0 / 30.0)
        f_seen.add(int(live.host.get_field(eid, "frame")))
    _, o1 = _edict_by_model(live, WALKER_MDL)
    assert np.linalg.norm(o1[:2] - o0[:2]) > 4.0  # walked
    assert f_seen == {0, 1}  # waddle animation toggles


def test_secret_trigger_fires_and_particles():
    live = make_arena(dynamic_capacity=512)
    # walk the player toward the trigger at (256, 140): from (64, 256)
    # face it and run
    dx, dy = 256.0 - 64.0, 140.0 - 256.0
    yaw = np.degrees(np.arctan2(dy, dx))
    saw_msg = False
    saw_particles = False
    for _ in range(220):
        live.step(1.0 / 30.0, forward=320.0, yaw=yaw)
        if any("secret" in m.lower() for m in live.messages):
            saw_msg = True
        if live.particles.arrays() is not None:
            saw_particles = True
        if saw_msg and saw_particles:
            break
    assert saw_msg, "player never hit the trigger zone"
    assert saw_particles, "QC particle() event produced no client particles"
    assert "misc/secret.wav" in live.host.sound_names


def test_static_torch_sprite(arena):
    live = arena
    live.step(1.0 / 30.0)
    assert len(live._static_sprites) + len(live._static_entities) >= 1
    # sprite quad lands in the dynamic block
    scene, _ = live.step(1.0 / 30.0)
    n_static = live.gs.static_bundle.scene.num_tris
    assert np.asarray(scene.valid)[n_static:].sum() >= 4


def test_live_renders_frame(arena):
    from merian_quake_tpu.accel.build import build_accel
    from merian_quake_tpu.models.types import RenderConfig
    from merian_quake_tpu.renderer import init_state, render_frame

    live = arena
    cfg = RenderConfig(width=48, height=32, spp=1)
    state = init_state(cfg)
    for _ in range(2):
        scene, uniforms = live.step(1.0 / 30.0, yaw=0.0)
        accel = build_accel(scene, live.gs.static_bundle.atlas)
        state, out = render_frame(
            accel, live.gs.static_bundle.atlas, uniforms, cfg, state
        )
    ldr = np.asarray(out["ldr"])
    assert np.isfinite(ldr).all()
    assert ldr.mean() > 0.01


def test_hud_from_live_state(arena):
    hud = arena.hud_state()
    assert hud.health == 100.0
    assert hud.armor == 30.0
    assert hud.liquid == 0


def test_client_particles_lifecycle():
    cp = ClientParticles(reproducible=True)
    cp.spawn_effect((0, 0, 0), (0, 0, 1), 73, 16, now=0.0)
    assert len(cp.pos) == 16
    arr = cp.arrays()
    assert arr is not None and (np.abs(arr[0]) <= 8.0).all()
    # colors stay in the requested ramp
    assert ((arr[1].astype(np.int32) & ~7) == 72).all()
    cp.step(now=0.2, dt=0.2)
    alive_mid = len(cp.pos)
    cp.step(now=2.0, dt=0.1)
    assert len(cp.pos) == 0 and alive_mid <= 16


def test_live_accel_matches_full_build(arena):
    """The incremental accel (build_accel_live + refresh_dynamic) must
    trace identically to a from-scratch build_accel of the same frame's
    full scene — hit positions equal (triangle orders differ), both on
    the oracle path and the interpret-mode cluster sweep, nearest and
    any-hit (quake_node.cpp:985-1012 BLAS-refit equivalence)."""
    import jax.numpy as jnp

    from merian_quake_tpu.accel import build_accel, trace_nearest
    from merian_quake_tpu.accel.build import (
        build_accel_live, refresh_dynamic,
    )
    from merian_quake_tpu.accel import sweep
    from merian_quake_tpu.accel.build import MASK_OCCLUDER

    live = make_arena(dynamic_capacity=512)
    la = build_accel_live(
        live.gs.static_bundle, dyn_cap=live.gs.dynamic_capacity
    )
    for i in range(3):
        dyn, uni = live.step_dynamic(dt=1 / 30, forward=60.0, yaw=10.0)
    la = refresh_dynamic(la, dyn)
    # full rebuild of the same frame (classic path)
    live._extract_dynamic_only = False
    scene, _ = live.gs.extract()
    acc_full = build_accel(scene, live.gs.static_bundle.atlas)

    rng = np.random.default_rng(7)
    n = 256
    o = np.full((n, 3), (256.0, 256.0, 120.0), np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o_j, d_j = jnp.asarray(o), jnp.asarray(d)
    h_live = trace_nearest(la.accel, None, o_j, d_j, 0.0, 1e4)
    h_full = trace_nearest(acc_full, None, o_j, d_j, 0.0, 1e4)
    np.testing.assert_array_equal(
        np.asarray(h_live.hit), np.asarray(h_full.hit)
    )
    np.testing.assert_allclose(
        np.asarray(h_live.t)[np.asarray(h_full.hit)],
        np.asarray(h_full.t)[np.asarray(h_full.hit)],
        rtol=1e-5, atol=1e-3,
    )
    # cluster sweep on the live tables (static prefix + dynamic suffix)
    hs = sweep.sweep_nearest(la.accel, o_j, d_j, 0.0, 1e4, bit=1)
    hit = np.asarray(h_full.hit)
    np.testing.assert_array_equal(np.asarray(hs[1]) >= 0, hit)
    np.testing.assert_allclose(
        np.asarray(hs[0])[hit], np.asarray(h_full.t)[hit],
        rtol=1e-5, atol=1e-3,
    )
    dyn_hit = np.asarray(hs[1]) >= la.n_static
    assert dyn_hit.any()  # some rays end on the dynamic suffix
    t_max = np.where(hit, np.asarray(h_full.t) * 0.5, 1e4).astype(np.float32)
    occ = sweep.sweep_any(la.accel, o_j, d_j, 0.0, t_max, bit=MASK_OCCLUDER)
    ref = trace_nearest(acc_full, None, o_j, d_j, 0.0, t_max, mask=MASK_OCCLUDER)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref.hit))


def test_bigmap_dungeon_live_loop():
    """AD-scale dungeon (grid=3 variant): boots through the native
    host, monsters wander, incremental accel refreshes per frame, and a
    small frame renders finite (the live bench row's path end-to-end)."""
    import jax.numpy as jnp
    import pytest

    pytest.importorskip("jax")
    from merian_quake_tpu.accel.build import (
        build_accel_live, refresh_dynamic, scene_features,
    )
    from merian_quake_tpu.game.bigmap import make_bigmap
    from merian_quake_tpu.models.types import RenderConfig
    from merian_quake_tpu.renderer import init_state, render_frame

    live, d = make_bigmap(grid=3, monsters=4, dynamic_capacity=512)
    assert d.bundle.scene.num_tris > 30000
    la = build_accel_live(
        live.gs.static_bundle, dyn_cap=live.gs.dynamic_capacity
    )
    feats = scene_features(
        live.gs.static_bundle.scene, live.gs.static_bundle.uniforms,
        live.gs.static_bundle.atlas,
    )._replace(has_alpha_tris=True, has_fb=True, has_emissive_tex=True)
    cfg = RenderConfig(
        width=64, height=40, spp=1, max_path_length=2, integrator="pt",
        features=feats,
    )
    state = init_state(cfg)
    for i in range(3):
        dyn, uniforms = live.step_dynamic(
            dt=1 / 30, forward=100.0, yaw=15.0 + i
        )
        la = refresh_dynamic(la, dyn)
    assert int(dyn["valid"].sum()) > 0  # monsters/flames present
    state, out = render_frame(
        la.accel, live.gs.static_bundle.atlas, uniforms, cfg, state, None
    )
    ldr = out["ldr"]
    assert bool(jnp.isfinite(ldr).all())
    assert float(ldr.max()) > 0.01  # torches/sky actually light the map
    ps = live.host.player_state()
    assert ps.health > 0
