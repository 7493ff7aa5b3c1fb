import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from merian_quake_tpu.accel import build_accel, intersect, trace_nearest
from merian_quake_tpu.accel.intersect import trace_visibility
from merian_quake_tpu.models import materials, procedural
from merian_quake_tpu.models.types import build_scene_from_soup


def _single_tri_accel(v0, v1, v2):
    scene = build_scene_from_soup(
        np.asarray([v0], np.float32),
        np.asarray([v1], np.float32),
        np.asarray([v2], np.float32),
    )
    return build_accel(scene)


def test_front_hit_and_backface_cull():
    # Triangle in the x=10 plane. Reference normal n = cross(v2-v0, v1-v0).
    v0, v1, v2 = [10, -1, -1], [10, 1, -1], [10, 0, 1]
    acc = _single_tri_accel(v0, v1, v2)
    n = np.cross(np.subtract(v2, v0), np.subtract(v1, v0))
    o = jnp.asarray([[0.0, 0.0, 0.0]])
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    hr = intersect(acc, o, d, 0.0, 100.0)
    if n[0] < 0:  # normal faces the ray origin → front hit
        assert int(hr.tri[0]) == 0
        np.testing.assert_allclose(float(hr.t[0]), 10.0, atol=1e-4)
    else:
        assert int(hr.tri[0]) == -1
    # From the other side: opposite behavior.
    hr2 = intersect(acc, jnp.asarray([[20.0, 0.0, 0.0]]), -d, 0.0, 100.0)
    assert (int(hr2.tri[0]) == -1) != (int(hr.tri[0]) == -1)


def test_barycentrics_match_position():
    v0, v1, v2 = [5, 0, 0], [5, 4, 0], [5, 0, 4]
    acc = _single_tri_accel(v0, v1, v2)
    # aim at point v0 + 0.25*(v1-v0) + 0.5*(v2-v0) = (5, 1, 2)
    o = jnp.asarray([[0.0, 1.0, 2.0]])
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    hr = intersect(acc, o, d, 0.0, 100.0)
    hit = int(hr.tri[0]) == 0
    if not hit:  # winding may cull; flip
        acc = _single_tri_accel(v0, v2, v1)
        hr = intersect(acc, o, d, 0.0, 100.0)
        assert int(hr.tri[0]) == 0
        np.testing.assert_allclose(float(hr.u[0]), 0.5, atol=1e-5)
        np.testing.assert_allclose(float(hr.v[0]), 0.25, atol=1e-5)
    else:
        np.testing.assert_allclose(float(hr.u[0]), 0.25, atol=1e-5)
        np.testing.assert_allclose(float(hr.v[0]), 0.5, atol=1e-5)


def test_nearest_of_many():
    # winding chosen so normals face -x (toward the ray origin)
    scene = build_scene_from_soup(
        np.asarray([[10, -1, -1], [4, -1, -1]], np.float32),
        np.asarray([[10, 1, -1], [4, 1, -1]], np.float32),
        np.asarray([[10, 0, 1], [4, 0, 1]], np.float32),
    )
    acc = build_accel(scene)
    o = jnp.asarray([[0.0, 0.0, 0.0]])
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    hr = intersect(acc, o, d, 0.0, 100.0)
    np.testing.assert_allclose(float(hr.t[0]), 4.0, atol=1e-4)


def test_box_scene_center_rays_hit_walls():
    bundle = procedural.cornell_box()
    acc = build_accel(bundle.scene, bundle.atlas)
    cam = np.asarray(bundle.uniforms.cam_x)
    o = jnp.asarray([cam, cam, cam, cam], jnp.float32)
    d = jnp.asarray(
        [[1, 0, 0], [0, 0, 1], [0, 0, -1], [0, 1, 0]], jnp.float32
    )
    hr = trace_nearest(acc, bundle.atlas, o, d, 0.0, materials.T_MAX)
    assert bool(hr.hit.all())
    t = np.asarray(hr.t)
    np.testing.assert_allclose(t[0], 512.0 - cam[0], atol=0.01)  # far wall
    np.testing.assert_allclose(t[1], 256.0 - cam[2], atol=0.01)  # ceiling
    np.testing.assert_allclose(t[2], cam[2], atol=0.01)  # floor
    np.testing.assert_allclose(t[3], 512.0 - cam[1], atol=0.01)  # left wall


def test_alpha_grate_passthrough():
    bundle = procedural.outdoor_court()
    acc = build_accel(bundle.scene, bundle.atlas)
    # Ray through a grate hole: holes are where bars are absent.
    # Bars at (x%8)<3 in texture space; pick UV region in a hole and
    # verify the ray continues to the far wall instead of stopping.
    o = jnp.asarray([[600.0, 150.0, 80.0]], jnp.float32)
    d = jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32)
    hr = trace_nearest(acc, bundle.atlas, o, d, 0.0, materials.T_MAX)
    assert bool(hr.hit[0])
    t = float(hr.t[0])
    # must either stop at one of the grates (~40 or ~240 away: bar) or
    # reach the far wall (1024-600-1): never in between
    assert t > 39.0
    flags = int(np.asarray(acc.scene.flags)[int(hr.tri[0])])
    assert flags in (materials.MAT_FLAGS_NONE,)
    # Shooting many parallel rays: some pass through both grates to the
    # far wall (hole), some stop at the first grate (bar).
    ys = np.linspace(110, 290, 64)
    o = jnp.asarray([[600.0, y, 80.0] for y in ys], jnp.float32)
    d = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (64, 3))
    hr = trace_nearest(acc, bundle.atlas, o, d, 0.0, materials.T_MAX)
    t = np.asarray(hr.t)
    assert (np.abs(t - 40.0) < 1.5).any(), "some rays should hit the near grate"
    assert (t > 400).any(), "some rays should pass through grate holes"


def test_visibility_through_box():
    bundle = procedural.cornell_box()
    acc = build_accel(bundle.scene, bundle.atlas)
    a = jnp.asarray([[60.0, 256.0, 130.0]], jnp.float32)
    b = jnp.asarray([[200.0, 256.0, 130.0]], jnp.float32)  # open air
    c = jnp.asarray([[345.0, 335.0, 60.0]], jnp.float32)  # inside tall block
    assert bool(trace_visibility(acc, bundle.atlas, a, b)[0])
    assert not bool(trace_visibility(acc, bundle.atlas, a, c)[0])


def test_cluster_aabbs_cover_candidates():
    bundle = procedural.cornell_box()
    acc = build_accel(bundle.scene, bundle.atlas)
    cand = np.asarray(acc.candidate)
    v = np.stack(
        [np.asarray(acc.scene.v0), np.asarray(acc.scene.v1), np.asarray(acc.scene.v2)],
        axis=1,
    )
    C = acc.num_clusters
    from merian_quake_tpu.models.types import CLUSTER_SIZE

    v = v.reshape(C, CLUSTER_SIZE * 3, 3)
    m = cand.reshape(C, CLUSTER_SIZE).repeat(3, 1).reshape(C, CLUSTER_SIZE * 3)
    lo = np.asarray(acc.cluster_lo)
    hi = np.asarray(acc.cluster_hi)
    for ci in range(C):
        pts = v[ci][m[ci]]
        if len(pts) == 0:
            continue
        assert (pts >= lo[ci] - 1e-3).all()
        assert (pts <= hi[ci] + 1e-3).all()


def test_mip_selection_far_surfaces():
    """Far hits with ray cones must sample coarser mips (checker → grey)."""
    import jax.numpy as jnp
    from merian_quake_tpu.models.procedural import _SoupBuilder, _checker_tex, _const_tex
    from merian_quake_tpu.models.atlas import pack_textures, sample_mip
    from merian_quake_tpu.models.types import default_uniforms
    from merian_quake_tpu.render.trace import trace_ray

    b = _SoupBuilder()
    b.quad((0, -5000, -10), (10000, 0, 0), (0, 10000, 0), uv_scale=(500, 500), texnum=1)
    scene = b.build()
    atlas = pack_textures(
        [_const_tex((255,) * 3, 1), _checker_tex((255, 255, 255), (0, 0, 0), 32, 8)]
    )
    assert atlas.num_levels > 1
    acc = build_accel(scene, atlas)
    u = default_uniforms(cam_x=(0, 0, 100), cam_w=(1, 0, -0.02))
    o = jnp.asarray([[0.0, 0.0, 100.0], [0.0, 0.0, 100.0]])
    d = jnp.asarray([[0.9999, 0.0, -0.0141], [0.1, 0.0, -0.995]])  # far, near
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    res = trace_ray(acc, atlas, u, o, d, pixel_cone=jnp.float32(0.001))
    far, near = np.asarray(res.hit.albedo)
    # far grazing hit: averaged checker ≈ mid-grey; near hit: near 0 or 1
    assert 0.2 < far[0] < 0.8, far
    assert near[0] < 0.2 or near[0] > 0.8, near


def test_scene_features_alpha_flag_and_no_alpha_fast_path():
    """scene_features(atlas) resolves has_alpha_tris; the tex=None fast
    path in trace_nearest must agree with the alpha loop on scenes
    without alpha-test triangles."""
    import jax
    import jax.numpy as jnp

    from merian_quake_tpu.accel.build import build_accel, scene_features
    from merian_quake_tpu.accel.intersect import trace_nearest
    from merian_quake_tpu.models import materials
    from merian_quake_tpu.models.procedural import cornell_box

    bundle = cornell_box()
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    assert feats.has_alpha_tris is False  # procedural textures are opaque
    # without the atlas the flag stays conservatively True
    assert scene_features(bundle.scene, bundle.uniforms).has_alpha_tris

    acc = build_accel(bundle.scene, bundle.atlas)
    key = jax.random.PRNGKey(3)
    o = jax.random.uniform(key, (256, 3), minval=-0.8, maxval=0.8)
    d = jax.random.normal(jax.random.PRNGKey(4), (256, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    slow = trace_nearest(acc, bundle.atlas, o, d, 0.0, materials.T_MAX)
    fast = trace_nearest(acc, None, o, d, 0.0, materials.T_MAX)
    np.testing.assert_array_equal(np.asarray(slow.tri), np.asarray(fast.tri))
    np.testing.assert_allclose(np.asarray(slow.t), np.asarray(fast.t))


def _soup_accel(rng, t=256, flags=None, pad_to=None):
    c = rng.uniform(-40, 40, (t, 1, 3))
    tri = c + rng.uniform(-8, 8, (t, 3, 3))
    scene = build_scene_from_soup(
        tri[:, 0].astype(np.float32),
        tri[:, 1].astype(np.float32),
        tri[:, 2].astype(np.float32),
        flags=flags,
        pad_to=pad_to,
    )
    return build_accel(scene)


def _rays(rng, n, spread=60.0):
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _assert_hits_match(got, ref):
    """Sweep vs oracle: same winner, t/u/v to the last few bits."""
    tri, t_ref = np.asarray(ref.tri), np.asarray(ref.t)
    np.testing.assert_array_equal(np.asarray(got[1]), tri)
    hit = tri >= 0
    np.testing.assert_allclose(
        np.asarray(got[0])[hit], t_ref[hit], rtol=1e-5, atol=1e-3
    )
    for k, ref_k in ((2, ref.u), (3, ref.v)):
        np.testing.assert_allclose(
            np.asarray(got[k])[hit], np.asarray(ref_k)[hit], atol=1e-4
        )
    assert (np.asarray(got[0])[~hit] >= 1e38).all()


@pytest.mark.parametrize("padded", [False, True], ids=["soup", "padded"])
@pytest.mark.parametrize("ray_block", [32, 64, 128])
def test_sweep_nearest_matches_oracle(rng, ray_block, padded):
    """Interpret-mode sweep vs the oracle: misses (rays aimed away from
    the soup), backfaces (random windings), per-ray t_min/t_max
    (including empty intervals), and — padded — trailing clusters of
    padding triangles that the sweep must skip."""
    from merian_quake_tpu.accel import sweep
    from merian_quake_tpu.accel.intersect import intersect_oracle

    acc = _soup_accel(rng, pad_to=1024 if padded else None)
    cmask = np.asarray(acc.cluster_mask)
    if padded:
        assert (cmask == 0).sum() >= 8  # empty clusters present
    n = 384
    o, d = _rays(rng, n)
    o[: n // 4] = 500.0
    d[: n // 4] = np.abs(d[: n // 4])  # guaranteed misses
    t_min = rng.uniform(0.0, 20.0, n).astype(np.float32)
    t_max = np.where(
        rng.random(n) < 0.1, -1.0, rng.uniform(10.0, 300.0, n)
    ).astype(np.float32)
    args = (jnp.asarray(o), jnp.asarray(d), t_min, t_max)
    got = sweep.sweep_nearest(acc, *args, bit=1, ray_block=ray_block)
    ref = intersect_oracle(acc, *args)
    _assert_hits_match(got, ref)
    hit = np.asarray(ref.tri) >= 0
    assert hit.any() and (~hit[: n // 4]).all()


def test_sweep_ray_count_not_multiple_of_block(rng):
    """N = 3·64 + 5 rays: the padded tail is idle and sliced off."""
    from merian_quake_tpu.accel import sweep
    from merian_quake_tpu.accel.intersect import intersect_oracle

    acc = _soup_accel(rng)
    o, d = _rays(rng, 3 * 64 + 5, spread=30.0)
    got = sweep.sweep_nearest(acc, o, d, 0.0, 1e4, bit=1, ray_block=64)
    assert all(x.shape == (3 * 64 + 5,) for x in got)
    ref = intersect_oracle(acc, jnp.asarray(o), jnp.asarray(d), 0.0, 1e4)
    _assert_hits_match(got, ref)
    occ = sweep.sweep_any(acc, o, d, 0.0, 1e4, bit=2, ray_block=64)
    assert occ.shape == (3 * 64 + 5,) and occ.dtype == jnp.bool_


def test_sweep_anyhit_matches_oracle_occlusion_with_sky(rng):
    """Any-hit over the occluder bit vs the oracle restricted to the same
    mask, on a soup where a third of the triangles are sky (which passes
    light and must never occlude), with per-ray t_max."""
    from merian_quake_tpu.accel import sweep
    from merian_quake_tpu.accel.build import MASK_OCCLUDER
    from merian_quake_tpu.accel.intersect import intersect_oracle

    t = 384
    flags = np.where(
        rng.random(t) < 0.33, materials.MAT_FLAGS_SKY, 0
    ).astype(np.int32)
    acc = _soup_accel(rng, t=t, flags=flags)
    n = 512
    o, d = _rays(rng, n)
    t_max = rng.uniform(1.0, 200.0, n).astype(np.float32)
    occ = np.asarray(
        sweep.sweep_any(acc, o, d, 1e-3, t_max, bit=MASK_OCCLUDER,
                        ray_block=64)
    )
    ref = intersect_oracle(
        acc, jnp.asarray(o), jnp.asarray(d), 1e-3, t_max, mask=MASK_OCCLUDER
    )
    np.testing.assert_array_equal(occ, np.asarray(ref.hit))
    # sky hits exist that the occluder mask ignores
    every = intersect_oracle(acc, jnp.asarray(o), jnp.asarray(d), 1e-3, t_max)
    assert (np.asarray(every.hit) & ~occ).any()
    assert occ.any() and (~occ).any()


def test_trace_visibility_alpha_grate_sweep_matches_oracle(rng, monkeypatch):
    """Shadow rays through the court's alpha grates: the sweep path
    (any-hit on occluders + nearest/alpha loop on the alpha-only bit)
    agrees with the oracle path (nearest + alpha loop + sky test)."""
    isect = importlib.import_module("merian_quake_tpu.accel.intersect")

    bundle = procedural.outdoor_court()
    acc = build_accel(bundle.scene, bundle.atlas)
    n = 256
    a = np.stack([
        np.full(n, 600.0), rng.uniform(110, 290, n), rng.uniform(10, 150, n)
    ], 1).astype(np.float32)
    b = np.stack([
        rng.uniform(720, 1000, n), rng.uniform(50, 350, n),
        rng.uniform(10, 300, n),
    ], 1).astype(np.float32)
    ref = np.asarray(trace_visibility(acc, bundle.atlas, a, b))
    monkeypatch.setattr(isect, "use_sweep", lambda: True)
    got = np.asarray(trace_visibility(acc, bundle.atlas, a, b))
    np.testing.assert_array_equal(got, ref)
    assert ref.any() and (~ref).any()  # holes pass, bars block


@pytest.mark.parametrize("platform, expect", [("gpu", True), ("cpu", False)])
def test_traversal_dispatch_by_platform(monkeypatch, platform, expect):
    """The sweep runs on the GPU; the oracle on every other platform."""
    isect = importlib.import_module("merian_quake_tpu.accel.intersect")

    monkeypatch.setattr(isect.jax, "default_backend", lambda: platform)
    assert isect.use_sweep() is expect
    calls = []
    monkeypatch.setattr(
        isect.sweep, "sweep_nearest",
        lambda *a, **k: calls.append("sweep") or (0, 0, 0, 0),
    )
    monkeypatch.setattr(
        isect, "intersect_oracle",
        lambda *a, **k: calls.append("oracle") or isect.HitRecord(0, 0, 0, 0),
    )
    isect.intersect(None, None, None, 0.0, 1.0)
    assert calls == (["sweep"] if expect else ["oracle"])


@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "any"])
def test_sweep_lowers_to_triton_for_cuda(rng, any_hit):
    """Both kernel modes lower to a Triton module for the CUDA platform
    (every primitive has a Triton lowering rule), without a card."""
    import jax

    from merian_quake_tpu.accel import sweep

    acc = _soup_accel(rng)
    o, d = _rays(rng, 100)

    def f(acc, o, d):
        return sweep._sweep(
            acc, o, d, 0.0, 1e4, bit=1, any_hit=any_hit, ray_block=32,
            interpret=False,
        )

    text = jax.jit(f).trace(acc, o, d).lower(
        lowering_platforms=("cuda",)
    ).as_text()
    assert "__gpu$xla.gpu.triton" in text


def test_trace_visibility_alpha_and_shadow_tables():
    """build_accel's mask bits: sky triangles are candidates but not
    occluders, alpha-tested ones carry the alpha bit instead of the
    occluder bit, and each cluster's word is the OR of its triangles'."""
    from merian_quake_tpu.accel.build import (
        MASK_ALPHA, MASK_CANDIDATE, MASK_OCCLUDER,
    )
    from merian_quake_tpu.models.types import CLUSTER_SIZE

    bundle = procedural.outdoor_court()
    acc = build_accel(bundle.scene, bundle.atlas)
    mask = np.asarray(acc.tri_mask)
    flags = np.asarray(acc.scene.flags)
    valid = np.asarray(acc.scene.valid)
    sky = flags == materials.MAT_FLAGS_SKY
    cand = (mask & MASK_CANDIDATE) != 0
    alpha = (mask & MASK_ALPHA) != 0
    occl = (mask & MASK_OCCLUDER) != 0
    assert sky.any() and alpha.any()
    assert (cand == (valid & (np.asarray(acc.scene.alpha) < 0))).all()
    assert cand[sky].all() and not occl[sky].any()
    assert not occl[alpha].any() and not (alpha & ~cand).any()
    assert (occl == (cand & ~sky & ~alpha)).all()
    np.testing.assert_array_equal(
        np.asarray(acc.cluster_mask),
        np.bitwise_or.reduce(mask.reshape(-1, CLUSTER_SIZE), axis=1),
    )
    # SoA rows are v0, v1 - v0, v2 - v0 in cluster-major order
    soa = np.asarray(acc.tri_soa)
    v0, v1 = np.asarray(acc.scene.v0), np.asarray(acc.scene.v1)
    np.testing.assert_array_equal(soa[:, 0:3].transpose(0, 2, 1).reshape(-1, 3), v0)
    np.testing.assert_array_equal(
        soa[:, 3:6].transpose(0, 2, 1).reshape(-1, 3), v1 - v0
    )


@pytest.mark.gpu
def test_sweep_on_card_matches_oracle(rng, gpu):
    """The compiled kernel (not the interpreter) vs the oracle."""
    import jax

    from merian_quake_tpu.accel import sweep
    from merian_quake_tpu.accel.intersect import intersect_oracle

    acc = _soup_accel(rng, t=4096)
    o, d = _rays(rng, 4096)
    got = sweep.sweep_nearest(acc, o, d, 0.0, 1e4, bit=1, interpret=False)
    with jax.default_matmul_precision("highest"):
        ref = intersect_oracle(acc, jnp.asarray(o), jnp.asarray(d), 0.0, 1e4)
    agree = np.asarray(got[1]) == np.asarray(ref.tri)
    assert agree.mean() >= 0.9999
