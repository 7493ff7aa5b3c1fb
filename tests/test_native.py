"""Native (C++) accel builder must agree with the numpy reference."""
import numpy as np
import pytest

from merian_quake_tpu.utils import native
from merian_quake_tpu.models.types import CLUSTER_SIZE


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    if lib is None:
        pytest.skip("native library unavailable (no compiler)")
    return lib


def _soup(rng, t=512):
    c = rng.uniform(-500, 500, (t, 1, 3))
    tri = c + rng.uniform(-30, 30, (t, 3, 3))
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    cand = rng.uniform(size=t) < 0.8
    valid = cand | (rng.uniform(size=t) < 0.5)
    return (
        v0.astype(np.float32), v1.astype(np.float32), v2.astype(np.float32),
        cand, valid,
    )


def test_version(lib):
    assert lib.mq_version() == 1


def test_morton_perm_matches_numpy(rng, lib):
    v0, v1, v2, cand, valid = _soup(rng)
    got = native.morton_perm(v0, v1, v2, cand, valid)
    # numpy reference (same ordering rules)
    from merian_quake_tpu.accel.build import _morton3

    cent = (v0 + v1 + v2) / 3.0
    lo, hi = cent.min(0), cent.max(0)
    ext = np.maximum(hi - lo, 1e-6)
    q = np.clip((cent - lo) / ext * 1023.0, 0, 1023).astype(np.uint64)
    codes = _morton3(q[:, 0], q[:, 1], q[:, 2])
    rank = np.where(cand, 0, np.where(valid, 1, 2)).astype(np.uint64)
    ref = np.lexsort((codes, rank))
    # orders must agree up to ties (same composite keys)
    key = (rank << 62) | codes
    np.testing.assert_array_equal(key[got], key[ref])
    # candidates must come first in both
    assert (np.cumsum(~cand[got]) * cand[got]).sum() == 0


def test_cluster_aabbs_match(rng, lib):
    v0, v1, v2, cand, valid = _soup(rng, t=CLUSTER_SIZE * 4)
    lo, hi = native.cluster_aabbs(v0, v1, v2, cand, CLUSTER_SIZE)
    C = v0.shape[0] // CLUSTER_SIZE
    for c in range(C):
        sel = slice(c * CLUSTER_SIZE, (c + 1) * CLUSTER_SIZE)
        m = cand[sel]
        if not m.any():
            assert (lo[c] > 1e29).all()
            continue
        pts = np.concatenate([v0[sel][m], v1[sel][m], v2[sel][m]])
        np.testing.assert_allclose(lo[c], pts.min(0), rtol=1e-6)
        np.testing.assert_allclose(hi[c], pts.max(0), rtol=1e-6)


def test_build_accel_native_matches_numpy(rng, lib, monkeypatch):
    """build_accel's sweep tables are the same with the native AABB
    builder and with the numpy fallback."""
    from merian_quake_tpu.accel.build import build_accel
    from merian_quake_tpu.models.types import build_scene_from_soup

    v0, v1, v2, cand, valid = _soup(rng, t=CLUSTER_SIZE * 3 + 17)
    scene = build_scene_from_soup(v0, v1, v2)
    nat = build_accel(scene)
    monkeypatch.setattr(native, "cluster_aabbs", lambda *a, **k: None)
    ref = build_accel(scene)
    for name in ("cluster_lo", "cluster_hi", "tri_soa", "tri_mask",
                 "cluster_mask"):
        np.testing.assert_allclose(
            np.asarray(getattr(nat, name)), np.asarray(getattr(ref, name)),
            rtol=1e-6, err_msg=name,
        )
