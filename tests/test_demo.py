"""Demo (.dem) playback tests against a synthetic protocol-15 stream."""
import struct

import numpy as np

from merian_quake_tpu.game.demo import (
    SVC_CLIENTDATA,
    SVC_SERVERINFO,
    SVC_SETANGLE,
    SVC_SETVIEW,
    SVC_SPAWNBASELINE,
    SVC_TIME,
    U_FRAME,
    U_MOREBITS,
    U_ORIGIN1,
    U_ORIGIN2,
    U_ORIGIN3,
    U_SIGNAL,
    demo_camera_path,
    parse_demo,
)


import pytest

# compile-heavy integration tier: run with the full suite (pytest tests/);
# the core tier is pytest -m 'not slow'
pytestmark = pytest.mark.slow


def _block(angles, payload: bytes) -> bytes:
    return struct.pack("<ifff", len(payload), *angles) + payload


def _coord(v):
    return struct.pack("<h", int(round(v * 8)))


def _build_demo():
    out = b"-1\n"  # cd track line
    # block 0: serverinfo + baseline + setview
    p = bytes([SVC_SERVERINFO]) + struct.pack("<i", 15) + bytes([1, 0])
    p += b"Test Level\0"
    p += b"maps/test.bsp\0progs/player.mdl\0\0"  # models
    p += b"\0"  # sounds (empty)
    p += bytes([SVC_SETVIEW]) + struct.pack("<h", 1)
    p += bytes([SVC_SPAWNBASELINE]) + struct.pack("<h", 1) + bytes([1, 0, 0, 0])
    for k in range(3):
        p += _coord(100.0 * (k + 1)) + bytes([0])
    out += _block((0, 0, 0), p)
    # blocks 1..4: time + clientdata + player entity updates
    for i in range(4):
        t = 1.0 + 0.1 * i
        p = bytes([SVC_TIME]) + struct.pack("<f", t)
        # clientdata: health 75+i, no optional fields
        p += bytes([SVC_CLIENTDATA]) + struct.pack("<h", 0)
        p += struct.pack("<i", 0)  # items
        p += struct.pack("<h", 75 + i)  # health
        p += bytes([0, 0, 0, 0, 0, 0])  # ammo counts + weapon
        # entity 1 moves +10 in x per frame, frame counter advances
        bits = U_SIGNAL | U_ORIGIN1 | U_ORIGIN2 | U_ORIGIN3 | U_MOREBITS | U_FRAME
        p += bytes([bits & 0xFF, (bits >> 8) & 0xFF, 1])  # low, more, ent num
        p += bytes([i % 4])  # frame
        p += _coord(100.0 + 10 * i) + _coord(200.0) + _coord(300.0)
        p += bytes([SVC_SETANGLE, 0, 64, 0])  # yaw = 90 deg
        out += _block((0.0, 90.0, 0.0), p)
    return out


def test_parse_demo():
    info, frames = parse_demo(_build_demo())
    assert info["map"] == "maps/test.bsp"
    assert info["name"] == "Test Level"
    assert len(frames) == 4
    f0, f3 = frames[0], frames[3]
    assert abs(f0.time - 1.0) < 1e-6
    assert f0.health == 75 and f3.health == 78
    e = f3.entities[1]
    np.testing.assert_allclose(e.origin, (130.0, 200.0, 300.0))
    assert e.frame == 3
    np.testing.assert_allclose(f0.view_angles[1], 90.0)


def test_demo_camera_path():
    info, frames = parse_demo(_build_demo())
    path = demo_camera_path(frames)
    pos, fwd, up = path(1.05)  # halfway between frames 0 and 1
    np.testing.assert_allclose(pos[0], 105.0, atol=1e-4)
    np.testing.assert_allclose(pos[2], 322.0, atol=1e-4)  # +eye height
    # yaw 90° → forward +y
    np.testing.assert_allclose(fwd[1], 1.0, atol=1e-5)
    # clamps beyond the demo
    pos2, _, _ = path(99.0)
    np.testing.assert_allclose(pos2[0], 130.0, atol=1e-4)
