"""World-space hash-grid index math for the guiding caches.

Equivalent of ``merian-shaders/grid.glsl`` + ``hash.glsl``
(grid_idx_closest/interpolate, hash_grid, hash_grid_normal_level,
hash2_grid_level — use sites render_mcpg/mc.glsl:98-150 and
light_cache.glsl). Two independent hashes per cell: a primary hash for
the buffer slot and a 16-bit verification hash to detect collisions
(collision → state reset, mc.glsl:90-96).

All functions are batched over leading dims and uint32-exact.
"""
from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def grid_idx_closest(pos: jnp.ndarray, width) -> jnp.ndarray:
    """Cell index of the nearest cell center: round(pos/width). int32[..., 3]."""
    return jnp.round(pos / width).astype(jnp.int32)


def grid_idx_interpolate(pos: jnp.ndarray, width, u3: jnp.ndarray) -> jnp.ndarray:
    """Stochastic trilinear cell selection.

    Chooses one of the 8 surrounding cells with trilinear-weight
    probability: floor(pos/width + u3) where u3 ~ U[0,1)^3 (pos measured
    relative to cell centers).
    """
    return jnp.floor(pos / width - 0.5 + u3).astype(jnp.int32)


def _hash_coords(vals) -> jnp.ndarray:
    """xxhash-style avalanche over a list of uint32 coordinates."""
    h = _U32(0x9E3779B1)
    for v in vals:
        v = jnp.asarray(v).astype(_U32)
        h = h ^ (v * _U32(0x85EBCA77))
        h = (h << _U32(13)) | (h >> _U32(19))
        h = h * _U32(0xC2B2AE3D)
    h = h ^ (h >> _U32(16))
    h = h * _U32(0x7FEB352D)
    h = h ^ (h >> _U32(15))
    return h


def _hash2_coords(vals) -> jnp.ndarray:
    """Independent second hash (different constants) for verification."""
    h = _U32(0x27220A95)
    for v in vals:
        v = jnp.asarray(v).astype(_U32)
        h = (h + v * _U32(0x165667B1)) * _U32(0x01000193)
        h = h ^ (h >> _U32(17))
    return h


def quantize_normal(normal: jnp.ndarray) -> jnp.ndarray:
    """Dominant-axis bucket 0..5 so states are split per face orientation.

    Pure selects instead of argmax + take_along_axis (an M-row gather):
    they fuse into the surrounding elementwise graph.
    """
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    ax, ay, az = jnp.abs(nx), jnp.abs(ny), jnp.abs(nz)
    is_x = (ax >= ay) & (ax >= az)  # first-max tie-break like argmax
    is_y = (~is_x) & (ay >= az)
    axis = jnp.where(is_x, 0, jnp.where(is_y, 1, 2))
    val = jnp.where(is_x, nx, jnp.where(is_y, ny, nz))
    return (axis * 2 + (val < 0.0).astype(jnp.int32)).astype(_U32)


def _tiled_slot(idx, extra, size, tile_bits: int):
    """Locality-preserving slot: hash the TILE (idx >> tile_bits per
    axis), place the cell at bucket·T + linearized sub-coordinate
    (T = 8^tile_bits consecutive rows per tile).

    Spatially-adjacent cells land in adjacent table rows, so the guide
    draws of neighboring pixels/samples — which address neighboring
    cells — coalesce into the same HBM region instead of fully random
    rows. Collision RATE is
    unchanged (same load factor); collisions become tile-correlated,
    which the 16-bit verification hash detects per cell as before.
    Arithmetic shift + mask give consistent floor semantics for
    negative cell indices."""
    t = 1 << (3 * tile_bits)
    mask = jnp.int32((1 << tile_bits) - 1)
    sub = idx & mask  # per-axis 0..2^b-1, non-negative for any idx
    sub_lin = (
        sub[..., 0] | (sub[..., 1] << tile_bits)
        | (sub[..., 2] << (2 * tile_bits))
    ).astype(_U32)
    tile = idx >> tile_bits
    h = _hash_coords(
        [tile[..., 0], tile[..., 1], tile[..., 2]] + list(extra)
    )
    buckets = max(int(size) // t, 1)
    return (h % _U32(buckets)) * _U32(t) + sub_lin


def hash_grid(idx: jnp.ndarray, size, tile_bits: int = 0) -> jnp.ndarray:
    """Primary slot for a cell: hash(idx) % size. uint32[...].

    ``tile_bits`` > 0 switches to the locality-preserving tiled layout
    (see _tiled_slot); 0 is the reference's fully-scrambled layout."""
    if tile_bits:
        return _tiled_slot(idx, [], size, tile_bits)
    h = _hash_coords([idx[..., 0], idx[..., 1], idx[..., 2]])
    return h % _U32(size)


def hash_grid_normal_level(idx, normal, level, size,
                           tile_bits: int = 0) -> jnp.ndarray:
    """Primary slot including quantized normal and grid level."""
    if tile_bits:
        return _tiled_slot(
            idx, [quantize_normal(normal), level], size, tile_bits
        )
    h = _hash_coords(
        [idx[..., 0], idx[..., 1], idx[..., 2], quantize_normal(normal), level]
    )
    return h % _U32(size)


def hash2_grid(idx) -> jnp.ndarray:
    """16-bit verification hash of a cell."""
    return _hash2_coords([idx[..., 0], idx[..., 1], idx[..., 2]]) & _U32(0xFFFF)


def hash2_grid_level(idx, level) -> jnp.ndarray:
    """16-bit verification hash including the level."""
    return (
        _hash2_coords([idx[..., 0], idx[..., 1], idx[..., 2], level]) & _U32(0xFFFF)
    )
