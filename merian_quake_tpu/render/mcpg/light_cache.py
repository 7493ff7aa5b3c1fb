"""Light cache: adaptive hash grid of EWA irradiance estimates.

Port of render_mcpg/light_cache.glsl. The reference serializes writers
with a per-cell spinlock whose loser samples are DROPPED (at most one
update per cell per frame; losses counted in update_canceled). Here
the same cadence is kept — one EWA step per cell per frame — but the
step uses the MEAN of the frame's samples for that cell instead of an
arbitrary lock winner (strictly lower estimator variance; divergence
documented). Hash-mismatch cells are re-initialized from one coarser
level, as in the reference (:72-75).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ...ops import hashgrid, linalg, rng as rng_ops
from .config import LightCache, MCPGConfig

_U32 = jnp.uint32


def _lc_width_for_level(level, cfg: MCPGConfig):
    return cfg.lc_min_width * jnp.power(cfg.lc_power, level / cfg.lc_steps_per_unit)


def _lc_level(pos, cam_x, cfg: MCPGConfig):
    width = 2.0 * cfg.lc_tan_alpha_half * linalg.distance(cam_x, pos)
    return jnp.round(
        cfg.lc_steps_per_unit
        * jnp.log(jnp.maximum(width, cfg.lc_min_width) / cfg.lc_min_width)
        / jnp.log(cfg.lc_power)
    )


def _lc_cell(rng_state, pos, normal, level, cfg: MCPGConfig):
    rng_state, u3 = rng_ops.uniform3(rng_state)
    idx = hashgrid.grid_idx_interpolate(
        pos, _lc_width_for_level(level, cfg)[..., None], u3
    )
    lvl = level.astype(jnp.int32).astype(_U32)
    buf = hashgrid.hash_grid_normal_level(
        idx, normal, lvl, cfg.lc_size, tile_bits=cfg.grid_tile_bits
    )
    h = hashgrid.hash2_grid_level(idx, lvl)
    return rng_state, buf, h


def _pack_lc(lc: LightCache) -> jnp.ndarray:
    """(L, 5) i32 table [hash, irr(3 bitcast), N]: ONE row-gather per
    lookup instead of three (row-gather cost is per ROW, not per
    byte). Integer lanes, so that hash bits riding the gather are never
    touched by float canonicalization."""
    f2i = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
    return jnp.concatenate(
        [f2i(lc.hash)[:, None], f2i(lc.irr), lc.N[:, None]], axis=1
    )


def _get_level(rng_state, lc: LightCache, pos, normal, level, cfg: MCPGConfig,
               packed=None, dead=None):
    rng_state, buf, h = _lc_cell(rng_state, pos, normal, level, cfg)
    tab = _pack_lc(lc) if packed is None else packed
    idx = buf.astype(jnp.int32)
    if dead is not None:
        # dead lanes read row 0 (result discarded by the caller): a
        # constant address makes the random HBM gather a cached one
        idx = jnp.where(dead, 0, idx)
    from .grids import gather_rows

    rows = gather_rows(tab, idx)  # (..., 5)
    stored_h = jax.lax.bitcast_convert_type(rows[..., 0], jnp.uint32)
    irr = jax.lax.bitcast_convert_type(rows[..., 1:4], jnp.float32)
    n = rows[..., 4]
    ok = (stored_h == h) & jnp.isfinite(irr).all(axis=-1)
    return rng_state, jnp.where(ok[..., None], irr, 0.0), jnp.where(ok, n, 0)


def lc_get(rng_state, lc: LightCache, pos, normal, cam_x, cfg: MCPGConfig,
           packed=None, dead=None):
    """light_cache_get: returns (rng, irradiance [..., 3]).

    ``packed``: optional _pack_lc(lc) table — pass it when calling in a
    loop so the (L, 5) pack is built once, not per call. ``dead``:
    optional bool mask of lanes whose result the caller discards."""
    level = _lc_level(pos, cam_x, cfg)
    rng_state, irr, _ = _get_level(
        rng_state, lc, pos, normal, level, cfg, packed=packed, dead=dead
    )
    return rng_state, irr


def lc_update_batch(
    rng_state,
    lc: LightCache,
    pos,
    normal,
    irr,
    mask,
    cam_x,
    cfg: MCPGConfig,
    tiebreak=None,
):
    """Batched light_cache_update over M samples.

    pos/normal/irr: [M, 3]; mask: bool[M]. Returns
    (rng, new lc, applied_cells, merged_samples).

    Aggregation is sort-based and COMPACT-FIRST (ops/segments.py):
    no duplicate-index scatter-adds or M-row gathers: after one sort
    the per-cell math runs entirely on the
    compacted segment-end rows (≤ update_cell_capacity), and only
    capacity-row scatters touch the cache arrays. Per-cell mean
    irradiance comes from cumulative-sum differences at compacted end
    rows; the representative sample (→ coarse-level re-init site) is
    the segment-end row — an arbitrary frame winner, like the lock.
    """
    from ...ops import segments

    mask = mask & jnp.isfinite(irr).all(axis=-1)
    level = _lc_level(pos, cam_x, cfg)
    rng_state, buf, h = _lc_cell(rng_state, pos, normal, level, cfg)
    L = cfg.lc_size
    bi = jnp.where(mask, buf.astype(jnp.int32), L)
    mf = mask.astype(jnp.float32)
    # sanitize non-finite rows BEFORE the cumulative sum (0*inf = NaN)
    irr = jnp.where(mask[:, None], irr, 0.0)

    # sort operands are the per-row aggregation inputs ONLY (irr, count)
    # plus the original row index: the representative columns (pos,
    # normal, level, hash) are gathered afterwards at the ≤capacity
    # segment-end rows — a cap-row gather is ~free while every extra
    # sort operand pays a full O(M log M) permute pass. The irradiance
    # + count ride as f16 PAIRS in two i32 lanes (each operand costs a
    # full permute pass; the reference stores light-cache irradiance as
    # fp16 anyway, grid.h:37-46, so in-flight f16 loses nothing)
    def _pack2(a, b):
        u16 = lambda x: jax.lax.bitcast_convert_type(
            jnp.clip(x, 0.0, 6e4).astype(jnp.float16), jnp.uint16
        ).astype(jnp.uint32)
        return (u16(a) | (u16(b) << jnp.uint32(16))).astype(jnp.int32)

    def _unpack2(p):
        p = p.astype(jnp.uint32)
        f16 = lambda x: jax.lax.bitcast_convert_type(
            x.astype(jnp.uint16), jnp.float16
        ).astype(jnp.float32)
        return f16(p & jnp.uint32(0xFFFF)), f16(p >> jnp.uint32(16))

    m = bi.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)[:, 0]
    # ``tiebreak`` (the global row index under sharding) makes the
    # within-cell order — and so the segment-end representative and
    # the f32 sum order — independent of how shards concatenated
    segs, cols = segments.sort_segments(
        bi, [_pack2(irr[:, 0], irr[:, 1]), _pack2(irr[:, 2], mf), iota],
        tiebreak=tiebreak,
    )
    ix, iy = _unpack2(cols[0])
    iz, mf_s = _unpack2(cols[1])
    idx_s = cols[2]

    cap = int(min(L + 1, cfg.update_cell_capacity))
    comp = segments.compact_indices(segs, cap)
    cell_c = segments.take_compact(comp, segs.cell, fill=L)
    acc = segments.compact_sums(
        comp, jnp.stack([mf_s, ix, iy, iz], axis=1)
    )  # (cap, 4): count + irr sum per touched cell
    rep_idx = jnp.maximum(segments.take_compact(comp, idx_s), 0)
    f2i = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
    i2f = lambda x: jax.lax.bitcast_convert_type(x, jnp.float32)
    # integer lanes: the hash bits must survive the gather unchanged
    rep_tab = jnp.concatenate(
        [
            f2i(pos), f2i(normal), f2i(level)[:, None],
            f2i(h)[:, None],
        ],
        axis=1,
    )  # (M, 8) i32 — ONE cap-row gather instead of four
    rep = jnp.take(rep_tab, rep_idx, axis=0)
    rep_pos, rep_norm, rep_level = (
        i2f(rep[:, 0:3]), i2f(rep[:, 3:6]), i2f(rep[:, 6])
    )
    new_hash = jax.lax.bitcast_convert_type(rep[:, 7], _U32)
    count, sum_irr = acc[:, 0], acc[:, 1:4]

    touched = comp.valid & (cell_c < L) & (count > 0.0)
    cell_r = jnp.minimum(cell_c, L - 1)
    mean_irr = sum_irr / jnp.maximum(count, 1.0)[..., None]

    old_hash = jnp.take(lc.hash, cell_r)
    old_irr = jnp.take(lc.irr, cell_r, axis=0)
    old_n = jnp.take(lc.N, cell_r)

    # cells whose stored hash mismatches: re-init from one coarser level
    mismatch = (old_hash != new_hash) | ~jnp.isfinite(old_irr).all(axis=-1)
    # per-CELL rng stream for the coarse-level jitter
    cell_rng = rng_ops.seed_pixel(
        cell_r.astype(jnp.uint32), 2, 0, rng_state[0]
    )
    _, coarse_irr, coarse_n = _get_level(
        cell_rng, lc, rep_pos, rep_norm, rep_level + 1.0, cfg
    )
    base_irr = jnp.where(mismatch[..., None], coarse_irr, old_irr)
    base_n = jnp.where(mismatch, coarse_n, old_n)

    new_n = jnp.minimum(base_n + 1, cfg.lc_max_n)
    alpha = jnp.maximum(1.0 / jnp.maximum(new_n, 1), cfg.lc_min_alpha)
    new_irr = base_irr + (mean_irr - base_irr) * alpha[..., None]

    idx = jnp.where(touched, cell_c, L)
    out = LightCache(
        hash=lc.hash.at[idx].set(new_hash, mode="drop", unique_indices=True),
        irr=lc.irr.at[idx].set(new_irr, mode="drop", unique_indices=True),
        N=lc.N.at[idx].set(new_n, mode="drop", unique_indices=True),
    )
    applied = touched.sum().astype(_U32)
    merged = (mask.sum() - touched.sum()).astype(_U32)
    return rng_state, out, applied, merged
