"""Two-phase Markov-chain update replay (sort-based).

Port of res/shader/render_mcpg/compute_updates.comp. The reference
replays ≤10 queued samples per cell sequentially (EWA chain update with
id-mismatch chain restarts), weighted-reservoir-samples one winning
state, and stochastically writes the winner into BOTH grids keeping the
incumbent with probability old.sum_w/(new+old).

Formulation without atomics, per-cell serial loops or duplicate-index
scatter-adds: per-cell sample groups are formed by ONE two-key sort
(see ops/segments.py). Whether a direct segment scatter is faster on
the GPU is not measured yet:

- sort samples by (cell, negated reservoir race key): groups become
  contiguous segments and the race winner (Efraimidis–Spirakis:
  argmin -log(u)/weight) lands on each segment's END row;
- the sequential EWA over k same-id samples collapses to one batched
  EWA step with effective alpha 1-(1-α)^k against the group mean
  (second-order-equivalent for the reference's k ≤ 10);
- the winner's stochastic grid writes keep the reference's replacement
  rule, applied from a compacted per-touched-cell buffer (segments past
  ``update_cell_capacity`` drop, like the reference's full ≤10-slot
  queues, grid.h:23-35).

Divergences from the reference (documented):
- the race weight of a matching sample is the cell's PRE-update sum_w
  (the reference uses the evolving post-replay value; within one cell
  these differ only by the replay-order EWA drift);
- the winner's mv is the w-weighted mean of the frame's matching
  samples (reference: last replayed sample's mv);
- the replacement RNG is seeded per (cell, frame), not per sample.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ...ops import linalg, rng as rng_ops, segments
from .config import MCPGConfig, MCPGState, MCStates
from . import grids
from .light_cache import lc_update_batch
from .surface import SurfaceResult

_U32 = jnp.uint32
_BIGF = jnp.float32(3e38)


def _f2i(x):
    """f32 → i32 lanes (integer lanes carry the bits unchanged)."""
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _i2f(x):
    return jax.lax.bitcast_convert_type(x, jnp.float32)


from typing import NamedTuple as _NT


class CompactedQueues(_NT):
    """Per-shard-compacted guiding-update queues (VERDICT r2 #6).

    The raw frame queues are spp·segments·pixels rows of which only the
    gated few percent are live; under shard_map the old path
    all_gathered the FULL dense queues (~27 i32 columns × M rows ×
    devices of ICI traffic). Each shard now class-sorts its own queues
    and keeps a static live prefix (per-shard capacity = the global
    capacity / n_shards), so the gather moves only ~1/8 the bytes at
    the bench config. RNG replay streams are seeded by the carried
    GLOBAL row index (``gidx``), making the replay order-invariant: the
    sharded concat applies the same sample set with the same seeds as
    the single-device path (f32 segment sums may reassociate — within
    the test tolerances).

    Columns:
    - upd: i32[capu, 16] — UpdateQueue's 15 emission-packed columns +
      gidx (dead rows carry the sentinel cell);
    - zeros: i32[capz] — fast-recovery cells (sentinel = none);
    - lc: i32[capl, 7] — [pos(3, f32 bits), oct normal (u32 bits),
      irr (2 f16-pair lanes), gidx (-1 = dead)]. The light cache's
      irradiance is fp16 in the reference (grid.h:37-46) and its
      normal only buckets the hash, so the narrow lanes lose nothing.
    """

    upd: jnp.ndarray
    zeros: jnp.ndarray
    lc: jnp.ndarray


def _pack_f16_pair(a, b):
    u16 = lambda x: jax.lax.bitcast_convert_type(
        jnp.clip(x, 0.0, 6e4).astype(jnp.float16), jnp.uint16
    ).astype(jnp.uint32)
    return (u16(a) | (u16(b) << jnp.uint32(16))).astype(jnp.int32)


def _unpack_f16_pair(p):
    p = p.astype(jnp.uint32)
    f16 = lambda x: jax.lax.bitcast_convert_type(
        x.astype(jnp.uint16), jnp.float16
    ).astype(jnp.float32)
    return f16(p & jnp.uint32(0xFFFF)), f16(p >> jnp.uint32(16))


def queue_gidx(m_local, groups, width, rows, y0, height, base=0):
    """Global row index of each local queue row: local queues are
    [group, slab pixels]-ordered, pixels in the TILE-MAJOR flat layout
    (render/layout.py), so the global index of a local row is
    base + group·H·W + global_flat_index(pixel) — computed through
    layout.index_of on the slab's global pixel coordinates."""
    from .. import layout as _layout

    per = rows * width
    assert m_local == (m_local // per) * per, (m_local, per)
    groups = m_local // per
    px, py = _layout.gen_pixels(width, rows, y0=y0)
    gpix = _layout.index_of(px, py, width, height).astype(jnp.int32)
    goff = jnp.arange(groups, dtype=jnp.int32) * (height * width)
    return base + (goff[:, None] + gpix[None, :]).reshape(-1)


def compact_queues(
    result: SurfaceResult,
    mcfg: MCPGConfig,
    gidx_upd,
    gidx_lc,
    n_shards: int = 1,
) -> CompactedQueues:
    """Class-sort + static-prefix compaction of one shard's queues."""
    from ...ops import octahedral

    S = mcfg.mc_total_size
    qtab = result.updates.data  # (M, 15)
    M = qtab.shape[0]
    live = qtab[:, 14] < S
    cls = jnp.where(
        live,
        jnp.int32(0),
        jnp.where(result.zeros.mask, jnp.int32(2), jnp.int32(1)),
    )
    iota = jax.lax.broadcasted_iota(jnp.int32, (M, 1), 0)[:, 0]
    ks, ps = jax.lax.sort([cls, iota], num_keys=1)

    capu = int(min(M, max(mcfg.update_queue_capacity // n_shards, 1024)))
    pu = ps[:capu]
    upd = jnp.concatenate(
        [
            jnp.take(qtab, pu, axis=0),
            jnp.take(gidx_upd, pu)[:, None],
        ],
        axis=1,
    )
    # rows past the live prefix already carry the sentinel cell ✓ (the
    # class sort puts live rows first; dead rows keep cell >= S)

    capz = int(min(M, max(mcfg.zero_queue_capacity // n_shards, 256)))
    pz = ps[-capz:]
    zeros = jnp.where(
        ks[-capz:] == 2, jnp.take(result.zeros.cell, pz), jnp.int32(S)
    )

    # light-cache queue: its own liveness sort (different mask)
    lcq = result.lc_samples
    lmask = lcq.mask & jnp.isfinite(lcq.irr).all(axis=-1)
    lcls = jnp.where(lmask, jnp.int32(0), jnp.int32(1))
    _, lps = jax.lax.sort([lcls, iota], num_keys=1)
    capl = int(min(M, max(mcfg.lc_queue_capacity // n_shards, 1024)))
    pl = lps[:capl]
    f2i = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
    lc_tab = jnp.concatenate(
        [
            f2i(lcq.pos),
            f2i(octahedral.encode_normal(lcq.normal))[:, None],
            _pack_f16_pair(lcq.irr[:, 0], lcq.irr[:, 1])[:, None],
            _pack_f16_pair(lcq.irr[:, 2], jnp.zeros_like(lcq.irr[:, 2]))[
                :, None
            ],
            jnp.where(lmask, gidx_lc, jnp.int32(-1))[:, None],
        ],
        axis=1,
    )  # (M, 7)
    lc = jnp.take(lc_tab, pl, axis=0)
    return CompactedQueues(upd=upd, zeros=zeros, lc=lc)


def apply_updates(
    rng_key,
    mstate: MCPGState,
    result: SurfaceResult,
    uniforms,
    mcfg: MCPGConfig,
) -> MCPGState:
    """Applies fast-recovery zeros, light-cache samples and MC updates
    from the dense frame queues (single-device path: compaction +
    replay in one step; the sharded path compacts per shard first —
    see compact_queues — and calls apply_updates_compact on the
    gathered prefixes, with identical sample sets and RNG streams)."""
    M = result.updates.data.shape[0]
    gidx = jax.lax.broadcasted_iota(jnp.int32, (M, 1), 0)[:, 0]
    cq = compact_queues(result, mcfg, gidx, gidx, n_shards=1)
    return apply_updates_compact(rng_key, mstate, cq, uniforms, mcfg)


def apply_updates_compact(
    rng_key,
    mstate: MCPGState,
    cq: CompactedQueues,
    uniforms,
    mcfg: MCPGConfig,
) -> MCPGState:
    """Replay compacted queues into the guiding state.

    ``rng_key``: uint32 scalar seed for this frame's replay randomness
    (≈ pcg4d16(pixel, frame, SEED) in compute_updates.comp:63). All
    replay sorts are keyed (cell, race) with gidx-seeded races, so the
    result is independent of row ORDER (single-device vs sharded
    concat) up to f32 segment-sum reassociation.
    """
    from ...ops import octahedral

    mc = mstate.mc
    S = mcfg.mc_total_size

    # ---- 1a. fast-recovery zeroing (mcpg.comp:175-178) (duplicate
    # cells write the same 0.0 — benign) ----
    mc = mc._replace(f=mc.f.at[cq.zeros, 3].set(0.0, mode="drop"))

    # ---- 1b. compacted update rows (emission-packed + gidx) ----
    qr = cq.upd[:, :15]
    cap_u = qr.shape[0]
    w_u = _i2f(qr[:, 0])
    tgt_u = _i2f(qr[:, 1:4])
    mv_u = _i2f(qr[:, 4:7])
    pos_u = _i2f(qr[:, 7:10])
    norm_u = _i2f(qr[:, 10:13])
    id_u = qr[:, 13].astype(_U32)
    cells_u = qr[:, 14]
    live_u = cells_u < S

    # per-sample rng streams seeded by the GLOBAL queue row index
    # (compaction- and sharding-invariant streams)
    rs = rng_ops.seed_pixel(
        cq.upd[:, 15].astype(_U32), 0, uniforms.frame, rng_key
    )

    # ---- 2. light cache (from the compacted narrow rows) ----
    lc_pos = _i2f(cq.lc[:, 0:3])
    lc_norm = octahedral.decode_normal(
        cq.lc[:, 3].astype(jnp.uint32)
    )
    ir0, ir1 = _unpack_f16_pair(cq.lc[:, 4])
    ir2, _ = _unpack_f16_pair(cq.lc[:, 5])
    lc_irr = jnp.stack([ir0, ir1, ir2], axis=1)
    lc_gidx = cq.lc[:, 6]
    rng_lc = rng_ops.seed_pixel(
        jnp.maximum(lc_gidx, 0).astype(_U32), 1, uniforms.frame, rng_key
    )
    _, lc, applied, merged = lc_update_batch(
        rng_lc,
        mstate.lc,
        lc_pos,
        lc_norm,
        lc_irr,
        lc_gidx >= 0,
        uniforms.cam_x,
        mcfg,
        tiebreak=lc_gidx,
    )

    # ---- 3. MC chain replay on the compacted rows ----
    # narrow 2-column incumbent peek (id, sum_w) from one packed table
    inc_tab = jnp.stack(
        [mc.i[:, 0], jax.lax.bitcast_convert_type(mc.f[:, 3], jnp.int32)],
        axis=1,
    )  # (S, 2) i32
    inc = grids.gather_rows(inc_tab, jnp.minimum(cells_u, S - 1))  # (cap_u, 2)
    inc_id = inc[:, 0].astype(_U32)
    inc_sum_w = _i2f(inc[:, 1])
    match = (inc_id == id_u) & live_u

    # reservoir race key (winner = min); sorted DESC via negation so the
    # winner is the segment-end row
    rs, u_race = rng_ops.uniform(rs)
    cand_w = jnp.where(match, inc_sum_w, w_u)
    race = -jnp.log(jnp.maximum(u_race, 1e-12)) / jnp.maximum(cand_w, 1e-20)
    key2 = jnp.where(live_u, -race, -_BIGF)

    mf = match.astype(jnp.float32)

    # sort operands are the per-row aggregation inputs ONLY plus the
    # compacted row index: winner-only columns (normal, id) are gathered
    # afterwards at the ≤capacity segment-end rows — every extra sort
    # operand pays a full O(M log M) permute pass, a cap-row gather is
    # ~free
    iota_c = jax.lax.broadcasted_iota(jnp.int32, (cap_u, 1), 0)[:, 0]
    segs, cols = segments.sort_segments(
        cells_u,
        [
            w_u,
            mf,
            tgt_u[:, 0], tgt_u[:, 1], tgt_u[:, 2],
            pos_u[:, 0], pos_u[:, 1], pos_u[:, 2],
            mv_u[:, 0], mv_u[:, 1], mv_u[:, 2],
            iota_c,
        ],
        tiebreak=key2,
    )
    (w_s, m_s, tx, ty, tz, px, py, pz, mvx, mvy, mvz, idx_s) = cols
    tgt_s = jnp.stack([tx, ty, tz], axis=1)
    pos_s = jnp.stack([px, py, pz], axis=1)
    mv_s = jnp.stack([mvx, mvy, mvz], axis=1)

    # ---- compact to one row per touched cell; per-cell math runs on
    # (cap,) rows only (no M-row gathers/scatters) ----
    cap = int(min(S + 1, mcfg.update_cell_capacity))
    comp = segments.compact_indices(segs, cap)
    cell_c = segments.take_compact(comp, segs.cell, fill=S)
    live_c = comp.valid & (cell_c < S)
    cell_r = jnp.minimum(cell_c, S - 1)

    # segment aggregates over MATCHING samples (masked rows all carry
    # the sentinel cell and sort into the trailing dead segment)
    mw = m_s * w_s
    agg = segments.compact_sums(
        comp,
        jnp.concatenate(
            [m_s[:, None], mw[:, None], mw[:, None] * tgt_s,
             mw[:, None] * mv_s],
            axis=1,
        ),
    )  # (cap, 8): k, sum_w, sum_wt(3), sum_wmv(3)
    k_m, sum_w_g, sum_wt_g, sum_wmv_g = (
        agg[:, 0], agg[:, 1], agg[:, 2:5], agg[:, 5:8]
    )

    cur_f = grids.gather_rows(mc.f, cell_r)  # (cap, 9)
    cur_i = grids.gather_rows(mc.i, cell_r)  # (cap, 3)

    kf = jnp.maximum(k_m, 1.0)
    mean_w = sum_w_g / kf
    mean_wt = sum_wt_g / kf[..., None]
    n_new = jnp.minimum(cur_i[:, 1] + k_m.astype(jnp.int32), mcfg.ml_max_n)
    alpha = jnp.maximum(1.0 / jnp.maximum(n_new, 1), mcfg.ml_min_alpha)
    alpha_eff = 1.0 - jnp.power(1.0 - alpha, k_m)
    upd_sum_w = cur_f[:, 3] + (mean_w - cur_f[:, 3]) * alpha_eff
    upd_w_tgt = cur_f[:, 0:3] + (mean_wt - cur_f[:, 0:3]) * alpha_eff[..., None]
    mean_mv = sum_wmv_g / jnp.maximum(sum_w_g, 1e-20)[..., None]

    # cos term against the POST-update state direction (GLSL inout
    # mutation order in mc_update, compute_updates.comp:48-52: sum_w and
    # w_tgt are written BEFORE w_cos reads mc_state_dir). This
    # bootstraps guiding: a fresh chain's first light-find gives cos = 1
    # → mean cos ≈ 1 → a sharp vMF lobe at the light. The per-row
    # broadcast goes through a small (S, 4) scratch table: capacity-row
    # scatter + fast small-table gather (never an M-row row-gather).
    post_tab = segments.scatter_table(
        comp, cell_c,
        jnp.concatenate([upd_w_tgt, upd_sum_w[:, None]], axis=1), S + 1,
    )
    post = grids.gather_rows(post_tab, jnp.minimum(segs.cell, S))  # (M, 4)
    pos_post = jnp.where(
        (post[:, 3] > 0.0)[..., None],
        post[:, 0:3] / jnp.where(post[:, 3] == 0.0, 1.0, post[:, 3])[..., None],
        post[:, 0:3],
    )
    dir_post = linalg.normalize(pos_post - pos_s)
    cos_post = jnp.maximum(
        0.0, linalg.dot(linalg.normalize(tgt_s - pos_s), dir_post)
    )
    cos_post = jnp.where(mw > 0.0, cos_post, 0.0)
    sum_wc_g = segments.compact_sums(comp, mw * cos_post)  # (cap,)
    mean_wc = sum_wc_g / kf
    upd_w_cos = jnp.minimum(
        cur_f[:, 4] + (mean_wc - cur_f[:, 4]) * alpha_eff, upd_sum_w
    )

    # ---- winner row (the segment end) per touched cell ----
    wf = segments.take_compact(
        comp,
        jnp.stack(
            [w_s, m_s, tx, ty, tz, mvx, mvy, mvz, px, py, pz], axis=1
        ),
    )  # (cap, 11)
    # winner-only columns from the COMPACTED queue rows (cap-row gather)
    win_idx = jnp.maximum(segments.take_compact(comp, idx_s), 0)
    win_tab = jnp.concatenate(
        [_f2i(norm_u), id_u.astype(jnp.int32)[:, None]], axis=1
    )  # (cap_u, 4) i32
    win_rows = jnp.take(win_tab, win_idx, axis=0)
    norm_c = _i2f(win_rows[:, 0:3])
    win_id_s = win_rows[:, 3]
    w_c, m_c = wf[:, 0], wf[:, 1]
    tgt_c, mv_c = wf[:, 2:5], wf[:, 5:8]
    pos_c = wf[:, 8:11]

    winner_match = m_c > 0.5
    # matched winner → the post-EWA cell state; fresh winner → a new
    # chain from the sample (cos = 1 by construction, mcpg fresh path)
    win_f = jnp.where(
        winner_match[:, None],
        jnp.concatenate(
            [upd_w_tgt, upd_sum_w[:, None], upd_w_cos[:, None], mean_mv],
            axis=1,
        ),
        jnp.concatenate(
            [w_c[:, None] * tgt_c, w_c[:, None], w_c[:, None], mv_c], axis=1
        ),
    )  # (cap, 8): w_tgt3, sum_w, w_cos, mv3
    win_id = jnp.where(winner_match, cur_i[:, 0].astype(_U32), win_id_s)
    win_n = jnp.where(winner_match, n_new, 1)
    win_valid = live_c

    # save-site cells: stochastic level/jitter drawn per WINNER (the
    # reference draws them in compute_updates.comp:98-121 — per winner,
    # not per sample), so the hash math runs on cap rows, not M
    rc = rng_ops.seed_pixel(
        cell_r.astype(_U32), 3, uniforms.frame, rng_key
    )
    rc, sbuf_c, shash_c = grids.static_cell(rc, pos_c, mcfg)
    rc, abuf_c, ahash_c = grids.adaptive_cell(
        rc, pos_c, norm_c, uniforms.cam_x, mcfg
    )

    # ---- stochastic saves into BOTH grids (compute_updates.comp:98-121)
    def save(mc: MCStates, buf, site_hash, stream: int) -> MCStates:
        buf = buf.astype(jnp.int32)
        old = grids.gather_rows(inc_tab, jnp.minimum(buf, S - 1))
        old_id = old[:, 0].astype(_U32)
        old_sum_w = _i2f(old[:, 1])
        cell_rng = rng_ops.seed_pixel(
            buf.astype(_U32), 4 + stream, uniforms.frame, rng_key
        )
        _, u_rep = rng_ops.uniform(cell_rng)
        new_sum_w = win_f[:, 3]
        replace = win_valid & (
            (old_id == win_id)
            | (u_rep < new_sum_w / (new_sum_w + old_sum_w))
        )
        idx = jnp.where(replace, buf, S)
        f_rows = jnp.concatenate(
            [win_f, jnp.full((cap, 1), uniforms.cl_time, jnp.float32)], axis=1
        )
        i_rows = jnp.stack(
            [win_id.astype(jnp.int32), win_n, site_hash.astype(jnp.int32)],
            axis=1,
        )
        return MCStates(
            f=mc.f.at[idx].set(f_rows, mode="drop"),
            i=mc.i.at[idx].set(i_rows, mode="drop"),
        )

    mc = save(mc, sbuf_c, shash_c, 0)  # static grid
    mc = save(mc, abuf_c, ahash_c, 1)  # adaptive grid

    return MCPGState(
        mc=mc,
        lc=lc,
        lc_updates_applied=mstate.lc_updates_applied + applied,
        lc_updates_merged=mstate.lc_updates_merged + merged,
    )
