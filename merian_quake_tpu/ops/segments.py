"""Sort-based segmented reductions in place of duplicate-heavy scatter
aggregation.

The reference applies Markov-chain / light-cache updates with device
atomics (atomicAdd queue cursors, spinlocks: render_mcpg/mc.glsl:159-203,
light_cache.glsl:54-84). This module aggregates without atomics or
duplicate-index scatter-adds (`.at[cells].add(rows)` with millions of
duplicate indices), and keeps gathers indexed by an M-sized vector off
the hot path. Whether XLA's GPU scatter-add (atomics) beats the sort is
not measured yet. The design rules here are:

1. aggregate by sorting rows by cell (contiguous segments; a secondary
   key parks a chosen "winner" row at each segment END);
2. all per-CELL math runs on a COMPACTED array of segment-end rows —
   the end-row positions come from one cheap single-key sort
   (`compact_indices`), and compaction gathers index only `capacity`
   (~0.5M) rows;
3. per-cell segment SUMS are adjacent differences of the cumulative
   sum taken at compacted end rows (`compact_sums`) — no M-row gather;
4. per-ROW broadcast of per-cell results goes through a small (S, K)
   scratch table: one capacity-row scatter + one fast small-table
   gather (`scatter_table` + jnp.take) — never an M-row row-gather.

Weighted-reservoir winner selection uses the Efraimidis–Spirakis
exponential race: winner = min over the segment of -log(u)/weight — we
sort by the NEGATED race key ascending so the winner lands on the
segment end row, where compaction picks it up.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp


class Segments(NamedTuple):
    """Sorted segment structure over M rows.

    ``cell`` is ascending; rows whose input cell was the sentinel (any
    value >= the live-cell range chosen by the caller) sort last and
    form ordinary (ignorable) segments.
    """

    cell: jnp.ndarray  # i32[M] ascending
    is_start: jnp.ndarray  # bool[M] first row of its segment
    is_end: jnp.ndarray  # bool[M] last row of its segment


def sort_segments(
    cell: jnp.ndarray,
    values: Sequence[jnp.ndarray],
    tiebreak: jnp.ndarray | None = None,
) -> tuple[Segments, list[jnp.ndarray]]:
    """Sort rows by (cell, tiebreak) ascending and build Segments.

    ``values``: 1-D (M,) arrays carried through the sort (f32/i32/u32 —
    multi-column data must be passed column-wise; `lax.sort` carries any
    number of operands in one pass and column count barely moves the
    cost). With a ``tiebreak`` key, the row with the LARGEST tiebreak in
    each segment ends up at the segment end (`is_end` row) — pass the
    negated reservoir race key to make the winner readable there.
    """
    cell = cell.astype(jnp.int32)
    ops = [cell]
    if tiebreak is not None:
        ops.append(tiebreak)
    ops.extend(values)
    out = jax.lax.sort(ops, num_keys=2 if tiebreak is not None else 1)
    cell_s = out[0]
    vals_s = list(out[(2 if tiebreak is not None else 1):])

    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), cell_s[:-1]])
    nxt = jnp.concatenate([cell_s[1:], jnp.full((1,), -1, jnp.int32)])
    return (
        Segments(cell=cell_s, is_start=cell_s != prev, is_end=cell_s != nxt),
        vals_s,
    )


class Compact(NamedTuple):
    """Per-segment (one row per touched cell) view of a sorted array.

    ``idx`` holds the positions of the first ``capacity`` segment-end
    rows (ascending = cell order); overflow segments are DROPPED — the
    reference's fixed ≤10-slot per-cell update queues drop overflow the
    same way (grid.h:23-35). ``valid`` masks unused rows.
    """

    idx: jnp.ndarray  # i32[capacity] end-row positions (M = none)
    valid: jnp.ndarray  # bool[capacity]


def compact_indices(segs: Segments, capacity: int) -> Compact:
    """ONE single-operand sort: positions of segment-end rows, packed."""
    m = segs.cell.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)[:, 0]
    k = jnp.where(segs.is_end, iota, jnp.int32(m))
    idx = jax.lax.sort([k], num_keys=1)[0][:capacity]
    if idx.shape[0] < capacity:  # tiny inputs (tests)
        idx = jnp.pad(idx, (0, capacity - idx.shape[0]), constant_values=m)
    return Compact(idx=idx, valid=idx < m)


def take_compact(comp: Compact, cols: jnp.ndarray, fill=0) -> jnp.ndarray:
    """Gather rows at the compacted end positions (a capacity-row take —
    cheap). Invalid rows read row 0 and are overwritten with ``fill``."""
    safe = jnp.where(comp.valid, comp.idx, 0)
    out = jnp.take(cols, safe, axis=0)
    mask = comp.valid
    if cols.ndim > 1:
        mask = mask[:, None]
    return jnp.where(mask, out, jnp.asarray(fill, cols.dtype))


def compact_sums(comp: Compact, cols: jnp.ndarray) -> jnp.ndarray:
    """Per-segment totals on the compacted rows.

    ``cols``: f32[M] or f32[M, K] of per-row addends (already masked).
    cumsum + capacity-row gather + adjacent difference — the previous
    compacted row is exactly the previous segment's end, so no start
    index is ever materialized.
    """
    squeeze = cols.ndim == 1
    if squeeze:
        cols = cols[:, None]
    cum = jnp.cumsum(cols, axis=0)
    at_end = take_compact(comp, cum)  # (cap, K)
    prev = jnp.concatenate([jnp.zeros_like(at_end[:1]), at_end[:-1]], axis=0)
    tot = at_end - prev
    return tot[:, 0] if squeeze else tot


def scatter_table(
    comp: Compact, cell: jnp.ndarray, cols: jnp.ndarray, size: int, fill=0
) -> jnp.ndarray:
    """Scatter compacted per-cell rows into a dense (size, K) table
    (capacity-row scatter — cheap; table gathers are the fast path for
    per-row broadcast). ``cell``: i32[capacity] target cells."""
    idx = jnp.where(comp.valid, cell, size)
    out = jnp.full((size,) + cols.shape[1:], fill, cols.dtype)
    return out.at[idx].set(cols, mode="drop", unique_indices=True)
