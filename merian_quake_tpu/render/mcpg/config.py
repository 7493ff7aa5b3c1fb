"""MCPG configuration and persistent device state.

State layout mirrors render_mcpg/grid.h (MCState, LightCacheVertex) in
structure-of-arrays form; defaults mirror render_mcpg.hpp:112-166.
The production grid sizes (32,777,259 adaptive + 800,009 static states,
4,000,000 light-cache entries ≈ 2.4 GB) are presets; tests use small
grids (hash grids degrade gracefully — only collision rates change).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class MCPGConfig(NamedTuple):
    """Static (compile-time) MCPG knobs (≈ shader macros,
    render_mcpg.cpp:137-185)."""

    # grid sizes
    mc_adaptive_size: int = 1 << 17
    mc_static_size: int = 1 << 14
    lc_size: int = 1 << 16
    # sampling
    mc_samples: int = 5
    mc_samples_adaptive_prob: float = 0.7
    surf_bsdf_p: float = 0.15
    # per-cell adaptive defensive probability (round-3 quality fix,
    # docs/quality_notes_r2.md follow-up): when > 0, the per-lane BSDF
    # probability is raised toward 1 for IMMATURE winner chains,
    # sbp_eff = 1 - (1 - surf_bsdf_p) · N/(N + trust_n) — young/
    # uncertain lobes sample mostly like plain PT (no defensive-mixture
    # tax while learning), converged chains get the full guiding
    # weight. The MIS pdf uses the same per-lane probability, so the
    # estimator stays unbiased. 0 = reference-fixed SURF_BSDF_P.
    surf_bsdf_trust_n: int = 16
    # luminance clamp on guiding-update weights (the reference's
    # MAX_SUN_COLOR clamp family, config.h:19 — fp16 storage also caps
    # its update weights implicitly). Bounds the Metropolis target so a
    # single firefly cannot dominate a chain's sum_w for hundreds of
    # frames. 0 = off. Biases only the GUIDING DISTRIBUTION (which may
    # be anything), never the estimator.
    mc_update_clamp: float = 64.0
    dir_guide_prior: float = 0.2
    mc_fast_recovery: bool = True
    use_light_cache_tail: bool = False
    # adaptive grid (exponential type, render_mcpg.hpp:143-148)
    mc_adaptive_tan_alpha_half: float = 0.003
    mc_adaptive_min_width: float = 0.01
    mc_adaptive_power: float = 4.0
    mc_adaptive_steps_per_unit: float = 6.0
    # static grid
    mc_static_width: float = 25.3
    # light cache grid (exponential, render_mcpg.hpp:135-141)
    lc_tan_alpha_half: float = 0.002
    lc_min_width: float = 0.01
    lc_power: float = 2.0
    lc_steps_per_unit: float = 6.0
    # chain limits (mc.glsl / compute_updates.comp)
    ml_max_n: int = 1024
    ml_min_alpha: float = 0.01
    # per-frame budget of distinct cells receiving MC updates; segments
    # past it drop, like the reference's full ≤10-slot per-cell queues
    # (grid.h:23-35). 2^19 covers a 1080p frame's touched-cell count
    # with wide margin (≤ pixels × bounces, heavily shared).
    update_cell_capacity: int = 1 << 19
    # per-frame budget of live MC update SAMPLES. The raw queue is
    # pixels × spp × bounces rows but only ~15% pass the Metropolis
    # accept gate (measured on chip), so one cheap 2-op sort compacts
    # the queue to this prefix and every downstream M-row sort/gather
    # runs at capacity instead of queue size. Overflow rows drop, like
    # the reference's full per-cell queues.
    update_queue_capacity: int = 1 << 21
    # fast-recovery zero requests per frame (measured ~500/frame; these
    # ride the same compaction sort as the update samples)
    zero_queue_capacity: int = 1 << 16
    # per-frame budget of live LIGHT-CACHE samples kept by the queue
    # compaction (compact_queues). The reference's per-cell spinlock
    # keeps ONE winner per cell per frame and drops every other racer
    # (light_cache.glsl:54-84), so capping the mean-merge inputs is
    # faithful; 2^22 keeps everything at 1080p·2spp. Under sharding
    # each shard keeps capacity/n_shards rows BEFORE the all_gather.
    lc_queue_capacity: int = 1 << 22
    lc_max_n: int = 128
    lc_min_alpha: float = 0.01
    # vMF sharpness cap. The reference lets kappa run to the fp32 limit
    # (mc_state_kappa, mc.glsl:43-46); on this implementation moderate
    # caps measurably reduce guided-MIS variance (see test sweep).
    kappa_max: float = 30.0
    # live-lane compaction budgets for the surface bounce segments
    # (fraction of the spp·pixels lane population per segment index,
    # last entry repeats; () = off). After bounce 1 most lanes are dead
    # (sky/emission found) but XLA cannot skip masked lanes; segments
    # with budget < 1 sort lanes live-first and run the whole segment
    # body (guide draws, sampling, MIS, trace, light cache, queue
    # emission) on the static live prefix only, falling back to full
    # width via lax.cond when the prefix would overflow — exact either
    # way. Off by default: no GPU measurement yet.
    surf_live_budget: tuple = ()
    # locality-preserving guide-table layout: cells hashed per TILE of
    # 8^b cells, placed at consecutive rows within the tile's bucket.
    # Off by default; its effect on the GPU is not measured yet. Same
    # load factor / collision rate as the reference layout either way
    # (mc.glsl:60-111). Applies to both MC grids and the light cache.
    grid_tile_bits: int = 0
    # volume single scattering (None = surface only); see volume.py
    volume: object = None

    @property
    def mc_total_size(self) -> int:
        return self.mc_adaptive_size + self.mc_static_size


def production_config():
    """Production-scale preset mirroring the reference's default MCPG
    node properties (default_config.json:626-660 'render_markovchain'):
    33.6M chain states + 4M light cache, 2 spp volume single scattering
    with distance guiding p=0.9 and 7 µm Draine particles, exponential
    adaptive grid with power √3 / 1 step per unit, BSDF prob 0.1."""
    from .volume import VolumeConfig

    return MCPGConfig(
        mc_adaptive_size=32_777_259,
        mc_static_size=800_009,
        lc_size=4_000_037,
        mc_samples=5,
        mc_samples_adaptive_prob=0.7,
        surf_bsdf_p=0.1,
        dir_guide_prior=0.3,
        mc_adaptive_tan_alpha_half=0.002,
        mc_adaptive_min_width=0.01,
        mc_adaptive_power=1.7320508,
        mc_adaptive_steps_per_unit=1.0,
        lc_tan_alpha_half=0.005,
        lc_min_width=0.01,
        lc_power=2.0,
        lc_steps_per_unit=6.0,
        mc_static_width=25.3,
        volume=VolumeConfig(
            volume_spp=2,
            volume_phase_p=0.1,
            dist_guide_p=0.9,
            distance_mc_samples=3,
            distance_grid_width=25,
            distance_state_count=10,
            volume_use_light_cache=True,
            particle_size_um=7.0,
            forward_project=True,
        ),
    )


def __getattr__(name):
    # lazy: VolumeConfig lives in volume.py which imports this module
    if name == "PRODUCTION":
        return production_config()
    raise AttributeError(name)


class MCStates(NamedTuple):
    """MCState array over adaptive ++ static slots (grid.h:6-21).

    Stored as TWO packed matrices instead of 8 SoA arrays: XLA gather/
    scatter cost scales with the number of ops, not row width, and the
    guided sampler + update replay gather/scatter states ~40×/frame.
    Column layout: f = [w_tgt(3), sum_w, w_cos, mv(3), T]; i = [id, N,
    hash]. Read sites use the accessor properties below.
    """

    f: jnp.ndarray  # f32[S, 9]
    i: jnp.ndarray  # i32[S, 3]

    @property
    def w_tgt(self):
        return self.f[:, 0:3]

    @property
    def sum_w(self):
        return self.f[:, 3]

    @property
    def w_cos(self):
        return self.f[:, 4]

    @property
    def mv(self):
        return self.f[:, 5:8]

    @property
    def T(self):
        return self.f[:, 8]

    @property
    def id(self):
        return self.i[:, 0].astype(jnp.uint32)

    @property
    def N(self):
        return self.i[:, 1]

    @property
    def hash(self):
        return self.i[:, 2].astype(jnp.uint32)


class LightCache(NamedTuple):
    """SoA LightCacheVertex array (grid.h:37-46). The spinlock is
    replaced by per-frame aggregation; the update_succeeded/canceled
    contention counters become per-frame scalars (collisions = samples
    sharing a cell in one frame)."""

    hash: jnp.ndarray  # u32[L] verification hash
    irr: jnp.ndarray  # f32[L, 3]
    N: jnp.ndarray  # i32[L]


class MCPGState(NamedTuple):
    mc: MCStates
    lc: LightCache
    # observability (≈ lock contention counters, light_cache.glsl:59-83)
    lc_updates_applied: jnp.ndarray  # u32[]
    lc_updates_merged: jnp.ndarray  # u32[] samples merged into one cell


def init_mcpg_state(config: MCPGConfig) -> MCPGState:
    s = config.mc_total_size
    l = config.lc_size
    return MCPGState(
        mc=MCStates(
            f=jnp.zeros((s, 9), jnp.float32),
            i=jnp.zeros((s, 3), jnp.int32),
        ),
        lc=LightCache(
            hash=jnp.zeros((l,), jnp.uint32),
            irr=jnp.zeros((l, 3), jnp.float32),
            N=jnp.zeros((l,), jnp.int32),
        ),
        lc_updates_applied=jnp.zeros((), jnp.uint32),
        lc_updates_merged=jnp.zeros((), jnp.uint32),
    )
