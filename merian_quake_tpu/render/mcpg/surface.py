"""MCPG guided surface kernel.

Port of res/shader/render_mcpg/mcpg.comp (guided mode): per pixel and
sample, each bounce draws MC_SAMPLES Markov-chain states from the two
hash grids (adaptive w.p. mc_samples_adaptive_prob, else static),
reservoir-selects a winner by sum_w, samples the outgoing direction
defensively (BSDF w.p. surf_bsdf_p, else the winner's vMF lobe), and
MIS-combines the vMF mixture with the BSDF pdf. Paths emit light-cache
samples and Markov-chain update samples into dense masked queues (in
place of the reference's atomic update buffer), plus fast-recovery zero
requests for vanished lights.

RNG note: the draw ORDER differs from the GLSL (both grid cells are
always computed, branches are masked selects), so streams are not
bit-identical to the reference — only distribution-equivalent.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ...accel.build import AccelScene
from ...models.types import RenderConfig, TextureAtlas, Uniforms
from ...ops import bsdf, color as color_ops, linalg, rng as rng_ops, vmf
from .. import layout
from ..gbuffer import GBufferOutput
from ..hit import Hit, decompress_hit
from ..pt import _where_hit
from ..trace import trace_ray
from .config import MCPGConfig, MCPGState
from . import grids
from .light_cache import lc_get


class UpdateQueue(NamedTuple):
    """Dense masked MC update samples (≈ MCUpdate slots, grid.h:23-35).

    PACKED at emission into one i32 matrix — apply_updates' compaction
    gather then reads one table instead of first materializing a
     15-column concat of the whole frame queue (~500 MB of pure
    bandwidth at 1080p). Integer lanes carry the f32 bits unchanged.
    Column layout (15):
    [w, target(3), mv(3), pos(3), normal(3), id, cell] — dead rows
    carry the sentinel cell (>= mc_total_size), encoding the mask.
    """

    data: jnp.ndarray  # i32[..., 15]

    _F32_COLS = {"w": 0, "target": slice(1, 4), "mv": slice(4, 7),
                 "pos": slice(7, 10), "normal": slice(10, 13)}

    @classmethod
    def build(cls, cell, id, w, target, mv, pos, normal, mask, sentinel):
        f2i = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
        data = jnp.concatenate(
            [
                f2i(w)[..., None],
                f2i(target),
                f2i(mv),
                f2i(pos),
                f2i(normal),
                id.astype(jnp.int32)[..., None],
                jnp.where(mask, cell, jnp.int32(sentinel))[..., None],
            ],
            axis=-1,
        )
        return cls(data=data)

    def _f(self, name):
        return jax.lax.bitcast_convert_type(
            self.data[..., self._F32_COLS[name]], jnp.float32
        )

    @property
    def w(self):
        return self._f("w")

    @property
    def target(self):
        return self._f("target")

    @property
    def mv(self):
        return self._f("mv")

    @property
    def pos(self):
        return self._f("pos")

    @property
    def normal(self):
        return self._f("normal")

    @property
    def id(self):
        return self.data[..., 13].astype(jnp.uint32)

    @property
    def cell(self):
        return self.data[..., 14]


class LCQueue(NamedTuple):
    pos: jnp.ndarray  # f32[M, 3]
    normal: jnp.ndarray
    irr: jnp.ndarray
    mask: jnp.ndarray


class ZeroQueue(NamedTuple):
    """Fast-recovery sum_w zero requests (mcpg.comp:175-178)."""

    cell: jnp.ndarray  # i32[M]
    mask: jnp.ndarray


class DistQueue(NamedTuple):
    """Distance-MC state writes from the volume pass, deferred to
    apply_updates (columns [sw, m0, m1, N, flat] — f32 bitcast in i32
    lanes; dropped rows carry the sentinel flat index). Deferral keeps
    replicated distance grids identical under sharding: every device
    applies the same gathered queue. Divergence from the reference's
    in-pass writes (volume.comp): later volume spp samples read the
    frame-START states instead of same-frame updates — one frame of
    extra lag on a state that converges over hundreds."""

    data: jnp.ndarray  # i32[M, 5]

    @classmethod
    def build(cls, sw, m0, m1, n_chain, flat, mask, sentinel):
        f2i = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
        return cls(
            data=jnp.stack(
                [
                    f2i(sw), f2i(m0), f2i(m1), n_chain.astype(jnp.int32),
                    jnp.where(mask, flat, jnp.int32(sentinel)),
                ],
                axis=-1,
            )
        )


class SurfaceResult(NamedTuple):
    irradiance: jnp.ndarray  # f32[rows, W, 4]
    updates: UpdateQueue
    lc_samples: LCQueue
    zeros: ZeroQueue
    dist: DistQueue | None = None  # volume pass only
    # i32[segments] count of lanes still alive ENTERING each bounce
    # segment (out of spp·W·rows) — drives the live-lane compaction
    # budget choice and the perf-notes anatomy; ~free (one reduce per
    # segment). None on paths that rebuild the result (frame_core).
    live_in: jnp.ndarray | None = None
    # i32[M] GLOBAL row id per queue row ((seg·spp + sample)·H·W +
    # global pixel index) — replaces frame_core's layout-derived
    # queue_gidx: under live-lane compaction queue rows are in
    # liveness-sorted lane order, so the id must ride with the row.
    gidx: jnp.ndarray | None = None


# smallest lane population worth the live-lane compaction sorts
# (patched down by tests to exercise the compacted path at toy sizes)
COMPACT_MIN_NS = 1 << 16


def _seg_budgets(mcfg: MCPGConfig, segs_n: int, ns: int) -> list[int]:
    """Static per-segment lane budgets (live-lane compaction).

    ``mcfg.surf_live_budget`` gives the fraction of the spp·pixels lane
    population each bounce segment is expected to need (indexed by
    segment, last entry repeats). 1.0 / empty = no compaction. Tiny
    populations (tests, thumbnails) skip compaction — the sort is not
    worth it below ~64k lanes."""
    fr = mcfg.surf_live_budget
    out = []
    for s in range(segs_n):
        frac = fr[min(s, len(fr) - 1)] if fr else 1.0
        if frac >= 1.0 or ns < COMPACT_MIN_NS:
            out.append(ns)
        else:
            b = max(1024, -(-int(ns * frac) // 1024) * 1024)
            out.append(min(ns, b))
    return out


def _select_state(mask, a: grids.StateSample, b: grids.StateSample):
    pick = lambda x, y: jnp.where(
        mask[..., None] if x.ndim > mask.ndim else mask, x, y
    )
    return grids.StateSample(*[pick(x, y) for x, y in zip(a, b)])


def render_mcpg_surface(
    accel: AccelScene,
    atlas: TextureAtlas,
    uniforms: Uniforms,
    config: RenderConfig,
    mcfg: MCPGConfig,
    mstate: MCPGState,
    gbuf: GBufferOutput,
    y0=0,
    rows: int | None = None,
) -> SurfaceResult:
    W, H = config.width, config.height
    rows = H if rows is None else rows
    n = W * rows
    K = mcfg.mc_samples
    spp = max(config.spp, 1)
    cam_x = uniforms.cam_x
    mc = mstate.mc
    lc = mstate.lc

    # ALL spp samples ride in ONE ray population (ns = spp·n): the
    # samples of a pixel retrace nearly the same region, so merged
    # sorted blocks are ~2x denser and the packet sweep visits ~half
    # the clusters per ray. RNG streams are seeded per (sample, pixel)
    # instead of chaining samples sequentially — distribution-
    # equivalent (see module RNG note).
    pxi, pyi = layout.gen_pixels(W, rows, y0=y0)
    ns = n * spp
    tile = (
        (lambda x: jnp.concatenate([x] * spp, axis=0))
        if spp > 1
        else (lambda x: x)
    )
    samp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), n)
    state0 = rng_ops.seed_pixel(
        tile(pxi),
        tile(pyi),
        uniforms.frame,
        jnp.uint32(config.seed) ^ (samp * jnp.uint32(0x9E3779B9)),
    )
    first_spp = samp == 0
    # one (S, 8) packed draw table (temporal reprojection pre-applied
    # table-side): each of the K×segments guide draws pays a single
    # 8-column gather instead of two 12-column ones
    mc_packed = grids.pack_states_draw(mc, uniforms.cl_time)
    from .light_cache import _pack_lc

    lc_packed = _pack_lc(lc)  # one row-gather per lc_get, not three

    first_hit = jax.tree.map(tile, decompress_hit(gbuf.hits))
    pixel_live = (first_hit.albedo >= 1e-7).any(axis=-1)

    # per-lane GLOBAL queue-row id base: (sample group)·H·W + global
    # pixel index (rides through the liveness sorts; see SurfaceResult)
    gpix = layout.index_of(pxi, pyi, W, H).astype(jnp.int32)
    samp_row = samp.astype(jnp.int32) * (H * W) + tile(gpix)

    def segment_body(seg_idx, rng_state, cur, throughput, f, p, done,
                     first_lane):
        """One bounce segment over an arbitrary lane population.

        Shape-generic over the leading dim (full frame or a compacted
        live prefix); ``seg_idx`` is a static int (unrolled loop).
        Returns the updated per-lane state plus this segment's emission
        queues (same leading dim as the input).
        """
        nl = cur.pos.shape[0]
        # sample 0 looks up at the previous-frame position (better
        # temporal stability), later samples at the current one
        lookup_pos = jnp.where(
            first_lane[:, None], cur.prev_pos, cur.pos
        )
        lookup_level = grids.adaptive_target_level(lookup_pos, cam_x, mcfg)

        # ---- draw K guide states, reservoir-select by sum_w ----
        # STRATIFIED grid choice: the reference Bernoulli(p)-picks
        # adaptive vs static per draw (mcpg.comp:74-111), which as
        # dense vector code means computing BOTH grids' cell math +
        # finalize for every draw (vector selects don't skip work). Here draw
        # slots are statically assigned — floor(K·p) adaptive,
        # K−ceil(K·p) static, one Bernoulli(frac) boundary slot —
        # so all but one draw run ONE grid's math. Draws are
        # exchangeable in the reservoir and the MIS mixture, and
        # the expected adaptive count stays exactly K·p.
        # mc_samples_adaptive_prob must be a static Python float:
        # the slot split below is computed at trace time (a traced
        # value would raise a ConcretizationTypeError here). It also
        # fixes the adaptive/static counts (deterministic instead of
        # the reference's i.i.d. Bernoulli draws) — unbiased (the
        # MIS pdf uses realized scores) but a variance/correlation
        # difference to keep in mind when A/B-ing noise vs the
        # reference.
        assert isinstance(mcfg.mc_samples_adaptive_prob, float), (
            "mc_samples_adaptive_prob must be a static float"
        )
        ka_exact = K * mcfg.mc_samples_adaptive_prob
        score_sum = jnp.zeros((nl,))
        mus, kappas, scores, draw_ns = [], [], [], []
        rng_state, win = grids.new_state(rng_state)
        win_buf = jnp.full((nl,), -1, jnp.int32)
        for k in range(K):
            if k + 1 <= int(ka_exact):
                mode = "adaptive"
            elif k >= math.ceil(ka_exact):
                mode = "static"
            else:
                mode = "mixed"
            if mode != "static":
                rng_state, abuf, ahash = grids.adaptive_cell(
                    rng_state, lookup_pos, cur.normal, cam_x, mcfg,
                    target_level=lookup_level,
                )
            if mode != "adaptive":
                rng_state, sbuf, shash = grids.static_cell(
                    rng_state, lookup_pos, mcfg
                )
            if mode == "adaptive":
                adaptive = True
                buf = abuf.astype(jnp.int32)
            elif mode == "static":
                adaptive = False
                buf = sbuf.astype(jnp.int32)
            else:
                frac = ka_exact - int(ka_exact)
                rng_state, u_grid = rng_ops.uniform(rng_state)
                adaptive = u_grid < frac
                buf = jnp.where(adaptive, abuf, sbuf).astype(jnp.int32)
            # dead lanes gather row 0: their results are discarded
            # anyway (everything downstream is gated on ``active``)
            # and a constant address turns the random HBM access
            # into a cached one — the gather is the draw's cost
            st = grids.gather_state_packed_draw(
                mc_packed, jnp.where(done, 0, buf)
            )
            if mode == "adaptive":
                st = grids.finalize_load(st, ahash, uniforms.cl_time)
            elif mode == "static":
                st = grids.finalize_load(
                    st, shash, uniforms.cl_time, pos=cur.pos,
                    normal=cur.normal, hemisphere_check=True,
                )
            else:
                st_a = grids.finalize_load(st, ahash, uniforms.cl_time)
                st_s = grids.finalize_load(
                    st, shash, uniforms.cl_time, pos=cur.pos,
                    normal=cur.normal, hemisphere_check=True,
                )
                st = _select_state(adaptive, st_a, st_s)
            score_sum = score_sum + st.sum_w
            rng_state, u_res = rng_ops.uniform(rng_state)
            take = u_res < st.sum_w / score_sum  # NaN-compare false
            win = _select_state(take, st, win)
            win_buf = jnp.where(take, buf, win_buf)
            mu_i, kap_i = grids.state_vmf(st, cur.pos, mcfg)
            mus.append(mu_i)
            kappas.append(kap_i)
            scores.append(st.sum_w)
            draw_ns.append(st.N)

        have_guide = score_sum > 0.0

        # ---- defensive direction sampling ----
        # per-DRAW defensive probability: immature chains (small N)
        # sample mostly BSDF — no 1/surf_bsdf_p variance tax while
        # the lobes are still learning (config surf_bsdf_trust_n).
        # The sample decision uses the realized winner's sbp; the
        # MIS pdf below mixes per-draw sbp_i over the reservoir
        # weights, which is EXACTLY the marginal sampling density
        # (round-4 fix: the r3 code put the realized winner's sbp
        # in the pdf, a small bias whenever the K drawn states'
        # maturities differed).
        def _sbp_of(n_arr):
            if mcfg.surf_bsdf_trust_n <= 0:
                return jnp.full(n_arr.shape, mcfg.surf_bsdf_p)
            mat = n_arr.astype(jnp.float32) / (
                n_arr.astype(jnp.float32)
                + float(mcfg.surf_bsdf_trust_n)
            )
            return 1.0 - (1.0 - mcfg.surf_bsdf_p) * mat

        sbp = _sbp_of(win.N)
        rng_state, u_b = rng_ops.uniform(rng_state)
        use_bsdf = (~have_guide) | (u_b < sbp)
        alpha = bsdf.roughness_to_alpha(cur.roughness)
        rng_state, u3 = rng_ops.uniform3(rng_state)
        wo_b = bsdf.sample(cur.wi, cur.normal, alpha, u3)
        win_mu, win_kappa = grids.state_vmf(win, cur.pos, mcfg)
        rng_state, u2 = rng_ops.uniform2(rng_state)
        wo_g = vmf.sample(win_mu, win_kappa, u2)
        wo = jnp.where(use_bsdf[..., None], wo_b, wo_g)
        rng_state, fresh = grids.new_state(rng_state)
        mc_state = _select_state(use_bsdf, fresh, win)
        mc_idx = jnp.where(use_bsdf, -1, win_buf)

        wodotn = linalg.dot(wo, cur.normal)
        below = (wodotn <= 1e-3) | (linalg.dot(wo, cur.geo_normal) <= 1e-3)
        active = ~done & ~below

        # ---- MIS pdf (mcpg.comp:127-136): exact marginal of the
        # per-draw defensive mixture ----
        safe_sum = jnp.where(have_guide, score_sum, 1.0)
        bsdf_mix = jnp.zeros((nl,))
        guided_p = jnp.zeros((nl,))
        for mu_i, kap_i, sc_i, n_i in zip(mus, kappas, scores, draw_ns):
            sbp_i = _sbp_of(n_i)
            w_i = sc_i / safe_sum
            bsdf_mix = bsdf_mix + w_i * sbp_i
            guided_p = guided_p + w_i * (1.0 - sbp_i) * vmf.pdf(
                wo, mu_i, kap_i
            )
        bsdf_p = bsdf.pdf(cur.wi, wo, cur.normal, alpha)
        wo_p = (
            jnp.where(have_guide, bsdf_mix, 1.0) * bsdf_p
            + jnp.where(have_guide, guided_p, 0.0)
        )

        # ---- trace next segment (dead lanes masked: they trace
        # with t_max = -1 → uniform miss at near-zero sweep cost;
        # every consumer below is already gated on ``active``) ----
        origin = cur.pos - cur.wi * 1e-3
        res = trace_ray(
            accel, atlas, uniforms, origin, wo,
            bilinear=config.bilinear, features=config.features,
            sort_rays=True, active=active,
        )
        incident = res.contribution
        has_inc = (incident > 0.0).any(axis=-1)

        rng_state, lc_irr = lc_get(
            rng_state, lc, res.hit.pos, res.hit.normal, cam_x, mcfg,
            packed=lc_packed, dead=~active,
        )
        use_inc = has_inc | (
            (not mcfg.use_light_cache_tail) and config.max_path_length == 2
        )
        lc_incident = jnp.where(
            use_inc[..., None], incident, res.throughput * lc_irr
        )

        micro = bsdf.eval_times_cos(cur.wi, wo, cur.normal, alpha)
        new_thr = throughput * micro[..., None]
        if mcfg.use_light_cache_tail:
            last = seg_idx == config.max_path_length - 2
            f_val = jnp.where(last, lc_incident, incident)
            new_f = new_thr * f_val
        else:
            new_f = new_thr * incident
        new_p = p * wo_p

        # ---- guiding updates (mcpg.comp:165-181) ----
        mc_f = color_ops.yuv_luminance(
            lc_incident * micro[..., None] / wo_p[..., None]
        )
        if mcfg.mc_update_clamp > 0.0:
            # luminance-clamped guiding updates (config knob): a
            # single low-pdf firefly cannot dominate a chain's
            # Metropolis target for hundreds of frames
            mc_f = jnp.minimum(mc_f, mcfg.mc_update_clamp)
        finite = jnp.isfinite(mc_f)
        lc_val = (
            lc_incident
            * (cur.albedo / jnp.pi)
            * (wodotn / jnp.maximum(wo_p, 10.0))[..., None]
        )
        lc_mask = active & finite

        rng_state, u_acc = rng_ops.uniform(rng_state)
        accept = u_acc * score_sum < mc_f * K  # NaN-compare false
        rng_state, fb_buf, _ = grids.adaptive_cell(
            rng_state, cur.pos, cur.normal, cam_x, mcfg
        )
        up_cell = jnp.where(mc_idx >= 0, mc_idx, fb_buf.astype(jnp.int32))
        target_mv = (res.hit.pos - res.hit.prev_pos) / uniforms.time_diff
        up_mask = active & finite & accept

        missing = grids.light_missing(mc_state, mc_f, wo, cur.pos, mcfg)
        zero_mask = (
            active
            & finite
            & ~accept
            & (mc_idx >= 0)
            & missing
            & bool(mcfg.mc_fast_recovery)
        )

        ys = (
            LCQueue(pos=cur.pos, normal=cur.normal, irr=lc_val, mask=lc_mask),
            UpdateQueue.build(
                cell=up_cell,
                id=mc_state.id,
                w=mc_f,
                target=res.hit.pos,
                mv=target_mv,
                pos=cur.pos,
                normal=cur.normal,
                mask=up_mask,
                sentinel=mcfg.mc_total_size,
            ),
            ZeroQueue(cell=jnp.maximum(mc_idx, 0), mask=zero_mask),
        )

        # ---- commit path state on active lanes ----
        throughput = jnp.where(active[..., None], new_thr, throughput)
        f = jnp.where(active[..., None], new_f, f)
        p = jnp.where(active, new_p, p)
        throughput = jnp.where(
            active[..., None],
            throughput * res.throughput * res.hit.albedo,
            throughput,
        )
        cur = _where_hit(active, res.hit, cur)
        dead = (throughput < 1e-7).all(axis=-1) | (f > 1e-7).any(axis=-1)
        done = done | below | dead
        return rng_state, cur, throughput, f, p, done, ys

    # ---------- segment driver (round 5): unrolled loop with optional
    # LIVE-LANE COMPACTION ----------
    # After the first bounce most lanes are dead (sky/emission hits —
    # measured live fractions in docs/perf_notes_r5.md), yet every
    # per-lane op in a segment still runs at full width: XLA cannot
    # skip masked lanes. When a segment's static budget B < ns, the
    # lanes are sorted live-first (lax.sort carrying the whole path
    # state — operands ride the sort ~free, vs ~27 ns/row for an
    # equivalent gather), the segment body runs on the [0:B) prefix
    # only, and the dead suffix passes through untouched. A lax.cond
    # falls back to the full-width body when more than B lanes are
    # alive (enclosed scenes), so the estimator is EXACTLY unbiased
    # either way — the budget only chooses which compiled width runs.
    rng_state = state0
    cur = first_hit
    throughput = jnp.ones((ns, 3))
    f = jnp.zeros((ns, 3))
    p = jnp.ones((ns,))
    done = ~pixel_live
    first_lane = first_spp
    iota_l = jnp.arange(ns, dtype=jnp.int32)
    row_l = samp_row
    segs_n = max(config.max_path_length - 1, 0)
    buds = _seg_budgets(mcfg, segs_n, ns)
    sorted_mode = False
    ys_list = []
    gidx_list = []
    live_list = []

    def _pack_cols(rng_state, cur, thr, f, p, first_lane, iota_l, row_l):
        return [
            rng_state, iota_l, row_l,
            first_lane.astype(jnp.int32),
            cur.pos[:, 0], cur.pos[:, 1], cur.pos[:, 2],
            cur.prev_pos[:, 0], cur.prev_pos[:, 1], cur.prev_pos[:, 2],
            cur.wi[:, 0], cur.wi[:, 1], cur.wi[:, 2],
            cur.normal[:, 0], cur.normal[:, 1], cur.normal[:, 2],
            cur.geo_normal[:, 0], cur.geo_normal[:, 1],
            cur.geo_normal[:, 2],
            cur.albedo[:, 0], cur.albedo[:, 1], cur.albedo[:, 2],
            cur.roughness,
            thr[:, 0], thr[:, 1], thr[:, 2],
            f[:, 0], f[:, 1], f[:, 2],
            p,
        ]

    def _unpack_cols(c):
        v3 = lambda i: jnp.stack([c[i], c[i + 1], c[i + 2]], axis=1)
        cur = Hit(
            pos=v3(4), prev_pos=v3(7), wi=v3(10), normal=v3(13),
            geo_normal=v3(16), albedo=v3(19), roughness=c[22],
        )
        return (
            c[0], c[1], c[2], c[3].astype(bool), cur, v3(23), v3(26),
            c[29],
        )

    def _pad_rows(x, rows_to, fill):
        if x.shape[0] == rows_to:
            return x
        pad = jnp.full((rows_to - x.shape[0],) + x.shape[1:], fill, x.dtype)
        return jnp.concatenate([x, pad])

    def _pad_ys(ys, rows_to, sentinel):
        lcq, upq, zq = ys
        updata = _pad_rows(upq.data, rows_to, 0)
        if updata.shape[0] != upq.data.shape[0]:
            # dead pad rows must carry the sentinel cell (the mask)
            tail = jnp.full(
                (rows_to - upq.data.shape[0],), sentinel, jnp.int32
            )
            updata = updata.at[upq.data.shape[0]:, 14].set(tail)
        return (
            LCQueue(
                pos=_pad_rows(lcq.pos, rows_to, 0.0),
                normal=_pad_rows(lcq.normal, rows_to, 0.0),
                irr=_pad_rows(lcq.irr, rows_to, 0.0),
                mask=_pad_rows(lcq.mask, rows_to, False),
            ),
            UpdateQueue(data=updata),
            ZeroQueue(
                cell=_pad_rows(zq.cell, rows_to, 0),
                mask=_pad_rows(zq.mask, rows_to, False),
            ),
        )

    for seg_idx in range(segs_n):
        live_cnt = jnp.sum((~done).astype(jnp.int32))
        live_list.append(live_cnt)
        B = buds[seg_idx]
        if B >= ns:
            (rng_state, cur, throughput, f, p, done, ys) = segment_body(
                seg_idx, rng_state, cur, throughput, f, p, done,
                first_lane,
            )
            ys_list.append(ys)
            gidx_list.append(seg_idx * spp * H * W + row_l)
            continue
        key = done.astype(jnp.int32)
        cols = _pack_cols(
            rng_state, cur, throughput, f, p, first_lane, iota_l, row_l
        )
        s = jax.lax.sort([key] + cols, num_keys=1)
        key_s, cols_s = s[0], list(s[1:])

        def _run(width, key_s=key_s, cols_s=cols_s, seg_idx=seg_idx):
            pre = [c[:width] for c in cols_s]
            (rng_s, iota_s, row_s, first_s, cur_s, thr_s, f_s, p_s) = (
                _unpack_cols(pre)
            )
            done_s = key_s[:width] > 0
            rng_s, cur_s, thr_s, f_s, p_s, done_s, ys = segment_body(
                seg_idx, rng_s, cur_s, thr_s, f_s, p_s, done_s, first_s,
            )
            out_cols = _pack_cols(
                rng_s, cur_s, thr_s, f_s, p_s, first_s, iota_s, row_s
            )
            merged = [
                jnp.concatenate([oc, c[width:]])
                for oc, c in zip(out_cols, cols_s)
            ]
            new_key = jnp.concatenate(
                [done_s.astype(jnp.int32), key_s[width:]]
            )
            ys = _pad_ys(ys, ns, mcfg.mc_total_size)
            gidx_rows = _pad_rows(
                seg_idx * spp * H * W + row_s, ns, 0
            )
            return (new_key, merged, ys, gidx_rows)

        new_key, merged, ys, gidx_rows = jax.lax.cond(
            live_cnt <= B,
            lambda: _run(B),
            lambda: _run(ns),
        )
        (rng_state, iota_l, row_l, first_lane, cur, throughput, f, p) = (
            _unpack_cols(merged)
        )
        done = new_key > 0
        sorted_mode = True
        ys_list.append(ys)
        gidx_list.append(gidx_rows)

    if sorted_mode:
        # one final unsort of the per-lane contribution (queues carry
        # their own global row ids and never need unsorting)
        back = jax.lax.sort(
            [iota_l, f[:, 0], f[:, 1], f[:, 2], p], num_keys=1
        )
        f = jnp.stack(back[1:4], axis=1)
        p = back[4]
    contrib = f / jnp.maximum(p, 1e-30)[..., None]
    ok = jnp.isfinite(contrib).all(axis=-1)
    contrib = jnp.where((ok & pixel_live)[..., None], contrib, 0.0)
    lum = color_ops.yuv_luminance(contrib)
    l2 = lum * lum

    if config.spp > 0:
        irr = contrib.reshape(spp, n, 3).mean(axis=0)
        m2 = l2.reshape(spp, n).mean(axis=0)
    else:
        irr = jnp.zeros((n, 3))
        m2 = jnp.zeros((n,))

    # flatten per-segment queues → (segs·ns,)
    def _cat(i):
        return jax.tree.map(
            lambda *xs: jnp.concatenate(xs), *[ys[i] for ys in ys_list]
        ) if ys_list else None

    if ys_list:
        lcq, upq, zq = _cat(0), _cat(1), _cat(2)
        gidx = jnp.concatenate(gidx_list)
        live_in = jnp.stack(live_list)
    else:  # max_path_length < 2: no bounce segments
        z = jnp.zeros((0,), jnp.int32)
        lcq = LCQueue(
            pos=jnp.zeros((0, 3)), normal=jnp.zeros((0, 3)),
            irr=jnp.zeros((0, 3)), mask=jnp.zeros((0,), bool),
        )
        upq = UpdateQueue(data=jnp.zeros((0, 15), jnp.int32))
        zq = ZeroQueue(cell=z, mask=jnp.zeros((0,), bool))
        gidx = z
        live_in = z

    img = layout.flat_to_image(
        jnp.concatenate([irr, m2[..., None]], axis=-1), W, rows
    )
    return SurfaceResult(
        irradiance=img, updates=upq, lc_samples=lcq, zeros=zq,
        live_in=live_in, gidx=gidx,
    )
