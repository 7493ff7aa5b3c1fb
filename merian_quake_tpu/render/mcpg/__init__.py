"""Markov Chain Path Guiding (MCPG) — the flagship integrator.

Rebuild of /root/reference/src/render_mcpg + its kernels
(mcpg.comp, compute_updates.comp, mc.glsl, light_cache.glsl,
volume.comp): two world-space hash grids of Markov-chain vMF states
guide path directions; paths emit update samples that are replayed into
the chains in a second phase; a light cache stores EWA irradiance for
path tails and volume NEE.

Device atomics (update queue, light-cache spinlock) are not used. The
reference's own two-phase design is already the right shape
(SURVEY §2.6): updates become dense masked sample arrays, grouped by
cell with scatter/segment reductions, replayed with a batched EWA and
an exponential-race weighted-reservoir winner per cell.
"""
from .config import MCPGConfig, MCPGState, init_mcpg_state  # noqa: F401
from .surface import render_mcpg_surface  # noqa: F401
from .updates import apply_updates  # noqa: F401
