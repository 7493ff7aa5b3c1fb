"""Phase functions: isotropic, Henyey–Greenstein, Draine.

Equivalent of ``merian-shaders/phase_draine.glsl`` /
``phase_isotropic.glsl`` (volume.comp:119-195). The Draine phase is
parameterized by (g, alpha); the reference computes both from a fog
particle size via the fits of Jendersie & d'Eon, "An Approximate Mie
Scattering Function for Fog and Cloud Rendering" (SIGGRAPH 2023 talk) —
see render_mcpg.cpp:134-135 and scripts/draine_parameters.py.
Exact Draine sampling follows the same paper's closed form.
"""
from __future__ import annotations

import jax.numpy as jnp

from . import linalg

INV_4PI = 1.0 / (4.0 * jnp.pi)


def isotropic_pdf(shape=()):
    return jnp.full(shape, INV_4PI)


def sample_isotropic(u: jnp.ndarray) -> jnp.ndarray:
    """Uniform sphere direction from u: [..., 2]."""
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def hg_pdf(cos_theta, g):
    g = jnp.asarray(g)
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / jnp.power(jnp.maximum(denom, 1e-12), 1.5)


def hg_sample_cos(u1, g):
    g = jnp.asarray(g)
    small = jnp.abs(g) < 1e-3
    safe_g = jnp.where(small, 0.5, g)
    sqr = (1.0 - safe_g * safe_g) / (1.0 - safe_g + 2.0 * safe_g * u1)
    cos_t = (1.0 + safe_g * safe_g - sqr * sqr) / (2.0 * safe_g)
    return jnp.clip(jnp.where(small, 1.0 - 2.0 * u1, cos_t), -1.0, 1.0)


def draine_pdf(cos_theta, g, alpha):
    """Draine (1atm) phase: HG * (1 + alpha cos^2) / (1 + alpha(1+2g^2)/3)."""
    g = jnp.asarray(g)
    alpha = jnp.asarray(alpha)
    norm = 1.0 + alpha * (1.0 + 2.0 * g * g) / 3.0
    return hg_pdf(cos_theta, g) * (1.0 + alpha * cos_theta * cos_theta) / norm


DRAINE_TABLE_SIZE = 1024


def draine_inverse_cdf_table(g, alpha, size=DRAINE_TABLE_SIZE):
    """Tabulated inverse CDF of cos(theta) for the Draine phase.

    (g, alpha) are per-frame constants in the reference (computed from
    the fog particle size, render_mcpg.cpp:134-135), so a per-frame
    host-precomputed table is the natural choice: the closed-form
    inversion (Jendersie & d'Eon 2023) catastrophically cancels in
    float32 at strong anisotropy, and the device path stays in float32.

    Returns float32[size] mapping u in [0,1) (left bin edges) → cos_t.
    """
    import numpy as np

    g = float(g)
    alpha = float(alpha)
    n_fine = 1 << 14
    cos_grid = np.linspace(-1.0, 1.0, n_fine, dtype=np.float64)
    # pure-numpy Draine pdf (host-side: g/alpha are static per frame)
    denom = np.maximum(1.0 + g * g - 2.0 * g * cos_grid, 1e-12)
    hg = (1.0 - g * g) / (4.0 * np.pi * np.power(denom, 1.5))
    norm_d = 1.0 + alpha * (1.0 + 2.0 * g * g) / 3.0
    p = hg * (1.0 + alpha * cos_grid * cos_grid) / norm_d
    # CDF over cos via trapezoid; normalized (pdf integrates over sphere
    # to 1 => over cos with 2*pi azimuth factor).
    cdf = np.concatenate([[0.0], np.cumsum((p[1:] + p[:-1]) * 0.5 * np.diff(cos_grid))])
    cdf /= cdf[-1]
    u = (np.arange(size, dtype=np.float64) + 0.5) / size
    cos_t = np.interp(u, cdf, cos_grid)
    return jnp.asarray(cos_t, jnp.float32)


def draine_sample_cos_table(u1, table):
    """Sample cos(theta) by linear interpolation into a precomputed table."""
    size = table.shape[0]
    x = jnp.clip(u1 * size - 0.5, 0.0, size - 1.0)
    i0 = jnp.floor(x).astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, size - 1)
    w = x - i0.astype(jnp.float32)
    return jnp.clip(table[i0] * (1.0 - w) + table[i1] * w, -1.0, 1.0)


def draine_sample_cos(u1, g, alpha, table=None):
    """Sample cos(theta) ~ Draine(g, alpha).

    Uses the inverse-CDF table (precompute once per (g, alpha) via
    :func:`draine_inverse_cdf_table` and pass it for jit-friendliness).
    """
    if table is None:
        table = draine_inverse_cdf_table(g, alpha)
    return draine_sample_cos_table(u1, table)


def sample_dir(w: jnp.ndarray, cos_theta, u_phi) -> jnp.ndarray:
    """Direction at angle acos(cos_theta) around axis w, azimuth u_phi."""
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    phi = 2.0 * jnp.pi * u_phi
    local = jnp.stack(
        [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_theta], axis=-1
    )
    return linalg.frame_to_world(w, local)


def draine_params_from_particle_size(d):
    """Fog/cloud droplet diameter d (µm) → (g_hg_unused, g_d, alpha, w_d).

    Mie fit for small water droplets (0.1 <= d <= 1.5), Jendersie & d'Eon
    2023 eq. fits — the regime the reference exposes as 'particle size'
    (render_mcpg.cpp:134-135).
    """
    import numpy as np

    d = float(d)
    g_hg = np.exp(-0.0990567 / (d - 1.67154))
    g_d = np.exp(-2.20679 / (d + 3.91029) - 0.428934)
    a = np.exp(3.62489 - 8.29288 / (d + 5.52825))
    w_d = np.exp(-0.599085 / (d - 0.641583) - 0.665888)
    return g_hg, g_d, a, w_d
