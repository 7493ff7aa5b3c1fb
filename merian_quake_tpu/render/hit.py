"""Hit records, uncompressed and compressed.

Mirrors /root/reference/res/shader/hit.glsl.h: ``Hit`` carries positions
and material at a surface interaction; ``CompressedHit`` is the gbuffer
→ integrator handoff format (octahedral-encoded directions, low-precision
mv/albedo/roughness). The reference stores f16; we use bfloat16. Note the reference has a latent layout inconsistency
(ReSTIR/SSMM read the same buffer as uncompressed, SURVEY §2.2) — here
one format is used everywhere.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..ops import octahedral


class Hit(NamedTuple):
    pos: jnp.ndarray  # f32[..., 3]
    prev_pos: jnp.ndarray  # f32[..., 3]
    wi: jnp.ndarray  # f32[..., 3] incoming ray direction (toward surface)
    normal: jnp.ndarray  # f32[..., 3] shading normal
    geo_normal: jnp.ndarray  # f32[..., 3] geometric normal
    albedo: jnp.ndarray  # f32[..., 3]
    roughness: jnp.ndarray  # f32[...]


class CompressedHit(NamedTuple):
    pos: jnp.ndarray  # f32[..., 3]
    mv: jnp.ndarray  # bf16[..., 3] pos - prev_pos
    wi: jnp.ndarray  # u32[...] octahedral
    normal: jnp.ndarray  # u32[...]
    geo_normal: jnp.ndarray  # u32[...]
    albedo: jnp.ndarray  # bf16[..., 3]
    roughness: jnp.ndarray  # bf16[...]


def compress_hit(h: Hit) -> CompressedHit:
    return CompressedHit(
        pos=h.pos,
        mv=(h.pos - h.prev_pos).astype(jnp.bfloat16),
        wi=octahedral.encode_normal(h.wi),
        normal=octahedral.encode_normal(h.normal),
        geo_normal=octahedral.encode_normal(h.geo_normal),
        albedo=h.albedo.astype(jnp.bfloat16),
        roughness=h.roughness.astype(jnp.bfloat16),
    )


def decompress_hit(c: CompressedHit) -> Hit:
    return Hit(
        pos=c.pos,
        prev_pos=c.pos - c.mv.astype(jnp.float32),
        wi=octahedral.decode_normal(c.wi),
        normal=octahedral.decode_normal(c.normal),
        geo_normal=octahedral.decode_normal(c.geo_normal),
        albedo=c.albedo.astype(jnp.float32),
        roughness=c.roughness.astype(jnp.float32),
    )
