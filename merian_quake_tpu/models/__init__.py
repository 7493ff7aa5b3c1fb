"""Scene sources: geometry/material buffers, texture atlas, loaders.

Replacement of the reference's scene-extraction layer
(src/game/quake_node.* and quake_helpers.* producing vtx/prev_vtx/idx/ext
buffers + a 4096-texture array, see quake_node.hpp:181-193). The device
representation is structure-of-arrays with static shapes (padded), which
is what XLA wants — the reference's packed ``VertexExtraData`` bitfields
are unpacked at upload time on the host.
"""
from .types import Scene, Uniforms, RenderConfig  # noqa: F401
