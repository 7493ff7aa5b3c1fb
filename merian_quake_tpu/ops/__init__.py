"""Math/sampling kernel library (pure JAX, VPU-friendly).

Replacement for the reference's ``merian-shaders`` GLSL library
(see use sites at /root/reference/res/shader/raytrace.glsl:12-20 and
render_mcpg/mcpg.comp:12-23). Every function is shape-polymorphic over
leading batch dimensions and safe under ``jit``/``vmap``.
"""
