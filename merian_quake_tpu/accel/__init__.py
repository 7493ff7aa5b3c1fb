"""Ray–scene intersection.

The reference outsources traversal to the Vulkan driver's BVH
(rayQueryEXT, raytrace.glsl:69-119), which JAX cannot reach, so this
layer computes it itself:

- ``build``: acceptance classes as per-triangle mask bits, a median-split
  cluster order with per-cluster AABBs, and the cluster-major SoA
  triangle layout;
- ``sweep``: the GPU kernel — one program per ray block loops over the
  clusters, skips those no ray can reach, and runs Möller–Trumbore on the
  rest (nearest-hit and any-hit modes);
- ``intersect``: dispatch (sweep on the GPU, the dense ``intersect_oracle``
  elsewhere and as the tests' reference), and the alpha-test any-hit loop
  done as bounded re-trace passes, gated on the per-triangle
  ``needs_alpha`` class (most hits commit without a texture fetch).
"""
from .build import AccelScene, build_accel  # noqa: F401
from .intersect import intersect, trace_nearest, HitRecord  # noqa: F401
