"""merian_quake_tpu — real-time path tracing framework in JAX.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
UnleqitDEV/merian-quake (a Vulkan real-time path tracer for Quake with
Markov Chain Path Guiding, ReSTIR DI and Screen-Space Mixture Models).

Layers (bottom → top), mirroring the reference's layer map
(see SURVEY.md §1), as dense array programs:

- ``ops``      : math/sampling kernel library (pure JAX + Pallas)
- ``models``   : scene sources — Quake asset loaders and procedural scenes
- ``accel``    : ray-scene intersection (cluster sweep kernel, no HW RT)
- ``render``   : gbuffer + integrators (PT / MCPG / ReSTIR / SSMM)
- ``post``     : accumulate, denoise, exposure, tonemap, fxaa
- ``graph``    : declarative frame graph with delayed edges + JSON config
- ``parallel`` : device-mesh sharding of the pixel grid
- ``game``     : game simulation bridge (entity animation, demo playback)
- ``utils``    : profiling, image IO, properties/config
"""

__version__ = "0.1.0"
