"""Declarative frame graph with typed connectors and delayed edges.

Equivalent of merian's ``merian_nodes::Graph<>`` (SURVEY
§2.4): nodes declare named inputs/outputs, connections wire them (with
an optional one-frame delay — the reference's ``("prev_gbuffer", 1)``
connectors and history self-loops), the graph topologically orders the
nodes and compiles the whole frame into ONE jitted pure function over
(persistent node states, frame inputs). The JSON config is the pipeline
definition, exactly like res/default_config.json in the reference.

Vulkan concepts map as: command buffer recording → XLA trace; barriers
→ dataflow edges; resource allocation on connect → state init; node
property diff → static-config change (recompile), matching the
reference's pipeline-rebuild-on-property-change lifecycle
(render_mcpg.cpp:419-578).
"""
from .graph import Graph, Node, InputSpec  # noqa: F401
from . import nodes  # noqa: F401  (registers built-in node types)
