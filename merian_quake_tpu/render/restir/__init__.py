"""ReSTIR DI — reservoir-based direct lighting with temporal/spatial reuse.

Rebuild of /root/reference/src/render_restir +
res/shader/render_restir/* (weighted reservoir sampling per Bitterli et
al. 2020; structure follows the reference's 4 passes: generate →
temporal → spatial → shade). Reservoirs are SoA arrays over pixels;
ping-pong buffers become pure function outputs; the subgroup boiling
filter becomes an 8×8 tile mean reduction (the reference's subgroup ==
its 8×8 workgroup).
"""
from .restir import (  # noqa: F401
    ReSTIRConfig,
    ReSTIRState,
    init_restir_state,
    render_restir,
)
