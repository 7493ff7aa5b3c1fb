"""Screen-Space Mixture Models (SSMM) guided path tracing.

Rebuild of /root/reference/src/render_ssmm +
res/shader/render_ssmm/ssmm.comp (Dittebrandt et al. 2020 style;
the reference is ported from VKDT with the author's approval).
Per-pixel vMF Markov chains live in screen space; proposals are
exchanged via lane shuffles (here: rolls over the pixel array) and
stochastic reads of the previous frame's state buffer, combined with a
stochastic-MIS (SMIS) estimator over the sample group's lobes.
"""
from .ssmm import SSMMConfig, SSMMState, init_ssmm_state, render_ssmm  # noqa: F401
