"""Coarse-grid pattern passes: the auto-enable rule only.

Counterpart of the ``auto_coarse_every`` rule of
``deconv3d_tpu/ops/coarse.py``.  The passes themselves are not ported yet
(ROADMAP.md, Queue 1 item 13): :class:`deconv3d_tpu_torch.Run` raises where
this rule would switch them on, instead of silently running without them.
"""

from __future__ import annotations

#: auto-enable threshold for interleaved global passes (spaxel count); the
#: JAX package measured them as a wall-clock ESS/s win only from here up
COARSE_AUTO_MIN_SPAXELS = 10_000

#: minimum FSF footprint for the auto default: a narrow FSF leaves no slow
#: blur-null modes for the pass to attack
COARSE_AUTO_MIN_F = 9


def auto_coarse_every(problem):
    """Data-driven default for ``coarse_every`` (None = stay plain).

    Fires for ``sampler='mh'`` without positivity on fields of at least
    ``COARSE_AUTO_MIN_SPAXELS`` spaxels with footprint ≥
    ``COARSE_AUTO_MIN_F``.
    """
    cfg = problem.config
    if (
        cfg.sampler == "mh"
        and not cfg.positivity
        and problem.Y * problem.X >= COARSE_AUTO_MIN_SPAXELS
        and problem.f >= COARSE_AUTO_MIN_F
    ):
        return 8
    return None
