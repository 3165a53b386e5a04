"""The least time one sweep could take on the card, and the card's peaks.

A frozen copy of the sweep bound the port's chip smoke uses: flops and
bytes from the problem's shapes and the run's acceptance, the same
whatever kernel does the work, held against the published peaks of one
NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): 67 TFLOP/s float32
outside the tensor cores and 3.35 TB/s of HBM3, at a 700 W power limit.
A card set below 700 W runs slower under load; :func:`card` reads its
name and limit so that every share is printed beside them.
"""

from __future__ import annotations

import subprocess

F32_FLOP_PER_S = 67e12
HBM_BYTE_PER_S = 3.35e12


def sweep_bound(shapes: dict, C: int, accept: float) -> dict:
    """The least time of one sweep of ``C`` chains: max(flops / float32
    peak, bytes / HBM bandwidth), with what bounds it.

    ``shapes``: ``f``, ``L``, ``S`` (the FSF's rank), ``lw``, ``n_valid``
    (spaxels swept), ``Hp``, ``Wp`` (the padded residual's plane),
    ``n_colors``, ``ny``, ``nx``, ``sampler`` and ``positivity``.

    Flops (a multiply or add 1, an fma 2; transcendentals not counted) of
    what this run's data needs: per valid spaxel visit the patch
    contraction (f² L (1 + 2S): resid·w and S fmas) and lin (2S per λ); MH
    the jump's band and Δχ² share (2 lw + 6 per λ) and, per ACCEPTED visit
    (``accept``: the run's acceptance), the commit (f² L (2S + 1)) and
    clean += jump; gibbs per λ the transpose band (2 lw), the draw (3), lw
    phase updates (4 each), the Δχ² terms (9) and clean += jump, and the
    commit of every live visit.  Bytes: each input read once, each output
    written once, of what the visits touch: resid read and written whole
    (the committed patches cover it); weights read; per valid spaxel quad,
    and for gibbs qvox and quad_lo, read; clean read and written at the
    committed visits' spaxels only (MH: the accepted ones, gibbs: every
    live visit); LSF, FSF and per-spaxel outputs.  ``accept`` is ignored
    for gibbs.  With positivity MH also reads clean at every valid visit
    and reflects (3 per λ); gibbs' truncated draw adds its mean, σ·z and
    clamp (6 per λ)."""
    f, L, S, lw = (int(shapes[k]) for k in ("f", "L", "S", "lw"))
    valid = float(shapes["n_valid"])
    visits = C * valid
    patch = f * f * L
    flops = visits * (patch * (1 + 2 * S) + L * 2 * S)
    gibbs = shapes["sampler"] == "gibbs"
    if gibbs:
        committed = visits
        flops += visits * (L * (2 * lw + 3 + 4 * lw + 9 + 1)
                           + patch * (2 * S + 1))
    else:
        committed = visits * float(accept)
        flops += visits * L * (2 * lw + 6) + committed * (
            patch * (2 * S + 1) + L)
    positivity = bool(shapes["positivity"])
    if positivity:
        flops += visits * L * (6 if gibbs else 3)
    spectrum = L * 4
    nbytes = (2 * C * shapes["Hp"] * shapes["Wp"] * spectrum
              + shapes["Hp"] * shapes["Wp"] * spectrum
              + valid * spectrum * (3 if gibbs else 1)
              + 2 * committed * spectrum
              + (0 if gibbs or not positivity
                 else (visits - committed) * spectrum)
              + L * lw * 4 + S * (L + f * f) * 4
              + 2 * C * shapes["n_colors"] * shapes["ny"] * shapes["nx"] * 4)
    t_ops, t_bytes = flops / F32_FLOP_PER_S, nbytes / HBM_BYTE_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def card() -> dict:
    """The first card's name and power limit as ``nvidia-smi`` reads them
    (empty where it cannot)."""
    try:
        text = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    name, limit = (v.strip() for v in text.rsplit(",", 1))
    return {"name": name, "power_limit": limit}
