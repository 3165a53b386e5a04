"""Tiled sweep segments: the full-field path, modes ``'mh'`` and ``'gibbs'``.

Counterpart of ``deconv3d_tpu/ops/pallas_tiled.py``.  The spaxel grid
(``ny × nx`` blocks of ``f × f``) is cut into tiles of ``ny_t × nx_t``
blocks; a sweep walks the tiles in raster order and, inside each tile, all
f² colors, each (tile, color) step updating the tile's spaxels of that
color with the whole-cube sweep's per-spaxel math.  A step sees every
earlier step's commit, so this is a fixed MH-within-Gibbs scan of the same
posterior as the whole-cube one (``ops/sweep.py``), visited in another
order.  :func:`tiled_segment` runs each sweep as one launch of the
hand-written kernel ``csrc/tiled_sweep.cu`` on a CUDA device;
:func:`tiled_segment_reference` is the same scan in plain torch, which
:func:`tiled_segment` takes only for tensors on the CPU.  Both share ``ops/sweep.py``'s segment
(layout, per-(sweep, color, spaxel) outputs, Kahan χ², accumulators,
traces, injected uniforms in the same shapes).

Random numbers are keyed as in the whole-cube sweep, by (λ >> 2, absolute
sweep, color, stream << 24 | GLOBAL spaxel row) (``ops/philox.py``), not by
the tile as the TPU kernel keys them: a spaxel's visit draws the same
numbers under any tiling, so one tile ``(ny, nx)`` is the whole-cube sweep
bit for bit and the engines differ only in the order of their visits.

Tile planning.  The TPU kernel copies each tile's window (owned rows plus
the f − 1 halo) into VMEM.  On Hopper no window fits one SM's shared
memory (one f=17 patch at L=3681 is 4.3 MB); the level that can hold a
window is the L2 (50 MB on the H100), where it stays hot across the tile's
f² steps.  :func:`plan_tiles` keeps the TPU rule — most spaxels per step,
then the least total window volume — under a budget of the card's whole
L2 for the window's residual and weights (:func:`l2_budget_bytes`).
"""

from __future__ import annotations

import types
from typing import Optional, Tuple

import torch

from .. import sampler as sm
from . import sweep as sw

#: L2 of the H100 (bytes), the budget's base when no CUDA device is given
#: (CPU runs plan the tiles the card would)
H100_L2_BYTES = 50 * 2**20

#: launch counters of the two modes of ``csrc/tiled_sweep.cu``: each adds
#: one per kernel launch, and the plain version never adds to them
tiled_mh = types.SimpleNamespace(launches=0)
tiled_gibbs = types.SimpleNamespace(launches=0)


def l2_budget_bytes(device=None) -> int:
    """The tile budget: the L2 of ``device`` (a CUDA device), or the H100's
    for anything else.

    The whole L2, not a share of it: a step's fixed cost (its grid
    barriers, and in gibbs the λ-phase loop of one block per spaxel)
    outweighs what the window's residency saves, so the largest window that
    nominally fits wins.  At the full MUSE field (f=17, L=3681, float32
    weights) that is the (1, 2) window, 33·50·3681·8 B = 48.6 MB; on an
    H100 its sweep took 0.87 s (MH) and 2.98 s (gibbs) against 0.98 s and
    5.02 s with the 32 MB (1, 1) window that 0.75 of the L2 would plan
    (PERF.md §6; ``python -m deconv3d_tpu_torch.tile_sweep`` measures it).
    """
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.get_device_properties(
            torch.device(device)).L2_cache_size
    return H100_L2_BYTES


def tile_geometry(f: int, ny_t: int, nx_t: int):
    """(BY, BX, Hp_t, Wp_t): a tile's rows and columns, and its window's —
    the owned rows and columns plus the f − 1 halo."""
    BY, BX = ny_t * f, nx_t * f
    return BY, BX, BY + f - 1, BX + f - 1


def window_bytes(f: int, ny_t: int, nx_t: int, L: int, w_bytes: int = 4) -> int:
    """Bytes of one tile's window: float32 residual plus the weights."""
    _, _, Hp_t, Wp_t = tile_geometry(f, ny_t, nx_t)
    return Hp_t * Wp_t * L * (4 + w_bytes)


def _divisors(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


def plan_tiles(f: int, ny: int, nx: int, L: int, budget: int,
               w_bytes: int = 4) -> Optional[Tuple[int, int]]:
    """(ny_t, nx_t) over the divisors of (ny, nx) with the most spaxels per
    step whose window fits ``budget`` bytes; among equal spaxel counts the
    least total window volume.  None when no window fits."""
    best = None
    for ny_t in _divisors(ny):
        for nx_t in _divisors(nx):
            if window_bytes(f, ny_t, nx_t, L, w_bytes) > budget:
                continue
            _, _, Hp_t, Wp_t = tile_geometry(f, ny_t, nx_t)
            volume = (ny // ny_t) * (nx // nx_t) * Hp_t * Wp_t * L
            key = (ny_t * nx_t, -volume)
            if best is None or key > best[0]:
                best = (key, (ny_t, nx_t))
    return None if best is None else best[1]


def _tile(problem: sm.Problem, tile) -> Tuple[int, int]:
    tile = problem.config.tile if tile is None else tile
    if tile is None:
        raise ValueError("a tiled segment needs a tile: make_problem with a "
                         "tiled engine, or pass tile=(ny_t, nx_t)")
    ny_t, nx_t = int(tile[0]), int(tile[1])
    if ny_t < 1 or nx_t < 1 or problem.ny % ny_t or problem.nx % nx_t:
        raise ValueError(f"tile {tile} does not divide the {problem.ny}x"
                         f"{problem.nx} spaxel-block grid")
    return ny_t, nx_t


def _mode(problem: sm.Problem) -> str:
    return "gibbs" if problem.config.sampler == "gibbs" else "mh"


def tiled_segment_reference(problem: sm.Problem, state: sm.SamplerState,
                            n_sweeps: int,
                            uniforms: Optional[torch.Tensor] = None,
                            record_uniforms: bool = False,
                            tile: Optional[Tuple[int, int]] = None
                            ) -> sw.Segment:
    """``n_sweeps`` tiled sweeps of ``config.sampler`` in plain torch (the
    kernel's plain version), on whatever device the problem lives on.
    ``tile`` defaults to ``config.tile``; ``uniforms`` as in
    ``ops/sweep.py``."""
    return sw._run_segment(problem, state, n_sweeps, uniforms,
                           record_uniforms, mode=_mode(problem),
                           tile=_tile(problem, tile))


def tiled_segment(problem: sm.Problem, state: sm.SamplerState, n_sweeps: int,
                  uniforms: Optional[torch.Tensor] = None,
                  record_uniforms: bool = False,
                  tile: Optional[Tuple[int, int]] = None) -> sw.Segment:
    """``n_sweeps`` tiled sweeps of ``config.sampler``; each one launch of
    ``csrc/tiled_sweep.cu`` for the whole batch of chains.

    On a CUDA device every sweep goes through the kernel (a failed build or
    launch raises); only for tensors on the CPU does it run the plain
    version.  :data:`tiled_mh` / :data:`tiled_gibbs` count the launches.
    """
    mode = _mode(problem)
    use = sw._use_kernel(problem, state, "tiled_segment")
    counter = (tiled_gibbs if mode == "gibbs" else tiled_mh) if use else None
    return sw._run_segment(problem, state, n_sweeps, uniforms,
                           record_uniforms, mode=mode, counter=counter,
                           tile=_tile(problem, tile))
