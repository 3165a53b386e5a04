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
:func:`tiled_segment` takes only for tensors on the CPU.  Both share
``ops/sweep.py``'s segment (layout, per-(sweep, color, spaxel) outputs,
Kahan χ², accumulators, traces, injected uniforms in the same shapes).

Random numbers are keyed as in the whole-cube sweep, by (λ >> 2, absolute
sweep, color, stream << 24 | GLOBAL spaxel row) (``ops/philox.py``), not by
the tile as the TPU kernel keys them: a spaxel's visit draws the same
numbers under any tiling, so one tile ``(ny, nx)`` is the whole-cube sweep
bit for bit and the engines differ only in the order of their visits.

The schedule.  The TPU runs its tiles one after another; on the card that
leaves most SMs idle (a (1, 2) tile of the full MUSE field is two spaxels
per step).  :func:`wave_schedule` runs the tiles that share no window side
by side, in waves, and gives the raster sweep bit for bit in far fewer
dependent steps; it is the default, the raster stays for comparison.

Tile planning.  The TPU kernel copies each tile's window (owned rows plus
the f − 1 halo) into VMEM and plans the tile under VMEM's size.  On Hopper
no window fits one SM's shared memory (one f=17 patch at L=3681 is 4.3 MB)
and the window is not copied.  :func:`plan_tiles` keeps the TPU rule — most
spaxels per step, then the least total window volume — under a window
budget that was measured on the card (:data:`WINDOW_BUDGET_BYTES`).
"""

from __future__ import annotations

import types
from typing import List, Optional, Tuple

import torch

from .. import sampler as sm
from . import sweep as sw

#: the tile budget: the largest window (a tile's residual and weights, in
#: bytes) the planner takes, and the size of field above which
#: ``engine='auto'`` leaves the whole-cube kernel for the tiled one
#: (``sampler.resolve_engine``).  A measured constant, the same for every
#: device.  A sweep's time falls with every larger tile — fewer dependent
#: steps, each a few grid barriers — while the window stays under about a
#: gigabyte, and rises again above: on an NVIDIA H100 80GB HBM3 the full
#: MUSE field (f=17, L=3681; 4.6 GB of residual and weights) took 469 ms
#: (MH) and 974 ms (gibbs) per sweep in (1, 2) tiles, 406 / 817 in (3, 3),
#: 391 / 759 in (6, 6), 393 / 744 in (9, 9) tiles of 0.84 GB windows, and
#: 440 / 811 ms as one tile, the whole-cube kernel; a (9, 18) tile of
#: 1.6 GB was slower than (9, 9) too.  Fields under the budget are fastest
#: as one tile (60×60×3681, 0.2 GB: 21.6 / 37.8 ms against 25–33 / 50–69 in
#: smaller tiles).  The 50 MB L2 plays no part.  Every byte comes from
#: device memory either way; what a window of that size keeps is not
#: measured (the reach of the address translation caches is a guess).
#: PERF.md §6 has the runs (``python -m deconv3d_tpu_torch.tile_sweep``).
WINDOW_BUDGET_BYTES = 2**30

#: launch counters of the two modes of ``csrc/tiled_sweep.cu``: each adds
#: one per kernel launch, and the plain version never adds to them
tiled_mh = types.SimpleNamespace(launches=0)
tiled_gibbs = types.SimpleNamespace(launches=0)
#: the same kernel's band launches (:func:`band_sweep`, :func:`band_segment`;
#: the sweeps of ``parallel/kernel_sharded.py``)
band_mh = types.SimpleNamespace(launches=0)
band_gibbs = types.SimpleNamespace(launches=0)


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


#: the tile schedules: ``'raster'`` runs one tile after another, as the TPU
#: kernel's grid does; ``'wavefront'`` runs the tiles that share no window
#: side by side and gives the same bits
SCHEDULES = ("raster", "wavefront")


def wave_schedule(Ty: int, Tx: int, schedule: str = "wavefront"
                  ) -> List[List[int]]:
    """The waves of a sweep over Ty × Tx tiles: lists of raster tile
    indices ``ti · Tx + tj``, run in order, the tiles of one wave side by
    side (color by color).

    ``'wavefront'``: tile (ti, tj) runs in wave 2·ti + tj.  The neighbours
    that precede it in raster order — (ti, tj−1), (ti−1, tj−1), (ti−1, tj),
    (ti−1, tj+1) — are 1, 3, 2 and 1 waves earlier, the later ones later,
    and two tiles of one wave lie at least two tile columns apart, so their
    windows (the owned columns plus f − 1 of halo) do not meet: every tile
    sees exactly the commits it sees in the raster, and the sweep is the
    raster sweep bit for bit in 2·(Ty − 1) + Tx waves (Ty when Tx = 1)
    instead of Ty · Tx.  ``'raster'``: one tile per wave."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, "
                         f"got {schedule!r}")
    if schedule == "raster":
        return [[t] for t in range(Ty * Tx)]
    waves: List[List[int]] = [[] for _ in range(2 * (Ty - 1) + Tx)]
    for ti in range(Ty):
        for tj in range(Tx):
            waves[2 * ti + tj].append(ti * Tx + tj)
    return [wave for wave in waves if wave]


def _waves(problem: sm.Problem, tile: Tuple[int, int], schedule: str):
    return wave_schedule(problem.ny // tile[0], problem.nx // tile[1],
                         schedule)


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
                            tile: Optional[Tuple[int, int]] = None,
                            schedule: str = "wavefront") -> sw.Segment:
    """``n_sweeps`` tiled sweeps of ``config.sampler`` in plain torch (the
    kernel's plain version), on whatever device the problem lives on.
    ``tile`` defaults to ``config.tile``; ``schedule`` as
    :func:`wave_schedule` (both give the same bits); ``uniforms`` as in
    ``ops/sweep.py``."""
    tile = _tile(problem, tile)
    return sw._run_segment(problem, state, n_sweeps, uniforms,
                           record_uniforms, mode=_mode(problem), tile=tile,
                           waves=_waves(problem, tile, schedule))


def tiled_segment(problem: sm.Problem, state: sm.SamplerState, n_sweeps: int,
                  uniforms: Optional[torch.Tensor] = None,
                  record_uniforms: bool = False,
                  tile: Optional[Tuple[int, int]] = None,
                  schedule: str = "wavefront") -> sw.Segment:
    """``n_sweeps`` tiled sweeps of ``config.sampler``; each one launch of
    ``csrc/tiled_sweep.cu`` for the whole batch of chains, the tiles in
    the order of ``schedule`` (:func:`wave_schedule`; both give the same
    bits).

    On a CUDA device every sweep goes through the kernel (a failed build or
    launch raises); only for tensors on the CPU does it run the plain
    version.  :data:`tiled_mh` / :data:`tiled_gibbs` count the launches.
    """
    return tuned_segment(problem, state, n_sweeps, uniforms, record_uniforms,
                         tile=_tile(problem, tile), schedule=schedule)


def tuned_segment(problem: sm.Problem, state: sm.SamplerState, n_sweeps: int,
                  uniforms: Optional[torch.Tensor] = None,
                  record_uniforms: bool = False,
                  tile: Optional[Tuple[int, int]] = None,
                  schedule: str = "wavefront", stages: int = -1,
                  lam_b: Optional[int] = None) -> sw.Segment:
    """The measurements' entry (``tile_sweep``, ``task_phases``, the knob
    tests): :func:`tiled_segment` in ``tile`` — or, with ``tile`` None, the
    classic whole-cube kernel — under the kernels' tuning knobs ``stages``
    and ``lam_b`` of ``ops.sweep._run_segment``, which the entry points
    leave at the shipped rules.  Any setting gives the same bits."""
    mode = _mode(problem)
    use = sw._use_kernel(problem, state, "tuned_segment")
    if tile is None:
        counter = sw.gibbs_segment if mode == "gibbs" else sw.mh_segment
        waves = None
    else:
        counter = tiled_gibbs if mode == "gibbs" else tiled_mh
        tile = _tile(problem, tile)
        waves = _waves(problem, tile, schedule)
    return sw._run_segment(problem, state, n_sweeps, uniforms,
                           record_uniforms, mode=mode,
                           counter=counter if use else None, tile=tile,
                           classic=tile is None, waves=waves, stages=stages,
                           lam_b=lam_b)


# ---------------------------------------------------------------------------
# Bands: the y_base launch of the TPU kernel
# ---------------------------------------------------------------------------

def band_sweep(k: sw._SweepState, mode: str, sweep: int, adapt: float,
               u: Optional[torch.Tensor], out_a: torch.Tensor,
               out_b: torch.Tensor, kernel: bool) -> None:
    """One sweep of the band ``k.rows`` of the carried state ``k`` (a tiled
    ``ops.sweep._SweepState``: a shard's residual with its replica rows,
    ``k.gy0`` its first block row in the field): all f² colors of every
    tile of the band, waves in order.  ``kernel``: one launch of
    ``csrc/tiled_sweep.cu`` (counted by :data:`band_mh` /
    :data:`band_gibbs`; a failed launch raises), else the same scan in
    plain torch (``u`` then required).  The TPU kernel's ``y_base``
    (``deconv3d_tpu/ops/pallas_tiled.py:155``, ``:190-192``)."""
    counter = band_gibbs if mode == "gibbs" else band_mh
    sw._sweep(k, mode, counter if kernel else None, sweep, adapt, u, out_a,
              out_b, None)


def band_segment(problem: sm.Problem, state: sm.SamplerState, n_sweeps: int,
                 rows, gy0: int = 0,
                 record_uniforms: bool = False) -> sw.Segment:
    """``n_sweeps`` sweeps of only the block rows ``rows`` = (first, count)
    of the problem's grid, the band as one tile on the Philox draws, whose
    row 0 is the field's block row ``gy0`` (it keys the draws); the other
    rows' outputs stay 0.  On a CUDA device one band launch of
    ``csrc/tiled_sweep.cu`` per sweep (:data:`band_mh` /
    :data:`band_gibbs`); for tensors on the CPU the plain version."""
    mode = _mode(problem)
    use = sw._use_kernel(problem, state, "band_segment")
    by0, nyb = (int(r) for r in rows)
    if by0 < 0 or nyb < 1 or by0 + nyb > problem.ny:
        raise ValueError(f"rows {tuple(rows)} leave the {problem.ny} block "
                         "rows of the grid")
    counter = band_gibbs if mode == "gibbs" else band_mh
    return sw._run_segment(problem, state, n_sweeps, None, record_uniforms,
                           mode=mode, counter=counter if use else None,
                           tile=(nyb, problem.nx), waves=[[0]],
                           rows=(by0, nyb), gy0=gy0)
