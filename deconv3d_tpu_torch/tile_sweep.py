"""Time the tiled kernel at several tiles and schedules beside the
whole-cube kernel.

    python -m deconv3d_tpu_torch.tile_sweep                  # 60×60 and 300×300
    python -m deconv3d_tpu_torch.tile_sweep --size 300 --tiles 1x1,1x2,2x2 \
        --schedule raster,wavefront --stages=-1,0 --lam-b 0,3681

Needs one CUDA card.  For each field size (a MUSE cube of L=3681 made on
the card from a seeded generator, as ``field_cube``) and each sampler, one
problem and state; then one sweep of the whole-cube kernel (K1) and one of
the tiled kernel (K2) per tile and schedule, each timed with CUDA events
after a warm-up sweep, for every setting of the kernels' knobs:
``--stages`` the ring of asynchronous copies (-1: as many stages as fit,
0: synchronous loads, the task as it was before the ring) and ``--lam-b``
the wavelengths per slab of gibbs phase (b) (0: the shipped rule
``ops.sweep.phase_slab``; L: one block per (chain, spaxel), as before the
slabs).  Prints one JSON line per (size, sampler) with the waves, steps
and window bytes of every (tile, schedule), the tile and schedule
``plan_tiles`` picks and the engine ``resolve_engine`` takes — the
measurements behind both — then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from . import sampler as sm
from .cube import Cube
from .instruments import MUSE
from .ops import tiled as tl


def field_cube(L: int = 3681, Y: int = 300, X: int = 300, seed: int = 0,
               device: str = "cuda") -> Cube:
    """A MUSE field made on ``device`` from a seeded generator: unit noise
    and two emission lines (50 and 30) at the bench subcube's positions,
    scaled to the field."""
    gen = torch.Generator(device=device).manual_seed(seed)
    data = torch.randn((L, Y, X), generator=gen, device=device)
    data[L * 300 // 600, Y // 2, X // 2] += 50.0
    data[L * 200 // 600, Y * 8 // 30, X * 20 // 30] += 30.0
    return Cube.from_data(data, variance=torch.ones_like(data),
                          crval=4750.0, cdelt=1.25)


def _ms(fn) -> float:
    """ms of one ``fn()`` between CUDA events, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def parse_tile(text: str):
    """'2x3' → (2, 3)."""
    ny_t, nx_t = (int(v) for v in text.split("x"))
    return ny_t, nx_t


def default_tiles(ny: int, nx: int):
    """(1, 1), (1, 2) and every square tile that divides the grid."""
    tiles = [(1, 1), (1, 2)] + [(d, d) for d in range(2, min(ny, nx) + 1)
                                if ny % d == 0 and nx % d == 0]
    return [t for t in tiles if ny % t[0] == 0 and nx % t[1] == 0]


def sweep_tiles(cube: Cube, sampler: str, tiles=None,
                schedules=tl.SCHEDULES, stages=(-1,), lam_bs=(0,)) -> dict:
    """ms per sweep of the whole-cube kernel (classic K1, pinned) and of
    the tiled kernel at each of ``tiles`` (default :func:`default_tiles`)
    and ``schedules``, one state, for every (stages, λ_b) setting."""
    problem = sm.make_problem(cube, MUSE(), sm.RunConfig(
        seed=0, sampler=sampler, engine="cuda"))
    state = sm.init_state(problem)
    f, L = problem.f, problem.L
    budget = tl.WINDOW_BUDGET_BYTES
    auto = sm.resolve_engine(sm.RunConfig(sampler=sampler), problem.device,
                             f, problem.ny, problem.nx, L)
    out = {"shape": list(cube.shape), "sampler": sampler, "f": f,
           "window_budget_bytes": budget,
           "planned": tl.plan_tiles(f, problem.ny, problem.nx, L, budget),
           "auto_engine": list(auto), "k1_ms": [], "tiles": []}
    settings = [(st, lb) for st in stages
                for lb in (lam_bs if sampler == "gibbs" else (0,))]
    for st, lb in settings:
        knobs = {"stages": st, **({"lam_b": lb} if lb else {})}
        out["k1_ms"].append({"stages": st, "lam_b": lb, "ms": _ms(
            lambda: tl.tuned_segment(problem, state, 1, **knobs))})
        for tile in tiles or default_tiles(problem.ny, problem.nx):
            for schedule in schedules:
                waves = tl.wave_schedule(problem.ny // tile[0],
                                         problem.nx // tile[1], schedule)
                ms = _ms(lambda: tl.tuned_segment(
                    problem, state, 1, tile=tile, schedule=schedule, **knobs))
                out["tiles"].append({
                    "tile": list(tile), "schedule": schedule, "stages": st,
                    "lam_b": lb, "ms": ms, "waves": len(waves),
                    "steps": len(waves) * problem.n_colors,
                    "max_wave_tiles": max(map(len, waves)),
                    "window_bytes": tl.window_bytes(f, *tile, L)})
    return out


def _ints(text: str):
    return tuple(int(v) for v in text.split(","))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, action="append",
                    help="field side in spaxels (repeatable; default 60, 300)")
    ap.add_argument("--tiles", help="comma list of NYxNX tiles "
                    "(default: 1x1, 1x2 and every square that divides)")
    ap.add_argument("--schedule", default=",".join(tl.SCHEDULES),
                    help="comma list of schedules (default: both)")
    ap.add_argument("--stages", default="-1", help="comma list of ring "
                    "stages (-1: as many as fit, 0: synchronous loads)")
    ap.add_argument("--lam-b", default="0", help="comma list of gibbs "
                    "phase (b) slab widths (0: the shipped rule)")
    ap.add_argument("--sampler", default="mh,gibbs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep: needs a CUDA device")
    tiles = ([parse_tile(t) for t in args.tiles.split(",")]
             if args.tiles else None)
    for size in args.size or (60, 300):
        cube = field_cube(Y=size, X=size)
        for sampler in args.sampler.split(","):
            print(json.dumps(sweep_tiles(
                cube, sampler, tiles, tuple(args.schedule.split(",")),
                _ints(args.stages), _ints(args.lam_b))), flush=True)
        del cube
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
