"""Time the tiled kernel at several tiles beside the whole-cube kernel.

    python -m deconv3d_tpu_torch.tile_sweep                  # 60×60 and 300×300
    python -m deconv3d_tpu_torch.tile_sweep --size 300 --tiles 1x1,1x2,2x2

Needs one CUDA card.  For each field size (a MUSE cube of L=3681 made on
the card from a seeded generator, as ``field_cube``) and each sampler, one
problem and state; then one sweep of the whole-cube kernel and one of the
tiled kernel per tile, each timed with CUDA events after a warm-up sweep.
Prints one JSON line per (size, sampler) with the window bytes of every
tile and the tile ``plan_tiles`` picks under the card's L2 — the
measurement behind ``ops.tiled.l2_budget_bytes`` — then the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from . import sampler as sm
from .cube import Cube
from .instruments import MUSE
from .ops import sweep as sw
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


def default_tiles(ny: int, nx: int):
    """(1, 1), (1, 2) and every square tile that divides the grid."""
    tiles = [(1, 1), (1, 2)] + [(d, d) for d in range(2, min(ny, nx) + 1)
                                if ny % d == 0 and nx % d == 0]
    return [t for t in tiles if ny % t[0] == 0 and nx % t[1] == 0]


def sweep_tiles(cube: Cube, sampler: str, tiles=None) -> dict:
    """ms per sweep of the whole-cube kernel and of the tiled kernel at
    each of ``tiles`` (default :func:`default_tiles`), one state."""
    problem = sm.make_problem(cube, MUSE(), sm.RunConfig(
        seed=0, sampler=sampler, engine="cuda"))
    state = sm.init_state(problem)
    whole = sw.gibbs_segment if sampler == "gibbs" else sw.mh_segment
    f, L = problem.f, problem.L
    out = {"shape": list(cube.shape), "sampler": sampler, "f": f,
           "k1_ms": _ms(lambda: whole(problem, state, 1)),
           "l2_bytes": tl.l2_budget_bytes(problem.device),
           "planned": tl.plan_tiles(f, problem.ny, problem.nx, L,
                                    tl.l2_budget_bytes(problem.device)),
           "tiles": []}
    for tile in tiles or default_tiles(problem.ny, problem.nx):
        ms = _ms(lambda: tl.tiled_segment(problem, state, 1, tile=tile))
        out["tiles"].append({"tile": list(tile), "ms": ms,
                             "window_bytes": tl.window_bytes(f, *tile, L)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, action="append",
                    help="field side in spaxels (repeatable; default 60, 300)")
    ap.add_argument("--tiles", help="comma list of NYxNX tiles "
                    "(default: 1x1, 1x2 and every square that divides)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep: needs a CUDA device")
    tiles = None
    if args.tiles:
        tiles = [tuple(int(v) for v in t.split("x"))
                 for t in args.tiles.split(",")]
    for size in args.size or (60, 300):
        cube = field_cube(Y=size, X=size)
        for sampler in ("mh", "gibbs"):
            print(json.dumps(sweep_tiles(cube, sampler, tiles)), flush=True)
        del cube
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
