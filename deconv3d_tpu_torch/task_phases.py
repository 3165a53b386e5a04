"""Where a task's time goes in the tiled sweep kernel: the task clocks of
``csrc/tiled_sweep.cu`` on a seeded MUSE field, mh and gibbs, on one CUDA
card.

    python -m deconv3d_tpu_torch.task_phases [--size 60] [--tile 1x2]
        [--schedule wavefront] [--stages -1,0]

Builds ``csrc/tiled_sweep.cu`` a second time with ``-DTASK_PHASE_CLOCKS``
(thread 0 of block 0 — a thread of a row warp: it waits for a task's
copies, contracts its rows and meets the service warps at the block
barrier — reads the SM clock after every phase of the step code,
``mh_step.cuh`` / ``gibbs_step.cuh``), runs one sweep through the ordinary wrapper with that
build's launchers, and prints one JSON line per (sampler, stages): the µs
per sweep in each phase, the tasks block 0 took, the µs per task of the
per-task phases, and the ms of the sweep between CUDA events.  ``--stages
0`` is the task with synchronous loads (the kernel as it was before the
ring of asynchronous copies), ``-1`` the ring with as many stages as fit.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from . import _build
from . import sampler as sm
from .instruments import MUSE
from .ops import tiled as tl
from .tile_sweep import field_cube, parse_tile

#: what each clock slot holds (csrc/mh_step.cuh, csrc/gibbs_step.cuh
#: ``clk.mark(k)``: the cycles since the previous mark) and, in
#: :data:`COUNTS`, what each counter counts (``clk.count(k)``)
PHASES = {
    "mh": {0: "decode, first copies", 2: "waiting for the copies",
           3: "partials", 4: "block barrier (the service warps)",
           6: "grid barrier 1", 7: "decisions", 8: "commits",
           9: "grid barrier 2"},
    "gibbs": {0: "grid barrier 3, decode, first copies",
              2: "waiting for the copies", 3: "partials",
              4: "block barrier (the service warps)", 6: "grid barrier 1",
              7: "window load, normals", 8: "the lw phases",
              9: "terms, clean, gacc", 10: "grid barrier 2",
              11: "the dchi2 sums", 15: "commits"},
}
COUNTS = {
    "mh": {12: "tasks", 13: "commits"},
    "gibbs": {12: "tasks", 13: "slab tasks", 14: "commit tasks"},
}
#: the phases a block pays once per task, and the counter that divides them
PER_TASK = {
    "mh": {12: (2, 3, 4), 13: (8,)},
    "gibbs": {12: (2, 3, 4), 13: (7, 8, 9), 14: (15,)},
}
N_CLOCKS = 16          # csrc/sweep_common.cuh kTaskClocks


def task_split(sampler: str, cube, tile, schedule: str, stages: int) -> dict:
    """µs per sweep in each phase of one tiled sweep (block 0's clocks)."""
    lib = _build.load_library()
    variant = _build.load_variant("tiled_sweep", "TASK_PHASE_CLOCKS")
    name = f"tiled_{sampler}_launch"
    plain_launch = getattr(lib, name)
    problem = sm.make_problem(cube, MUSE(), sm.RunConfig(
        seed=0, sampler=sampler, tile=tile))
    state = sm.init_state(problem)
    clocks = (ctypes.c_ulonglong * N_CLOCKS)()
    counter = tl.tiled_gibbs if sampler == "gibbs" else tl.tiled_mh

    def sweep():
        return tl.tuned_segment(problem, state, 1, tile=tile,
                                schedule=schedule, stages=stages)

    setattr(lib, name, getattr(variant, name))
    try:
        sweep()
        torch.cuda.synchronize()
        variant.task_phase_clocks(clocks)              # clear
        n0 = counter.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sweep()
        end.record()
        torch.cuda.synchronize()
        if counter.launches - n0 != 1:
            raise RuntimeError("the tiled kernel did not run the sweep")
        err = variant.task_phase_clocks(clocks)
        if err != 0:
            raise RuntimeError(f"task_phase_clocks: CUDA error {err}")
    finally:
        setattr(lib, name, plain_launch)
    khz = torch.cuda.get_device_properties(0).clock_rate
    us = {k: clocks[k] / khz * 1e3 for k in PHASES[sampler]}
    counts = {label: int(clocks[k]) for k, label in COUNTS[sampler].items()}
    per_task = {
        COUNTS[sampler][k]: sum(us[p] for p in phases) / max(clocks[k], 1)
        for k, phases in PER_TASK[sampler].items()}
    return {"sampler": sampler, "shape": [problem.L, problem.Y, problem.X],
            "tile": list(tile), "schedule": schedule, "stages": stages,
            "clock_khz": khz, "block_0": counts,
            "us_per_sweep": {PHASES[sampler][k]: v for k, v in us.items()},
            "us_per_task": per_task, "sum_ms": sum(us.values()) / 1e3,
            "ms_per_sweep": start.elapsed_time(end)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=60,
                        help="field side in spaxels (L = 3681)")
    parser.add_argument("--tile", default="1x2")
    parser.add_argument("--schedule", default="wavefront",
                        choices=tl.SCHEDULES)
    parser.add_argument("--stages", default="-1,0",
                        help="comma list of ring stages (-1: as many as fit)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("task_phases: no CUDA device")
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    cube = field_cube(Y=args.size, X=args.size)
    for sampler in ("mh", "gibbs"):
        for stages in (int(v) for v in args.stages.split(",")):
            print(json.dumps(task_split(sampler, cube, parse_tile(args.tile),
                                        args.schedule, stages)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
