"""Time the direct sampler's CG iteration on one CUDA card, repeatedly.

    python -m deconv3d_tpu_torch.direct_timing [--repeats 5] [--draws 20]

On the bench cube (the synthetic MUSE 30×30×600 subcube of
``chip_smoke.py``: two emission lines and unit noise from numpy seed 0),
each repeat runs ``Run(sampler='direct', prior_precision='auto')`` for
``--draws`` draws and ``map_estimate(prior_precision='auto', tol=1e-6)``,
the workloads of ``chip_smoke.py`` phase ``direct``, and prints one JSON
line: ms per CG iteration of each (every ``ops.direct.pcg`` call between
CUDA events, summed, over the iterations), then a line with the medians
and the card's name and power limit.  A warm-up draw and MAP come first
and are not reported.  The script uses the package's public entry points
and ``ops.direct.pcg`` only, so the same file run inside another checkout
of the package times that checkout: host-bound readings move by tens of
percent between processes, so compare two checkouts on one machine in
one sitting, alternating them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from . import Cube, MUSE, Run
from .ops import direct as td


def bench_cube() -> Cube:
    """The bench.py synthetic MUSE subcube, as ``chip_smoke.bench_cube``."""
    rng = np.random.default_rng(0)
    truth = np.zeros((600, 30, 30), np.float32)
    truth[300, 15, 15] = 50.0
    truth[200, 8, 20] = 30.0
    data = truth + rng.standard_normal(truth.shape).astype(np.float32)
    return Cube.from_data(data, variance=np.ones_like(data), crval=4750.0,
                          cdelt=1.25, device="cuda")


def cg_ms(fn):
    """``fn()`` with every ``ops.direct.pcg`` call timed between CUDA
    events: (CG iterations, their ms)."""
    solves, real = [], td.pcg

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        res = real(*args, **kwargs)
        end.record()
        torch.cuda.synchronize()
        solves.append((res.iterations, start.elapsed_time(end)))
        return res

    td.pcg = timed
    try:
        fn()
    finally:
        td.pcg = real
    return sum(i for i, _ in solves), sum(ms for _, ms in solves)


def measure(cube: Cube, draws: int) -> dict:
    """One repeat: ms per CG iteration of the draws and of the MAP."""
    run = Run(cube, MUSE(), max_iterations=draws, seed=0, sampler="direct",
              prior_precision="auto")
    run.states
    it, ms = cg_ms(run.run)
    mrun = Run(cube, MUSE(), seed=0)
    mit, mms = cg_ms(lambda: mrun.map_estimate(prior_precision="auto",
                                               tol=1e-6))
    return {"draw_ms_per_iteration": ms / it, "draw_iterations": it,
            "map_ms_per_iteration": mms / mit, "map_iterations": mit}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--draws", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("direct_timing needs a CUDA card")
    cube = bench_cube()
    measure(cube, 1)
    rows = []
    for r in range(args.repeats):
        rows.append(measure(cube, args.draws))
        print(json.dumps({"repeat": r, **rows[-1]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"median": {k: statistics.median(r[k] for r in rows)
                                 for k in rows[0]},
                      "device": smi}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
