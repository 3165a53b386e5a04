"""The control of a cell's comparison: the reference put in the program's
place, computed in bfloat16, one precision below the configuration's
float32, held to the cell's limits.  It has to come out not correct.

    python3 -m portbench.control --workload <name> --seeds 11,12,13

Runs on the card at the cell's own size (the CPU with ``--device cpu``);
prints one JSON line per seed with every compared number and its limit,
and exits 1 if any seed came out correct.  The benchmark's own runs never
run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from . import harness, scene, spec
from .reference import check

ROOT = Path(__file__).resolve().parent.parent


def control(root: Path, workload: str, seed: int, device="cuda",
            bench: Path = spec.HERE):
    """(correct, compared) of the control of ``workload`` on ``seed``'s
    inputs."""
    cell = spec.cell(spec.load(root), workload, root, bench)
    config, run = cell["config"], cell["traffic"]["run"]
    data, variance, mask = scene.make_inputs(config, seed,
                                             torch.device(device))
    out = check.control_outputs(config, data, variance,
                                int(run.get("n_chains", 1)),
                                run.get("sampler", "mh"), seed,
                                float(run.get("target_acceptance",
                                              check.TARGET_ACCEPTANCE)),
                                mask=mask)
    return check.judge(check.compare(config, data, variance, out, mask=mask),
                       cell["limits"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    passed = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        correct, compared = control(ROOT, args.workload, seed, args.device)
        passed += correct
        print(json.dumps(harness.finite({
            "workload": args.workload, "seed": seed, "correct": correct,
            "compared": compared})), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
