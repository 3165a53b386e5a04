"""One run of one cell:

    python3 -m portbench --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the compared numbers with their limits
as the last lines of standard error and the result as one JSON line, the
last of standard output.  Exits 3 without a result when the cell's cards
are not there, and 4 when the process has loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# fixed cache directories inside the checkout, for any library that compiles
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench"
                                         / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, roofline, spec

    chips = int(spec.cell(spec.load(ROOT), args.workload, ROOT)
                ["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); {have} available",
              file=sys.stderr)
        return 3
    result, compared, notes = harness.run_cell(
        ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
        "cuda", T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    card = roofline.card()
    print(json.dumps({"card": card, **harness.finite(notes)}),
          file=sys.stderr)
    result["compared"] = harness.finite(compared)
    print("\n".join(harness.compared_lines(compared)), file=sys.stderr,
          flush=True)
    print(json.dumps(harness.finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
