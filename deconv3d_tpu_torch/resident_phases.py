"""Where a resident sweep's time goes: the phase clocks of the resident
kernel on a seeded MUSE 30×30×600 cube, mh and gibbs, on one CUDA card.

    python -m deconv3d_tpu_torch.resident_phases [--sweeps N] [--fwhm-slope D]

Builds ``csrc/resident_sweep.cu`` a second time with
``-DRESIDENT_PHASE_CLOCKS`` (thread 0 of block 0 reads the SM clock after
every block-level phase of the color loop), runs ``N`` sweeps through the
ordinary wrapper with that build's launchers, and prints one JSON line per
sampler (mh, gibbs, then gibbs with ``positivity=True``, the
truncated-normal λ-phases): µs per sweep in each phase (clocks over the
card's clock rate), their sum, and the ms per sweep of the same run between
CUDA events (the clocks cost a little: compare with ``chip_smoke.py`` phase
``resident``).  ``--fwhm-slope`` makes the seeing chromatic (the Moffat
FWHM 0.66″ at 4750 Å plus D ″/Å; −3e-5 gives FSF rank 3, the any-rank
``<8>`` build), else the FSF is MUSE's default, rank 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from . import _build
from . import sampler as sm
from .cube import Cube
from .instruments import MUSE, MoffatFSF
from .ops import sweep as sw
from .tile_sweep import field_cube

#: the phase after which each clock is read (csrc/resident_sweep.cu PHASE)
PHASES = {
    "mh": ("previous commit", "partials + jumps", "lin, g, shares",
           "grid barrier", "dchi2, decision"),
    "gibbs": ("previous commit", "partials", "lin", "grid barrier",
              "window", "lw phases", "dchi2 terms, clean"),
}


def phase_split(sampler: str, n: int, cube: Cube,
                positivity: bool = False, instrument=None) -> dict:
    """µs per sweep in each phase of the resident kernel (block 0), its
    ``kPos`` instantiation with ``positivity``; ``instrument`` defaults to
    ``MUSE()``."""
    lib = _build.load_library()
    variant = _build.load_variant("resident_sweep", "RESIDENT_PHASE_CLOCKS")
    name = f"resident_{sampler}_launch"
    plain_launch = getattr(lib, name)
    problem = sm.make_problem(cube, instrument or MUSE(), sm.RunConfig(
        seed=0, sampler=sampler, positivity=positivity))
    state = sm.init_state(problem)
    seg = sw.gibbs_segment if sampler == "gibbs" else sw.mh_segment
    clocks = (ctypes.c_ulonglong * 8)()
    setattr(lib, name, getattr(variant, name))
    try:
        seg(problem, state, 1)
        torch.cuda.synchronize()
        variant.resident_phase_clocks(clocks)        # clear
        n0 = seg.resident_launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        seg(problem, state, n)
        end.record()
        torch.cuda.synchronize()
        if seg.resident_launches - n0 != n:
            raise RuntimeError("the resident kernel did not run every sweep")
        err = variant.resident_phase_clocks(clocks)
        if err != 0:
            raise RuntimeError(f"resident_phase_clocks: CUDA error {err}")
    finally:
        setattr(lib, name, plain_launch)
    khz = torch.cuda.get_device_properties(0).clock_rate
    us = {label: clocks[k] / n / khz * 1e3
          for k, label in enumerate(PHASES[sampler])}
    return {"sampler": sampler, "positivity": positivity,
            "shape": [problem.L, problem.Y, problem.X],
            "fsf_rank": int(problem.fsf_spec.shape[0]),
            "sweeps": n, "clock_khz": khz, "us_per_sweep": us,
            "sum_us": sum(us.values()),
            "ms_per_sweep": start.elapsed_time(end) / n}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sweeps", type=int, default=50)
    parser.add_argument("--fwhm-slope", type=float, default=0.0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("resident_phases: no CUDA device")
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    cube = field_cube(L=600, Y=30, X=30)      # the bench subcube's size
    inst = None
    if args.fwhm_slope:
        inst = MUSE(fsf=MoffatFSF(fwhm=0.66, beta=2.6, lambda_ref=4750.0,
                                  fwhm_slope=args.fwhm_slope))
    for sampler, positivity in (("mh", False), ("gibbs", False),
                                ("gibbs", True)):
        print(json.dumps(phase_split(sampler, args.sweeps, cube, positivity,
                                     inst)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
