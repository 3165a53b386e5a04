"""A benchmark root holding the repository's benchmark and tiny cells that
the CPU runs in a second: ``tiny_mh`` (one MH chain) and ``tiny_gibbs``
(four gibbs chains) on a 12 × 10 × 10 cube with a 5 × 5 FSF, and
``tiny_b5_mh`` and ``tiny_b5_gibbs``, the same traffic on ``tiny_b5``: a
Moffat FSF whose FWHM grows with λ, a per-voxel variance with a sky line,
masked spaxels, an edge strip of NaN spaxels and a block of NaN voxels.
All are added as new files and new ``BENCHMARK.json`` entries, the way a
later cell is added."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"

TINY_CONFIG = {
    "name": "tiny", "source": "a test cube", "reduced": [],
    "shape": [12, 10, 10], "crval": 4750.0, "cdelt": 1.25,
    "pixel_scale": 0.2, "fsf": {"kind": "moffat", "fwhm": 0.2, "beta": 2.6},
    "lsf": {"kind": "muse", "c2": 5.866e-08, "c1": -0.0009187, "c0": 6.04},
    "fsf_size": 5, "lsf_width": 11, "dtype": "float32", "noise_sigma": 1.0,
    "sources": [{"at": [[1, 2], [1, 2], [1, 2]], "flux": 50.0}],
}
TINY_B5 = {
    **TINY_CONFIG, "name": "tiny_b5",
    "fsf": {"kind": "moffat", "fwhm": 0.2, "beta": 2.6, "fwhm_slope": 2e-3,
            "lambda_ref": 4750.0},
    "variance": {"sky_lines": [{"lambda": 4757.5, "fwhm": 2.5,
                                "amplitude": 4.0}],
                 "spaxel_scale": [0.5, 2.0]},
    # rows 2-3 × columns 6-7
    "mask": [{"y": [[2, 10], [4, 10]], "x": [[6, 10], [8, 10]]}],
    # column 0 on every plane; planes 0-2 of rows 5-6 × columns 2-3
    "nan": [{"y": [[0, 1], [1, 1]], "x": [[0, 1], [1, 10]]},
            {"lam": [[0, 1], [3, 12]], "y": [[5, 10], [7, 10]],
             "x": [[2, 10], [4, 10]]}],
}
TINY_TRAFFIC = {
    "tiny_mh": {"why": "t", "run": {"sampler": "mh", "n_chains": 1,
                                     "burn_in": 8},
                "segment_size": 48, "warmup_sweeps": 8},
    "tiny_gibbs": {"why": "t", "run": {"sampler": "gibbs", "n_chains": 4,
                                       "burn_in": 4},
                   "segment_size": 4, "warmup_sweeps": 4},
}
#: the cells' (configuration, traffic)
TINY_CELLS = {"tiny_mh": ("tiny", "tiny_mh"),
              "tiny_gibbs": ("tiny", "tiny_gibbs"),
              "tiny_b5_mh": ("tiny_b5", "tiny_mh"),
              "tiny_b5_gibbs": ("tiny_b5", "tiny_gibbs")}
TINY_LIMITS = {"fsf_err": 1e-05, "lsf_err": 1e-05, "weight_err": 0.0,
               "quad_err": 1e-04, "resid_err": 0.01, "chi2_err": 1e-05,
               "unmoved": 1e-2}


def make_root(tmp_path: Path):
    """(root, bench): a copy of the repository's ``BENCHMARK.json`` and
    ``portbench/`` under ``tmp_path`` with the tiny cells added as files;
    every metric that lists cells lists them too."""
    root = tmp_path / "root"
    bench = root / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for config in (TINY_CONFIG, TINY_B5):
        name = config["name"]
        (bench / "configs" / f"{name}.json").write_text(json.dumps(config))
        spec["configs"].append({"name": name, "source": "a test cube",
                                "file": f"portbench/configs/{name}.json",
                                "reduced": [], "why": "t"})
    for name, traffic in TINY_TRAFFIC.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    for name, (config, traffic) in TINY_CELLS.items():
        limits = dict(TINY_LIMITS)
        if TINY_TRAFFIC[traffic]["run"]["sampler"] == "gibbs":
            limits["qvox_err"] = 1e-04
        else:
            limits["accept_dev"] = 0.1
        if config == "tiny_b5":
            limits["unswept_moved"] = 0.0
        (bench / "limits" / f"{name}.json").write_text(json.dumps(limits))
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": traffic, "chips": 1, "why": "t"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += list(TINY_CELLS)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root, bench


@pytest.fixture
def tiny(tmp_path):
    return make_root(tmp_path)
