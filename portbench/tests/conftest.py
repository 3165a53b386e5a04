"""A benchmark root holding the repository's benchmark and tiny cells that
the CPU runs in a second: ``tiny_mh`` (one MH chain) and ``tiny_gibbs``
(four gibbs chains) on a 12 × 10 × 10 cube with a 5 × 5 FSF, added as new
files and new ``BENCHMARK.json`` entries, the way a later cell is added."""

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
TINY_TRAFFIC = {
    "tiny_mh": {"why": "t", "run": {"sampler": "mh", "n_chains": 1,
                                     "burn_in": 8},
                "segment_size": 48, "warmup_sweeps": 8},
    "tiny_gibbs": {"why": "t", "run": {"sampler": "gibbs", "n_chains": 4,
                                       "burn_in": 4},
                   "segment_size": 4, "warmup_sweeps": 4},
}
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
    (bench / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    spec["configs"].append({"name": "tiny", "source": "a test cube",
                            "file": "portbench/configs/tiny.json",
                            "reduced": [], "why": "t"})
    for name, traffic in TINY_TRAFFIC.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        limits = dict(TINY_LIMITS)
        if traffic["run"]["sampler"] == "gibbs":
            limits["qvox_err"] = 1e-04
        else:
            limits["accept_dev"] = 0.1
        (bench / "limits" / f"{name}.json").write_text(json.dumps(limits))
        spec["workloads"].append({"name": name, "config": "tiny",
                                  "traffic": name, "chips": 1, "why": "t"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += list(TINY_TRAFFIC)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root, bench


@pytest.fixture
def tiny(tmp_path):
    return make_root(tmp_path)
