"""BASELINE #5 on the bench subcube (``portbench/configs/
muse_subcube_chromatic_masked_30x30x600.json``) held to the benchmark's
plain reference on the CPU: at full size the port's problem has the FSF
rank and the swept spaxels the reference derives from the inputs; a
cut-down copy that keeps the FSF's slope over the same wavelengths, the
variance law and the rectangles runs through the harness as the
benchmark's cells do, comes out ``correct`` with none of its unswept
spaxels moved, and the reference in bfloat16 in its place does not."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import sampler as tsm

REPO = Path(__file__).resolve().parents[1]
CONFIG = "muse_subcube_chromatic_masked_30x30x600"
#: the cells of the configuration, by sampler
CELLS = {"mh": "chromatic_subcube_mh",
         "gibbs": "chromatic_subcube_gibbs_chains32"}

#: short traffic for the cut-down copy.  MH starts from the jump scale at
#: which this copy accepts at the target (0.234 here): a CPU window of a
#: few dozen sweeps is too short for ``burn_in`` to adapt it, and long
#: enough for each swept voxel to move.
CUT_TRAFFIC = {
    "mh": {"why": "t", "run": {"sampler": "mh", "n_chains": 1, "burn_in": 8,
                               "jump_amplitude": 0.33},
           "segment_size": 32, "warmup_sweeps": 8},
    "gibbs": {"why": "t", "run": {"sampler": "gibbs", "n_chains": 2,
                                  "burn_in": 1},
              "segment_size": 1, "warmup_sweeps": 1},
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """A plain sweep at f = 17 is 289 small color steps: more intra-op
    threads cost more than they give, and contend with the other
    workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config() -> dict:
    return json.loads((REPO / "portbench" / "configs"
                       / f"{CONFIG}.json").read_text())


def test_full_size_problem_matches_the_reference_swept_spaxels():
    from portbench import harness, scene
    from portbench.reference import check

    config = _config()
    assert config["reduced"] == [] and config["shape"] == [600, 30, 30]
    data, variance, mask = scene.make_inputs(config, 2**31 + 11,
                                             torch.device("cpu"))
    cube = d3.Cube.from_data(data, variance=variance, mask=mask,
                             crval=float(config["crval"]),
                             cdelt=float(config["cdelt"]))
    problem = tsm.make_problem(cube, harness.instrument_of(config),
                               tsm.RunConfig(sampler="mh",
                                             fsf_size=config["fsf_size"],
                                             lsf_width=config["lsf_width"]),
                               device="cpu")
    shapes = harness.shapes_of(problem)
    assert shapes["S"] == 3 and shapes["f"] == 17
    assert int(torch.isnan(data).sum()) == 38_300
    w_pad = check.padded_weights(config, variance, torch.float64, data, mask)
    swept = check.swept(config, w_pad, data, mask)
    assert problem.n_valid == 814 == int(swept.sum())
    assert np.array_equal(problem.valid[:30, :30].numpy(), swept.numpy())


def _cut_root(tmp_path: Path):
    """(root, bench): the repository's benchmark under ``tmp_path`` with a
    cut-down copy of the configuration (48 planes over the same 4750-5499
    Å, 34 × 34 spaxels: the same FSF slope, variance law and rectangles)
    and a cell per sampler whose limits are the full cell's."""
    root = tmp_path / "root"
    bench = root / "portbench"
    shutil.copytree(REPO / "portbench", bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    config = _config()
    L = 48
    config.update(name="cut", shape=[L, 34, 34],
                  cdelt=config["cdelt"] * config["shape"][0] / L)
    (bench / "configs" / "cut.json").write_text(json.dumps(config))
    spec["configs"].append({"name": "cut", "source": "a test cube",
                            "file": "portbench/configs/cut.json",
                            "reduced": ["shape", "cdelt"], "why": "t"})
    for sampler, traffic in CUT_TRAFFIC.items():
        name = f"cut_{sampler}"
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        shutil.copy(bench / "limits" / f"{CELLS[sampler]}.json",
                    bench / "limits" / f"{name}.json")
        spec["workloads"].append({"name": name, "config": "cut",
                                  "traffic": name, "chips": 1, "why": "t"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, bench


@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_cut_down_cell_is_correct_and_its_control_is_not(tmp_path, sampler):
    from portbench import control, harness

    root, bench = _cut_root(tmp_path)
    cell = f"cut_{sampler}"
    result, compared, notes = harness.run_cell(root, cell, 2**31 + 21, 0.01,
                                               False, "cpu", bench=bench)
    assert notes["shapes"]["S"] == 3
    assert result["correct"] is True and result["failed"] == 0, compared
    assert compared["unswept_moved"]["value"] == 0.0
    assert set(compared) == set(json.loads(
        (bench / "limits" / f"{cell}.json").read_text()))
    correct, compared = control.control(root, cell, 2**31 + 21, "cpu",
                                        bench=bench)
    assert not correct
    failed = {k for k, c in compared.items() if not c["value"] <= c["limit"]}
    assert {"fsf_err", "quad_err", "resid_err", "chi2_err",
            "unmoved"} <= failed
