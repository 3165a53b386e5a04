"""BASELINE #5 on the whole MUSE field (``portbench/configs/
muse_field_chromatic_masked_300x300x3681.json``) held to the benchmark's
plain reference on the CPU: at full size the FSF factorises to rank 4 and
the NaN and mask rectangles land on the spaxels the file states, and the
swept spaxels follow the reference's rule from the rectangles alone (a
copy with few planes: which spaxels are swept does not depend on L); a
small copy with the same kinds of border, refraction strip, mask and sky
lines runs through the harness under the cell's traffic, comes out
``correct`` with none of its unswept spaxels moved, and the reference in
bfloat16 in its place does not."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import sampler as tsm

REPO = Path(__file__).resolve().parents[1]
CONFIG = "muse_field_chromatic_masked_300x300x3681"
CELL = "chromatic_fullfield_gibbs"
SEED = 2**31 + 26


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """A plain sweep is many small color steps: more intra-op threads cost
    more than they give, and contend with the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config() -> dict:
    return json.loads((REPO / "portbench" / "configs"
                       / f"{CONFIG}.json").read_text())


def test_full_size_fsf_factorises_to_rank_4():
    """The bank at all 3681 planes and its SVD under ``Run``'s defaults:
    rank S = 4, within the cell's ``fsf_err`` of the exact bank."""
    from deconv3d_tpu_torch.ops.fsf_factor import factor_bank
    from portbench import harness
    from portbench.reference import check

    config = _config()
    assert config["reduced"] == [] and config["shape"] == [3681, 300, 300]
    L, f = config["shape"][0], config["fsf_size"]
    lam = float(config["crval"]) + float(config["cdelt"]) * np.arange(L)
    bank = harness.instrument_of(config).fsf.bank(
        lam, size=f, pixel_scale=float(config["pixel_scale"]))
    cfg = tsm.RunConfig()
    spec, _imgs, fsf, _err = factor_bank(bank, tol=cfg.fsf_tol,
                                         max_rank=cfg.fsf_max_rank)
    assert spec.shape == (4, L)
    exact = check.banks(config, "cpu")[0]
    limits = json.loads((REPO / "portbench" / "limits"
                         / f"{CELL}.json").read_text())
    err = float((torch.as_tensor(fsf) - exact).abs().max() / exact.max())
    assert err <= limits["fsf_err"]


def test_rectangles_and_swept_spaxels_follow_the_file():
    """A one-spaxel NaN border (1196 spaxels, NaN on every plane), column
    298 NaN on the first tenth of the planes only, 144 masked spaxels at
    rows 120-131 × columns 200-211; the reference's ``swept()`` leaves out
    exactly the border and the mask, and the port's problem sweeps the
    same spaxels.  On a copy of 20 planes: the rectangles are fractions of
    Y and X, and the strip's planes a tenth of L."""
    from portbench import harness, scene
    from portbench.reference import check

    config = _config()
    strip = next(r for r in config["nan"] if "lam" in r)
    assert scene._span(3681, strip["lam"]) == slice(0, 368)
    L = 20
    config.update(shape=[L, 300, 300],
                  cdelt=config["cdelt"] * config["shape"][0] / L)
    data, variance, mask = scene.make_inputs(config, SEED,
                                             torch.device("cpu"))
    nan = torch.isnan(data)
    border = torch.zeros((300, 300), dtype=torch.bool)
    border[[0, -1]] = border[:, [0, -1]] = True
    assert int(border.sum()) == 1196
    assert torch.equal(nan.all(dim=0), border)
    assert torch.equal(torch.isnan(variance), nan)
    inner = nan[:, 1:-1, 1:-1]
    assert torch.equal(inner.any(dim=0).nonzero()[:, 1].unique(),
                       torch.tensor([297]))     # column 298 of the field
    assert bool(inner[:L // 10, :, 297].all())
    assert not bool(inner[L // 10:].any())
    stated = torch.zeros((300, 300), dtype=torch.bool)
    stated[120:132, 200:212] = True
    assert torch.equal(mask, stated) and int(mask.sum()) == 144

    w_pad = check.padded_weights(config, variance, torch.float64, data, mask)
    swept = check.swept(config, w_pad, data, mask)
    assert torch.equal(swept, ~(border | stated))
    assert int(swept.sum()) == 90_000 - 1196 - 144 == 88_660
    cube = d3.Cube.from_data(data, variance=variance, mask=mask,
                             crval=float(config["crval"]),
                             cdelt=float(config["cdelt"]))
    problem = tsm.make_problem(cube, harness.instrument_of(config),
                               tsm.RunConfig(sampler="gibbs",
                                             fsf_size=config["fsf_size"],
                                             lsf_width=config["lsf_width"]),
                               device="cpu")
    assert problem.n_valid == 88_660
    assert np.array_equal(problem.valid[:300, :300].numpy(), swept.numpy())


def _cut_root(tmp_path: Path):
    """(root, bench): the repository's benchmark under ``tmp_path`` with a
    64 × 34 × 34 copy of the configuration and a cell ``cut`` under the
    cell's own traffic (``gibbs_seg8``) and limits.  The copy keeps the
    FSF's slope over the same 4750-9350 Å (rank 4), the variance law with
    each sky line as many planes wide as on the field, a one-spaxel NaN
    border, the NaN column next to it on the first tenth of the planes
    and a masked 3 × 3 block; its footprint is f = 9 (81 colors, not
    289), so that the 16 plain sweeps of the traffic fit a CPU test."""
    root = tmp_path / "root"
    bench = root / "portbench"
    shutil.copytree(REPO / "portbench", bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    config = _config()
    L, Y, X = 64, 34, 34
    scale = config["shape"][0] / L
    config.update(name="cut", shape=[L, Y, X], cdelt=config["cdelt"] * scale,
                  fsf_size=9)
    for line in config["variance"]["sky_lines"]:
        line["fwhm"] *= scale
    config["mask"] = [{"y": [[14, Y], [17, Y]], "x": [[22, X], [25, X]]}]
    config["nan"] = [
        {"y": [[0, 1], [1, Y]], "x": [[0, 1], [1, 1]]},
        {"y": [[Y - 1, Y], [1, 1]], "x": [[0, 1], [1, 1]]},
        {"y": [[0, 1], [1, 1]], "x": [[0, 1], [1, X]]},
        {"y": [[0, 1], [1, 1]], "x": [[X - 1, X], [1, 1]]},
        {"lam": [[0, 1], [1, 10]], "y": [[0, 1], [1, 1]],
         "x": [[X - 2, X], [X - 1, X]]}]
    (bench / "configs" / "cut.json").write_text(json.dumps(config))
    spec["configs"].append({"name": "cut", "source": "a test cube",
                            "file": "portbench/configs/cut.json",
                            "reduced": ["shape", "cdelt", "fsf_size"],
                            "why": "t"})
    entry = next(w for w in spec["workloads"] if w["name"] == CELL)
    spec["workloads"].append({**entry, "name": "cut", "config": "cut"})
    shutil.copy(bench / "limits" / f"{CELL}.json",
                bench / "limits" / "cut.json")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, bench


def test_cut_down_cell_is_correct_and_its_control_is_not(tmp_path):
    from portbench import control, harness

    root, bench = _cut_root(tmp_path)
    result, compared, notes = harness.run_cell(root, "cut", SEED, 0.01,
                                               False, "cpu", bench=bench)
    assert notes["shapes"]["S"] == 4 and notes["shapes"]["n_valid"] == (
        34 * 34 - 132 - 9)
    assert notes["sweeps"] == 8
    assert result["correct"] is True and result["failed"] == 0, compared
    assert compared["unswept_moved"]["value"] == 0.0
    assert set(compared) == set(json.loads(
        (bench / "limits" / f"{CELL}.json").read_text()))
    correct, compared = control.control(root, "cut", SEED, "cpu",
                                        bench=bench)
    assert not correct
    failed = {k for k, c in compared.items() if not c["value"] <= c["limit"]}
    assert {"fsf_err", "quad_err", "qvox_err", "resid_err", "chi2_err",
            "unmoved"} <= failed


def _reader(name: str):
    from portbench import spec

    return spec.reader(name, REPO / "portbench" / "layer_metrics")


#: a traced gibbs run's device operations (name, start µs, end µs): K2's
#: any-rank build 0.1 s, its rank-1 build and classic K1's any-rank build
DEV = [("void deconv3d::tiled_gibbs_kernel<8, false>(deconv3d::GibbsArgs)",
        0.0, 60_000.0),
       ("void deconv3d::tiled_gibbs_kernel<1, false>(deconv3d::GibbsArgs)",
        60_000.0, 110_000.0),
       ("void deconv3d::gibbs_sweep_kernel<8, false>(deconv3d::GibbsArgs)",
        110_000.0, 510_000.0),
       ("void deconv3d::tiled_gibbs_kernel<8, false>(deconv3d::GibbsArgs)",
        510_000.0, 550_000.0)]


@pytest.mark.parametrize("counts, dev, value", [
    ({"problem.fsf_rank": 4, "sweep.launches.rank_any": 2}, DEV, 2.0),
    ({"problem.fsf_rank": 4, "sweep.launches.rank_any": 2}, DEV[1:3], None),
    ({"problem.fsf_rank": 1, "sweep.launches.rank1": 2}, DEV, None),
    ({"problem.fsf_rank": 4, "sweep.launches.rank1": 2}, DEV, None),
    ({}, DEV, None),
])
def test_tiled_anyrank_roofline_reads_the_tiled_anyrank_build_alone(
        monkeypatch, counts, dev, value):
    """The bound of 2 sweeps (1 ms each) over the 0.1 s of
    ``tiled_gibbs_kernel<8, …>``: 2%, whatever the rank-1 build and
    classic K1's any-rank build took; None without an any-rank launch or
    without that build in the profile."""
    from deconv3d_tpu_torch import metrics
    from portbench import harness

    monkeypatch.setattr(metrics, "counters", lambda: dict(counts))
    ctx = harness.Context(sampler="gibbs", dev=dev, traced_sweeps=2,
                          bound={"bound_ms": 1.0})
    got = _reader("tiled_anyrank_roofline").read(ctx)
    assert got == pytest.approx(value) if value is not None else got is None


@pytest.mark.parametrize("records, value", [
    ([{"name": "setup.sanitize", "host_ms": 1500.0},
      {"name": "setup.weights", "host_ms": 4000.0}], 1.5),
    ([{"name": "setup.weights", "host_ms": 4000.0}], None),
])
def test_sanitize_s_reads_the_span(records, value):
    from portbench import harness

    ctx = harness.Context(dev=DEV, tracer_records=records)
    assert _reader("sanitize_s").read(ctx) == value
