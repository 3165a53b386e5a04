"""A run's result line, the control that must come out not correct, and
runs with the timed path broken underneath that must come out not correct
too; all on the CPU at the tiny cells' size."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import control, harness, scene
from portbench.reference import check

from .conftest import REPO


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(tiny, traced):
    root, bench = tiny
    result, compared, notes = harness.run_cell(root, "tiny_gibbs", 2**31 + 7,
                                               0.2, traced, "cpu",
                                               bench=bench)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if traced else [])
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] == 4 * notes["sweeps"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        result["device"])
    names = {"kernel_load_s"} if traced else {
        "chain_sweeps_per_s", "setup_s"}
    assert set(result["metrics"]) == names
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    if traced:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(compared) == ["fsf_err", "lsf_err", "weight_err", "quad_err",
                              "resid_err", "chi2_err", "unmoved", "qvox_err"]
    json.dumps(harness.finite(result))


def test_no_card_no_result():
    """Without a CUDA card the command exits 3 and prints nothing to its
    standard output."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          "subcube_mh", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 3 and out.stdout == ""


def test_without_the_program_no_result(tmp_path):
    """In a directory holding only ``BENCHMARK.json`` and the benchmark, a
    run fails before it prints anything."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; from pathlib import Path; "
            "from portbench import harness; "
            "harness.run_cell(Path('.'), 'subcube_mh', 1, 1, False, 'cpu')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "deconv3d_tpu_torch" in out.stderr


@pytest.mark.parametrize("cell", ["tiny_mh", "tiny_gibbs"])
def test_control_is_not_correct(tiny, cell):
    """The reference in bfloat16 in the program's place breaks the banks',
    quad's, the residual's, χ²'s and the unmoved share's limits."""
    root, bench = tiny
    for seed in (1, 2, 3):
        correct, compared = control.control(root, cell, seed, "cpu",
                                            bench=bench)
        assert not correct
        failed = {k for k, c in compared.items() if not c["value"] <= c["limit"]}
        assert {"fsf_err", "lsf_err", "quad_err", "resid_err", "chi2_err",
                "unmoved"} <= failed
        if cell == "tiny_mh":
            assert "accept_dev" in failed


@pytest.mark.parametrize("cell", ["tiny_b5_mh", "tiny_b5_gibbs"])
def test_chromatic_masked_cell_is_correct_and_its_control_is_not(tiny, cell):
    """A λ-dependent FSF (rank > 1), masked spaxels, NaN spaxels and
    voxels and a per-voxel variance: the program's run holds to the
    reference, none of the spaxels it never sweeps moves, and the
    reference in bfloat16 in its place fails."""
    root, bench = tiny
    result, compared, notes = harness.run_cell(root, cell, 2**31 + 13, 0.2,
                                               False, "cpu", bench=bench)
    assert result["correct"] is True and result["failed"] == 0
    assert notes["shapes"]["S"] > 1
    assert notes["shapes"]["n_valid"] == 86     # 100 − 10 NaN − 4 masked
    assert compared["unswept_moved"]["value"] == 0.0
    assert compared["weight_err"]["value"] == 0.0
    for seed in (1, 2, 3):
        correct, compared = control.control(root, cell, seed, "cpu",
                                            bench=bench)
        assert not correct
        failed = {k for k, c in compared.items()
                  if not c["value"] <= c["limit"]}
        assert {"fsf_err", "quad_err", "resid_err", "chi2_err",
                "unmoved"} <= failed


def _engine():
    from deconv3d_tpu_torch import sampler

    return sampler, sampler._engine_run_sweeps


def unchanged(monkeypatch):
    """Every sweep returns its state unchanged but for the sweep count."""
    sm, run = _engine()

    def step(problem, state, n):
        r = run(problem, state, n)
        return dataclasses.replace(r, state=dataclasses.replace(
            state, sweep=r.state.sweep))

    monkeypatch.setattr(sm, "_engine_run_sweeps", step)


def half_batch(monkeypatch):
    """Only the first half of the chain batch is swept; the rest keep
    their state."""
    from deconv3d_tpu_torch import chains as ch

    sm, run = _engine()

    def step(problem, state, n):
        C = state.clean.shape[0]
        r = run(problem, ch.select_chains(state, slice(0, C // 2)), n)
        rest = ch.select_chains(state, slice(C // 2, C))
        rest = dataclasses.replace(rest, sweep=rest.sweep + n)
        merged = ch.stack_chains([ch.select_chains(r.state, c)
                                  for c in range(C // 2)]
                                 + [ch.select_chains(rest, c)
                                    for c in range(C - C // 2)])
        pad = lambda t: torch.cat([t, t[: C - C // 2]])  # noqa: E731
        return dataclasses.replace(
            r, state=merged, chi2_trace=pad(r.chi2_trace),
            accept_trace=pad(r.accept_trace), flux_trace=pad(r.flux_trace),
            monitor_trace=pad(r.monitor_trace))

    monkeypatch.setattr(sm, "_engine_run_sweeps", step)


def altered(monkeypatch):
    """Each segment's residual leaves the sweep with one voxel off by 1σ."""
    sm, run = _engine()

    def step(problem, state, n):
        r = run(problem, state, n)
        h = problem.f // 2
        r.state.resid[..., 0, h + 1, h + 1] += 1.0
        return r

    monkeypatch.setattr(sm, "_engine_run_sweeps", step)


def _edited(monkeypatch, edit):
    """Each segment's clean cube is changed in place by ``edit(clean,
    start)`` (``start``: the segment's first clean cube), and the residual
    and χ² are made consistent with it."""
    from deconv3d_tpu_torch.convolve import convolve_cube

    sm, run = _engine()

    def resid_of(problem, clean):
        p, h = problem, problem.f // 2
        resid = p.data_pad.clone()
        resid[:, h:h + p.Y, h:h + p.X] -= convolve_cube(
            clean[:, :p.Y, :p.X], p.fsf, p.lsf)
        return torch.where(p.w_pad > 0, resid, torch.zeros_like(resid))

    def step(problem, state, n):
        r = run(problem, state, n)
        clean = r.state.clean.clone()
        edit(clean, state.clean)
        resid = (torch.stack([resid_of(problem, c) for c in clean])
                 if clean.dim() == 4 else resid_of(problem, clean))
        kept = sm.rebaseline_chi2(problem, dataclasses.replace(
            r.state, clean=clean, resid=resid))
        return dataclasses.replace(r, state=kept)

    monkeypatch.setattr(sm, "_engine_run_sweeps", step)


def _unswept(monkeypatch, region):
    """Each segment leaves the clean cube's ``region`` (an index of its
    last three axes, λ, y, x) as it was: the sweep skipped part of the
    cube."""
    def edit(clean, start):
        clean[(Ellipsis, *region)] = start[(Ellipsis, *region)]

    _edited(monkeypatch, edit)


def masked_moved(monkeypatch):
    """Each segment also moves the masked spaxels of ``tiny_b5`` (rows 2-3,
    columns 6-7), which a sweep never visits."""
    def edit(clean, start):
        clean[..., 2:4, 6:8] += 0.5

    _edited(monkeypatch, edit)


def half_tiles(monkeypatch):
    """The sweep skips the tiles of the cube's right half."""
    _unswept(monkeypatch, (slice(None), slice(None), slice(5, None)))


def half_planes(monkeypatch):
    """The sweep skips the upper half of the λ-planes."""
    _unswept(monkeypatch, (slice(6, None), slice(None), slice(None)))


def _swept_share(root, cell, region):
    """The share of the swept voxels that ``region`` (λ, y, x) holds."""
    from portbench import spec

    config = spec.cell(spec.load(root), cell, root,
                       root / "portbench")["config"]
    data, variance, mask = scene.make_inputs(config, 11, "cpu")
    w_pad = check.padded_weights(config, variance, torch.float64, data, mask)
    visited = check.swept(config, w_pad, data, mask)
    return float(visited[region[1:]].sum()) / float(visited.sum())


@pytest.mark.parametrize("cell", ["tiny_b5_mh", "tiny_b5_gibbs"])
def test_unmoved_counts_the_swept_voxels(tiny, monkeypatch, cell):
    """With masked and NaN spaxels, which are never swept, a sound run
    reads ``unmoved`` 0, and a sweep that skips the columns x ≥ 5 reads
    the share of the swept voxels there, about ½."""
    root, bench = tiny
    _, compared, _ = harness.run_cell(root, cell, 11, 0.2, False, "cpu",
                                      bench=bench)
    assert compared["unmoved"]["value"] == 0.0
    half_tiles(monkeypatch)
    result, compared, _ = harness.run_cell(root, cell, 11, 0.2, False,
                                           "cpu", bench=bench)
    share = _swept_share(root, cell, (slice(None), slice(None),
                                      slice(5, None)))
    assert 0.4 < share < 0.6
    assert compared["unmoved"]["value"] == pytest.approx(share, abs=1e-3)
    assert not result["correct"]
    assert compared["unswept_moved"]["value"] == 0.0


@pytest.mark.parametrize("cell,fault,number", [
    ("tiny_mh", half_tiles, "unmoved"),
    ("tiny_gibbs", half_tiles, "unmoved"),
    ("tiny_mh", half_planes, "unmoved"),
    ("tiny_gibbs", half_planes, "unmoved"),
    ("tiny_mh", unchanged, "unmoved"),
    ("tiny_gibbs", unchanged, "unmoved"),
    ("tiny_gibbs", half_batch, "unmoved"),
    ("tiny_mh", altered, "resid_err"),
    ("tiny_gibbs", altered, "resid_err"),
    ("tiny_b5_mh", masked_moved, "unswept_moved"),
    ("tiny_b5_gibbs", masked_moved, "unswept_moved"),
])
def test_a_broken_sweep_is_not_correct(tiny, monkeypatch, cell, fault,
                                       number):
    root, bench = tiny
    fault(monkeypatch)
    result, compared, _ = harness.run_cell(root, cell, 11, 0.2, False, "cpu",
                                           bench=bench)
    assert not result["correct"]
    assert result["failed"] > 0
    assert not compared[number]["value"] <= compared[number]["limit"]
    if fault in (half_tiles, half_planes, masked_moved):
        # the state stays consistent: only the moved shares see the fault
        assert [k for k, c in compared.items()
                if not c["value"] <= c["limit"]] == [number]
