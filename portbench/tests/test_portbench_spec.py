"""``BENCHMARK.json`` against the benchmark's contract, every name in it
resolved to its file, and a new configuration, traffic mix, cell and
per-layer metric found as new files with no file edited."""

from __future__ import annotations

import hashlib
import json
import re

import pytest

from portbench import harness, spec

from .conftest import BENCH, REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = 24
    budget = (2 + 14 * cells) * (SPEC["run_seconds"] + 60) + cells * 180
    assert budget + 1200 <= 43200


@pytest.mark.parametrize("section", list(KEYS))
def test_entries(section):
    entries = SPEC[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if "unit" in e else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer"):
            assert k not in e or _line(e[k]), (e["name"], k)
        if section == "configs":
            assert _line(e["source"]) and e["source"].startswith("https://")


def test_metrics_and_cells():
    cells = {w["name"] for w in SPEC["workloads"]}
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(cells)
    assert {w["config"] for w in SPEC["workloads"]} == configs
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e[
        "setup_s"]
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        reported = [m for m in SPEC["end_to_end"]
                    if w in m.get("workloads", [w])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) > 1
        assert any(w in m["workloads"] for m in SPEC["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_name_resolves(cell):
    c = spec.cell(SPEC, cell, REPO)
    assert c["config"]["name"] == c["entry"]["config"]
    conf = next(x for x in SPEC["configs"] if x["name"] == c["entry"]["config"])
    assert c["config"]["reduced"] == conf["reduced"]
    assert c["traffic"]["run"]["sampler"] in ("mh", "gibbs")
    assert set(c["limits"]) >= {"fsf_err", "resid_err", "chi2_err", "unmoved"}
    assert ("qvox_err" in c["limits"]) == (
        c["traffic"]["run"]["sampler"] == "gibbs")
    for m in c["end_to_end"]:
        assert hasattr(spec.reader(m["name"], BENCH / "end_to_end"), "read")
    for m in c["per_layer"]:
        assert hasattr(spec.reader(m["name"], BENCH / "layer_metrics"), "read")


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file()}


def test_new_files_are_found_without_an_edit(tiny):
    """The tiny cells (a configuration, two traffic mixes, their limits)
    and a per-layer metric dropped in as files, with entries appended to
    ``BENCHMARK.json``: the traced run reads the new metric, and every file
    the benchmark had is unchanged."""
    root, bench = tiny
    before = _digests(BENCH)
    (bench / "layer_metrics" / "probe_sweeps.py").write_text(
        "def read(ctx):\n    return ctx.traced_sweeps\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["per_layer"].append({
        "name": "probe_sweeps", "unit": "sweeps", "better": "higher",
        "source": "program_counter", "layer": "facade (Run.run)",
        "moves": "chain_sweeps_per_s", "workloads": ["tiny_mh"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    result, _, _ = harness.run_cell(root, "tiny_mh", 21, 0.2, True, "cpu",
                                    bench=bench)
    assert result["metrics"]["probe_sweeps"]["value"] >= 8
    copied = {k: v for k, v in _digests(bench).items() if k in before}
    assert copied == {k: v for k, v in before.items() if k in copied}
    assert set(before) - {p for p in before if p.parts[0] in (
        "tests", "__pycache__") or "__pycache__" in p.parts} <= set(copied)
