"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file the
``configs`` entry gives (``configs/<config>.json``), and a traffic mix,
``traffic/<traffic>.json``; its comparison limits are
``limits/<cell>.json``.  An end-to-end metric ``<name>`` is read by
``end_to_end/<name>.py``, a per-layer one by
``layer_metrics/<name>.py``.  Nothing here knows a cell, configuration or
metric by name: a later cell adds files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

#: the benchmark's own folder; ``BENCHMARK.json`` sits in its parent
HERE = Path(__file__).resolve().parent


def load(root: Path) -> dict:
    """``BENCHMARK.json`` at ``root``."""
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell(spec: dict, name: str, root: Path, bench: Path = HERE) -> dict:
    """The cell ``name``: its entry, configuration, traffic and limits, and
    the metrics it reports with ``--trace 0`` (``end_to_end``) and with
    ``--trace 1`` (``per_layer``).  Raises KeyError for an unknown name."""
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    end_to_end = [m for m in spec["end_to_end"]
                  if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", ()) or (
                     "workloads" not in m and m["moves"] in reported)]
    return {"entry": entry,
            "config": _read_json(root / conf["file"]),
            "traffic": _read_json(bench / "traffic"
                                  / f"{entry['traffic']}.json"),
            "limits": _read_json(bench / "limits" / f"{name}.json"),
            "end_to_end": end_to_end, "per_layer": per_layer}


def reader(metric: str, folder: Path):
    """The module ``<folder>/<metric>.py`` (``end_to_end`` or
    ``layer_metrics``): its ``read(ctx)`` returns the metric's value, or
    None where the run has nothing to read, and its optional ``SPANS``
    lists the ``(module, attribute, span)`` calls to time in the traced
    run."""
    path = folder / f"{metric}.py"
    mod_name = "portbench_layer_" + metric.replace(".", "_").replace("-", "_")
    loader = importlib.util.spec_from_file_location(mod_name, path)
    if loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod
