"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names are
compared whole, since ``deconv3d_tpu_torch`` begins with ``deconv3d_tpu``."""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap

import pytest

from portbench import harness

from .conftest import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "deconv3d_tpu"}


def imported_tops(path):
    """Top-level names of every module ``path`` imports (relative imports
    left out)."""
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_module_imports_jax(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert not tops & (FORBIDDEN | {"deconv3d_tpu_torch", "portbench"})
    assert tops <= {"__future__", "math", "numpy", "torch"}


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "deconv3d_tpu_torch_probe", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "deconv3d_tpu.probe", object())
    assert harness.forbidden_modules() == ["deconv3d_tpu"]


def test_a_run_loads_no_jax(tiny):
    """A tiny cell run in a fresh interpreter, JAX installed beside it,
    leaves every forbidden name out of ``sys.modules``."""
    root, bench = tiny
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        from portbench import harness
        result, _, _ = harness.run_cell(Path({str(root)!r}), "tiny_mh", 5,
                                        0.2, False, "cpu",
                                        bench=Path({str(bench)!r}))
        assert result["correct"], result
        print(harness.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
