"""What the benchmark imports, and that ``BENCHMARK.json`` and the files
the harness finds by name agree."""

import ast
import json
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(harness.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_path_tracer"}


def _imports(path: Path):
    """(top-level name, full name) of each module a file imports, relative
    imports resolved against the file's package."""
    tree = ast.parse(path.read_text())
    package = list(path.relative_to(BENCH.parent).parent.parts)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[:len(package) - node.level + 1]
                full = ".".join(base + ([node.module] if node.module
                                        else []))
                yield base[0], full
            else:
                yield node.module.split(".")[0], node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0], node.args[0].value


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_old_harness(path):
    for top, full in _imports(path):
        assert top not in FORBIDDEN, (path, full)
        assert full not in ("tpu_path_tracer_torch.bench", "bench"), \
            (path, full)


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        for top, full in _imports(path):
            assert top != "tpu_path_tracer_torch", (path, full)
            assert not full.startswith("benchmark.") or full.startswith(
                "benchmark.reference"), (path, full)


def test_top_level_names_are_compared_whole():
    assert "tpu_path_tracer_torch".split(".")[0] not in FORBIDDEN
    assert "tpu_path_tracer.core".split(".")[0] in FORBIDDEN


def test_benchmark_json_agrees_with_the_files():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for cfg in spec["configs"]:
        data = json.loads((BENCH.parent / cfg["file"]).read_text())
        assert data["name"] == cfg["name"]
        assert data["source"] == cfg["source"]
        assert data["reduced"] == cfg["reduced"]
        assert (BENCH / "scenes" / f"{data['recipe']}.py").exists()
    for w in spec["workloads"]:
        cell = harness.load("cells", w["name"])
        for k in ("config", "traffic", "chips", "why"):
            assert cell[k] == w[k], (w["name"], k)
        traffic = harness.load("traffic", cell["traffic"])
        assert (BENCH / "jobs" / f"{traffic['job']}.py").exists()
        assert set(cell["limits"]), w["name"]
    for m in spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
    # Cells proven on the card but not yet held (PERF.md) may wait here.
    assert {w["name"] for w in spec["workloads"]} <= {
        p.stem for p in (BENCH / "cells").glob("*.json")}
