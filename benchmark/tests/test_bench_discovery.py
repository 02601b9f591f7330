"""A configuration, a traffic mix, a cell and a per-layer metric are added
by adding files and ``BENCHMARK.json`` entries: a copy of the benchmark
with such files added finds and runs them, at a small size on the CPU's
plain path, while its measured path refuses a machine with no card."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

NEW_CONFIG = {"name": "dim_box", "recipe": "cornell_box",
              "recipe_args": {"light_emission": [5.0, 5.0, 5.0]},
              "eye": [0.0, 0.2, 3.0], "center": [0.0, 0.0, 0.0],
              "source": "a test's own scene", "reduced": [], "assumed": {}}
NEW_TRAFFIC = {"job": "frames", "width": 8, "height": 6, "spp": 1,
               "bounces": 3, "nee": True, "rr_start": 3, "check_frames": 2,
               "trace_units": 2, "trace_units_host": 2, "ref_block": 48}
NEW_CELL = {"name": "dim_box.frames", "config": "dim_box",
            "traffic": "frames.tiny", "chips": 1, "why": "a test's cell",
            "limits": {"frame_err": 0.0, "display_err": 0.0}}
NEW_READER = '''
def read(r):
    return float(r.units) if r.kind == "frames" else None
'''


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = root / "benchmark"
    (bench / "configs" / "dim_box.json").write_text(json.dumps(NEW_CONFIG))
    (bench / "traffic" / "frames.tiny.json").write_text(
        json.dumps(NEW_TRAFFIC))
    (bench / "cells" / "dim_box.frames.json").write_text(
        json.dumps(NEW_CELL))
    (bench / "metrics" / "frames_traced.py").write_text(NEW_READER)
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dim_box", "source": "a test",
                            "file": "benchmark/configs/dim_box.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({k: NEW_CELL[k] for k in (
        "name", "config", "traffic", "chips", "why")})
    spec["per_layer"].append({
        "name": "frames_traced", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "renderer",
        "moves": "frame_mrays", "workloads": ["dim_box.frames"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_added_files_are_found_and_run(tmp_path):
    root = _checkout(tmp_path)
    bench = root / "benchmark"
    plain = harness.run_cell("dim_box.frames", 2 ** 31 + 11, 0.2, False,
                             "cpu", base=bench, root=root)
    assert plain["correct"]
    assert set(plain["metrics"]) == {"frame_mrays", "setup_s"}
    lines = []
    traced = harness.run_cell("dim_box.frames", 2 ** 31 + 11, 0.2, True,
                              "cpu", base=bench, root=root, say=lines.append)
    assert traced["correct"]
    assert traced["metrics"]["frames_traced"]["value"] == 2.0
    assert "frame_host_ms" not in traced["metrics"]  # not listed for it
    assert "tracing_overhead" in json.loads(lines[0])
    assert list(traced)[-1] == "checks"


def test_the_measured_path_refuses_a_machine_without_a_card(tmp_path):
    root = _checkout(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dim_box.frames",
         "--seed", str(2 ** 31 + 12), "--seconds", "1", "--trace", "0"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr
