"""A cell on several ranks, on the CPU: the rank launcher of ``ranks.py``
starts gloo ranks (``device="cpu"``, where the cards' run takes NCCL) of a
small two-rank copy of ``cornell.frames`` in a copy of the benchmark.
Both ranks step the same frames and stop on the same one; the checked
frames and the summed ``frame_err`` / ``display_err`` equal those of one
process that takes the same decisions; the control and the two faults
planted in the gathered image fail; a fault under the timed path of a rank
is not correct; and a run whose ranks share a device, or one of whose
ranks raises or holds JAX, ends without a line."""

import json
import shutil
import time

import pytest

from benchmark import calibrate, harness, ranks

from .conftest import TINY, TINY_DEEP

SEED = 2 ** 31 + 23
CELL = "cornell.frames_2rank"
TWO_RANKS = {"name": CELL, "config": "cornell", "traffic": "frames.preview",
             "chips": 2, "why": "a test's cell: two ranks",
             "limits": {"frame_err": 0.005, "display_err": 0.02}}
# A job that plants one fault (the traffic's "fault") in every rank's
# program, or makes rank 1 raise or load a module named jax.
FAULTY_JOB = '''
import sys
import types

import torch

import tpu_path_tracer_torch.dist.render_dist as rd
import tpu_path_tracer_torch.renderer as renderer
from tpu_path_tracer_torch.integrator import film

from benchmark.jobs.frames import Job as Frames


def _traced(change):
    orig = rd.path_trace_pixels

    def trace(*args):
        state, rad = orig(*args)
        return state, change(rad.clone())

    return trace


def _half(rad):
    rad[rad.shape[0] // 2:] = 0.0
    return rad


def _own_chunk_everywhere(x, mesh):
    return torch.cat([x] * mesh.size())


FAULTS = {
    "state_unchanged": (film, "accumulate", lambda fb, rad, reset: fb),
    "half_batch": (rd, "path_trace_pixels", _traced(_half)),
    "answer_altered": (rd, "path_trace_pixels", _traced(lambda r: r * 1.25)),
    "exchange_left_out": (renderer, "gather_rows", _own_chunk_everywhere),
}


class Job(Frames):
    def setup(self):
        fault = self.job["fault"]
        if fault in FAULTS:
            setattr(*FAULTS[fault])
        elif fault == "holds_jax" and self.ctx.rank == 1:
            sys.modules["jax"] = types.ModuleType("jax")
        super().setup()

    def window(self, **kw):
        if self.job["fault"] == "raises" and self.ctx.rank == 1:
            raise RuntimeError("a fault planted in rank 1")
        return super().window(**kw)
'''


# The four-card cell waits outside BENCHMARK.json (PERF.md); the copy
# lists it as the PR that holds it would: under the frame metrics, with
# the gather's reader.
FOUR = "reference.frames_4chip"
ALLGATHER = {"name": "frame_allgather_ms", "unit": "ms", "better": "lower",
             "source": "device_trace", "layer": "dist",
             "moves": "frame_mrays", "workloads": [FOUR]}


def _listing_the_four_card_cell(spec):
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "reference.frames" in m.get("workloads", []):
            m["workloads"].append(FOUR)
    spec["per_layer"].append(ALLGATHER)
    return spec


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A copy of the benchmark with the two-rank cell, the faulty job and
    the four-card cell listed."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    (root / "BENCHMARK.json").write_text(
        json.dumps(_listing_the_four_card_cell(spec)))
    base = root / "benchmark"
    (base / "cells" / f"{CELL}.json").write_text(json.dumps(TWO_RANKS))
    (base / "jobs" / "faulty_frames.py").write_text(FAULTY_JOB)
    return base


def _run(bench, overrides=TINY, seconds=1.0, places=None):
    return ranks.run_cell(CELL, SEED, seconds, False, 2, time.perf_counter(),
                          device="cpu", places=places, base=bench,
                          root=bench.parent, overrides=overrides)


def _replay(units, kept):
    """Rank 0's decisions at each frame of a window of ``units`` frames
    that kept the frames numbered ``kept`` (the window's k-th frame, from
    0, is numbered k + 1; the first is a reset)."""
    decisions = iter([(i + 1 == units, i + 2 in kept) for i in range(units)])
    return lambda done, keep: next(decisions)


def test_two_ranks_equal_one_process(bench):
    code, out = _run(bench)
    assert code == 0 and out["correct"], out
    assert out["device"]["count"] == 2
    r0, r1 = out["ranks"]
    assert r0["units"] == r1["units"] == out["attempted"]
    assert r0["checked"] == r1["checked"]
    assert r0["checked"][0] == 1 and len(r0["checked"]) > 1

    _, job = harness.make_job(CELL, SEED, "cpu", bench, TINY)
    job.ctx.agree = _replay(out["attempted"], set(r0["checked"]))
    job.setup()
    _, units, _ = job.window(seconds=1e9, spans=harness._no_span)
    job.release()
    numbers, _ = job.check()
    assert units == out["attempted"]
    assert job.kept == r0["checked"]
    assert numbers == {k: c["value"] for k, c in out["checks"].items()}


def test_the_control_and_the_faults_in_the_gathered_image_fail(bench):
    code, lines = ranks.launch(calibrate.run_seeds, (
        CELL, [SEED], {SEED}, 1.0, "cpu", TINY, None, bench), 2, "cpu")
    assert code == 0
    (line,) = lines
    limits = TWO_RANKS["limits"]
    assert all(v <= limits[k] for k, v in line["program"].items()), line
    readings = ("control_bf16", "fault_chunks_swapped",
                "fault_increment_dropped")
    for name in readings:
        assert any(v > limits[k] for k, v in line[name].items()), (name,
                                                                   line)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "exchange_left_out", "answer_altered"])
def test_a_fault_under_a_ranks_timed_path_is_not_correct(bench, fault):
    code, out = _run(bench, dict(TINY, job="faulty_frames", fault=fault))
    assert code == 0
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault,code", [("raises", 1), ("holds_jax", 3)])
def test_a_failing_rank_ends_the_run_without_a_line(bench, fault, code):
    t0 = time.perf_counter()
    got, out = _run(bench, dict(TINY, job="faulty_frames", fault=fault))
    assert (got, out) == (code, None)
    assert time.perf_counter() - t0 < 120


def test_ranks_sharing_a_device_give_no_line(bench):
    assert _run(bench, places=[0, 0]) == (2, None)


def test_the_four_card_cell_traced_on_the_cpu(bench):
    """``reference.frames_4chip`` as committed, listed as a later PR would
    list it, at a small size on four ranks, traced: rank 0 reads the
    program's spans and counters; the device metrics wait for a card."""
    code, line = ranks.run_cell(
        FOUR, SEED, 0.5, True, 4, time.perf_counter(), device="cpu",
        base=bench, root=bench.parent, overrides=TINY_DEEP)
    assert code == 0 and line["correct"], line
    assert line["device"]["count"] == 4
    assert list(line)[-1] == "checks"
    metrics = line["metrics"]
    assert metrics["frame_host_syncs"]["value"] == 1.0
    assert metrics["frame_renderer_ms"]["value"] > 0
    assert "frame_allgather_ms" not in metrics

