"""``icosphere81k.frames`` and what it added: its five readers on
synthetic records, the frozen bound of a mesh frame, and the cell itself
at a small size on the CPU (its icosphere subdivided twice, 320
triangles, in a copy of the benchmark): a sound run is correct and reads
the mesh route's spans, the control and the dropped block fail, and a
fault under the timed path is not correct."""

import collections
import json
import shutil

import pytest
import torch

from benchmark import harness
from benchmark.profile_reduce import Trace
from benchmark.reference import integrator_mesh as rm
from benchmark.reference import scene as rs
from benchmark.reference import work_mesh as wm
from benchmark.scenes import icosphere81k

from .conftest import TINY

import tpu_path_tracer_torch.dist.render_dist as rd
from tpu_path_tracer_torch.integrator import film
from tpu_path_tracer_torch.utils import profiling

CELL = "icosphere81k.frames"
SEED = 2 ** 31 + 29
# 32x32 pixels: enough of them on the sphere that the dropped block shows.
SMALL = dict(TINY, width=32, height=32, ref_block=256, tri_block=80)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as ``run.py`` runs a cell: the plain BVH walk's
    many small operations crawl when several test workers each spread
    them over every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               f"benchmark.metrics.{name}")


def _span(name, start_ms, end_ms, parent, frame):
    return profiling.Span(name, int(start_ms * 1e6), int(end_ms * 1e6),
                          parent, frame)


def _frames(walk=True):
    """Two frames' spans: a step holding the wavefront's span, which holds
    the walk's pack and launch spans of its two bounces (the CUDA route;
    none on the plain walk); wavefront 10 ms, walk 1 + 2 + 1 + 2 ms."""
    spans = []
    for frame in (1, 2):
        t = 100.0 * frame
        step = len(spans)
        spans += [_span("renderer.step", t, t + 12, -1, frame),
                  _span("wavefront.trace", t + 1, t + 11, step, frame)]
        trace = step + 1
        if walk:
            for b in range(2):
                s = t + 2 + 4 * b
                spans += [_span("traversal.pack", s, s + 1, trace, frame),
                          _span("traversal.launch", s + 1, s + 3, trace,
                                frame)]
        spans += [_span("renderer.display", t + 12, t + 13, -1, frame)]
    return spans


def _reading(units=2, trace=None, bounds=None, kind="frames"):
    return harness.Reading(kind, units, trace, {}, bounds or {})


@pytest.fixture
def record(monkeypatch):
    """The program's record replaced by a synthetic one; returns a setter."""
    def put(spans, counts):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))
        monkeypatch.setattr(profiling, "counts",
                            lambda: collections.Counter(counts))
    return put


def test_span_readers_on_synthetic_records(record):
    wavefront, walk = _reader("frame_wavefront_ms"), _reader(
        "frame_traversal_ms")
    renderer = _reader("frame_renderer_ms.mesh")
    record(_frames(), {"frames": 2})
    assert wavefront.read(_reading()) == pytest.approx(10.0 - 6.0)
    assert walk.read(_reading()) == pytest.approx(6.0)
    assert renderer.read(_reading()) == pytest.approx(12.0 - 10.0)
    assert wavefront.read(_reading(kind="train")) is None
    assert renderer.read(_reading(kind="train")) is None
    # The plain walk (CPU tensors) has no traversal spans.
    record(_frames(walk=False), {"frames": 2})
    assert wavefront.read(_reading()) == pytest.approx(10.0)
    assert walk.read(_reading()) is None
    assert renderer.read(_reading()) == pytest.approx(2.0)
    # A program without the wavefront's span (the megakernel route, or a
    # program before the span existed).
    record([s for s in _frames() if s.name.startswith("renderer.")],
           {"frames": 2})
    assert wavefront.read(_reading()) is None
    assert walk.read(_reading()) is None
    assert renderer.read(_reading()) is None


def test_span_readers_without_a_record(monkeypatch):
    for name in ("spans", "counts"):
        monkeypatch.delattr(profiling, name)
    for name in ("frame_wavefront_ms", "frame_traversal_ms",
                 "frame_bvh_packs", "frame_renderer_ms.mesh"):
        assert _reader(name).read(_reading()) is None


def test_the_packs_reader(record):
    packs = _reader("frame_bvh_packs")
    record([], {"frames": 10, "bvh_pack": 40})
    assert packs.read(_reading()) == 4.0
    record([], {"frames": 10})  # never packed
    assert packs.read(_reading()) is None
    record([], {"frames": 0, "bvh_pack": 1})
    assert packs.read(_reading()) is None


def test_the_roofline_reader():
    roofline = _reader("mesh_frame_roofline.frames")
    device = [("bvh_stack_walk_kernel", 0.0, 100.0),
              ("elementwise_kernel", 100.0, 400.0),
              ("Memcpy DtoH (Device -> Pageable)", 400.0, 900.0),
              ("Memset (Device)", 900.0, 950.0)]
    trace = Trace(device, 1.0)
    r = _reading(units=2, trace=trace, bounds={"mesh_frame": 0.003})
    # 0.4 ms of kernels in 2 frames: 0.2 ms a frame; copies and fills out.
    assert roofline.read(r) == pytest.approx(100.0 * 0.003 / 0.2)
    assert roofline.read(_reading(trace=trace)) is None
    assert roofline.read(_reading(bounds={"mesh_frame": 0.003})) is None
    only_copies = Trace(device[2:], 1.0)
    assert roofline.read(_reading(trace=only_copies,
                                  bounds={"mesh_frame": 0.003})) is None


def test_the_frame_bound_is_frozen():
    """The bound's arithmetic, pinned: 1,000 triangles read once, 2,000
    lane-bounces, 100 pixels, NEE with a light; the lanes' rays and hits
    cost no bytes, so 4,000 lane-bounces make it bound by operations."""
    work = {"lanes": 2000.0, "facing_quads": 123.0}
    b = wm.frame_bound(work, 1000, 100, True, True)
    assert b["flops"] == 2000 * (200 + 120)
    assert b["bytes"] == 1000 * 36 + 100 * 27
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e12 * 1e3)
    assert wm.frame_bound(work, 1000, 100, False, True)["flops"] == 2000 * 200
    busy = wm.frame_bound({"lanes": 4000.0}, 1000, 100, True, True)
    assert busy["bytes"] == b["bytes"]
    assert busy["bound_by"] == "operations"
    assert busy["bound_ms"] == pytest.approx(4000 * 320 / 67e12 * 1e3)


def test_the_frame_bound_does_not_depend_on_the_search():
    """The same frame traced with other triangle and pixel blocks gives the
    same work, so the same bound."""
    desc = icosphere81k.describe({"subdivisions": 2})
    ref = rs.build(desc, "cpu")
    view = torch.as_tensor(rs.target_to([0, 0, 3.2], [0, 0, 0], [0, 1, 0]))
    job = dict(width=16, height=8, spp=1, bounces=4, nee=True,
               stratify=False, rr_start=3)
    bounds = []
    for block, tri_block in ((128, 320), (48, 7), (100, 64)):
        work = {}
        rm.render(ref, 4, view, job, block, tri_block, work)
        work = {k: float(v) for k, v in work.items()}
        bounds.append(wm.frame_bound(work, 320, 128, True, True))
    assert bounds[0]["bound_ms"] > 0
    assert bounds[1:] == bounds[:1] * 2


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A copy of the benchmark whose icosphere is subdivided twice."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    path = root / "benchmark" / "configs" / "icosphere81k.json"
    config = json.loads(path.read_text())
    config["recipe_args"]["subdivisions"] = 2
    path.write_text(json.dumps(config))
    return root / "benchmark"


def _run(bench, trace=False):
    profiling.reset()
    return harness.run_cell(CELL, SEED, 0.2, trace, "cpu", base=bench,
                            root=bench.parent, overrides=SMALL,
                            say=lambda _: None)


def test_a_sound_run_is_correct_and_traced(bench):
    out = _run(bench, trace=True)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["frame_wavefront_ms"] > 0
    assert m["frame_renderer_ms.mesh"] > 0
    assert m["frame_host_syncs"] == 1.0
    # The CPU walk neither packs nor enqueues the kernel; no device trace.
    for name in ("frame_traversal_ms", "frame_bvh_packs",
                 "mesh_frame_roofline.frames", "frame_kernels"):
        assert name not in m
    assert profiling.counts()["wavefront_bounces"] == 4 * profiling.counts()[
        "frames"]


def test_the_control_and_the_dropped_block_fail(bench):
    spec, job = harness.make_job(CELL, SEED, "cpu", base=bench,
                                 overrides=SMALL)
    job.setup()
    job.window(seconds=0.2, spans=harness._no_span)
    job.release()
    numbers, bounds = job.check()
    limits = spec["limits"]
    assert all(v <= limits[k] for k, v in numbers.items()), numbers
    assert bounds["mesh_frame"] > 0
    readings = job.control_readings()
    assert set(readings) == {"control_bf16", "fault_block_dropped"}
    for name, got in readings.items():
        assert any(v > limits[k] for k, v in got.items()), (name, got)


def _scaled(factor):
    orig = rd.path_trace_pixels

    def trace(*args):
        state, rad = orig(*args)
        return state, rad * factor

    return trace


@pytest.mark.parametrize("fault", [
    (film, "accumulate", lambda fb, rad, reset: fb),
    (rd, "path_trace_pixels", _scaled(1.25))], ids=["state_unchanged",
                                                    "answer_altered"])
def test_a_fault_under_the_timed_path_is_not_correct(bench, fault,
                                                     monkeypatch):
    monkeypatch.setattr(*fault)
    out = _run(bench)
    assert not out["correct"], out["checks"]
