"""The readers of the program's own spans and counters, on traced runs of
``cornell.frames`` at a small size on the CPU: each reads the program's
record of the run, and a reader whose spans are absent is left out (on CPU
tensors the megakernel route is the wavefront, which neither packs nor
launches, so the wrapper's spans are absent there).  A program without the
record, as before it had one, gives a run with none of these metrics."""

import ctypes
import statistics
import types

import pytest
import torch

from benchmark import harness

from .conftest import TINY

from tpu_path_tracer_torch.kernels import _build
from tpu_path_tracer_torch.kernels import megakernel as mk
from tpu_path_tracer_torch.utils import profiling

SEED = 2 ** 31 + 17
SPAN_METRICS = ("frame_wrapper_ms", "frame_renderer_ms", "display_wait_ms")
COUNTER_METRICS = ("frame_host_syncs", "frame_table_packs")


def _traced_run():
    profiling.reset()
    return harness.run_cell("cornell.frames", SEED, 0.2, True, "cpu",
                            overrides=TINY, say=lambda _: None)


def _ms(span):
    return (span.end_ns - span.start_ns) / 1e6


def test_traced_frames_read_the_program_record():
    out = _traced_run()
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert "frame_wrapper_ms" not in m
    assert m["frame_host_syncs"] == 1.0
    assert m["frame_table_packs"] == 0.0
    assert m["display_wait_ms"] > 0
    # The first trace_units steps of the record are the device profile's.
    spans = profiling.spans()
    steps = [s for s in spans if s.name == "renderer.step"]
    assert len(steps) == TINY["trace_units"] + TINY["trace_units_host"]
    first = steps[:TINY["trace_units"]]
    assert m["frame_renderer_ms"] == pytest.approx(
        statistics.mean(map(_ms, first)))


def test_the_wrapper_reader_on_the_kernel_route(monkeypatch):
    """With the CUDA route taken on CPU tensors (its kernel a stand-in that
    writes zeros, so the run is not correct), the wrapper's spans are read
    and the tables are packed once in the whole run: the wrapper reuses
    them while the scene's tensors are unchanged."""
    def launch(*args):
        ctypes.memset(args[7], 0, 12 * args[8])
        return 0

    monkeypatch.setattr(mk, "path_trace_pixels_reference", mk._kernel_route)
    monkeypatch.setattr(_build, "load", lambda: None)
    monkeypatch.setattr(mk, "_bind", lambda lib: (launch, None, None))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    m = {k: v["value"] for k, v in _traced_run()["metrics"].items()}
    counts = profiling.counts()
    assert counts["table_packs"] == 1
    assert m["frame_table_packs"] == 1.0 / counts["frames"]
    assert m["frame_host_syncs"] == 1.0
    assert 0 < m["frame_wrapper_ms"]
    assert 0 < m["frame_renderer_ms"]


def test_a_program_without_the_record_reads_nothing(monkeypatch):
    for name in ("spans", "counts"):
        monkeypatch.delattr(profiling, name)
    out = _traced_run()
    assert out["correct"], out["checks"]
    assert not set(out["metrics"]) & set(SPAN_METRICS + COUNTER_METRICS)
