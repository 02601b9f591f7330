"""The port's spans and counters (``utils.profiling``): off unless a
profiler runs or ``recording()`` is entered, the six spans of a frame with
their parents and frame, their annotations in a ``torch.profiler`` profile,
the record's cap, and the counters a frame adds.

The megakernel wrapper's spans sit on its CUDA route; here that route runs
on CPU tensors with the launch's ctypes call replaced by one that writes
zeros (the ``kernel_route`` fixture of ``torch_kernel_route.py``), so
everything but the kernel runs as on the card.
"""

import statistics
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpu_path_tracer_torch as pt
from tpu_path_tracer_torch.utils import profiling

from torch_kernel_route import kernel_route  # noqa: F401

FRAME_SPANS = ("renderer.step", "megakernel.pack_tables",
               "megakernel.prepare", "megakernel.launch", "renderer.display",
               "renderer.display.copy")
# Each span's parent, by name (None: no program span encloses it).
PARENT = {"renderer.step": None, "megakernel.pack_tables": "renderer.step",
          "megakernel.prepare": "renderer.step",
          "megakernel.launch": "renderer.step", "renderer.display": None,
          "renderer.display.copy": "renderer.display"}
# The record reads the clock just before each annotation enters and just
# before it leaves, where the profile stamps it inside the two calls: the
# two durations differ by the difference of the calls' overheads, about a
# microsecond on an idle machine and a few under load (the first frame,
# which pays first calls, is left out of the comparison).
AGREE_US = 10.0


@pytest.fixture(autouse=True)
def clean_record():
    profiling.reset()
    yield
    profiling.reset()


def _renderer(use_megakernel=True):
    scene, meta, _ = pt.builtin.cornell_box(device="cpu")
    cfg = pt.RenderConfig(width=8, height=4, max_bounces=2,
                          importance_sampling=True,
                          use_megakernel=use_megakernel)
    return pt.Renderer(scene, meta, cfg, camera=pt.Camera(eye=[0, 0, 3.2]))


def _frames(renderer, n):
    for _ in range(n):
        renderer.step()
        renderer.display()


def _program_events(prof):
    return sorted((e for e in prof.events() if e.name in FRAME_SPANS),
                  key=lambda e: e.time_range.start)


def _ancestors(event):
    out, p = [], event.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def test_spans_off_leave_no_record_and_no_annotation(kernel_route,
                                                     monkeypatch):
    """Without a profiler a frame records nothing; and with the recorder
    seeing no profiler (its flag held off), a profile of a frame holds none
    of the program's annotations.  The counters count either way."""
    r = _renderer()
    _frames(r, 1)
    assert profiling.spans() == []
    monkeypatch.setattr(profiling, "_torch_profiler",
                        types.SimpleNamespace(_is_profiler_enabled=False))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frames(r, 1)
    assert profiling.spans() == []
    assert _program_events(prof) == []
    assert profiling.counts()["frames"] == 2


def test_frame_spans_under_a_profiler(kernel_route):
    """Under a CPU profile the six spans of each frame are recorded in
    order, with their parents and the frame's number, appear as user
    annotations inside the caller's annotation and their parent's, and
    last as long on the record's clock as in the profile."""
    r = _renderer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.frames"):
            _frames(r, 3)
    spans = profiling.spans()
    assert [s.name for s in spans] == list(FRAME_SPANS) * 3
    for s in spans:
        parent = PARENT[s.name]
        assert (spans[s.parent].name if s.parent >= 0 else None) == parent
        assert s.frame == 1 + spans.index(s) // len(FRAME_SPANS)
        assert 0 < s.start_ns <= s.end_ns
        if parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns

    events = _program_events(prof)
    assert [e.name for e in events] == [s.name for s in spans]
    for e in events:
        assert e.is_user_annotation
        above = _ancestors(e)
        assert "test.frames" in above
        if PARENT[e.name] is not None:
            assert PARENT[e.name] in above
    gaps = [abs((e.time_range.end - e.time_range.start)
                - (s.end_ns - s.start_ns) / 1e3)
            for e, s in zip(events, spans) if s.frame > 1]
    assert statistics.median(gaps) <= AGREE_US, gaps


def test_recording_turns_spans_on_without_a_profiler():
    """``recording()`` records the renderer's spans, and the wavefront's
    inside its step, with no profiler running, and stops when it ends;
    ``reset()`` clears the record, and refuses inside a span."""
    r = _renderer(use_megakernel=False)
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.recording():
        _frames(r, 1)
        with profiling.span("test.open"), pytest.raises(RuntimeError):
            profiling.reset()
    _frames(r, 1)
    assert [s.name for s in profiling.spans()] == [
        "renderer.step", "wavefront.trace", "renderer.display",
        "renderer.display.copy", "test.open"]
    profiling.reset()
    assert profiling.spans() == [] and profiling.counts() == {}


def test_the_record_is_capped(kernel_route, monkeypatch):
    """Past MAX_SPANS a span is not kept, and is counted as dropped."""
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    with profiling.recording():
        _frames(_renderer(), 2)
    assert [s.name for s in profiling.spans()] == list(FRAME_SPANS[:5])
    assert profiling.counts()["spans_dropped"] == 2 * len(FRAME_SPANS) - 5


@pytest.mark.parametrize("route", ["kernel", "wavefront"])
def test_counters_per_frame(route, request):
    """Each ``Renderer.step`` + ``display`` counts one frame and one host
    sync (the display's copy); the kernel route launches the forward kernel
    once a frame and packs the static scene's tables on the first frame
    only, reusing them after; the wavefront does none of these."""
    if route == "kernel":
        request.getfixturevalue("kernel_route")
    r = _renderer(use_megakernel=route == "kernel")
    _frames(r, 3)
    c = profiling.counts()
    kernel = route == "kernel"
    assert (c["frames"], c["host_syncs"]) == (3, 3)
    assert c["megakernel_fwd"] == 3 * kernel
    assert (c["table_packs"], c["table_cache_hits"]) == (kernel, 2 * kernel)
