"""Frame statistics, device traces, and the program's spans and counters
(``tpu_path_tracer.utils.profiling``).

:class:`FrameStats` is the JAX package's rolling frame-time and rays-per-
second meter (the reference's stats.js panel and its 100-frame log,
``renderer.js:145-150, 197-204``); :func:`device_trace` records a
``torch.profiler`` timeline where the JAX package records a
``jax.profiler`` one, and :func:`profile_device_ms` sums the device time of
a call by kernel.  The JAX ``cost_summary`` reads XLA's cost model; the
port's kernel bounds are counted in ``utils.bounds`` instead.

:func:`span` marks a layer boundary of the frame's path and :func:`count`
adds to a named counter.  Spans are recorded only while a
``torch.profiler`` runs or inside :func:`recording`; each then sits in the
profile as a ``record_function`` annotation, on the kernels' clock, and in
an in-memory record that :func:`spans` returns.  Counters are always on.
"""

from __future__ import annotations

import array
import contextlib
import os
import time
from collections import Counter, deque
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _torch_profiler


class FrameStats:
    """Rolling frame-time / rays-per-second meter (stats.js equivalent)."""

    def __init__(self, window: int = 100):
        self.times = deque(maxlen=window)
        self.frames = 0
        self._t0: Optional[float] = None

    def begin(self):
        self._t0 = time.perf_counter()

    def end(self):
        if self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
            self.frames += 1
            self._t0 = None

    @property
    def avg_ms(self) -> float:
        return 1e3 * sum(self.times) / len(self.times) if self.times else 0.0

    @property
    def fps(self) -> float:
        avg = self.avg_ms
        return 1e3 / avg if avg > 0 else 0.0

    def mrays_per_s(self, rays_per_frame: int) -> float:
        avg = self.avg_ms
        return rays_per_frame / (avg * 1e-3) / 1e6 if avg > 0 else 0.0

    def report(self, rays_per_frame: int) -> str:
        """One-line log mirroring renderer.js:197-204's periodic output."""
        return (f"frames={self.frames} avg={self.avg_ms:.2f}ms "
                f"fps={self.fps:.1f} "
                f"throughput={self.mrays_per_s(rays_per_frame):.1f} Mray/s")


@contextlib.contextmanager
def device_trace(log_dir: str = "tpt_trace"):
    """``torch.profiler`` trace context (CPU, and CUDA where there is a
    card): writes ``trace.json`` into ``log_dir`` on exit, a Chrome trace
    for Perfetto or chrome://tracing.  Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_us(e):
    """Device microseconds of a ``key_averages()`` row."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def kernel_rows(prof):
    """The device kernels of a profile, by name, busiest first.  A CPU op
    that launched a kernel reports the same device time again, and so does
    a user annotation (the optimizer's step), so both are left out."""
    from torch.autograd import DeviceType

    annotations = {e.name for e in prof.events()
                   if getattr(e, "is_user_annotation", False)}
    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and device_us(e) > 0
                   and e.key not in annotations),
                  key=device_us, reverse=True)


def profile_device_ms(fn, calls, names):
    """Device ms per call of ``fn`` by kernel-name group (torch.profiler),
    after one call outside the profile: ``names`` maps a group to
    substrings of kernel names; "all" sums every kernel.  Returns that and
    the profile's kernel rows; each group reads "not measured" where the
    profiler saw no device time (the CPU, or a card it cannot trace)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])) as prof:
        for _ in range(calls):
            fn()
        sync()
    rows = kernel_rows(prof)
    if not rows:
        return {k: "not measured" for k in list(names) + ["all"]}, []
    out = {k: sum(device_us(e) for e in rows
                  if any(s in e.key for s in subs)) / 1e3 / calls
           for k, subs in names.items()}
    out["all"] = sum(device_us(e) for e in rows) / 1e3 / calls
    return out, rows


# The record of spans is bounded: past MAX_SPANS a span still annotates the
# profile, and counts as "spans_dropped" instead of being kept.
MAX_SPANS = 1 << 20


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns() before entering the annotation
    end_ns: int    # and before leaving it
    parent: int    # index in spans() of the enclosing span; -1 for none
    frame: int     # the "frames" count when it began: its frame's number


_recording = False
_counts = Counter()
_names = []
_starts, _ends = array.array("q"), array.array("q")
_parents, _frames = array.array("q"), array.array("q")
_open = []  # indices of the spans entered and not yet left
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "note", "index")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.index = len(_names)
        if self.index < MAX_SPANS:
            _names.append(self.name)
            _parents.append(_open[-1] if _open else -1)
            _frames.append(_counts["frames"])
            _ends.append(-1)
            _starts.append(time.perf_counter_ns())
        else:
            self.index = -1
            _counts["spans_dropped"] += 1
        _open.append(self.index)
        self.note = _torch_profiler.record_function(self.name)
        self.note.__enter__()

    def __exit__(self, *exc):
        if self.index >= 0:
            _ends[self.index] = time.perf_counter_ns()
        _open.pop()
        return self.note.__exit__(*exc)


def span(name: str):
    """A context manager that marks ``name``, a layer boundary of the
    program, while recording is on (a ``torch.profiler`` runs, or inside
    :func:`recording`).  Off, it is a shared null context: no clock read,
    no annotation, nothing kept."""
    if _recording or _torch_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


@contextlib.contextmanager
def recording():
    """Record spans inside the context without a profiler."""
    global _recording
    before, _recording = _recording, True
    try:
        yield
    finally:
        _recording = before


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``.  The program counts "frames"
    (``Renderer.step``), "host_syncs" (each place it makes the host wait
    for the device), "table_packs" (``megakernel.pack_tables``),
    "table_cache_hits" (a frame that reused the megakernel's packed
    tables), "wavefront_bounces" (a bounce of the wavefront integrator)
    and the launches of each CUDA kernel under the kernel's name:
    "megakernel_fwd", and "megakernel_fwd_bvh" for the forward kernel's
    BVH variant (a frame of a BVH scene through the megakernel), among
    them."""
    _counts[name] += n


def counts() -> Counter:
    """A copy of the counters; a counter never added to reads 0."""
    return Counter(_counts)


def spans() -> list:
    """The recorded spans, in the order they began."""
    return [Span(*r) for r in zip(_names, _starts, _ends, _parents,
                                  _frames)]


def reset():
    """Clear the spans and the counters (outside any span)."""
    if _open:
        raise RuntimeError("profiling.reset() inside a span")
    _counts.clear()
    del _names[:], _starts[:], _ends[:], _parents[:], _frames[:]
