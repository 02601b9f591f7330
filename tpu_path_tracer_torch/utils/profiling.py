"""Frame statistics and device traces (``tpu_path_tracer.utils.profiling``).

:class:`FrameStats` is the JAX package's rolling frame-time and rays-per-
second meter (the reference's stats.js panel and its 100-frame log,
``renderer.js:145-150, 197-204``); :func:`device_trace` records a
``torch.profiler`` timeline where the JAX package records a
``jax.profiler`` one.  The JAX ``cost_summary`` reads XLA's cost model and
has no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Optional


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
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
