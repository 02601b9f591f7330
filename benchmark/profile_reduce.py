"""``torch.profiler`` runs of a traced window reduced to plain lists.

Two profiles are taken.  The device profile records the device alone
(kernels, copies, fills: ``(name, start_us, end_us)``), so that the host
runs at nearly its untraced speed; its window's length is the host's
clock around the loop, which ends by waiting for the device.  The host
profile records host operations too, and the benchmark's spans as user
annotations inside the annotation ``WINDOW``; it names what the host was
doing in each idle stretch of the device.
"""

from __future__ import annotations

import collections
import dataclasses

WINDOW = "benchmark.window"


@dataclasses.dataclass
class Trace:
    device: list     # (name, start_us, end_us), device operations
    window_s: float  # the traced loop's length on the host's clock
    host: list = dataclasses.field(default_factory=list)
    marks: list = dataclasses.field(default_factory=list)
    window: tuple = None  # (start_us, end_us) of WINDOW, host profile

    def busy_intervals(self, lo=float("-inf"), hi=float("inf")):
        """The union of the device's operations between ``lo`` and ``hi``,
        as sorted disjoint intervals."""
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device
                       if e > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernels(self):
        """The device operations that are kernels (not copies or fills)."""
        return [d for d in self.device
                if not d[0].startswith(("Memcpy", "Memset"))]

    def top_device_ops(self, k=10):
        total = collections.Counter()
        for name, s, e in self.device:
            total[short_name(name)] += (e - s) / 1e6
        return [[n, t] for n, t in total.most_common(k)]

    def idle_gaps(self, k=10):
        """The ``k`` longest idle stretches of the window (host profile),
        each named by the benchmark's innermost span and the innermost
        host operation running at its middle."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals(lo, hi)
                        for x in iv] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)), reverse=True)[:k]
        out = []
        for length, s, e in gaps:
            mid = (s + e) / 2
            mark = _innermost(self.marks, mid) or "outside the spans"
            op = _innermost(self.host, mid) or "no host op"
            out.append([f"{mark} / {short_name(op)}", length / 1e6])
        return out


def _innermost(events, t):
    best = None
    for name, s, e in events:
        if s <= t <= e and (best is None or s >= best[1]):
            best = (name, s)
    return best[0] if best else None


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    argument list, cut to ``width`` characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:width].strip()


def _events(prof):
    from torch.autograd import DeviceType

    events = prof.events()
    notes = {e.name for e in events
             if getattr(e, "is_user_annotation", False)}
    for e in events:
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        yield e, item, e.device_type == DeviceType.CUDA, e.name in notes


def device_trace(prof, window_s) -> Trace:
    """The Trace of a device profile."""
    return Trace([item for _, item, dev, note in _events(prof)
                  if dev and not note], window_s)


def host_trace(prof, mark_names) -> Trace:
    """The Trace of a host profile; ``mark_names`` are the benchmark's
    span names."""
    device, host, marks, window = [], [], [], None
    for e, item, dev, note in _events(prof):
        if dev:
            if not note:
                device.append(item)
        elif note:
            if e.name == WINDOW:
                window = item[1:]
            elif e.name in mark_names:
                marks.append(item)
        else:
            host.append(item)
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW} annotation")
    return Trace(device, (window[1] - window[0]) / 1e6, host, marks, window)
