"""The program's own record of a traced run: the spans and counters of
``tpu_path_tracer_torch.utils.profiling``, in this process.

The record's spans start with the first profiled window, the device
profile of ``r.units`` frames, where the host runs closest to its untraced
speed; a span reader takes the first ``r.units`` spans of a name and the
spans nested directly in them.  A counter reader divides a counter by the
frames the whole process stepped.  A program without such a record gives
nothing to read, and its readers return None.
"""

import importlib


def _record(what):
    profiling = importlib.import_module(
        "tpu_path_tracer_torch.utils.profiling")
    read = getattr(profiling, what, None)
    return read() if read is not None else None


def ms(span):
    return (span.end_ns - span.start_ns) / 1e6


def frame_spans(r, name):
    """[(span, its children)] of the first ``r.units`` spans called
    ``name`` in a traced run of frames; None where there are none."""
    spans = _record("spans") if r.kind == "frames" else None
    if not spans:
        return None
    tops = [i for i, s in enumerate(spans) if s.name == name][:r.units]
    if not tops:
        return None
    children = {i: [] for i in tops}
    for s in spans:
        if s.parent in children:
            children[s.parent].append(s)
    return [(spans[i], children[i]) for i in tops]


def per_frame(r, counter):
    """``counter`` over the frames the process stepped; None before any."""
    counts = _record("counts") if r.kind == "frames" else None
    if not counts or not counts["frames"]:
        return None
    return counts[counter] / counts["frames"]
