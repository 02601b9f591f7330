"""The host's time a frame in the renderer outside the integrator on the
mesh route (the pixel grid, the PCG seeds, the view, the film): the mean a
frame of the program's ``renderer.step`` span less its ``wavefront.trace``
and ``megakernel.*`` children, over the steps that hold a
``wavefront.trace``, in ms.  Nothing where no step holds one (the
megakernel's route, or a program without that span)."""

from benchmark.metrics._program import frame_spans, ms


def _integrator(span):
    return span.name == "wavefront.trace" or span.name.startswith(
        "megakernel.")


def read(r):
    own = [ms(s) - sum(ms(c) for c in children if _integrator(c))
           for s, children in frame_spans(r, "renderer.step") or []
           if any(c.name == "wavefront.trace" for c in children)]
    if not own:
        return None
    return sum(own) / len(own)
