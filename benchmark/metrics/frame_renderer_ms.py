"""The host's time a frame in the renderer outside the megakernel wrapper
(the pixel grid, the PCG seeds, the view, the film): the mean a frame of
the program's ``renderer.step`` span less its ``megakernel.*`` children,
in ms."""

from benchmark.metrics._program import frame_spans, ms


def read(r):
    steps = frame_spans(r, "renderer.step")
    if not steps:
        return None
    own = [ms(s) - sum(ms(c) for c in children
                       if c.name.startswith("megakernel."))
           for s, children in steps]
    return sum(own) / len(own)
