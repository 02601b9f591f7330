"""The host's time a frame in the megakernel wrapper (packing the tables,
preparing the buffers, launching): the mean a frame of the program's
``megakernel.*`` spans inside its ``renderer.step``, in ms."""

from benchmark.metrics._program import frame_spans, ms


def read(r):
    steps = frame_spans(r, "renderer.step")
    wrapper = [[ms(c) for c in children
                if c.name.startswith("megakernel.")]
               for _, children in steps or []]
    if not any(wrapper):
        return None
    return sum(map(sum, wrapper)) / len(wrapper)
