"""The host's time in ``Renderer.step`` a frame (its enqueue, before the
display's copy waits for the device): the mean of the benchmark's span
around the call, in ms."""


def read(r):
    d = r.spans.get("frames.step")
    return 1e3 * sum(d) / len(d) if d else None
