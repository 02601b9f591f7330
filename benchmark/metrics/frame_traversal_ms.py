"""The host's time a frame in the BVH traversal's wrapper (packing the
walk's tables and enqueueing the walk, every bounce): the program's
``traversal.pack`` and ``traversal.launch`` spans inside its
``wavefront.trace``, summed over a frame and averaged over the frames, in
ms."""

from benchmark.metrics._program import frame_spans, ms

WALK = ("traversal.pack", "traversal.launch")


def read(r):
    traces = frame_spans(r, "wavefront.trace")
    walks = [[ms(c) for c in children if c.name in WALK]
             for _, children in traces or []]
    if not any(walks):
        return None
    return sum(map(sum, walks)) / len({s.frame for s, _ in traces})
