"""The host's time a frame in the wavefront integrator outside the BVH
traversal's wrapper (the bounces' torch operations: the hit search's other
primitives, the re-shade, the BSDF, NEE, roulette): the program's
``wavefront.trace`` spans less their ``traversal.*`` children, summed over
a frame's spans and averaged over the frames, in ms."""

from benchmark.metrics._program import frame_spans, ms


def read(r):
    traces = frame_spans(r, "wavefront.trace")
    if not traces:
        return None
    own = sum(ms(s) - sum(ms(c) for c in children
                          if c.name.startswith("traversal."))
              for s, children in traces)
    return own / len({s.frame for s, _ in traces})
