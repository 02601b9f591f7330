"""The host's wait a frame in the display's copy of the 8-bit image, which
waits for the frame on the device: the mean a frame of the program's
``renderer.display.copy`` span, in ms."""

from benchmark.metrics._program import frame_spans, ms


def read(r):
    shows = frame_spans(r, "renderer.display")
    copies = [[ms(c) for c in children
               if c.name == "renderer.display.copy"]
              for _, children in shows or []]
    if not any(copies):
        return None
    return sum(map(sum, copies)) / len(copies)
