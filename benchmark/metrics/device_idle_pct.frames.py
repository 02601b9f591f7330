"""The device's idle share of the traced window of frames, in %."""

from benchmark.metrics._idle import idle_pct


def read(r):
    return idle_pct(r, "frames")
