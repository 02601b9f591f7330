"""The forward megakernel's share of its roofline in a frame: its least
time over its device time a frame."""

from benchmark.metrics._roofline import share


def read(r):
    return share(r, "frames", "megakernel_fwd", ("megakernel_fwd",))
