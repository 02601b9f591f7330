"""The backward megakernel's share of its roofline in a train step: its
least time over the device time a step of the backward kernel and the
fold of its block rows."""

from benchmark.metrics._roofline import share


def read(r):
    return share(r, "train", "megakernel_bwd", ("megakernel_bwd",))
