"""The times a frame the program makes the host wait for the device (its
``host_syncs`` counter over its ``frames``)."""

from benchmark.metrics._program import per_frame


def read(r):
    return per_frame(r, "host_syncs")
