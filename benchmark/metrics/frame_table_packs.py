"""The megakernel's scene tables packed a frame (the program's
``table_packs`` counter over its ``frames``)."""

from benchmark.metrics._program import per_frame


def read(r):
    return per_frame(r, "table_packs")
