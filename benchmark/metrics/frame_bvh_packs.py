"""The BVH walk's tables packed a frame (the program's ``bvh_pack``
counter, one a launch of the packing kernel, over its ``frames``); None
where the program never packed them."""

from benchmark.metrics._program import _record, per_frame


def read(r):
    counts = _record("counts") if r.kind == "frames" else None
    if not counts or "bvh_pack" not in counts:
        return None
    return per_frame(r, "bvh_pack")
