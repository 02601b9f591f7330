"""Least time of a whole progressive frame of a mesh scene on an H100,
counted from the work that the reference's paths did, whatever kernels do
it: the larger of the FP32 operations over the card's FP32 peak and the
bytes over its memory rate (``work.py``'s peaks and ``bound_ms``).

Operations: every lane-bounce's shading (hit point, normal, BSDF sample,
roulette) and, with NEE and a light, its light sample and MIS, at
``work.py``'s counts.  The triangle tests are left out: how many a ray
makes depends on the acceleration structure, and a bound that did not
would move with it.  Bytes: only what every route moves to the card's
memory and back.  The scene's triangles, three float32 corners each, are
read once a frame; the framebuffer is read and written once; the 8-bit
image is written once.  A route that keeps rays and hits on chip (a
fused kernel in place of the wavefront and the BVH walk) moves no more
than this; a BVH walk may skip triangles its rays never near, so the
scene read whole is the one term that can count above a route's least.
The arithmetic is frozen here, and every route of the same frame is held
to the same number.
"""

from __future__ import annotations

from .work import NEE_FLOPS, SHADE_FLOPS, bound_ms

CORNER_BYTES = 3 * 3 * 4     # a triangle's three float32 corners
PIXEL_BYTES = 2 * 3 * 4 + 3  # framebuffer in and out; the 8-bit image


def frame_bound(work: dict, triangles: int, n_pixels: int, nee: bool,
                has_light: bool):
    """Bound of one frame over ``n_pixels`` pixels of a scene of
    ``triangles`` triangles; ``work``: one frame's ``lanes``
    (``integrator_mesh``'s counter of lane-bounces)."""
    per_lane = SHADE_FLOPS + (NEE_FLOPS if nee and has_light else 0)
    flops = work["lanes"] * per_lane
    nbytes = triangles * CORNER_BYTES + n_pixels * PIXEL_BYTES
    ms, by = bound_ms(flops, nbytes)
    return {"bound_ms": ms, "bound_by": by, "flops": flops, "bytes": nbytes}
