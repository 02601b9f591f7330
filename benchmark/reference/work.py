"""Least times of the megakernels on an H100, counted from a cell's inputs
and the work that the reference's paths did: the larger of the FP32
operations over the card's FP32 peak and the bytes over its memory rate.

The operation counts per test were counted by hand from the kernels'
source when they were written (each add, multiply, division, square
root, min, max and compare one operation; integer work such as the PCG
stream and indexing is not counted), so a bound is a lower bound.  They
are frozen here: a later kernel that does the same work is held to the
same bound, however it does it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at 700 W: FP32 outside the tensor cores,
# and HBM bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

RAY_FLOPS = 6          # a = d . d and 1 / a, per lane-bounce
RAY_LEN_FLOPS = 2      # the ray's length, per lane-bounce with volumes
SPHERE_PASS_FLOPS = 2  # with volumes, per sphere: its draw, the type test
SPHERE_FLOPS = 29      # a solid sphere: roots, root choice, running best
QUAD_CULL_FLOPS = 7    # every quad: n . d, back-face and parallel tests
QUAD_FLOPS = 51        # a quad the ray faces: t, alpha, beta, compares
MT_PRE_FLOPS = 45      # a triangle (Moller-Trumbore with its edges ready)
SPAN_FLOPS = 29        # a fog sphere: roots and its span
FLIGHT_FLOPS = 7       # a span before the closest hit: length, log, test
EVENT_FLOPS = 3        # a flight that ends inside: t and the running best
SHADE_FLOPS = 200      # hit point, normal, BSDF sample, roulette (about)
NEE_FLOPS = 120        # light sample, both pdfs, MIS (about)
BWD_FLOPS_FACTOR = 3   # the backward replays a bounce and runs its adjoint
SPH_COLS, QUAD_COLS, TRI_COLS, LIGHT_COLS, CAM_FLOATS = 17, 29, 31, 9, 16


def bound_ms(flops: float, nbytes: float):
    """The least time in ms, and which of the two bounds it."""
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def megakernel_bound(work: dict, counts: dict, n_pixels: int, nee: bool,
                     backward: bool):
    """Bound of one launch over ``n_pixels`` pixels.

    ``work``: one launch's ``lanes``, ``facing_quads``, ``spans`` and
    ``events`` (``integrator``'s counters); ``counts``: the scene's
    ``spheres``, ``fog_spheres`` (0 without volumes), ``quads``,
    ``triangles`` and ``has_light``.  The bytes are the state, pixel
    coordinates and radiance of each pixel and the packed tables (for the
    backward also the radiance's cotangent in and the tables' gradients
    out)."""
    volumes = counts["fog_spheres"] > 0
    n_sph, n_vol = counts["spheres"], counts["fog_spheres"]
    per_bounce = (RAY_FLOPS
                  + ((RAY_LEN_FLOPS + n_sph * SPHERE_PASS_FLOPS
                      + n_vol * SPAN_FLOPS) if volumes else 0)
                  + (n_sph - n_vol) * SPHERE_FLOPS
                  + counts["quads"] * QUAD_CULL_FLOPS
                  + counts["triangles"] * MT_PRE_FLOPS
                  + SHADE_FLOPS
                  + (NEE_FLOPS if nee and counts["has_light"] else 0))
    flops = (work["lanes"] * per_bounce + work["facing_quads"] * QUAD_FLOPS
             + ((work["spans"] * FLIGHT_FLOPS + work["events"] * EVENT_FLOPS)
                if volumes else 0))
    table_bytes = 4 * (n_sph * SPH_COLS + counts["quads"] * QUAD_COLS
                       + counts["triangles"] * TRI_COLS + LIGHT_COLS
                       + CAM_FLOATS)
    nbytes = n_pixels * (3 * 4 + 3 * 4) + table_bytes
    if backward:
        flops *= BWD_FLOPS_FACTOR
        nbytes += n_pixels * 3 * 4 + table_bytes
    ms, by = bound_ms(flops, nbytes)
    return {"bound_ms": ms, "bound_by": by, "flops": flops, "bytes": nbytes}


def scene_counts(scene) -> dict:
    """The counts ``megakernel_bound`` reads, of a reference scene."""
    from .scene import ISOTROPIC

    mats, sph = scene.materials, scene.spheres
    fog = (int((mats["mtype"][sph["material_id"]] == ISOTROPIC).sum())
           if scene.has_volumes else 0)
    return {"spheres": int(sph["center"].shape[0]), "fog_spheres": fog,
            "quads": int(scene.quads["q"].shape[0]),
            "triangles": int(scene.triangles["a"].shape[0]),
            "has_light": scene.light_index >= 0}
