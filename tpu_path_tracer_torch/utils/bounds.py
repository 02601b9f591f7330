"""Least times of the port's kernels on an H100, counted from their inputs
and from the work the paths actually did.

A bound is the larger of two times: the FP32 operations of the work over
the card's FP32 peak, and its bytes (inputs read once, outputs written
once) over the memory rate.  ``python3 chip_smoke.py`` holds every kernel
to these bounds and ``python -m tpu_path_tracer_torch bench`` (``sol``)
divides them by measured times, so both read one count.  The JAX
package's ``utils.profiling.cost_summary`` reads XLA's cost model and has
no counterpart here.
"""

from __future__ import annotations

import collections
import contextlib

import torch

# The card's peaks (NVIDIA's H100 SXM data sheet, at 700 W): FP32
# outside the tensor cores and HBM bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# FP32 operations per test, counted by hand in csrc/tracer.cuh and
# csrc/traversal.cu, each add, multiply, division, square root, min, max
# and compare one operation; integer work (the PCG stream, indexing) is not
# counted, so the bounds are lower bounds.
ROW_FLOPS = 63       # a node row: two box_enter (12 for t0/t1, 6 NaN
#                      checks, 11 min/max, 2 compares) and the order compare
PACK_TRI_FLOPS = 15  # triangle_edges: ab, ac (6), ab x ac (9)
# pair.cuh edge_test: every test its 3 x 11 edge volumes and 6 sign
# compares; only a test whose three volumes share a strict sign goes on to
# tn 6, den 2, 1/den, t, 3 s_k/den, |den| and 6 compares 7.
EDGE_SIGN_FLOPS = 39
EDGE_REST_FLOPS = 20
PAIR_SLAB_FLOPS = 25  # chunk_slab_hit: 12 for t0/t1, 10 min/max, 3 compares
PAIR_INV_FLOPS = 12   # pair_inv_dir, once per pair-bin row
# The megakernels' hit search (tracer.cuh find_hit).  A block derives each
# triangle's edges and normal, each sphere's R * R and the light's plane
# once (prepare_scene), and a ray its a = d . d and 1 / a once per bounce,
# so no test counts them again.  Quads and volume spheres count only what
# their early outs leave, on the rays of the run (megakernel_bound).
RAY_FLOPS = 6        # a = d . d and 1 / a, per lane-bounce
RAY_LEN_FLOPS = 2    # the ray's length, per lane-bounce with volumes
SPHERE_PASS_FLOPS = 2  # with volumes, per sphere: its draw scaled to
#                        [0, 1), the ISOTROPIC compare of the two passes
SPHERE_FLOPS = 29    # a solid sphere: roots 23, root choice, running best
QUAD_CULL_FLOPS = 7  # every quad: n . d, the back-face and parallel compares
QUAD_FLOPS = 51      # a quad the ray faces: t, alpha, beta, compares
MT_PRE_FLOPS = 45    # triangle_mt_pre and the running-best compare (also
#                      the traversal's triangle test)
SPAN_FLOPS = 29      # an ISOTROPIC sphere: roots 23, its span's 6
FLIGHT_FLOPS = 7     # a span before the closest hit: length, log, compare
EVENT_FLOPS = 3      # a flight that ends inside: t and the running best
SHADE_FLOPS = 200    # hit point, normal, BSDF sample, roulette (about)
NEE_FLOPS = 120      # light sample, light and lambertian pdfs, MIS (about)
# The backward kernel replays each bounce's forward and runs its adjoint,
# counted as twice the forward's operations.
BWD_FLOPS_FACTOR = 3


def bound(flops, nbytes):
    """The least time (ms) of the work on the card and what bounds it."""
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


@contextlib.contextmanager
def counted_work(work, scene):
    """Count, over every bounce of the wavefront, its live lanes, the
    (lane, quad) pairs whose quad faces the ray, the (lane, ISOTROPIC
    sphere) pairs whose span lies before the closest solid hit, and those
    whose free flight ends inside it: the work the megakernels' early outs
    leave on these paths.  The kernel also clips a span by an earlier
    sphere's volume event, so the last two may count a few more."""
    from ..core.config import ISOTROPIC
    from ..integrator import path_tracer
    from ..kernels import intersect

    find, volume_t = path_tracer.find_hit, intersect.volume_t
    mats = scene.materials
    iso = mats.mtype[scene.spheres.material_id] == ISOTROPIC

    def counted(rand_state, ray, scene_, meta, cfg, alive=None):
        live = (torch.ones(ray.origin.shape[0], dtype=torch.bool,
                           device=ray.origin.device)
                if alive is None else alive)
        work["lanes"] += int(live.sum())
        if scene.quads.count:
            den = (scene.quads.normal[None] * ray.dir[:, None]).sum(-1)
            faces = (den <= 0.0) & (den.abs() >= 1e-8) & live[:, None]
            work["facing_quads"] += int(faces.sum())
        return find(rand_state, ray, scene_, meta, cfg, alive=alive)

    def counted_volume_t(o, d, center, radius, nid, u, t_min, t_max):
        span = intersect.volume_interval(o, d, center, radius, t_min,
                                         t_max)[2] & iso
        tv = volume_t(o, d, center, radius, nid, u, t_min, t_max)
        work["spans"] += int(span.sum())
        work["events"] += int(((tv < intersect.INF) & iso).sum())
        return tv

    path_tracer.find_hit, intersect.volume_t = counted, counted_volume_t
    try:
        yield
    finally:
        path_tracer.find_hit, intersect.volume_t = find, volume_t


@contextlib.contextmanager
def counted_walks(work, scene):
    """Count the node rows fetched and the triangle tests of every BVH walk
    of the wavefront (``traversal.closest_hit``), by the kernel's own walk
    on the host (:func:`counted_walk`) over the rows the card packs: the
    work of the forward megakernel's BVH variant, whose hit search makes
    the same walks.  On CPU tensors the walk's host build counts
    (``_build.load_host_walk``)."""
    from ..kernels import _build, traversal

    closest_hit = traversal.closest_hit
    rows, tri_rows = traversal.pack_bvh(scene.bvh, scene.triangles)
    lib = (_build.load_host_walk() if rows.device.type == "cpu" else None)

    def counted(origin, direction, bvh, tris, t_min, t_best0):
        _, _, n_rows, n_tests = counted_walk(rows, tri_rows, origin,
                                             direction, t_best0, t_min, lib)
        work["rows"] += n_rows
        work["tri_tests"] += n_tests
        return closest_hit(origin, direction, bvh, tris, t_min, t_best0)

    traversal.closest_hit = counted
    try:
        yield rows.shape[0]
    finally:
        traversal.closest_hit = closest_hit


def megakernel_bound(scene, meta, cfg, eye, backward):
    """Bound of one megakernel launch (``backward``: of the backward) on
    these inputs: the FP32 operations of the bounces the paths took, from
    the plain wavefront at frame 1, and the bytes of the state, pixels,
    tables and radiance (for the backward also the cotangent in and the
    table gradients out).  Where the forward walks the scene's BVH, its
    triangle tests are the walks' (:func:`counted_walks`) and the BVH's
    node and triangle rows are read once too."""
    from ..core import rng
    from ..core.camera import Camera
    from ..core.config import ISOTROPIC
    from ..integrator.render import pixel_grid
    from ..kernels import megakernel as mk

    device = scene.quads.q.device
    work = collections.Counter()
    pix, px, py = pixel_grid(cfg.width, cfg.height, device)
    view = torch.as_tensor(Camera(eye=eye, center=[0, 0, 0]).view_matrix,
                           device=device)
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.no_grad())
        walks = mk.route(scene, meta, cfg, view, device,
                         required=True).tracer == mk.BVH
        stack.enter_context(counted_work(work, scene))
        n_rows = (stack.enter_context(counted_walks(work, scene)) if walks
                  else 0)
        mk.path_trace_pixels_reference(rng.seed(pix, 1), view, px, py,
                                       scene, meta, cfg)
    n_sph = scene.spheres.count
    n_vol = (int((scene.materials.mtype[scene.spheres.material_id]
                  == ISOTROPIC).sum()) if meta.has_volumes else 0)
    per_bounce = (RAY_FLOPS
                  + ((RAY_LEN_FLOPS + n_sph * SPHERE_PASS_FLOPS
                      + n_vol * SPAN_FLOPS) if meta.has_volumes else 0)
                  + (n_sph - n_vol) * SPHERE_FLOPS
                  + scene.quads.count * QUAD_CULL_FLOPS
                  + (0 if walks else scene.triangles.count * MT_PRE_FLOPS)
                  + SHADE_FLOPS
                  + (NEE_FLOPS if cfg.importance_sampling and meta.has_light
                     else 0))
    flops = (work["lanes"] * per_bounce + work["facing_quads"] * QUAD_FLOPS
             + ((work["spans"] * FLIGHT_FLOPS + work["events"] * EVENT_FLOPS)
                if meta.has_volumes else 0)
             + work["rows"] * ROW_FLOPS + work["tri_tests"] * MT_PRE_FLOPS)
    table_bytes = (4 * sum(t.numel() for t in mk.pack_tables(scene)) + 64
                   + n_rows * 64 + (scene.triangles.count * 48 if walks
                                    else 0))
    nbytes = px.shape[0] * (3 * 4 + 3 * 4) + table_bytes
    if backward:
        flops *= BWD_FLOPS_FACTOR
        nbytes += px.shape[0] * 3 * 4 + table_bytes
    ms, by = bound(flops, nbytes)
    return {"bound_ms": ms, "bound_by": by, "lane_bounces": work["lanes"],
            "facing_quads": work["facing_quads"], "spans": work["spans"],
            "events": work["events"], "walk_rows": work["rows"],
            "walk_tri_tests": work["tri_tests"], "flops": flops,
            "bytes": nbytes}


def traversal_bound(n_rays, n_rows, n_tris, work):
    """FP32 operations of the walks these rays took (counted by the
    kernel's own walk on the host, ``counted_walk``) and the bytes of rays
    in, results out, and the node and triangle rows read once."""
    flops = (work["rows"] * ROW_FLOPS + work["tri_tests"] * MT_PRE_FLOPS
             + 3 * n_rays)
    nbytes = n_rays * (7 * 4 + 2 * 4) + n_rows * 64 + n_tris * 48
    ms, by = bound(flops, nbytes)
    return {"bound_ms": ms, "bound_by": by, "flops": flops, "bytes": nbytes}


def pack_bound(n_nodes, n_rows, n_tris):
    """The packing's bytes (the BVH's bounds and five int64 fields, the
    corners in; node and triangle rows out) and operations."""
    ms, by = bound(n_tris * PACK_TRI_FLOPS,
                   n_nodes * 64 + n_tris * 36 + n_rows * 64 + n_tris * 48)
    return {"bound_ms": ms, "bound_by": by}


def counted_walk(rows, tri_rows, o, d, t0, t_min, lib=None):
    """The kernel's walk run on the host (``csrc/traversal.cu``
    ``tpt_bvh_walk_host``, the same __host__ __device__ code with a work
    counter) over the tables the card packed: (t, index, node rows
    fetched, triangle tests).  ``lib``: the library that holds it, by
    default the nvcc build (``kernels._build.load``); where there is no
    nvcc, ``_build.load_host_walk()``."""
    import ctypes

    from ..kernels import _build
    from ..kernels.intersect import INF

    fn = (lib or _build.load()).tpt_bvh_walk_host
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 5 + [i, f, f, p, p, p]
    fn.restype = None
    rows, tri_rows, o, d, t0 = (x.detach().cpu().contiguous()
                                for x in (rows, tri_rows, o, d, t0))
    n = o.shape[0]
    t = torch.empty(n)
    idx = torch.empty(n, dtype=torch.int32)
    work = torch.zeros(2, dtype=torch.int64)
    fn(o.data_ptr(), d.data_ptr(), t0.data_ptr(), rows.data_ptr(),
       tri_rows.data_ptr(), n, t_min, INF, t.data_ptr(), idx.data_ptr(),
       work.data_ptr())
    return t.numpy(), idx.numpy(), int(work[0]), int(work[1])
