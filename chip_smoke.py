#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``tpu_path_tracer_torch``) on one
GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

1. device: CUDA must be available; prints the toolkit and the card's name
   and power limit as nvidia-smi reports them;
2. build: compiles the CUDA sources with nvcc into
   ``tpu_path_tracer_torch/_build/`` and prints the seconds it took;
3. the megakernel against its plain version (the port's wavefront) on the
   card, from the same PCG states, at 64x64 and at the main path's
   512x512;
4. the megakernel's progressive render against the JAX package's committed
   goldens (``tests/goldens``), read as numpy arrays;
5. the main path: ``Renderer.render_animation(16)`` of the reference scene
   at 512x512 through the megakernel, with its launch count;
6. frame times of the kernel and of the plain version at 512x512, and a
   torch.profiler breakdown of the main path's device time;
7. grad_vs_plain: the CUDA backward kernel against autograd of the
   wavefront on the card, from the same PCG states, at parameter level
   (``diff.params``): Cornell NEE at 64x64 with 4 and 6 bounces, the
   reference scene with every geometry group and the view matrix, a
   stratified spp 4 case, the 4-triangle tent, and the training path's own
   512x512 shapes; then the unroll-budget error on the card;
8. train: the training path, ``dist.render_dist.make_train_step`` at
   512x512 on the Cornell box (NEE, emission and BSDF parameters, through
   the kernels) for 10 steps, as ``cli train`` sets it up, with the launch
   counts of both kernels;
9. train timing: fwd+bwd+Adam step times through the kernels and through
   the wavefront, in turns, the backward alone of each, and the backward
   kernel's device time from torch.profiler;
10. traversal_vs_plain: the CUDA traversal kernel against its plain
    version (the skip-link walk) on the card, from the same 65,536 rays,
    at 81,920 and 327,680 triangles (median BVH), with the walk's node
    visits and triangle tests, the kernel's and the packing's device time
    and the walk's time;
11. mesh_main_path: the mesh path, ``Renderer.render_animation(8)`` of
    bench.py's 81,920-triangle mirror icosphere at 512x512 (4 bounces,
    NEE) with the traversal kernel's launch count, then one frame through
    the kernel and through the plain walk from the same PCG states;
12. mesh_timing: frame times through the kernel and the plain walk at
    512x512, through the kernel at 1024x1024 with 327,680 triangles, and
    a torch.profiler breakdown of a mesh frame;
13. mesh_train: 3 steps of ``make_train_step`` on the mesh scene at
    512x512 over emission and vertices (the BVH refit runs every step);
14. mesh_cli: ``python -m tpu_path_tracer_torch render`` of an OBJ written
    by ``save_obj``, through a median BVH, on the card;
15. pair_vs_plain: the two pair-sweep kernels against their plain versions
    on the card, on the pair arrays of a real emission of phase 10's 65,536
    rays at 81,920 and 327,680 triangles; then each entry point
    (``pairbin_closest_hit``, ``pair_closest_hit``) against the BVH
    kernel's answer (hit mask on every live lane, t on every lane whose
    edge-function sums are well conditioned, the others explained in
    float64), with rays, pairs and segments per launch, kernel, emission
    and call times, and the BVH kernel's time beside them;
16. pair_main_path: the mesh path of phase 11 with
    ``traversal.PAIR_DISPATCH`` set to ``"pairbin"`` and to ``"pair"``:
    launch counts of all three traversal kernels, every launch of one
    frame against the plain version on the launch's own arguments, what
    each of them served and its bound, one frame through each route
    against the BVH-kernel frame from the same PCG states, and frame times
    of the three routes;
17. user_layer: the renderer's perf log and FPS cap on the card, a
    checkpoint at frame k resumed in a new ``Renderer`` against an
    uninterrupted render, and ``render --checkpoint`` then ``--resume`` in
    subprocesses against the same frames in one go.

Bounds: each kernel's least time on the card, the larger of its FP32
operations over the card's FP32 peak and its bytes (inputs read once,
outputs written once) over the memory rate, counted from this run's inputs
and what the paths actually did.

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  In it the forward megakernel's
``ms`` is the time of a whole 512x512 frame through the kernel (phase 6:
packing, seeding, the kernel and accumulation) and its ``device_ms`` the
kernel's own device time per frame (phase 6's profile); the backward's
``ms`` is a train step's backward and its ``device_ms`` the kernel's own
(phase 9).  Both megakernel rows also carry what ptxas reported at the
build (``registers``, ``spill_bytes``, static ``smem_bytes``,
``stack_bytes``).  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
KERNEL_SOURCE = "tpu_path_tracer_torch/csrc/megakernel_fwd.cu"
KERNEL_REPLACES = "tpu_path_tracer/kernels/pallas/megakernel.py:765"
BWD_SOURCE = "tpu_path_tracer_torch/csrc/megakernel_bwd.cu"
BWD_REPLACES = "tpu_path_tracer/kernels/pallas/megakernel.py:804"
TRAV_SOURCE = "tpu_path_tracer_torch/csrc/traversal.cu"
TRAV_REPLACES = ("tpu_path_tracer/kernels/pallas/traversal.py:752, "
                 "tpu_path_tracer/kernels/pallas/traversal.py:865")
PAIR_SOURCE = "tpu_path_tracer_torch/csrc/pair_sweep.cu"
PAIRBIN_REPLACES = "tpu_path_tracer/kernels/pallas/traversal.py:1417"
PAIR_REPLACES = "tpu_path_tracer/kernels/pallas/traversal.py:1723"

# Phase 3: per-pixel tolerance of the JAX package's own kernel parity tests
# (tests/test_pallas.py:52).  The kernel and the wavefront evaluate sinf,
# cosf and logf with different implementations (CUDA's libdevice inside
# the kernel, torch's kernels outside), which differ in the last ulp; a
# glass, fog or roulette decision taken right at its threshold can flip,
# and that one path then differs completely.  Those rare flips are the
# expected outliers, hence a share of pixels and not every pixel.
KERNEL_TOL = 2e-4
KERNEL_MIN_SHARE = 0.99
KERNEL_MEAN_RTOL = 1e-3
# Phase 4: per-pixel tolerance of tests/test_golden.py:104.  The goldens
# were rendered by JAX under XLA's CPU compiler, which contracts a*b+c into
# fused multiply-adds; the port rounds every operation on its own (the
# kernel is built with --fmad=false).  That moves the self-intersection of
# a ray leaving a sphere's surface (the discriminant's cancellation near
# t_min), so paths off the spheres differ.
# tests/test_torch_render.py::test_golden_gap_is_xla_contraction shows it
# on the CPU: at the golden settings the port equals JAX run op by op on
# every pixel, and jitted JAX leaves both on the same pixels.  The port
# meets the goldens on 95.7% of pixels, with the Cornell box mean 1.07%
# apart.  Hence a share of pixels and a mean tolerance, not test_golden's
# every-pixel check; the CPU test holds the same bounds.
GOLDEN_RTOL, GOLDEN_ATOL = 1e-3, 5e-3
GOLDEN_MIN_SHARE = 0.95
GOLDEN_MEAN_RTOL = 0.015
# Phase 7: tests/test_pallas.py:160-167, the JAX package's kernel gradient
# tolerance: every gradient within 2e-3 of its group's largest.  The
# backward sums table gradients with atomics, in an order that changes
# from run to run, and the wavefront's autograd sums in another order.
GRAD_RTOL = 2e-3
GRAD_ATOL = 1e-6      # floor of a group's scale (test_pallas.py:160)
GRAD_LOSS_RTOL = 1e-5
# The training path (phases 8-9): the JAX package's headline training step
# (bench.py:146), Cornell box, 512x512, 4 bounces, NEE on.
TRAIN_KW = dict(width=512, height=512, max_bounces=4,
                importance_sampling=True)
TRAIN_GROUPS = ("emission", "bsdf")
# The mesh path (phases 10-14): bench.py:301's mesh_bvh workload, an
# icosphere of 20 * 4**6 = 81,920 triangles behind a median BVH, and
# bench.py:568's 327,680 (subdivision 7) for the larger table.
MESH_SUBDIVISIONS = (6, 7)
MESH_KW = dict(width=512, height=512, max_bounces=4, importance_sampling=True)
MESH_EYE = [0.0, 0.0, 3.2]
MESH_GROUPS = ("emission", "vertices")   # bench.py:177
TRAV_RAYS = 65536
# Traversal contract (tests/test_pallas.py:284-289): the same hit mask and
# triangle index on every lane, t within 1e-5.
TRAV_T_TOL = 1e-5
# The pair sweeps (phases 15-16).  Kernel against plain version: the same
# arithmetic in the same order, so the same index on every row and t within
# 1e-5 (equal bits expected).  Entry point against the BVH kernel: the same
# hit mask on every live lane, and the tolerance of
# tests/test_pallas.py:391-393, t within rtol 1e-3 / atol 1e-4 on lanes
# both hit.  The JAX tests hold every lane to it at 20,480 triangles and
# 2,048 rays; at this phase's sizes not every lane can meet it.  The
# edge-function form computes n . d as the sum of three edge volumes
# d . (p x q) + (o x d) . (q - p), whose products are of size |p| |q| and
# |o| |q - p| while their sum is |n| cos: in float32 the sum keeps few
# digits when the triangle is small, the origin far or the ray grazing.
# The walk's Möller-Trumbore works relative to a corner and does not
# cancel.  Phase 15 shows this lane by lane: the same formula evaluated in
# float64 meets the walk's t.  So a lane is held to the tolerance unless
# the rounding its sums can carry (2^-24 x condition number x t) exceeds
# PAIR_ROUNDING_MAX times the tolerance (measured: the median error is
# about 0.1 of that estimate, the largest 1.3 times it); at least
# PAIR_HELD_MIN_SHARE of the hit lanes must be held (measured: 98% at
# 81,920 triangles, 74% at 327,680), and
# every lane beyond the tolerance must be explained.  A hit on a shared
# edge may go to either neighbour, or through to the next surface, in
# either test (neither is watertight; the edge-function test also rejects
# barycentrics below t_min), so lanes that name another triangle than the
# walk are counted apart, at most PAIR_OTHER_TRIANGLE_MAX_SHARE of the hit
# lanes (measured: 7e-5 to 9e-4).  find_hit uses the
# sweeps' t only to order primitive families, and shade_hit recomputes it
# from the winning triangle.
PAIR_T_TOL = 1e-5
PAIR_WALK_RTOL, PAIR_WALK_ATOL = 1e-3, 1e-4
PAIR_ROUNDING_MAX = 2.0
PAIR_HELD_MIN_SHARE = 0.7
PAIR_OTHER_TRIANGLE_MAX_SHARE = 2e-3
PAIR_FRAME_MEAN_RTOL = 1e-2
# The card's peaks (NVIDIA's H100 SXM data sheet, at 700 W): FP32
# outside the tensor cores and HBM bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# FP32 operations per test, counted by hand in csrc/tracer.cuh and
# csrc/traversal.cu, each add, multiply, division, square root, min, max
# and compare one operation; integer work (the PCG stream, indexing) is not
# counted, so the bounds are lower bounds.
SLAB_FLOPS = 31      # slab_hit: 12 for t0/t1, 6 NaN checks, 13 min/max/cmp
MT_FLOPS = 64        # triangle_mt from the corners, running-best compare
EDGE_FLOPS = 53      # pair_sweep.cu edge_test: 3 x 11 edge volumes, tn 6,
#                      den 2, 1/den, t, |den| and 5 compares 7, 3 s_k/den
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
MT_PRE_FLOPS = 45    # triangle_mt_pre and the running-best compare
SPAN_FLOPS = 29      # an ISOTROPIC sphere: roots 23, its span's 6
FLIGHT_FLOPS = 7     # a span before the closest hit: length, log, compare
EVENT_FLOPS = 3      # a flight that ends inside: t and the running best
SHADE_FLOPS = 200    # hit point, normal, BSDF sample, roulette (about)
NEE_FLOPS = 120      # light sample, light and lambertian pdfs, MIS (about)
# The backward kernel replays each bounce's forward and runs its adjoint,
# counted as twice the forward's operations.
BWD_FLOPS_FACTOR = 3


class SmokeFailure(Exception):
    pass


def traversal_rays(n, seed, radius, vertices, width=512, eye_z=3.2):
    """The traversal rays for an icosphere of ``radius`` at the origin, as
    float32 numpy arrays (origin [n, 3], direction [n, 3], t_best0 [n]):

    * a third: primary rays of the ``width`` x ``width`` camera at (0, 0,
      eye_z) (60 degree field of view, pixel centres), at random pixels;
    * a third: bounce-like rays leaving the surface (origins at 0.999-1.01
      of the radius) towards random points of the sphere;
    * the rest: scattered origins in [-2, 2]^3;
    * every third lane retired: t_best0 = -INF, as kernels/hit.py seeds it;
    * the last 16 lanes: on the plane axis = v[axis] through a vertex v of
      the mesh (``vertices``), with a +0 or -0 direction component on that
      axis, towards a point near v; the slab test of a box bounded at
      v[axis] computes 0 * inf = NaN.
    """
    import numpy as np

    from tpu_path_tracer_torch.kernels.intersect import INF

    k = np.random.default_rng(seed)
    third = n // 3
    origin = np.zeros((n, 3))
    d = np.zeros((n, 3))
    pix = k.integers(0, width * width, third)
    s = 2.0 * ((pix % width + 0.5) / width) - 1.0
    t = -(2.0 * ((pix // width + 0.5) / width) - 1.0)
    d[:third] = np.stack([s, t, np.full(third, -np.sqrt(3.0))], axis=1)
    origin[:third] = [0.0, 0.0, eye_z]
    surf = k.normal(size=(n, 3))
    surf /= np.linalg.norm(surf, axis=1, keepdims=True)
    origin[third:2 * third] = (surf[third:2 * third] * radius
                               * k.uniform(0.999, 1.01, (third, 1)))
    origin[2 * third:] = k.uniform(-2, 2, (n - 2 * third, 3))
    target = k.uniform(-1, 1, (n, 3)) * radius
    d[third:] = target[third:] - origin[third:]
    for j in range(16):
        lane, axis = n - 16 + j, j % 3
        v = np.asarray(vertices[k.integers(len(vertices))], np.float64)
        centre = np.zeros(3)
        centre[axis] = v[axis]
        origin[lane] = centre
        origin[lane, (axis + 1) % 3] = 2.0 * radius
        d[lane] = v + 0.2 * (centre - v) - origin[lane]
        d[lane, axis] = -0.0 if j % 2 else 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t0 = np.where(np.arange(n) % 3 == 0, -INF, 1e9)
    t0[n - 16:] = 1e9
    return (origin.astype(np.float32), d.astype(np.float32),
            t0.astype(np.float32))


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def run_cmd(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"{' '.join(cmd)} failed: {proc.stderr}")
    return proc.stdout.strip()


def device_phase(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    from tpu_path_tracer_torch.kernels import _build

    nvcc = run_cmd([_build.nvcc_path(), "--version"]).splitlines()[-1]
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    phase("device", torch=torch.__version__, cuda=torch.version.cuda,
          nvcc=nvcc, gpu=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count())
    return smi


def build_phase():
    from tpu_path_tracer_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    seconds = time.perf_counter() - t0
    text = path.with_suffix(".log").read_text()
    log = text.splitlines()
    phase("build", seconds=round(seconds, 3), library=os.path.relpath(
        path, REPO), ptxas=[ln.strip()[-90:] for ln in log
                            if "Used" in ln or "spill" in ln
                            or "entry function" in ln])
    return {name: _build.ptxas_report(text, f"{name}_kernel")
            for name in ("megakernel_fwd", "megakernel_bwd")}


def kernel_vs_plain(torch, pt, device, scene_fn, eye, cfg, frame=3):
    """Megakernel and wavefront radiance from the same PCG states."""
    from tpu_path_tracer_torch.core import rng
    from tpu_path_tracer_torch.integrator.render import pixel_grid
    from tpu_path_tracer_torch.kernels import megakernel as mk

    scene, meta, _ = scene_fn(device=device)
    check(mk.supported(scene, meta, cfg), "megakernel does not support scene")
    view = torch.as_tensor(pt.Camera(eye=eye, center=[0, 0, 0]).view_matrix,
                           device=device)
    pix, px, py = pixel_grid(cfg.width, cfg.height, device)
    state = rng.seed(pix, frame)
    got = mk.path_trace_pixels_megakernel(state, view, px, py, scene, meta,
                                          cfg)
    ref = mk.path_trace_pixels_reference(state, view, px, py, scene, meta,
                                         cfg)
    return got.cpu().numpy(), ref.cpu().numpy()


def compare_phase(torch, pt, device):
    """Kernel against plain version at 64x64, and at the main path's own
    shape (the reference scene at 512x512, 4 bounces, 1 spp)."""
    import numpy as np

    B = pt.builtin
    cases = [
        ("cornell_nee_off", B.cornell_box, [0, 0, 3.2],
         dict(max_bounces=4)),
        ("cornell_nee_on", B.cornell_box, [0, 0, 3.2],
         dict(max_bounces=4, importance_sampling=True)),
        ("reference_full", B.reference_scene, [0.5, 0.0, 2.5],
         dict(max_bounces=4)),
        ("cornell_stratified_spp4", B.cornell_box, [0, 0, 3.2],
         dict(max_bounces=3, samples_per_pixel=4, stratify=True)),
        ("reference_full_512", B.reference_scene, [0.5, 0.0, 2.5],
         dict(width=512, height=512, max_bounces=4)),
    ]
    worst = 0.0
    for name, scene_fn, eye, kw in cases:
        cfg = pt.RenderConfig(**{"width": 64, "height": 64, **kw},
                              use_megakernel=True)
        got, ref = kernel_vs_plain(torch, pt, device, scene_fn, eye, cfg)
        check(got.shape == ref.shape == (cfg.width * cfg.height, 3),
              f"{name}: shape")
        check(np.isfinite(got).all(), f"{name}: non-finite kernel output")
        close = np.isclose(got, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL)
        share = float(close.all(axis=-1).mean())
        err = float(np.abs(got - ref).max())
        worst = max(worst, err)
        mean_ok = np.allclose(got.mean(0), ref.mean(0), rtol=KERNEL_MEAN_RTOL,
                              atol=1e-6)
        phase("kernel_vs_plain", case=name,
              size=f"{cfg.width}x{cfg.height}", max_abs_err=err,
              share_within_tol=share, tol=KERNEL_TOL,
              mean_kernel=got.mean(0).tolist(),
              mean_plain=ref.mean(0).tolist())
        check(share >= KERNEL_MIN_SHARE,
              f"{name}: only {share:.4f} of pixels within {KERNEL_TOL}")
        check(mean_ok, f"{name}: image means differ beyond rtol "
              f"{KERNEL_MEAN_RTOL}")
    return worst


def render_progressive(torch, pt, device, scene, meta, cfg, eye, frames):
    from tpu_path_tracer_torch.integrator.render import render_frame

    view = pt.Camera(eye=eye, center=[0, 0, 0]).view_matrix
    fb = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32,
                     device=device)
    for f in range(1, frames + 1):
        render_frame(fb, f, f == 1, view, scene, meta, cfg)
    return (fb / frames).cpu().numpy().reshape(cfg.height, cfg.width, 3)


def golden_phase(torch, pt, device):
    import numpy as np

    cases = [("cornell_box", pt.builtin.cornell_box, [0, 0, 3.2]),
             ("reference_scene", pt.builtin.reference_scene,
              [0.5, 0.0, 2.5])]
    cfg = pt.RenderConfig(width=64, height=64, max_bounces=6,
                          importance_sampling=False, use_megakernel=True)
    for name, scene_fn, eye in cases:
        golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
        scene, meta, _ = scene_fn(device=device)
        img = render_progressive(torch, pt, device, scene, meta, cfg, eye, 8)
        check(img.shape == golden.shape, f"{name}: shape {img.shape}")
        check(np.isfinite(img).all(), f"{name}: non-finite pixels")
        share = float(np.isclose(img, golden, rtol=GOLDEN_RTOL,
                                 atol=GOLDEN_ATOL).all(axis=-1).mean())
        mean_rel = (np.abs(img.mean((0, 1)) - golden.mean((0, 1)))
                    / np.abs(golden.mean((0, 1))))
        phase("golden", case=name, share_within_tol=share,
              mean=img.mean((0, 1)).tolist(),
              golden_mean=golden.mean((0, 1)).tolist(),
              mean_rel_diff=mean_rel.tolist())
        check(share >= GOLDEN_MIN_SHARE,
              f"{name}: only {share:.4f} of pixels within the golden tol")
        check(float(mean_rel.max()) <= GOLDEN_MEAN_RTOL,
              f"{name}: mean {mean_rel.max():.4f} from the golden's")


def main_path_phase(torch, pt, device, frames=16):
    import numpy as np
    from tpu_path_tracer_torch.kernels import megakernel as mk

    scene, meta, _ = pt.builtin.reference_scene(device=device)
    cfg = pt.RenderConfig(width=512, height=512, max_bounces=4,
                          use_megakernel=True)
    renderer = pt.Renderer(scene, meta, cfg)
    torch.cuda.synchronize()
    mk.LAUNCHES = 0
    t0 = time.perf_counter()
    fb = renderer.render_animation(frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = mk.LAUNCHES
    fb_np = fb.cpu().numpy()
    img = renderer.display()
    png = os.path.join(REPO, "tpu_path_tracer_torch", "_build",
                       "chip_smoke_reference_512.png")
    os.makedirs(os.path.dirname(png), exist_ok=True)
    renderer.save_png(png)
    phase("main_path", frames=frames, launches=launches,
          seconds=round(seconds, 4), fb_mean=fb_np.mean(0).tolist(),
          image_std=float(img.std()), png=os.path.relpath(png, REPO))
    check(fb_np.shape == (512 * 512, 3), "framebuffer shape")
    check(np.isfinite(fb_np).all(), "non-finite framebuffer")
    check(float(img.std()) > 1.0, "the image is flat")
    check(launches == frames,
          f"megakernel launched {launches} times for {frames} frames")
    return launches, seconds * 1e3 / frames


def time_frames(torch, pt, device, scene, meta, cfg, view, frames):
    from tpu_path_tracer_torch.integrator.render import render_frame

    fb = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32,
                     device=device)
    times = []
    for f in range(1, frames + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        render_frame(fb, f, f == 1, view, scene, meta, cfg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def timing_phase(torch, pt, device, smi, warmup=2, frames=10):
    """Median ms/frame of kernel and plain version at 512x512, measured in
    turns (plain, kernel, kernel, plain) on one card."""
    scene, meta, _ = pt.builtin.reference_scene(device=device)
    view = pt.Camera(eye=[0.5, 0.0, 2.5], center=[0, 0, 0]).view_matrix
    base = pt.RenderConfig(width=512, height=512, max_bounces=4)
    cfgs = {"plain": base, "kernel": base.replace(use_megakernel=True)}
    samples = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        t = time_frames(torch, pt, device, scene, meta, cfgs[name], view,
                        warmup + frames)
        samples[name] += t[warmup:]
    rays = base.width * base.height * base.samples_per_pixel
    out = {}
    for name, t in samples.items():
        ms = statistics.median(t)
        out[name] = ms
        phase("timing", version=name, scene="reference_scene",
              size="512x512", max_bounces=base.max_bounces,
              ms_per_frame=ms, mray_per_s=rays / ms / 1e3,
              ms_min=min(t), ms_max=max(t), frames=len(t), card=smi)
    return out


def device_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def kernel_rows(prof):
    """The device kernels of a profile, by name, busiest first.  A CPU op
    that launched a kernel reports the same device time again, and so does
    a user annotation (the optimizer's step), so both are left out."""
    from torch.autograd import DeviceType

    annotations = {e.name for e in prof.events()
                   if getattr(e, "is_user_annotation", False)}
    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and device_us(e) > 0
                   and e.key not in annotations),
                  key=device_us, reverse=True)


def profile_phase(torch, pt, device, frame_ms, frames=8):
    """Device time of the main path by kernel (torch.profiler), and the
    share of a frame's wall time (phase 5, unprofiled) the device is busy.
    Returns the forward kernel's own device ms per frame.  Reports "not
    measured" where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    scene, meta, _ = pt.builtin.reference_scene(device=device)
    renderer = pt.Renderer(scene, meta, pt.RenderConfig(
        width=512, height=512, max_bounces=4, use_megakernel=True))
    renderer.render_animation(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        renderer.render_animation(frames)
        torch.cuda.synchronize()

    rows = kernel_rows(prof)
    busy_ms = sum(device_us(e) for e in rows) / 1e3 / frames
    fwd = [e for e in rows if "megakernel_fwd" in e.key]
    kernel_ms = (sum(device_us(e) for e in fwd) / 1e3 / frames if fwd
                 else "not measured")
    phase("profile", frames=frames,
          device_ms_per_frame=busy_ms if rows else "not measured",
          kernel_device_ms_per_frame=kernel_ms,
          frame_wall_ms=frame_ms,
          device_busy_share=busy_ms / frame_ms if rows else "not measured",
          top=[{"name": e.key[:60], "calls": e.count,
                "ms_per_frame": device_us(e) / 1e3 / frames}
               for e in rows[:6]])
    return kernel_ms


def tent_scene(pt, device):
    """tests/test_pallas.py:72-101: one emissive quad, one glass sphere and
    a 4-triangle tent."""
    import numpy as np

    b = pt.SceneBuilder()
    white = b.add_material("white", pt.LAMBERTIAN, [0.7, 0.7, 0.7])
    light = b.add_material("light", pt.LAMBERTIAN, [0, 0, 0],
                           emission=[3, 3, 3])
    glass = b.add_material("glass", pt.GLASS, [1, 1, 1], eta=1.5)
    b.add_quad([-1, 1, -1], [2, 0, 0], [0, 0, 2], light)
    b.add_sphere([0.5, -0.3, 0.2], 0.3, glass)
    tent = [[-0.6, -0.5, 0.0], [0.0, -0.5, -0.6], [0.0, 0.2, -0.2],
            [0.6, -0.5, 0.0]]
    tris = np.asarray([[tent[0], tent[1], tent[2]],
                       [tent[1], tent[3], tent[2]],
                       [tent[0], tent[2], tent[3]],
                       [tent[0], tent[3], tent[1]]], np.float32)
    nrm = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    b.add_mesh(pt.MeshData(vertices=tris.reshape(-1, 3),
                           normals=np.repeat(nrm, 3, axis=0)
                           .astype(np.float32)), white)
    scene, meta = b.build(bvh="none", device=device)
    return scene, meta, b


def grad_pair(torch, pt, device, scene, meta, cfg, eye, groups, with_view,
              frame=7):
    """Loss and parameter gradients of an L2 image loss through the
    backward kernel and through its plain version (autograd of the
    wavefront), from the same PCG states.  The target is the kernel's
    image of the same scene at frame 1."""
    from tpu_path_tracer_torch.core import rng
    from tpu_path_tracer_torch.diff.params import apply_params, extract_params
    from tpu_path_tracer_torch.integrator.render import pixel_grid
    from tpu_path_tracer_torch.kernels import megakernel as mk

    check(mk.vjp_supported(scene, meta, cfg), "no differentiable route")
    view0 = torch.as_tensor(pt.Camera(eye=eye, center=[0, 0, 0]).view_matrix,
                            device=device)
    pix, px, py = pixel_grid(cfg.width, cfg.height, device)
    with torch.no_grad():
        target = mk.path_trace_pixels_megakernel(rng.seed(pix, 1), view0, px,
                                                 py, scene, meta, cfg)

    def leaves():
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in extract_params(scene, groups).items()}
        if with_view:
            params["view_matrix"] = view0.clone().requires_grad_(True)
        return params

    def trace(params, fn):
        s = apply_params(scene, params)
        view = params.get("view_matrix", view0)
        return fn(rng.seed(pix, frame), view, px, py, s, meta, cfg)

    # The kernel route: forward and backward kernels, one launch each.
    params = leaves()
    before = (mk.LAUNCHES, mk.BWD_LAUNCHES)
    rad = trace(params, mk.path_trace_pixels_megakernel)
    loss_k = torch.mean((rad - target) ** 2)
    got = torch.autograd.grad(loss_k, list(params.values()),
                              allow_unused=True)
    torch.cuda.synchronize()
    check((mk.LAUNCHES, mk.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1),
          "the kernel route did not launch each kernel once")
    # The plain version.
    params = leaves()
    rad_p = trace(params, mk.path_trace_pixels_reference).detach()
    loss_p = torch.mean((rad_p - target) ** 2)
    ref = mk.vjp_reference(rng.seed(pix, frame),
                           params.get("view_matrix", view0), px, py,
                           apply_params(scene, params), meta, cfg,
                           2.0 * (rad_p - target) / rad_p.numel(),
                           list(params.values()))
    out = {}
    for k, a, b in zip(params, ref, got):
        a = torch.zeros_like(params[k]) if a is None else a
        b = torch.zeros_like(params[k]) if b is None else b
        out[k] = (a.cpu().numpy(), b.cpu().numpy())
    return float(loss_k.detach()), float(loss_p), out


def grad_phase(torch, pt, device):
    """Phase 7: the backward kernel against its plain version; returns the
    largest absolute and relative gradient errors over all cases."""
    import numpy as np
    from tpu_path_tracer_torch.core import rng
    from tpu_path_tracer_torch.diff.params import apply_params, extract_params
    from tpu_path_tracer_torch.integrator.render import pixel_grid
    from tpu_path_tracer_torch.kernels import megakernel as mk

    B = pt.builtin
    geometry = ("emission", "bsdf", "spheres", "quads", "vertices")
    cases = [
        ("cornell_nee_4", B.cornell_box, [0, 0, 3.2],
         dict(max_bounces=4, importance_sampling=True),
         ("emission", "bsdf", "quads"), False),
        # Russian roulette from bounce 3 on, read by later bounces.
        ("cornell_nee_6", B.cornell_box, [0, 0, 3.2],
         dict(max_bounces=6, importance_sampling=True),
         ("emission", "bsdf", "quads"), False),
        ("reference_full", B.reference_scene, [0.5, 0.0, 2.5],
         dict(max_bounces=4), geometry, True),
        ("cornell_stratified_spp4", B.cornell_box, [0, 0, 3.2],
         dict(max_bounces=3, samples_per_pixel=4, stratify=True,
              importance_sampling=True), ("emission", "bsdf", "quads"),
         False),
        ("tent_vertices", lambda device: tent_scene(pt, device),
         [0.0, 0.0, 2.5], dict(max_bounces=2, importance_sampling=True,
                               light_sample_prob=0.9),
         ("emission", "vertices"), False),
        # The training path's own shapes.
        ("cornell_train_512", B.cornell_box, [0, 0, 3.2],
         dict(TRAIN_KW), TRAIN_GROUPS, False),
        ("reference_512", B.reference_scene, [0.5, 0.0, 2.5],
         dict(width=512, height=512, max_bounces=4), TRAIN_GROUPS, False),
    ]
    worst_abs = worst_rel = 0.0
    for name, scene_fn, eye, kw, groups, with_view in cases:
        cfg = pt.RenderConfig(**{"width": 64, "height": 64, **kw})
        scene, meta, _ = scene_fn(device=device)
        loss_k, loss_p, grads = grad_pair(torch, pt, device, scene, meta, cfg,
                                          eye, groups, with_view)
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        rows = {}
        for k, (a, b) in grads.items():
            check(np.isfinite(a).all() and np.isfinite(b).all(),
                  f"{name}: non-finite gradient {k}")
            scale = max(float(np.abs(a).max()), GRAD_ATOL)
            err = float(np.abs(a - b).max())
            rows[k] = {"max": float(np.abs(a).max()), "err_over_max":
                       err / scale}
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel, err / scale)
        phase("grad_vs_plain", case=name, size=f"{cfg.width}x{cfg.height}",
              max_bounces=cfg.max_bounces, loss_kernel=loss_k,
              loss_plain=loss_p, loss_rel=loss_rel, tol=GRAD_RTOL,
              groups=rows)
        check(loss_rel <= GRAD_LOSS_RTOL, f"{name}: losses {loss_k} and "
              f"{loss_p} differ beyond {GRAD_LOSS_RTOL}")
        for k, r in rows.items():
            check(r["err_over_max"] <= GRAD_RTOL,
                  f"{name}: gradient {k} off by {r['err_over_max']:.3g} of "
                  f"its largest")
        check(any(r["max"] > 0 for r in rows.values()),
              f"{name}: every gradient is zero")

    # Over the unroll budget, asking for gradients raises on the card too.
    scene, meta, _ = B.cornell_box(device=device)
    cfg = pt.RenderConfig(width=8, height=8, use_megakernel=True,
                          max_bounces=mk.MAX_UNROLL_BOUNCES + 1)
    params = {k: v.clone().requires_grad_(True)
              for k, v in extract_params(scene, ("emission",)).items()}
    pix, px, py = pixel_grid(8, 8, device)
    view = torch.as_tensor(pt.Camera(eye=[0, 0, 3.2]).view_matrix,
                           device=device)
    try:
        mk.path_trace_pixels_megakernel(rng.seed(pix, 1), view, px, py,
                                        apply_params(scene, params), meta,
                                        cfg)
        raised = ""
    except NotImplementedError as e:
        raised = str(e)
    phase("grad_vs_plain", case="unroll_budget_error", message=raised)
    check("wavefront" in raised, "no unroll-budget error on the card")
    return worst_abs, worst_rel


def train_setup(torch, pt, device, use_megakernel):
    """``cli train``'s setup at the training path's size: the target at
    frame 1 from the true scene, emission and BSDF parameters x 0.5."""
    from tpu_path_tracer_torch.diff.params import apply_params, extract_params
    from tpu_path_tracer_torch.dist import render_dist

    scene, meta, _ = pt.builtin.cornell_box(device=device)
    cfg = pt.RenderConfig(**TRAIN_KW, use_megakernel=use_megakernel)
    view = pt.Camera(eye=[0, 0, 3.2], center=[0, 0, 0]).view_matrix
    frame = render_dist.make_sharded_frame_fn(None, meta, cfg)
    with torch.no_grad():
        target = frame(torch.zeros((render_dist.padded_pixels(cfg), 3),
                                   device=device), 1, True, view, scene)
    params = {k: (v * 0.5).detach().clone().requires_grad_(True)
              for k, v in extract_params(scene, TRAIN_GROUPS).items()}
    optimizer = torch.optim.Adam(params.values(), lr=5e-2)
    step = render_dist.make_train_step(None, scene, meta, cfg, apply_params,
                                       optimizer)
    return step, params, target, view


def train_phase(torch, pt, device, steps=10):
    """Phase 8, the training path: 10 steps through the kernels; the
    launch counts are read around the steps alone."""
    import numpy as np
    from tpu_path_tracer_torch.kernels import megakernel as mk

    step, params, target, view = train_setup(torch, pt, device, True)
    torch.cuda.synchronize()
    mk.LAUNCHES = 0
    mk.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    losses = [float(step(params, target, 1, view)) for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"megakernel_fwd": mk.LAUNCHES,
                "megakernel_bwd": mk.BWD_LAUNCHES}
    phase("train", scene="cornell_box",
          size=f"{TRAIN_KW['width']}x{TRAIN_KW['height']}",
          max_bounces=TRAIN_KW["max_bounces"], groups=list(TRAIN_GROUPS),
          steps=steps, losses=losses, launches=launches,
          seconds=round(seconds, 4))
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(losses[-1] < losses[0], "the training loss did not fall")
    check(launches == {"megakernel_fwd": steps, "megakernel_bwd": steps},
          f"launches {launches} for {steps} steps")
    for k, v in params.items():
        check(bool(torch.isfinite(v).all()), f"non-finite parameter {k}")
    return launches


def time_train_steps(torch, pt, device, use_megakernel, warmup=2, steps=8):
    """Per step: the whole fwd+bwd+Adam step, and its backward alone
    (CUDA events around loss.backward())."""
    from tpu_path_tracer_torch.diff.params import apply_params
    from tpu_path_tracer_torch.dist import render_dist

    step, params, target, view = train_setup(torch, pt, device,
                                             use_megakernel)
    scene, meta, _ = pt.builtin.cornell_box(device=device)
    cfg = pt.RenderConfig(**TRAIN_KW, use_megakernel=use_megakernel)
    loss_fn = render_dist.make_sharded_loss_fn(None, scene, meta, cfg,
                                               apply_params)
    step_ms, bwd_ms = [], []
    for i in range(warmup + steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(params, target, 1, view)
        end.record()
        end.synchronize()
        loss = loss_fn(params, target, 1, view)
        b0 = torch.cuda.Event(enable_timing=True)
        b1 = torch.cuda.Event(enable_timing=True)
        b0.record()
        loss.backward()
        b1.record()
        b1.synchronize()
        if i >= warmup:
            step_ms.append(start.elapsed_time(end))
            bwd_ms.append(b0.elapsed_time(b1))
    return step_ms, bwd_ms


def train_timing_phase(torch, pt, device, smi):
    """Phase 9: median fwd+bwd+Adam step times through the kernels and
    through the wavefront, in turns (plain, kernel, kernel, plain), the
    backward alone of each, and the backward kernel's device time."""
    from torch.profiler import ProfilerActivity, profile

    samples = {"plain": ([], []), "kernel": ([], [])}
    for name in ("plain", "kernel", "kernel", "plain"):
        s, b = time_train_steps(torch, pt, device, name == "kernel")
        samples[name][0].extend(s)
        samples[name][1].extend(b)
    out = {}
    for name, (s, b) in samples.items():
        out[name] = {"step_ms": statistics.median(s),
                     "bwd_ms": statistics.median(b)}
        phase("train_timing", route=name, scene="cornell_box",
              size=f"{TRAIN_KW['width']}x{TRAIN_KW['height']}", max_bounces=TRAIN_KW["max_bounces"],
              step_ms=out[name]["step_ms"], step_ms_min=min(s),
              step_ms_max=max(s), bwd_ms=out[name]["bwd_ms"],
              bwd_ms_min=min(b), bwd_ms_max=max(b), steps=len(s), card=smi)

    step, params, target, view = train_setup(torch, pt, device, True)
    for _ in range(2):
        step(params, target, 1, view)
    torch.cuda.synchronize()
    steps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(params, target, 1, view)
        torch.cuda.synchronize()

    rows = kernel_rows(prof)
    bwd = [e for e in rows if "megakernel_bwd" in e.key]
    fwd = [e for e in rows if "megakernel_fwd" in e.key]
    busy_ms = sum(device_us(e) for e in rows) / 1e3 / steps
    kernel_ms = {
        "megakernel_bwd": (sum(device_us(e) for e in bwd) / 1e3 / steps
                           if bwd else "not measured"),
        "megakernel_fwd": (sum(device_us(e) for e in fwd) / 1e3 / steps
                           if fwd else "not measured")}
    phase("train_profile", steps=steps,
          device_ms_per_step=busy_ms if rows else "not measured",
          step_wall_ms=out["kernel"]["step_ms"],
          kernel_device_ms_per_step=kernel_ms,
          top=[{"name": e.key[:60], "calls": e.count,
                "ms_per_step": device_us(e) / 1e3 / steps}
               for e in rows[:8]])
    return out, kernel_ms


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
    import torch

    from tpu_path_tracer_torch.core.config import ISOTROPIC
    from tpu_path_tracer_torch.integrator import path_tracer
    from tpu_path_tracer_torch.kernels import intersect

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


def megakernel_bound(torch, pt, device, scene, meta, cfg, eye, backward):
    """Bound of one megakernel launch (``backward``: of the backward) on
    these inputs: the FP32 operations of the bounces the paths took, from
    the plain wavefront at frame 1, and the bytes of the state, pixels,
    tables and radiance (for the backward also the cotangent in and the
    table gradients out)."""
    from tpu_path_tracer_torch.core import rng
    from tpu_path_tracer_torch.core.config import ISOTROPIC
    from tpu_path_tracer_torch.integrator.render import pixel_grid
    from tpu_path_tracer_torch.kernels import megakernel as mk

    work = collections.Counter()
    pix, px, py = pixel_grid(cfg.width, cfg.height, device)
    view = torch.as_tensor(pt.Camera(eye=eye, center=[0, 0, 0]).view_matrix,
                           device=device)
    with torch.no_grad(), counted_work(work, scene):
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
                  + scene.triangles.count * MT_PRE_FLOPS
                  + SHADE_FLOPS
                  + (NEE_FLOPS if cfg.importance_sampling and meta.has_light
                     else 0))
    flops = (work["lanes"] * per_bounce + work["facing_quads"] * QUAD_FLOPS
             + ((work["spans"] * FLIGHT_FLOPS + work["events"] * EVENT_FLOPS)
                if meta.has_volumes else 0))
    table_bytes = 4 * sum(t.numel() for t in mk.pack_tables(scene)) + 64
    nbytes = px.shape[0] * (3 * 4 + 3 * 4) + table_bytes
    if backward:
        flops *= BWD_FLOPS_FACTOR
        nbytes += px.shape[0] * 3 * 4 + table_bytes
    ms, by = bound(flops, nbytes)
    return {"bound_ms": ms, "bound_by": by, "lane_bounces": work["lanes"],
            "facing_quads": work["facing_quads"], "spans": work["spans"],
            "events": work["events"], "flops": flops, "bytes": nbytes}


def mesh_scene(pt, device, subdivisions, timings=None):
    """bench.py:301's mesh scene: white back and front walls, the emissive
    quad and a mirror icosphere of radius 0.8, median BVH."""
    b = pt.SceneBuilder()
    b.add_material("default", pt.LAMBERTIAN, [1, 0, 0])
    white = b.add_material("white", pt.LAMBERTIAN, [0.73, 0.73, 0.73])
    light = b.add_material("light", pt.LAMBERTIAN, [0, 0, 0],
                           emission=[2, 2, 2])
    mirror = b.add_material("mirror", pt.MIRROR, [0.9, 0.9, 0.9])
    b.add_quad([-2, -2, -2], [4, 0, 0], [0, 4, 0], white)
    b.add_quad([-2, 2, -2], [4, 0, 0], [0, 0, 4], light)
    b.add_quad([-2, -2, 2], [4, 0, 0], [0, 0, -4], white)
    b.add_mesh(pt.procedural.icosphere(subdivisions=subdivisions,
                                       radius=0.8), mirror)
    return b.build(bvh="median", timings=timings, device=device)


def traversal_bound(n_rays, n_nodes, n_tris, stats):
    """FP32 operations of the walk this bundle took (counted on the plain
    walk) and the bytes of rays in, results out, and the node and triangle
    tables read once."""
    flops = (stats["node_visits"] * SLAB_FLOPS + stats["tri_tests"] * MT_FLOPS
             + 3 * n_rays)
    nbytes = n_rays * (7 * 4 + 2 * 4) + n_nodes * 36 + n_tris * 36
    ms, by = bound(flops, nbytes)
    return {"bound_ms": ms, "bound_by": by, "flops": flops, "bytes": nbytes}


def profile_device_ms(torch, fn, calls, names):
    """Device ms per call of ``fn`` by kernel-name group (torch.profiler):
    ``names`` maps a group to substrings of kernel names; "all" sums every
    kernel.  "not measured" where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    if not rows:
        return {k: "not measured" for k in list(names) + ["all"]}, []
    out = {k: sum(device_us(e) for e in rows
                  if any(s in e.key for s in subs)) / 1e3 / calls
           for k, subs in names.items()}
    out["all"] = sum(device_us(e) for e in rows) / 1e3 / calls
    return out, rows


def time_events(torch, fn, calls):
    """ms per call of ``fn`` by CUDA events, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def traversal_phase(torch, pt, device, smi):
    """Phase 10: the traversal kernel against the plain walk on the card,
    from the same rays, at both mesh sizes.  Returns the 81,920-triangle
    case's numbers for the kernels line."""
    import numpy as np
    from tpu_path_tracer_torch.accel import native
    from tpu_path_tracer_torch.kernels import traversal

    t_min = pt.RenderConfig().t_min
    out = {}
    for sub in MESH_SUBDIVISIONS:
        timings = {}
        scene, meta = mesh_scene(pt, device, sub, timings)
        bvh, tris = scene.bvh, scene.triangles
        o, d, t0 = (torch.from_numpy(x).to(device) for x in traversal_rays(
            TRAV_RAYS, sub, 0.8, tris.a.cpu().numpy()))
        t_k, i_k = traversal.closest_hit(o, d, bvh, tris, t_min, t0)
        torch.cuda.synchronize()
        stats = {}
        start = time.perf_counter()
        t_p, i_p = traversal.bvh_closest_hit(o, d, bvh, tris, t_min, t0,
                                             meta.max_leaf, stats=stats)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - start) * 1e3
        t_k, i_k, t_p, i_p = (x.cpu().numpy() for x in (t_k, i_k, t_p, i_p))
        dead = t0.cpu().numpy() < 0
        hit = i_p >= 0
        err = float(np.abs(t_k[hit] - t_p[hit]).max()) if hit.any() else 0.0

        def call():
            traversal.closest_hit(o, d, bvh, tris, t_min, t0)

        call_ms = time_events(torch, call, 20)
        pack_ms = time_events(
            torch, lambda: traversal.pack_bvh(bvh, tris), 20)
        dev_ms, _ = profile_device_ms(torch, call, 10,
                                      {"kernel": ["bvh_closest_hit"]})
        b = traversal_bound(TRAV_RAYS, bvh.count, tris.count, stats)
        row = {"tris": tris.count, "nodes": bvh.count,
               "builder": "native" if native.available() else "numpy",
               "bvh_build_s": timings["bvh_build_s"],
               "same_index": float((i_k == i_p).mean()),
               "same_hit_mask": bool(((i_k >= 0) == hit).all()),
               "max_abs_err": err, "t_bit_equal": bool((t_k == t_p).all()),
               "retired_all_miss": bool((i_k[dead] == -1).all()),
               "hit_share": float(hit.mean()),
               "node_visits_per_ray": stats["node_visits"] / TRAV_RAYS,
               "tri_tests_per_ray": stats["tri_tests"] / TRAV_RAYS,
               "walk_iterations": stats["iterations"],
               "kernel_ms": dev_ms["kernel"], "call_ms": call_ms,
               "pack_ms": pack_ms, "plain_ms": plain_ms, **b}
        phase("traversal_vs_plain", rays=TRAV_RAYS, card=smi, **row)
        check(row["same_hit_mask"], f"{sub}: hit masks differ")
        check(row["same_index"] == 1.0, f"{sub}: triangle indices differ on "
              f"{1 - row['same_index']:.2e} of lanes")
        check(err <= TRAV_T_TOL, f"{sub}: t differs by {err}")
        check(row["retired_all_miss"], f"{sub}: a retired lane hit")
        check(row["hit_share"] > 0.3, f"{sub}: the rays miss the mesh")
        out[sub] = row
    return out[MESH_SUBDIVISIONS[0]]


@contextlib.contextmanager
def plain_traversal(max_leaf):
    """Route find_hit's BVH search to the plain walk on the card.  The
    package has no such switch (a CUDA tensor launches the kernel or
    raises); this swaps the wrapper for the walk and restores it."""
    from tpu_path_tracer_torch.kernels import traversal

    kernel = traversal.closest_hit

    def walk(origin, direction, bvh, tris, t_min, t_best0):
        return traversal.bvh_closest_hit(origin, direction, bvh, tris, t_min,
                                         t_best0, max_leaf)

    traversal.closest_hit = walk
    try:
        yield
    finally:
        traversal.closest_hit = kernel


def mesh_main_path_phase(torch, pt, device, frames=8):
    """Phase 11: the mesh path through the entry points, with the
    traversal kernel's launches counted around it alone; then one frame
    through the kernel and through the plain walk, same PCG states."""
    import numpy as np
    from tpu_path_tracer_torch.integrator.render import render_frame
    from tpu_path_tracer_torch.kernels import traversal

    scene, meta = mesh_scene(pt, device, MESH_SUBDIVISIONS[0])
    check(meta.traversal == "bvh", "the mesh scene has no BVH")
    cfg = pt.RenderConfig(**MESH_KW)
    renderer = pt.Renderer(scene, meta, cfg,
                           pt.Camera(eye=MESH_EYE, center=[0, 0, 0]))
    torch.cuda.synchronize()
    traversal.LAUNCHES = 0
    start = time.perf_counter()
    fb = renderer.render_animation(frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = traversal.LAUNCHES
    fb_np = fb.cpu().numpy()
    img = renderer.display()
    png = os.path.join(REPO, "tpu_path_tracer_torch", "_build",
                       "chip_smoke_mesh_512.png")
    os.makedirs(os.path.dirname(png), exist_ok=True)
    renderer.save_png(png)
    phase("mesh_main_path", tris=scene.triangles.count, frames=frames,
          max_bounces=cfg.max_bounces, launches=launches,
          seconds=round(seconds, 4), fb_mean=fb_np.mean(0).tolist(),
          image_std=float(img.std()), png=os.path.relpath(png, REPO))
    check(launches == cfg.max_bounces * frames,
          f"traversal kernel launched {launches} times for {frames} frames "
          f"of {cfg.max_bounces} bounces")
    check(fb_np.shape == (cfg.width * cfg.height, 3), "framebuffer shape")
    check(np.isfinite(fb_np).all(), "non-finite framebuffer")
    check(float(img.std()) > 1.0, "the image is flat")

    view = pt.Camera(eye=MESH_EYE, center=[0, 0, 0]).view_matrix
    n = cfg.width * cfg.height
    got = render_frame(torch.zeros((n, 3), device=device), 3, True, view,
                       scene, meta, cfg).cpu().numpy()
    with plain_traversal(meta.max_leaf):
        ref = render_frame(torch.zeros((n, 3), device=device), 3, True, view,
                           scene, meta, cfg).cpu().numpy()
    share = float(np.isclose(got, ref, rtol=KERNEL_TOL,
                             atol=KERNEL_TOL).all(axis=-1).mean())
    phase("mesh_main_path", case="kernel_vs_plain_frame", share_within_tol=
          share, tol=KERNEL_TOL, max_abs_err=float(np.abs(got - ref).max()),
          mean_kernel=got.mean(0).tolist(), mean_plain=ref.mean(0).tolist())
    check(share >= KERNEL_MIN_SHARE,
          f"mesh frame: only {share:.4f} of pixels within {KERNEL_TOL}")
    check(np.allclose(got.mean(0), ref.mean(0), rtol=KERNEL_MEAN_RTOL,
                      atol=1e-6), "mesh frame: image means differ")
    return launches


def mesh_timing_phase(torch, pt, device, smi):
    """Phase 12: median frame times at 512x512 and 81,920 triangles through
    the kernel and through the plain walk, in turns (plain, kernel,
    kernel, plain); through the kernel at 1024x1024 with 327,680
    triangles; the device time of a 512x512 mesh frame by kernel and the
    packing's time per launch."""
    from tpu_path_tracer_torch.integrator.render import render_frame
    from tpu_path_tracer_torch.kernels import traversal

    view = pt.Camera(eye=MESH_EYE, center=[0, 0, 0]).view_matrix
    scene, meta = mesh_scene(pt, device, MESH_SUBDIVISIONS[0])
    cfg = pt.RenderConfig(**MESH_KW)
    runs = {"plain": (1, 3), "kernel": (2, 8)}   # warm-up, timed frames
    samples = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        warmup, frames = runs[name]
        ctx = (plain_traversal(meta.max_leaf) if name == "plain"
               else contextlib.nullcontext())
        with ctx:
            t = time_frames(torch, pt, device, scene, meta, cfg, view,
                            warmup + frames)
        samples[name] += t[warmup:]
    out = {}
    for name, t in samples.items():
        out[name] = statistics.median(t)
        phase("mesh_timing", version=name, tris=scene.triangles.count,
              size=f"{cfg.width}x{cfg.height}", max_bounces=cfg.max_bounces,
              ms_per_frame=out[name], ms_min=min(t), ms_max=max(t),
              frames=len(t), card=smi)

    n = cfg.width * cfg.height
    fb = torch.zeros((n, 3), device=device)
    frame = [0]

    def one_frame():
        frame[0] += 1
        render_frame(fb, frame[0], frame[0] == 1, view, scene, meta, cfg)

    dev_ms, rows = profile_device_ms(
        torch, one_frame, 4, {"traversal": ["bvh_closest_hit"]})
    pack_ms = time_events(
        torch, lambda: traversal.pack_bvh(scene.bvh, scene.triangles), 20)
    phase("mesh_profile", tris=scene.triangles.count,
          size=f"{cfg.width}x{cfg.height}", frames=4,
          pack_ms_per_launch=pack_ms,
          traversal_device_ms_per_frame=dev_ms["traversal"],
          traversal_device_ms_per_launch=(
              dev_ms["traversal"] / cfg.max_bounces
              if rows else "not measured"),
          device_ms_per_frame=dev_ms["all"], frame_wall_ms=out["kernel"],
          device_busy_share=(dev_ms["all"] / out["kernel"] if rows
                             else "not measured"),
          top=[{"name": e.key[:60], "calls": e.count,
                "ms_per_frame": device_us(e) / 1e3 / 4} for e in rows[:8]])
    out["kernel_device_ms_per_launch"] = (
        dev_ms["traversal"] / cfg.max_bounces if rows else "not measured")

    big, big_meta = mesh_scene(pt, device, MESH_SUBDIVISIONS[1])
    big_cfg = cfg.replace(width=2 * cfg.width, height=2 * cfg.height)
    t = time_frames(torch, pt, device, big, big_meta, big_cfg, view, 1 + 4)
    phase("mesh_timing", version="kernel", tris=big.triangles.count,
          size=f"{big_cfg.width}x{big_cfg.height}", max_bounces=big_cfg.max_bounces,
          ms_per_frame=statistics.median(t[1:]), ms_min=min(t[1:]),
          ms_max=max(t[1:]), frames=len(t) - 1, card=smi)
    return out


def mesh_train_phase(torch, pt, device, steps=3):
    """Phase 13: the training path on the mesh scene: emission and vertex
    parameters, the BVH refit inside apply_params every step, the
    traversal kernel's launches counted around the steps alone."""
    import numpy as np
    from tpu_path_tracer_torch.diff.params import apply_params, extract_params
    from tpu_path_tracer_torch.dist import render_dist
    from tpu_path_tracer_torch.kernels import traversal

    scene, meta = mesh_scene(pt, device, MESH_SUBDIVISIONS[0])
    cfg = pt.RenderConfig(**MESH_KW)
    view = pt.Camera(eye=MESH_EYE, center=[0, 0, 0]).view_matrix
    frame = render_dist.make_sharded_frame_fn(None, meta, cfg)
    with torch.no_grad():
        target = frame(torch.zeros((render_dist.padded_pixels(cfg), 3),
                                   device=device), 1, True, view, scene)
    # cli train's perturbation: geometry shifted, emission halved.
    params = {k: (v + 0.05 if k.startswith("tri_") else v * 0.5)
              .detach().clone().requires_grad_(True)
              for k, v in extract_params(scene, MESH_GROUPS).items()}
    optimizer = torch.optim.Adam(params.values(), lr=5e-3)
    step = render_dist.make_train_step(None, scene, meta, cfg, apply_params,
                                       optimizer)
    torch.cuda.synchronize()
    traversal.LAUNCHES = 0
    losses, step_ms, grad_max = [], [], []
    for _ in range(steps):
        start = time.perf_counter()
        losses.append(float(step(params, target, 1, view)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
        grad_max.append({k: float(v.grad.abs().max())
                         for k, v in params.items()})
        for k, v in params.items():
            check(bool(torch.isfinite(v.grad).all()),
                  f"non-finite gradient {k}")
    launches = traversal.LAUNCHES
    phase("mesh_train", tris=scene.triangles.count,
          size=f"{cfg.width}x{cfg.height}",
          max_bounces=cfg.max_bounces, groups=list(MESH_GROUPS), steps=steps,
          losses=losses, step_ms=step_ms, grad_max=grad_max,
          launches=launches)
    check(all(np.isfinite(losses)), "non-finite mesh training loss")
    check(all(g[k] > 0 for g in grad_max for k in ("tri_a", "tri_b",
                                                   "tri_c")),
          "zero vertex gradients")
    check(launches == cfg.max_bounces * steps,
          f"traversal kernel launched {launches} times in {steps} steps")
    return statistics.median(step_ms)


def mesh_cli_phase(pt):
    """Phase 14: the render command on an OBJ that save_obj wrote, through
    a median BVH, on the card (the command's default device)."""
    from tpu_path_tracer_torch.scene.objreader import save_obj

    out_dir = os.path.join(REPO, "tpu_path_tracer_torch", "_build",
                           "chip_smoke_cli")
    os.makedirs(out_dir, exist_ok=True)
    obj = os.path.join(out_dir, "ico.obj")
    png = os.path.join(out_dir, "ico.png")
    if os.path.exists(png):
        os.remove(png)
    save_obj(obj, pt.procedural.icosphere(subdivisions=5, radius=0.6))
    cmd = [sys.executable, "-m", "tpu_path_tracer_torch", "render", "--scene",
           obj, "--bvh", "median", "--frames", "2", "--width", "128",
           "--height", "128", "--bounces", "4", "-o", png]
    start = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    seconds = time.perf_counter() - start
    phase("mesh_cli", rc=proc.returncode, seconds=round(seconds, 2),
          stdout=proc.stdout.strip().splitlines()[-2:],
          png=os.path.relpath(png, REPO))
    check(proc.returncode == 0, f"render command failed: {proc.stderr}")
    check(os.path.exists(png), "render command wrote no PNG")
    check("on cuda" in proc.stdout, "render command did not run on the card")


@contextlib.contextmanager
def recorded_sweep(route, calls):
    """Keep ``(arguments, results, ray of each pair)`` of every launch of a
    pair-sweep wrapper (``route``: "pair" or "pairbin") made inside the
    context.  The rays come from the emission's ``_pair_rows``, which lays
    out the rows of each launch just before it."""
    from tpu_path_tracer_torch.kernels import pair_sweep as ps

    name = f"{route}_sweep"
    sweep, pair_rows = getattr(ps, name), ps._pair_rows
    rays = []

    def laying_out(o, d, bound, ray, rows, n_rows):
        rays.append(ray)
        return pair_rows(o, d, bound, ray, rows, n_rows)

    def recording(*args):
        out = sweep(*args)
        calls.append((args, out, rays.pop()))
        return out

    setattr(ps, name, recording)
    ps._pair_rows = laying_out
    try:
        yield
    finally:
        setattr(ps, name, sweep)
        ps._pair_rows = pair_rows


@contextlib.contextmanager
def pair_dispatch(route):
    """Route find_hit's BVH search through a pair sweep (None: the BVH
    kernel), as a test sets ``traversal.PAIR_DISPATCH``."""
    from tpu_path_tracer_torch.kernels import traversal

    before = traversal.PAIR_DISPATCH
    traversal.PAIR_DISPATCH = route
    try:
        yield
    finally:
        traversal.PAIR_DISPATCH = before


def pair_launch_work(torch, ps, route, args, out):
    """What one recorded launch of a pair-sweep wrapper needed, counted from
    its arguments: the FP32 operations of the row-triangle tests (and, for
    the pair-bin sweep, the chunk slab tests) of its real rows, and the bytes
    of its segments' pair rows in and results out, the segment ids, and only
    the chunk tables (and chunk boxes) its segments read.

    Which chunks a pair-bin segment sweeps depends on its rows' running
    best, so that sweep is replayed here as ``PAIR_G`` plain pair sweeps,
    each gated by the slab test at the running best; the replay's result is
    held to the launch's."""
    pair_dm, pair_o1, seg = args[0], args[1], args[2].to(torch.int64)
    table, t_min = args[-2], args[-1]
    n_chunks, chunk = table.shape[0], ps.TRI_CHUNK
    real = (pair_o1[:, 3] != 0).reshape(-1, chunk)
    if route == "pair":
        on = (seg >= 0) & (seg < n_chunks)
        row_tests = int((real & on[:, None]).sum()) * chunk
        slab_tests = boxes_read = 0
        tables_read = int(torch.unique(seg[on]).numel())
        flops = row_tests * EDGE_FLOPS
    else:
        boxes = args[3]
        on = (seg >= 0) & (seg < -(-n_chunks // ps.PAIR_G))
        o = pair_o1[:, :3].reshape(-1, chunk, 3)
        iv = ps.inv_dir(pair_dm[:, :3]).reshape(-1, chunk, 3)
        t_cur = pair_dm[:, 6].clone()
        i_cur = torch.full_like(out[1], -1)
        swept = torch.zeros(n_chunks, dtype=torch.bool, device=seg.device)
        tested = torch.zeros_like(swept)
        row_tests = slab_tests = 0
        for c in range(ps.PAIR_G):
            cid = seg * ps.PAIR_G + c
            live = on & (cid < n_chunks)
            box = boxes[torch.clamp(cid, 0, n_chunks - 1)][:, None]
            reach = ps.slab_entries(o, iv, t_cur.reshape(-1, chunk),
                                    box[..., :3], box[..., 3:]) < 1e30
            sweep = live & reach.any(dim=1)
            dm = pair_dm.clone()
            dm[:, 6] = t_cur
            t, i = ps.pair_sweep_plain(
                dm, pair_o1, torch.where(sweep, cid, -1).to(torch.int32),
                table, t_min)
            t_cur = torch.where(i >= 0, t, t_cur)
            i_cur = torch.where(i >= 0, i, i_cur)
            slab_tests += int((real & live[:, None]).sum())
            row_tests += int((real & sweep[:, None]).sum()) * chunk
            tested[cid[live]] = True
            swept[cid[sweep]] = True
        rows_on = on.repeat_interleave(chunk)
        check(bool((i_cur[rows_on] == out[1][rows_on]).all())
              and bool((t_cur[rows_on] == out[0][rows_on]).all()),
              "pairbin: the launch differs from its replay as gated pair "
              "sweeps")
        tables_read, boxes_read = int(swept.sum()), int(tested.sum())
        flops = (row_tests * EDGE_FLOPS + slab_tests * PAIR_SLAB_FLOPS
                 + int((real & on[:, None]).sum()) * PAIR_INV_FLOPS)
    nbytes = (int(on.sum()) * chunk * (64 + 8) + seg.shape[0] * 4
              + tables_read * ps.TABLE_ROWS * chunk * 4 + boxes_read * 24)
    return {"pairs": int(real.sum()), "rows": pair_dm.shape[0],
            "segments": seg.shape[0], "row_tests": row_tests,
            "slab_tests": slab_tests, "tables_read": tables_read,
            "flops": flops, "bytes": nbytes}


def sweeps_against_plain(torch, ps, route, calls):
    """Every recorded launch of a pair-sweep kernel against its plain
    version on the card, on the launch's own arguments, with the plain
    version's time, what each launch served and needed
    (:func:`pair_launch_work`) and the bound per launch (the mean of the
    launches' bounds)."""
    plain = {"pairbin": ps.pairbin_sweep_plain,
             "pair": ps.pair_sweep_plain}[route]
    same_index = bit_equal = True
    err = plain_ms = ops_ms = bytes_ms = bound_ms = 0.0
    served = []
    for args, (t_k, i_k), ray in calls:
        torch.cuda.synchronize()
        start = time.perf_counter()
        t_p, i_p = plain(*args)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - start) * 1e3
        same_index &= bool((i_k == i_p).all())
        bit_equal &= bool((t_k == t_p).all())
        err = max(err, float((t_k - t_p).abs().max()))
        work = pair_launch_work(torch, ps, route, args, (t_k, i_k))
        work["rays"] = int(torch.unique(ray).numel())
        ops = work["flops"] / PEAK_FP32_FLOPS * 1e3
        moved = work["bytes"] / PEAK_HBM_BYTES * 1e3
        ops_ms, bytes_ms = ops_ms + ops, bytes_ms + moved
        bound_ms += max(ops, moved)
        served.append(work)
    n = len(calls)
    return {"launches": n, "same_index": same_index, "t_bit_equal": bit_equal,
            "max_abs_err": err, "plain_ms_per_launch": plain_ms / n,
            "bound_ms": bound_ms / n,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": sum(w["flops"] for w in served) / n,
            "bytes": sum(w["bytes"] for w in served) / n,
            "rays_served": [w["rays"] for w in served],
            "pairs": [w["pairs"] for w in served],
            "rows": [w["rows"] for w in served],
            "segments": [w["segments"] for w in served],
            "tables_read": [w["tables_read"] for w in served]}


def edge_form_float64(np, o, d, a, b, c):
    """The pair sweeps' edge-function t of rays (o, d) against triangles
    (a, b, c), row by row, evaluated in float64 from the float32 inputs: t,
    the condition number of its sums and ``|n . d| / |n|``, the cosine
    between ray and normal.  The condition number is the sum of the
    magnitudes of the products that make up n . d = sum over the edges
    (p, q) of d . (p x q) + (o x d) . (q - p), the cross products written
    out (the table stores p x q rounded to float32, so its own cancellation
    counts), over |n . d|; plus the same for the numerator n . a - n . o."""
    o, d, a, b, c = (x.astype(np.float64) for x in (o, d, a, b, c))

    def cross_magnitude(p, q):
        return (np.abs(p[:, [1, 2, 0]] * q[:, [2, 0, 1]])
                + np.abs(p[:, [2, 0, 1]] * q[:, [1, 2, 0]]))

    m, m_mag = np.cross(o, d), cross_magnitude(o, d)
    den = mag = 0.0
    for p, q in ((b, c), (c, a), (a, b)):
        den = (den + (d * np.cross(p, q)).sum(axis=1)
               + (m * (q - p)).sum(axis=1))
        mag = (mag + (np.abs(d) * cross_magnitude(p, q)).sum(axis=1)
               + (m_mag * np.abs(q - p)).sum(axis=1))
    n = np.cross(b - a, c - a)
    tn = (n * a).sum(axis=1) - (n * o).sum(axis=1)
    tn_mag = np.abs(n * a).sum(axis=1) + np.abs(n * o).sum(axis=1)
    cond = mag / np.abs(den) + tn_mag / np.abs(tn)
    return tn / den, cond, np.abs(den) / np.linalg.norm(n, axis=1)


def pair_t_against_walk(np, o, d, verts, t_e, i_e, t_w, i_w, both):
    """The entry point's t against the BVH kernel's on the lanes both hit,
    with the cause of every lane beyond the tolerance shown in float64.

    The edge-function form of the lane's own triangle is evaluated in
    float64 (:func:`edge_form_float64`).  A lane that names the walk's
    triangle is *held* to rtol 1e-3 / atol 1e-4 unless the float32 rounding
    its sums can carry, 2^-24 x condition number x t, exceeds
    ``PAIR_ROUNDING_MAX`` times that tolerance; those lanes are
    ill-conditioned and exempt, and are counted.  Lanes that name another
    triangle (a hit on a shared edge, which either test may give to a
    neighbour or pass through to the next surface) are counted apart.  For
    the lanes beyond the tolerance the line says how many the float64 value
    of the same formula brings back to the walk's t (the float32 evaluation
    is the cause), how many name the walk's triangle, how many are
    unexplained (the walk's triangle, and still off in float64), and their
    ``|n . d| / |n|``."""
    lanes = np.nonzero(both)[0]
    tri = i_e[lanes]
    t64, cond, cosine = edge_form_float64(
        np, o[lanes], d[lanes], *(verts[k][tri] for k in range(3)))
    te, tw = t_e[lanes].astype(np.float64), t_w[lanes].astype(np.float64)
    tol = PAIR_WALK_ATOL + PAIR_WALK_RTOL * np.abs(tw)
    beyond = np.abs(te - tw) > tol
    rounding = 2.0 ** -24 * cond * np.abs(t64)
    same = tri == i_w[lanes]
    held = same & (rounding <= PAIR_ROUNDING_MAX * tol)
    meets64 = np.abs(t64 - tw) <= tol

    def spread(x):
        return ([float(v) for v in np.quantile(x, [0.0, 0.5, 1.0])]
                if x.size else [])

    return {
        "hit_lanes": int(lanes.size),
        "t_beyond_tol": int(beyond.sum()),
        "t_within_tol_share": float(1.0 - beyond.mean()),
        "held_lanes": int(held.sum()),
        "exempt_lanes": int((same & ~held).sum()),
        "other_triangle_lanes": int((~same).sum()),
        "other_triangle_beyond_tol": int((beyond & ~same).sum()),
        "held_beyond_tol": int((beyond & held).sum()),
        "beyond_float64_meets_walk": int((beyond & meets64).sum()),
        "beyond_same_triangle": int((beyond & same).sum()),
        "beyond_unexplained": int((beyond & same & ~meets64).sum()),
        "beyond_cosine_min_median_max": spread(cosine[beyond]),
        "all_cosine_min_median_max": spread(cosine),
        "beyond_rounding_over_tol_min_median_max": spread(
            (rounding / tol)[beyond]),
        "err_over_rounding_max": float(
            (np.abs(te - t64) / rounding).max()),
        "t_rel_err_median": float(np.median(np.abs(te - tw) / np.abs(tw))),
        "t_rel_err_p99": float(np.quantile(np.abs(te - tw) / np.abs(tw),
                                           0.99)),
        "index_differs_share": float((~same).mean())}


def pair_phase(torch, pt, device, smi):
    """Phase 15: both pair-sweep kernels against their plain versions, and
    both entry points against the BVH kernel, on phase 10's rays at both
    mesh sizes."""
    import numpy as np
    from tpu_path_tracer_torch.kernels import pair_sweep as ps
    from tpu_path_tracer_torch.kernels import traversal

    t_min = pt.RenderConfig().t_min
    entries = {"pairbin": ps.pairbin_closest_hit,
               "pair": ps.pair_closest_hit}
    kernel_names = {"pairbin": "pairbin_sweep_kernel",
                    "pair": "pair_sweep_kernel"}
    for sub in MESH_SUBDIVISIONS:
        scene, _ = mesh_scene(pt, device, sub)
        bvh, tris = scene.bvh, scene.triangles
        verts = [x.cpu().numpy() for x in (tris.a, tris.b, tris.c)]
        o_np, d_np, t0_np = traversal_rays(TRAV_RAYS, sub, 0.8, verts[0])
        o, d, t0 = (torch.from_numpy(x).to(device)
                    for x in (o_np, d_np, t0_np))
        live = t0_np > 0

        def bvh_call():
            return traversal.closest_hit(o, d, bvh, tris, t_min, t0)

        t_w, i_w = (x.cpu().numpy() for x in bvh_call())
        bvh_call_ms = time_events(torch, bvh_call, 10)
        bvh_dev, _ = profile_device_ms(torch, bvh_call, 5,
                                       {"kernel": ["bvh_closest_hit"]})
        for route, entry in entries.items():
            calls = []
            with recorded_sweep(route, calls):
                t_e, i_e = entry(o, d, bvh, tris, t_min, t0)
            torch.cuda.synchronize()
            check(calls, f"{route}: the entry point launched no sweep")
            # The kernel against its plain version, launch by launch.
            row = sweeps_against_plain(torch, ps, route, calls)
            n_launch = row["launches"]

            # The entry point against the BVH kernel's answer.
            t_e, i_e = t_e.cpu().numpy(), i_e.cpu().numpy()
            hit_w, hit_e = i_w >= 0, i_e >= 0
            mask_diff = int((hit_w != hit_e)[live].sum())
            both = hit_w & hit_e & live
            row.update(pair_t_against_walk(np, o_np, d_np, verts, t_e, i_e,
                                           t_w, i_w, both))

            def call():
                entry(o, d, bvh, tris, t_min, t0)

            call_ms = time_events(torch, call, 5)
            # Kernel and emission (every other device operation of the
            # call) from one profiled run.
            dev_ms, rows_prof = profile_device_ms(
                torch, call, 3, {"kernel": [kernel_names[route]]})
            measured = bool(rows_prof)
            row.update(
                route=route, tris=tris.count,
                mask_mismatches=mask_diff, live_lanes=int(live.sum()),
                retired_all_miss=bool((i_e[~live] == -1).all()),
                kernel_ms_per_launch=(dev_ms["kernel"] / n_launch
                                      if measured else "not measured"),
                kernel_ms_per_call=dev_ms["kernel"],
                emission_device_ms_per_call=(
                    dev_ms["all"] - dev_ms["kernel"] if measured
                    else "not measured"),
                device_ms_per_call=dev_ms["all"], call_ms=call_ms,
                bvh_kernel_ms=bvh_dev["kernel"], bvh_call_ms=bvh_call_ms)
            phase("pair_vs_plain", rays=TRAV_RAYS, card=smi, **row)
            name = f"{route} at {tris.count} triangles"
            check(row["same_index"],
                  f"{name}: kernel and plain indices differ")
            check(row["max_abs_err"] <= PAIR_T_TOL,
                  f"{name}: kernel t off plain by {row['max_abs_err']}")
            check(row["retired_all_miss"], f"{name}: a retired lane hit")
            check(mask_diff == 0,
                  f"{name}: {mask_diff} live lanes differ in the hit mask")
            check(row["held_beyond_tol"] == 0,
                  f"{name}: {row['held_beyond_tol']} well-conditioned lanes "
                  f"beyond the walk's t")
            check(row["beyond_unexplained"] == 0,
                  f"{name}: {row['beyond_unexplained']} lanes beyond the "
                  f"walk's t that float32 rounding does not explain")
            check(row["other_triangle_lanes"]
                  <= PAIR_OTHER_TRIANGLE_MAX_SHARE * row["hit_lanes"],
                  f"{name}: {row['other_triangle_lanes']} lanes name "
                  f"another triangle than the walk")
            check(row["held_lanes"] >= PAIR_HELD_MIN_SHARE * row["hit_lanes"],
                  f"{name}: only {row['held_lanes']} of {row['hit_lanes']} "
                  f"hit lanes are held to the tolerance")
            check(both.sum() > 0.3 * live.sum(), f"{name}: the rays miss")


def pair_main_path_phase(torch, pt, device, smi, frames=3):
    """Phase 16: the mesh main path with the closest-hit search routed
    through each pair sweep.  Every launch of one frame is held against the
    plain version on the launch's own arguments.  Returns, per kernel, the
    launches of its route's run and the numbers of that frame's launches
    for the kernels line."""
    import numpy as np
    from tpu_path_tracer_torch.integrator.render import render_frame
    from tpu_path_tracer_torch.kernels import pair_sweep as ps
    from tpu_path_tracer_torch.kernels import traversal

    scene, meta = mesh_scene(pt, device, MESH_SUBDIVISIONS[0])
    cfg = pt.RenderConfig(**MESH_KW)
    view = pt.Camera(eye=MESH_EYE, center=[0, 0, 0]).view_matrix
    n = cfg.width * cfg.height

    def one_frame():
        return render_frame(torch.zeros((n, 3), device=device), 3, True, view,
                            scene, meta, cfg).cpu().numpy()

    ref = one_frame()
    out = {}
    for route in ("pairbin", "pair"):
        renderer = pt.Renderer(scene, meta, cfg,
                               pt.Camera(eye=MESH_EYE, center=[0, 0, 0]))
        with pair_dispatch(route):
            torch.cuda.synchronize()
            ps.PAIR_LAUNCHES = ps.PAIRBIN_LAUNCHES = traversal.LAUNCHES = 0
            start = time.perf_counter()
            fb = renderer.render_animation(frames)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            counts = {"pairbin_sweep": ps.PAIRBIN_LAUNCHES,
                      "pair_sweep": ps.PAIR_LAUNCHES,
                      "bvh_closest_hit": traversal.LAUNCHES}
            calls = []
            with recorded_sweep(route, calls):
                got = one_frame()
        own = f"{route}_sweep"
        check(calls, f"{route}: a frame launched no sweep")
        row = sweeps_against_plain(torch, ps, route, calls)
        fb_np = fb.cpu().numpy()
        share = float(np.isclose(got, ref, rtol=KERNEL_TOL,
                                 atol=KERNEL_TOL).all(axis=-1).mean())
        mean_rel = float((np.abs(got.mean(0) - ref.mean(0))
                          / np.abs(ref.mean(0))).max())
        frame_launches = row.pop("launches")
        served = {k: row.pop(k)[:16] for k in (
            "rays_served", "pairs", "rows", "segments", "tables_read")}
        phase("pair_main_path", route=route, tris=scene.triangles.count,
              size=f"{cfg.width}x{cfg.height}", max_bounces=cfg.max_bounces,
              frames=frames, launches=counts, seconds=round(seconds, 4),
              fb_mean=fb_np.mean(0).tolist(),
              frame_launches=frame_launches, **row, **served,
              share_within_tol=share, tol=KERNEL_TOL,
              mean_rel_diff=mean_rel, mean_route=got.mean(0).tolist(),
              mean_bvh=ref.mean(0).tolist())
        check(counts[own] > 0, f"{route}: its kernel was never launched")
        check(all(v == 0 for k, v in counts.items() if k != own),
              f"{route}: another traversal kernel ran: {counts}")
        if route == "pairbin":
            # One launch per bounce; a bounce whose rays reach no bin
            # launches nothing.
            check(counts[own] <= cfg.max_bounces * frames,
                  f"pairbin: {counts[own]} launches in {frames} frames")
        check(row["same_index"], f"{route}: kernel and plain indices differ "
              f"on the main path's launches")
        check(row["max_abs_err"] <= PAIR_T_TOL, f"{route}: kernel t off "
              f"plain by {row['max_abs_err']} on the main path's launches")
        check(np.isfinite(fb_np).all(), f"{route}: non-finite framebuffer")
        check(mean_rel <= PAIR_FRAME_MEAN_RTOL,
              f"{route}: frame mean {mean_rel:.4f} from the BVH route's")
        out[own] = {"launches": counts[own], "frame_launches": frame_launches,
                    "max_abs_err": row["max_abs_err"],
                    "plain_ms": row["plain_ms_per_launch"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                    "flops": row["flops"], "bytes": row["bytes"]}

    order = (None, "pairbin", "pair", "pair", "pairbin", None)
    samples = {r: [] for r in order}
    for route in order:
        with pair_dispatch(route):
            t = time_frames(torch, pt, device, scene, meta, cfg, view, 1 + 4)
        samples[route] += t[1:]
    kernels = {None: "bvh_closest_hit", "pairbin": "pairbin_sweep_kernel",
               "pair": "pair_sweep_kernel"}
    for route, t in samples.items():
        with pair_dispatch(route):
            dev_ms, rows = profile_device_ms(torch, one_frame, 2,
                                             {"kernel": [kernels[route]]})
        ms = statistics.median(t)
        phase("pair_timing", route=route or "bvh",
              tris=scene.triangles.count, size=f"{cfg.width}x{cfg.height}",
              max_bounces=cfg.max_bounces, ms_per_frame=ms, ms_min=min(t),
              ms_max=max(t), frames=len(t),
              traversal_kernel_ms_per_frame=dev_ms["kernel"],
              device_ms_per_frame=dev_ms["all"],
              device_busy_share=(dev_ms["all"] / ms if rows
                                 else "not measured"), card=smi)
        if route:
            k = out[f"{route}_sweep"]
            k["ms"] = (dev_ms["kernel"] / k["frame_launches"] if rows
                       else "not measured")
    return out


def user_layer_phase(torch, pt, device, frames=100, max_fps=200.0, k=3):
    """Phase 17: the renderer's perf log and FPS cap, checkpoint and resume
    in process, and the render command's --checkpoint / --resume."""
    import io

    import numpy as np
    from tpu_path_tracer_torch.utils.image import read_png

    scene, meta, _ = pt.builtin.reference_scene(device=device)
    cfg = pt.RenderConfig(width=512, height=512, max_bounces=4,
                          use_megakernel=True)
    renderer = pt.Renderer(scene, meta, cfg, log_performance=True,
                           max_fps=max_fps)
    log = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(log):
        renderer.render_animation(frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    lines = log.getvalue().splitlines()
    phase("user_layer", case="log_and_fps_cap", frames=frames,
          max_fps=max_fps, seconds=round(seconds, 4), report=lines,
          avg_ms=renderer.stats.avg_ms)
    check(len(lines) == 1 and lines[0].startswith(f"frames={frames} avg="),
          f"perf log: {lines}")
    check(seconds >= frames / max_fps, "the FPS cap did not hold")

    out_dir = os.path.join(REPO, "tpu_path_tracer_torch", "_build",
                           "chip_smoke_cli")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "resume.npz")
    whole = pt.Renderer(scene, meta, cfg)
    whole.render_animation(k, checkpoint_path=path, checkpoint_every=k)
    whole.render_animation(k)
    resumed = pt.Renderer(scene, meta, cfg)
    resumed.load_checkpoint(path)
    at = resumed.frame_num
    resumed.render_animation(k)
    diff = float((resumed.framebuffer - whole.framebuffer).abs().max())
    phase("user_layer", case="checkpoint_resume", checkpoint_at=at,
          frames=resumed.frame_num, max_abs_diff=diff,
          device=str(resumed.framebuffer.device))
    check(at == k and resumed.frame_num == whole.frame_num == 2 * k,
          "resume: frame counts")
    check(diff == 0.0, f"resumed framebuffer differs by {diff}")

    ck = os.path.join(out_dir, "cli.npz")
    png = os.path.join(out_dir, "cli_resumed.png")
    for f in (ck, png):
        if os.path.exists(f):
            os.remove(f)
    base = [sys.executable, "-m", "tpu_path_tracer_torch", "render",
            "--scene", "cornell", "--width", "128", "--height", "128",
            "--bounces", "4", "--frames", "2", "-o", png]
    outs = []
    start = time.perf_counter()
    for extra in (["--checkpoint", ck], ["--resume", ck, "--log-samples"]):
        proc = subprocess.run(base + extra, cwd=REPO, capture_output=True,
                              text=True, timeout=300)
        check(proc.returncode == 0, f"render {extra} failed: {proc.stderr}")
        outs.append(proc.stdout.strip().splitlines())
    seconds = time.perf_counter() - start
    cornell, cornell_meta, _ = pt.builtin.cornell_box(device=device)
    one_go = pt.Renderer(cornell, cornell_meta, pt.RenderConfig(
        width=128, height=128, max_bounces=4),
        pt.Camera(eye=[0.0, 0.0, 3.2], center=[0, 0, 0]))
    one_go.render_animation(4)
    levels = int(np.abs(read_png(png).astype(np.int32)
                        - one_go.display().astype(np.int32)).max())
    phase("user_layer", case="cli_checkpoint_resume",
          seconds=round(seconds, 2), first=outs[0][-3:], second=outs[1][-4:],
          png_max_level_diff=levels)
    check(any("checkpoint ->" in ln for ln in outs[0]), "no checkpoint line")
    check("resumed at frame 2" in outs[1], "the second run did not resume")
    check("Total Samples: 4" in outs[1], "--log-samples printed no count")
    # Two processes and this one run the same torch ops on the same card;
    # one 8-bit level allows for a rounding at a level's edge.
    check(levels <= 1, f"the resumed PNG is {levels} levels from 4 frames "
          f"in one go")


def run():
    import torch

    smi = device_phase(torch)
    import tpu_path_tracer_torch as pt

    ptxas = build_phase()
    device = torch.device("cuda", 0)
    max_err = compare_phase(torch, pt, device)
    golden_phase(torch, pt, device)
    launches, frame_ms = main_path_phase(torch, pt, device)
    times = timing_phase(torch, pt, device, smi)
    fwd_device_ms = profile_phase(torch, pt, device, frame_ms)
    grad_abs, grad_rel = grad_phase(torch, pt, device)
    train_launches = train_phase(torch, pt, device)
    train_times, kernel_ms = train_timing_phase(torch, pt, device, smi)
    trav = traversal_phase(torch, pt, device, smi)
    mesh_launches = mesh_main_path_phase(torch, pt, device)
    mesh_times = mesh_timing_phase(torch, pt, device, smi)
    mesh_train_phase(torch, pt, device)
    mesh_cli_phase(pt)
    pair_phase(torch, pt, device, smi)
    pair_kernels = pair_main_path_phase(torch, pt, device, smi)
    user_layer_phase(torch, pt, device)
    ref, ref_meta, _ = pt.builtin.reference_scene(device=device)
    fwd_bound = megakernel_bound(
        torch, pt, device, ref, ref_meta,
        pt.RenderConfig(width=512, height=512, max_bounces=4),
        [0.5, 0.0, 2.5], backward=False)
    cornell, cornell_meta, _ = pt.builtin.cornell_box(device=device)
    bwd_bound = megakernel_bound(torch, pt, device, cornell, cornell_meta,
                                 pt.RenderConfig(**TRAIN_KW), [0, 0, 3.2],
                                 backward=True)
    phase("bounds", megakernel_fwd=fwd_bound, megakernel_bwd=bwd_bound,
          bvh_closest_hit={k: trav[k] for k in ("bound_ms", "bound_by",
                                                "flops", "bytes")},
          **{name: {k: v[k] for k in ("bound_ms", "bound_by", "flops",
                                      "bytes")}
             for name, v in pair_kernels.items()})
    print(json.dumps({"kernels": [
        {"name": "megakernel_fwd", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES,
         "launches": train_launches["megakernel_fwd"],
         "max_abs_err": max_err, "ms": times["kernel"],
         "device_ms": fwd_device_ms,
         "plain_ms": times["plain"], "bound_ms": fwd_bound["bound_ms"],
         "bound_by": fwd_bound["bound_by"], "library_ms": None,
         **ptxas["megakernel_fwd"]},
        {"name": "megakernel_bwd", "route": "cuda", "source": BWD_SOURCE,
         "replaces": BWD_REPLACES,
         "launches": train_launches["megakernel_bwd"],
         "max_abs_err": grad_abs, "max_err_over_group_max": grad_rel,
         "ms": train_times["kernel"]["bwd_ms"],
         "plain_ms": train_times["plain"]["bwd_ms"],
         "device_ms": kernel_ms["megakernel_bwd"],
         "bound_ms": bwd_bound["bound_ms"], "bound_by": bwd_bound["bound_by"],
         "library_ms": None, **ptxas["megakernel_bwd"]},
        {"name": "bvh_closest_hit", "route": "cuda", "source": TRAV_SOURCE,
         "replaces": TRAV_REPLACES, "launches": mesh_launches,
         "max_abs_err": trav["max_abs_err"], "ms": trav["kernel_ms"],
         "plain_ms": trav["plain_ms"], "bound_ms": trav["bound_ms"],
         "bound_by": trav["bound_by"], "library_ms": None,
         "main_path_ms_per_launch":
             mesh_times["kernel_device_ms_per_launch"]}] + [
        {"name": name, "route": "cuda", "source": PAIR_SOURCE,
         "replaces": replaces, "launches": pair_kernels[name]["launches"],
         "max_abs_err": pair_kernels[name]["max_abs_err"],
         "ms": pair_kernels[name]["ms"],
         "plain_ms": pair_kernels[name]["plain_ms"],
         "bound_ms": pair_kernels[name]["bound_ms"],
         "bound_by": pair_kernels[name]["bound_by"], "library_ms": None,
         "launches_per_frame": pair_kernels[name]["frame_launches"]}
        for name, replaces in (("pairbin_sweep", PAIRBIN_REPLACES),
                               ("pair_sweep", PAIR_REPLACES))]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main():
    try:
        run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
