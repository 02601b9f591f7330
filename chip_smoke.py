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
   at 512x512 through the megakernel, with its launch count; then
   table_cache: frames of the Cornell box and of the reference scene
   through the wrapper's cache of packed tables (a pack on the first frame,
   a reuse on each other, the camera moved once, then an edit in place of
   the emission that repacks) against the same frames with a repack forced
   on every one, the framebuffers bit for bit;
6. frame times of the kernel and of the plain version at 512x512, and a
   torch.profiler breakdown of the main path's device time;
7. grad_vs_plain: the CUDA backward kernel against autograd of the
   wavefront on the card, from the same PCG states, at parameter level
   (``diff.params``): Cornell NEE at 64x64 with 4 and 6 bounces, the
   reference scene with every geometry group and the view matrix, a
   stratified spp 4 case, the 4-triangle tent, and the training path's own
   512x512 shapes; then the unroll-budget error on the card; then the
   backward's two kernels (the adjoint and the fold of its block rows):
   ptxas' registers, spills and shared memory, a block's dynamic shared
   memory and the blocks an SM holds on four scenes, and the fold kernel
   against its plain version on a 512x512 step's rows, bit for bit, with
   its time, its plain version's, torch.sum's and its bound;
8. train: the training path, ``dist.render_dist.make_train_step`` at
   512x512 on the Cornell box (NEE, emission and BSDF parameters, through
   the kernels) for 10 steps, as ``cli train`` sets it up, with the launch
   counts of the three kernels; then the 10 steps again from the same
   start, with the same losses, parameters and Adam state bit for bit, and
   one step under ``torch.use_deterministic_algorithms(True,
   warn_only=True)``, what it warns of reported;
9. train timing: fwd+bwd+Adam step times through the kernels and through
   the wavefront, in turns, the backward alone of each, and the backward
   kernels' device time from torch.profiler;
10. traversal_vs_plain: the CUDA traversal kernel against its plain
    version (the skip-link walk) on the card, from the same 65,536 rays:
    the same hit mask and triangle index on every lane and t equal bit for
    bit, at 81,920 and 327,680 triangles (median BVH) and on two meshes
    added twice (every hit an exact tie) through the median, SAH and LBVH
    builders; the packing kernel's tables against its plain version, bit
    for bit; the tree's depth; the skip-link walk's node visits and
    triangle tests beside the kernel's row fetches, slab tests and
    triangle tests (counted by the kernel's walk built for the host), the
    kernel's and the packing's device time and the walk's time;
11. mesh_main_path: the mesh path, ``Renderer.render_animation(8)`` of
    bench.py's 81,920-triangle mirror icosphere at 512x512 (4 bounces,
    NEE) with the traversal and packing kernels' launch counts, then one
    frame through the kernel and through the plain walk from the same PCG
    states;
12. mesh_timing: frame times through the kernel and the plain walk at
    512x512, through the kernel at 1024x1024 with 327,680 triangles, a
    torch.profiler breakdown of a mesh frame, and the four traversal
    launches of one frame replayed one by one (work, device time, bound);
    then mesh_megakernel: ``render_animation(8)`` of the same scene
    through the forward megakernel's BVH variant (``use_megakernel``),
    its launches and the BVH's packs counted, one frame of it against the
    wavefront with the traversal kernel from the same PCG states (the
    share of bit-equal pixels, the largest difference), its device time a
    frame against its bound, and ptxas' report of both instantiations of
    the forward kernel;
13. mesh_train: 3 steps of ``make_train_step`` on the mesh scene at
    512x512 over emission and vertices (the BVH refit runs every step);
    then train_bits: the wavefront's train steps run twice from one start
    (the harness's ``fwd_bwd`` and ``fwd_bwd_mesh`` gradients, phase 13's
    steps), held to the same bits, and what the detector of
    nondeterministic torch ops warns of in each;
14. mesh_cli: ``python -m tpu_path_tracer_torch render`` of an OBJ written
    by ``save_obj``, through a median BVH, on the card;
15. pair_vs_plain: the two pair-sweep kernels against their plain versions
    on the card, on the pair arrays of a real emission of phase 10's 65,536
    rays at 81,920 and 327,680 triangles; the emission's kernels
    (``csrc/pair_emit.cu``) against the torch emission on the same inputs,
    call by call (rows row for row and bit for bit, the reductions' results
    bit for bit), and each entry point against the same route with the
    torch emission (every index, every bit of t); host syncs per call and
    per round (torch.cuda's sync debug mode); then each entry point
    (``pairbin_closest_hit``, ``pair_closest_hit``) against the BVH
    kernel's answer (hit mask on every live lane, t on every lane whose
    edge-function sums are well conditioned, the others explained in
    float64), with rays, pairs and segments per launch, the kernel's, the
    emission kernels' and the rest of the call's device time and call
    times, with the card's emission and with the torch emission, and the
    BVH kernel's time beside them;
16. pair_main_path: the mesh path of phase 11 with ``pairbin_closest_hit``
    and ``pair_closest_hit`` in place of ``traversal.closest_hit``:
    launch counts of all three traversal kernels and the emission's
    wrappers, every launch of one frame against the plain version on the
    launch's own arguments and every emission call against the torch
    emission, what each of them served and its bound, one frame through
    each route against the BVH-kernel frame from the same PCG states, and
    frame times of the three routes with their kernels' device time;
17. user_layer: the renderer's perf log and FPS cap on the card, a
    checkpoint at frame k resumed in a new ``Renderer`` against an
    uninterrupted render, and ``render --checkpoint`` then ``--resume`` in
    subprocesses against the same frames in one go;
18. dist: ranks of a ``torch.distributed`` group started by this script
    (``--dist-rank``, with torch's launcher variables), after the build:
    (i) one rank over NCCL, 3 sharded train steps at 512x512 on the Cornell
    box through both megakernels against the one-process
    ``make_train_step``, and that step against itself, losses, parameters
    and gradients bit for bit, with the kernels' launch counts; (ii) two ranks over gloo sharing the card, each
    with its chunk on it: the reference scene's 512x512 frame through the
    forward megakernel and the 81,920-triangle mesh frame through the
    traversal kernel, each gathered against the one-process frame bit for
    bit, and the Cornell step's summed gradients within 1e-5 of each
    group's largest, with each rank's launch counts; (iii)
    ``measure_scaling`` at 512x512 over the two ranks (sharding overhead:
    they share one card); then ``render --devices 2 --megakernel`` against
    the one-process image.  Times stand beside the card's name and power
    limit;
19. bench: ``python -m tpu_path_tracer_torch bench``, the port's harness
    over bench.py's workloads (``tpu_path_tracer_torch.bench``), in a
    subprocess: exit 0, every row there (the monkey row may be skipped
    without its asset), the headline equal to ``fwd_bwd_megakernel_mrays``,
    every row's device time, bench.py's sanity gate; its line is printed
    with the phase.  When the script has used too much of its budget
    (SMOKE_BUDGET_S), three of its workloads alone;
20. preview_ranks: the tty preview with a scripted terminal (keys a, w,
    left, q) on two gloo ranks sharing the card, against the one-process
    preview: what the first rank painted, bit for bit, the camera on both
    ranks at every frame, the forward launches of each rank; and without a
    terminal both ranks fail.

Bounds: each kernel's least time on the card, the larger of its FP32
operations over the card's FP32 peak and its bytes (inputs read once,
outputs written once) over the memory rate, counted from this run's inputs
and what the paths actually did (``tpu_path_tracer_torch.utils.bounds``,
the count the harness's ``sol`` row reads too).

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  In it the forward megakernel's
``ms`` is the time of a whole 512x512 frame through the kernel (phase 6:
packing, seeding, the kernel and accumulation) and its ``device_ms`` the
kernel's own device time per frame (phase 6's profile); the backward's
``ms`` is a train step's backward and its ``device_ms`` the kernel's own
(phase 9).  The forward's BVH variant, ``megakernel_fwd_bvh``, has a row
of its own: ``ms`` a mesh frame through the renderer, ``device_ms`` the
kernel's own (phase 12).  The megakernel rows also carry what ptxas
reported at the build (``registers``, ``spill_bytes``, static ``smem_bytes``,
``stack_bytes``), as do the traversal kernel's, the packing kernel's
and the pair sweeps' rows; the emission's rows (``emit_pairbin``,
``pairbin_best``, ``emit_pair``, ``pair_advance``: one launch counted per
wrapper call, which launches the kernels it names) carry them per kernel
under ``kernels``.  Imports nothing of JAX.
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

from tpu_path_tracer_torch.bench import (KERNEL_MEAN_RTOL, KERNEL_MIN_SHARE,
                                         KERNEL_TOL, mesh_scene)
from tpu_path_tracer_torch.utils.bounds import (
    EDGE_REST_FLOPS, EDGE_SIGN_FLOPS, PAIR_INV_FLOPS, PAIR_SLAB_FLOPS,
    PEAK_FP32_FLOPS, PEAK_HBM_BYTES, bound, counted_walk, megakernel_bound,
    pack_bound, traversal_bound)
from tpu_path_tracer_torch.utils.profiling import (counts, device_us,
                                                   kernel_rows,
                                                   profile_device_ms)

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
KERNEL_SOURCE = "tpu_path_tracer_torch/csrc/megakernel_fwd.cu"
KERNEL_REPLACES = "tpu_path_tracer/kernels/pallas/megakernel.py:765"
BWD_SOURCE = "tpu_path_tracer_torch/csrc/megakernel_bwd.cu"
BWD_REPLACES = "tpu_path_tracer/kernels/pallas/megakernel.py:804"
# The backward's fold of its block rows: the TPU kernel's sum over its
# sequential grid into revisited output blocks.
FOLD_REPLACES = "tpu_path_tracer/kernels/pallas/megakernel.py:852"
TRAV_SOURCE = "tpu_path_tracer_torch/csrc/traversal.cu"
TRAV_REPLACES = ("tpu_path_tracer/kernels/pallas/traversal.py:752, "
                 "tpu_path_tracer/kernels/pallas/traversal.py:865")
TRAV_KERNEL = "bvh_stack_walk_kernel"
# The traversal kernel's tables, packed on the card every call; the TPU
# kernels' tables are built by pack_tris with XLA ops.
PACK_KERNEL = "bvh_pack_kernel"
PACK_REPLACES = "tpu_path_tracer/kernels/pallas/traversal.py:145"
PAIR_SOURCE = "tpu_path_tracer_torch/csrc/pair_sweep.cu"
PAIRBIN_REPLACES = "tpu_path_tracer/kernels/pallas/traversal.py:1417"
PAIR_REPLACES = "tpu_path_tracer/kernels/pallas/traversal.py:1723"
# The emission on the card (csrc/pair_emit.cu) has no TPU kernel: its
# counterparts are the JAX emission around the TPU kernels, XLA ops in
# _pairbin_path and pair_closest_hit.
EMIT_SOURCE = "tpu_path_tracer_torch/csrc/pair_emit.cu"
EMIT_REPLACES = {
    "emit_pairbin": "tpu_path_tracer/kernels/pallas/traversal.py:1447",
    "pairbin_best": "tpu_path_tracer/kernels/pallas/traversal.py:1447",
    "emit_pair": "tpu_path_tracer/kernels/pallas/traversal.py:1755",
    "pair_advance": "tpu_path_tracer/kernels/pallas/traversal.py:1755"}

# Phase 3's tolerance (KERNEL_TOL, KERNEL_MIN_SHARE, KERNEL_MEAN_RTOL) is
# the harness's (tpu_path_tracer_torch.bench), which holds the forward
# kernel to it before each of its timed rows.
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
# backward sums table gradients in a fixed order of its own (lanes, warps,
# blocks), and the wavefront's autograd sums in another order.
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


def launches_since(before, *kernels):
    """The launches of each of ``kernels`` since ``before``, a copy of the
    program's counters (``utils.profiling.counts``)."""
    now = counts()
    return {k: now[k] - before[k] for k in kernels}


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
    out = {name: _build.ptxas_report(text, f"{name}_kernel")
           for name in ("megakernel_fwd", "megakernel_fwd_bvh",
                        "megakernel_bwd",
                        "megakernel_bwd_fold", "bvh_stack_walk", "bvh_pack",
                        "pairbin_sweep", "pair_sweep")}
    # The emission's kernels; the two emitting ones are templates with a
    # counting (false) and a scattering (true) instance.
    for kernel in {k for ks in EMIT_WRAPPER_KERNELS.values() for k in ks}:
        if kernel.endswith("emit_kernel"):
            for flag, step in (("0", "count"), ("1", "scatter")):
                out[f"{kernel}.{step}"] = _build.ptxas_report(
                    text, f"{kernel}ILb{flag}E")
        else:
            out[kernel] = _build.ptxas_report(text, kernel)
    return out


def kernel_vs_plain(torch, pt, device, scene_fn, eye, cfg, frame=3):
    """Megakernel and wavefront radiance from the same PCG states."""
    from tpu_path_tracer_torch.core import rng
    from tpu_path_tracer_torch.integrator.render import pixel_grid
    from tpu_path_tracer_torch.kernels import megakernel as mk

    scene, meta, _ = scene_fn(device=device)
    view = torch.as_tensor(pt.Camera(eye=eye, center=[0, 0, 0]).view_matrix,
                           device=device)
    pix, px, py = pixel_grid(cfg.width, cfg.height, device)
    check(mk.route(scene, meta, cfg.replace(use_megakernel=True), view,
                   px.device).tracer == mk.TABLES,
          "megakernel does not support scene")
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

    scene, meta, _ = pt.builtin.reference_scene(device=device)
    cfg = pt.RenderConfig(width=512, height=512, max_bounces=4,
                          use_megakernel=True)
    renderer = pt.Renderer(scene, meta, cfg)
    torch.cuda.synchronize()
    before = counts()
    t0 = time.perf_counter()
    fb = renderer.render_animation(frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launches_since(before, "megakernel_fwd")["megakernel_fwd"]
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


TABLE_CACHE_FRAMES = 6


def cached_frames(torch, pt, device, make, eye, cfg, repack):
    """The framebuffer after each of TABLE_CACHE_FRAMES frames of ``make``'s
    scene through the megakernel wrapper, the camera moved before frame 3
    and the emission doubled in place before frame 5; with ``repack`` the
    wrapper's cache is emptied before every frame.  Returns them and the
    packs and reuses counted."""
    from tpu_path_tracer_torch.kernels import megakernel as mk

    scene, meta, _ = getattr(pt.builtin, make)(device=device)
    renderer = pt.Renderer(scene, meta, cfg, camera=pt.Camera(eye=eye))
    mk.clear_table_cache()
    before = counts()
    fbs = []
    for f in range(TABLE_CACHE_FRAMES):
        if f == 2:
            renderer.camera.set_camera(eye=[e + 0.1 for e in eye])
        if f == 4:
            scene.materials.emission.mul_(2.0)
        if repack:
            mk.clear_table_cache()
        fbs.append(renderer.step().clone())
    torch.cuda.synchronize()
    mk.clear_table_cache()
    return fbs, launches_since(before, "table_packs", "table_cache_hits")


def table_cache_phase(torch, pt, device):
    """Frames through the wrapper's cache of packed tables against the same
    frames repacked every frame, bit for bit, with the packs counted."""
    for make, eye, cfg in (
            ("cornell_box", [0.0, 0.0, 3.2],
             pt.RenderConfig(width=512, height=512, max_bounces=4,
                             importance_sampling=True, use_megakernel=True)),
            ("reference_scene", [0.5, 0.0, 2.5],
             pt.RenderConfig(width=900, height=600, max_bounces=100,
                             use_megakernel=True))):
        cached, packs = cached_frames(torch, pt, device, make, eye, cfg,
                                      False)
        fresh, repacks = cached_frames(torch, pt, device, make, eye, cfg,
                                       True)
        differ = [f for f, (a, b) in enumerate(zip(cached, fresh))
                  if not torch.equal(a.view(torch.int32),
                                     b.view(torch.int32))]
        phase("table_cache", scene=make, frames=TABLE_CACHE_FRAMES,
              cached=packs, repacked=repacks, frames_differing=differ)
        check(not differ, f"{make}: cached frames {differ} differ from "
                          f"repacked ones")
        check(packs == {"table_packs": 2,
                        "table_cache_hits": TABLE_CACHE_FRAMES - 2},
              f"{make}: the cache counted {packs}")
        check(repacks == {"table_packs": TABLE_CACHE_FRAMES,
                          "table_cache_hits": 0},
              f"{make}: forced repacks counted {repacks}")


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

    view0 = torch.as_tensor(pt.Camera(eye=eye, center=[0, 0, 0]).view_matrix,
                            device=device)
    pix, px, py = pixel_grid(cfg.width, cfg.height, device)
    check(mk.route(scene, meta, cfg.replace(use_megakernel=True),
                   view0.clone().requires_grad_(), px.device)
          == mk.Route(mk.TABLES, True), "no differentiable route")
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
    before = counts()
    rad = trace(params, mk.path_trace_pixels_megakernel)
    loss_k = torch.mean((rad - target) ** 2)
    got = torch.autograd.grad(loss_k, list(params.values()),
                              allow_unused=True)
    torch.cuda.synchronize()
    check(launches_since(before, "megakernel_fwd", "megakernel_bwd")
          == {"megakernel_fwd": 1, "megakernel_bwd": 1},
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


# Phase 7's scenes for the backward's occupancy: (spheres, quads,
# triangles); the last two hold the most triangles the megakernel takes.
BWD_SCENES = {"cornell_box": (2, 6, 0), "reference_scene": (19, 8, 12),
              "cornell_box_64_tris": (2, 6, 64),
              "reference_scene_64_tris": (19, 8, 64)}


def bwd_fold_phase(torch, pt, device, smi, ptxas, calls=200):
    """Phase 7 (end): the backward's two kernels.  What ptxas reported for
    each; a block's dynamic shared memory and the blocks an SM holds
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for BWD_SCENES; then
    the fold kernel against its plain version on the block rows of a
    512x512 Cornell step, bit for bit, with its device time, the plain
    version's, torch.sum's over the same rows and its bound (bytes: the
    rows read once, the sum written once); times per call by CUDA events
    and device times by torch.profiler.  Returns the phase's numbers."""
    import ctypes
    import types

    import numpy as np
    from tpu_path_tracer_torch.core import rng
    from tpu_path_tracer_torch.integrator.render import pixel_grid
    from tpu_path_tracer_torch.kernels import _build
    from tpu_path_tracer_torch.kernels import megakernel as mk

    occupancy = _build.load().tpt_megakernel_bwd_blocks_per_sm
    occupancy.argtypes = [ctypes.c_int] * 3
    occupancy.restype = ctypes.c_int
    blocks = {}
    for name, counts in BWD_SCENES.items():
        families = [types.SimpleNamespace(count=c) for c in counts]
        shape = types.SimpleNamespace(spheres=families[0], quads=families[1],
                                      triangles=families[2])
        blocks[name] = {"counts": counts,
                        "smem_bytes": mk.bwd_smem_bytes(shape),
                        "blocks_per_sm": occupancy(*counts)}
    phase("grad_vs_plain", case="backward_kernels", card=smi,
          kernels={k: ptxas[k] for k in ("megakernel_bwd",
                                         "megakernel_bwd_fold")},
          blocks=blocks)
    check(all(b["blocks_per_sm"] > 0 for b in blocks.values()),
          f"a backward block does not fit an SM: {blocks}")

    # The rows of a 512x512 Cornell step at frame 1, from a seeded
    # cotangent of the gradients' scale.
    cfg = pt.RenderConfig(**TRAIN_KW)
    scene, meta, _ = pt.builtin.cornell_box(device=device)
    view = torch.as_tensor(pt.Camera(eye=[0, 0, 3.2], center=[0, 0, 0])
                           .view_matrix, device=device, dtype=torch.float32)
    pix, px, py = pixel_grid(cfg.width, cfg.height, device)
    args = mk._prepare(rng.seed(pix, 1), px, py,
                       mk.pack_tables(scene) + (view,), scene)
    g = np.random.default_rng(5).normal(size=(px.shape[0], 3)) * 1e-6
    gout = torch.as_tensor(g, dtype=torch.float32, device=device)
    rows = mk._launch_bwd_rows(*args, gout, scene, meta, cfg)
    got, plain = mk.fold_rows(rows), mk.fold_rows_plain(rows)
    exact = rows.double().sum(0)
    scale = float(exact.abs().max())
    fns = {"": lambda: mk.fold_rows(rows),
           "plain_": lambda: mk.fold_rows_plain(rows),
           "library_": lambda: torch.sum(rows, 0)}
    times = {f"{k}ms": time_events(torch, fn, calls) for k, fn in fns.items()}
    times.update({f"{k}device_ms": profile_device_ms(fn, 20, {})[0]["all"]
                  for k, fn in fns.items()})
    nbytes = 4 * (rows.numel() + rows.shape[1])
    bound_ms, bound_by = bound(rows.numel(), nbytes)
    out = {"rows": list(rows.shape), "bit_equal": bool(torch.equal(got,
                                                                    plain)),
           "max_abs_err": float((got - plain).abs().max()),
           "max_abs_err_vs_float64_over_max":
               float((got.double() - exact).abs().max()) / max(scale, 1e-30),
           **times, "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "flops": rows.numel()}
    phase("grad_vs_plain", case="fold_vs_plain", card=smi, **out)
    check(out["bit_equal"], "the fold kernel differs from its plain version")
    return out


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
    return step, params, target, view, optimizer


def train_run(torch, pt, device, steps):
    """``steps`` train steps of :func:`train_setup` through the kernels;
    returns the losses, the parameters and the Adam state after them, the
    seconds the steps took and the kernels' launches in them."""
    step, params, target, view, optimizer = train_setup(torch, pt, device,
                                                        True)
    torch.cuda.synchronize()
    before = counts()
    t0 = time.perf_counter()
    losses = [step(params, target, 1, view) for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launches_since(before, "megakernel_fwd", "megakernel_bwd",
                              "megakernel_bwd_fold")
    state = {f"{k}.{name}": v for k, p in params.items()
             for name, v in optimizer.state[p].items()}
    return (torch.stack(losses), {k: p.detach() for k, p in params.items()},
            state, seconds, launches)


def nondeterministic_ops(torch, fn):
    """The detector: runs ``fn`` once under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` (set here
    and restored after) and returns what it warned of, {message: where the
    warning was raised}."""
    import warnings

    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
    return {str(w.message)[:200]: f"{os.path.relpath(w.filename, REPO)}:"
            f"{w.lineno}" for w in caught
            if "determinis" in str(w.message)}


def train_phase(torch, pt, device, steps=10):
    """Phase 8, the training path: 10 steps through the kernels, the
    launch counts read around the steps alone; then the same 10 steps again
    from the same start, which must give the same losses, parameters and
    Adam state bit for bit, and one step under the detector of
    nondeterministic torch ops."""
    import numpy as np

    losses, params, state, seconds, launches = train_run(torch, pt, device,
                                                         steps)
    losses_r, params_r, state_r, _, _ = train_run(torch, pt, device, steps)
    bits = {"losses_bit_equal": bool(torch.equal(losses, losses_r)),
            "params_bit_equal": all(torch.equal(v, params_r[k])
                                    for k, v in params.items()),
            "adam_state_bit_equal": state.keys() == state_r.keys() and all(
                torch.equal(v, state_r[k]) for k, v in state.items()),
            "max_param_abs_diff": max(float((v - params_r[k]).abs().max())
                                      for k, v in params.items())}
    step, p0, target, view, _ = train_setup(torch, pt, device, True)
    detector = nondeterministic_ops(torch, lambda: step(p0, target, 1, view))
    losses = losses.tolist()
    phase("train", scene="cornell_box",
          size=f"{TRAIN_KW['width']}x{TRAIN_KW['height']}",
          max_bounces=TRAIN_KW["max_bounces"], groups=list(TRAIN_GROUPS),
          steps=steps, losses=losses, launches=launches,
          seconds=round(seconds, 4), second_run=bits, detector=detector)
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(losses[-1] < losses[0], "the training loss did not fall")
    check(launches == {"megakernel_fwd": steps, "megakernel_bwd": steps,
                       "megakernel_bwd_fold": steps},
          f"launches {launches} for {steps} steps")
    for k, v in params.items():
        check(bool(torch.isfinite(v).all()), f"non-finite parameter {k}")
    check(bits["losses_bit_equal"] and bits["params_bit_equal"]
          and bits["adam_state_bit_equal"],
          f"two runs of the train steps from one start differ: {bits}")
    return launches


def time_train_steps(torch, pt, device, use_megakernel, warmup=2, steps=8):
    """Per step: the whole fwd+bwd+Adam step, and its backward alone
    (CUDA events around loss.backward())."""
    from tpu_path_tracer_torch.diff.params import apply_params
    from tpu_path_tracer_torch.dist import render_dist

    step, params, target, view, _ = train_setup(torch, pt, device,
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

    step, params, target, view, _ = train_setup(torch, pt, device, True)
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
    busy_ms = sum(device_us(e) for e in rows) / 1e3 / steps
    kernel_ms = {}
    for name in ("megakernel_fwd", "megakernel_bwd", "megakernel_bwd_fold"):
        mine = [e for e in rows if f"{name}_kernel" in e.key]
        kernel_ms[name] = (sum(device_us(e) for e in mine) / 1e3 / steps
                           if mine else "not measured")
    phase("train_profile", steps=steps,
          device_ms_per_step=busy_ms if rows else "not measured",
          step_wall_ms=out["kernel"]["step_ms"],
          kernel_device_ms_per_step=kernel_ms,
          top=[{"name": e.key[:60], "calls": e.count,
                "ms_per_step": device_us(e) / 1e3 / steps}
               for e in rows[:8]])
    return out, kernel_ms


@contextlib.contextmanager
def recorded_traversal(calls):
    """Keep the arguments of every BVH closest-hit search find_hit makes,
    ``(origin, direction, bvh, triangles, t_min, t_best0)`` copied, and
    answer through the wrapper."""
    from tpu_path_tracer_torch.kernels import traversal

    kernel = traversal.closest_hit

    def recording(origin, direction, bvh, tris, t_min, t_best0):
        calls.append((origin.clone(), direction.clone(), bvh, tris, t_min,
                      t_best0.clone()))
        return kernel(origin, direction, bvh, tris, t_min, t_best0)

    traversal.closest_hit = recording
    try:
        yield
    finally:
        traversal.closest_hit = kernel


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


# Phase 10's doubled meshes: (name, mesh, radius the rays aim at, seed).
TIE_MESHES = (
    ("ico_twice", lambda pt: pt.procedural.icosphere(MESH_SUBDIVISIONS[0],
                                                     0.8), 0.8, 3),
    ("cube_twice", lambda pt: pt.procedural.cube(), 0.270893, 7))


def tie_scene(pt, device, make, builder):
    """A mesh added twice at the same place, so that every hit is an exact
    tie between two copies of one triangle, through ``builder``."""
    b = pt.SceneBuilder()
    white = b.add_material("white", pt.LAMBERTIAN, [0.73, 0.73, 0.73])
    for _ in range(2):
        b.add_mesh(make(pt), white)
    return b.build(bvh=builder, device=device)


def traversal_vs_plain(torch, scene, meta, rays, t_min, name):
    """The traversal kernel against the plain walk, and the packing kernel
    against its plain version, on one scene and bundle; the kernel's walk
    run again on the host over the card's tables counts its work.  Returns
    the phase's row (checked), the counts and the kernel's indices."""
    import numpy as np
    from tpu_path_tracer_torch.kernels import traversal

    bvh, tris = scene.bvh, scene.triangles
    o, d, t0 = rays
    rows, tri_rows = traversal.pack_bvh(bvh, tris)
    p_rows, p_tris = traversal.pack_bvh_plain(bvh, tris)
    pack_equal = (torch.equal(rows.view(torch.int32),
                              p_rows.view(torch.int32))
                  and torch.equal(tri_rows.view(torch.int32),
                                  p_tris.view(torch.int32)))
    pack_err = max(float((rows[:, :12] - p_rows[:, :12]).abs()
                         .nan_to_num(0.0).max()),
                   float((tri_rows - p_tris).abs().max()))
    t_k, i_k = traversal.closest_hit(o, d, bvh, tris, t_min, t0)
    torch.cuda.synchronize()
    stats = {}
    start = time.perf_counter()
    t_p, i_p = traversal.bvh_closest_hit(o, d, bvh, tris, t_min, t0,
                                         meta.max_leaf, stats=stats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - start) * 1e3
    t_h, i_h, n_rows, n_tests = counted_walk(rows, tri_rows, o, d, t0,
                                             t_min)
    t_k, i_k, t_p, i_p = (x.cpu().numpy() for x in (t_k, i_k, t_p, i_p))
    n = len(i_p)
    dead = t0.cpu().numpy() < 0
    hit = i_p >= 0
    row = {"tris": tris.count, "nodes": bvh.count, "rows": rows.shape[0],
           "depth": int(traversal.tree_depth(bvh)),
           "same_index": float((i_k == i_p).mean()),
           "same_hit_mask": bool(((i_k >= 0) == hit).all()),
           "max_abs_err": (float(np.abs(t_k[hit] - t_p[hit]).max())
                           if hit.any() else 0.0),
           "t_bit_equal": bool((t_k.view(np.uint32)
                                == t_p.view(np.uint32)).all()),
           "host_walk_equal": bool((i_h == i_k).all() and (
               t_h.view(np.uint32) == t_k.view(np.uint32)).all()),
           "retired_all_miss": bool((i_k[dead] == -1).all()),
           "hit_share": float(hit.mean()),
           "pack_bit_equal": bool(pack_equal), "pack_max_abs_err": pack_err,
           "walk_node_visits_per_ray": stats["node_visits"] / n,
           "walk_tri_tests_per_ray": stats["tri_tests"] / n,
           "walk_iterations": stats["iterations"],
           "row_fetches_per_ray": n_rows / n,
           "slab_tests_per_ray": 2 * n_rows / n,
           "tri_tests_per_ray": n_tests / n, "plain_ms": plain_ms}
    check(row["pack_bit_equal"], f"{name}: packed tables differ from the "
          f"plain packing by {pack_err}")
    check(row["same_hit_mask"], f"{name}: hit masks differ")
    check(row["same_index"] == 1.0, f"{name}: triangle indices differ on "
          f"{1 - row['same_index']:.2e} of lanes")
    check(row["max_abs_err"] <= TRAV_T_TOL,
          f"{name}: t differs by {row['max_abs_err']}")
    check(row["t_bit_equal"], f"{name}: t differs in its bits")
    check(row["host_walk_equal"], f"{name}: the host build of the walk "
          f"differs from the kernel")
    check(row["retired_all_miss"], f"{name}: a retired lane hit")
    check(row["hit_share"] > 0.3, f"{name}: the rays miss the mesh")
    return row, {"rows": n_rows, "tri_tests": n_tests}, i_k


def traversal_phase(torch, pt, device, smi):
    """Phase 10: the traversal kernel against the plain walk on the card,
    from the same rays, at both mesh sizes (median BVH, timed) and on the
    doubled meshes through every builder.  Returns the 81,920-triangle
    case's numbers for the kernels line."""
    import numpy as np
    from tpu_path_tracer_torch.accel import native
    from tpu_path_tracer_torch.kernels import traversal

    t_min = pt.RenderConfig().t_min
    builder = "native" if native.available() else "numpy"
    out = {}
    for sub in MESH_SUBDIVISIONS:
        timings = {}
        scene, meta = mesh_scene(sub, device, timings)
        bvh, tris = scene.bvh, scene.triangles
        rays = tuple(torch.from_numpy(x).to(device) for x in traversal_rays(
            TRAV_RAYS, sub, 0.8, tris.a.cpu().numpy()))
        row, work, _ = traversal_vs_plain(torch, scene, meta, rays, t_min,
                                          f"{tris.count} triangles")

        def call():
            traversal.closest_hit(*rays[:2], bvh, tris, t_min, rays[2])

        call_ms = time_events(torch, call, 20)
        pack_ms = time_events(
            torch, lambda: traversal.pack_bvh(bvh, tris), 20)
        pack_plain_ms = time_events(
            torch, lambda: traversal.pack_bvh_plain(bvh, tris), 5)
        dev_ms, _ = profile_device_ms(call, 10,
                                      {"kernel": [TRAV_KERNEL],
                                       "pack": [PACK_KERNEL]})
        b = traversal_bound(TRAV_RAYS, row["rows"], tris.count, work)
        pb = pack_bound(bvh.count, row["rows"], tris.count)
        row.update(case="bundle", builder=builder,
                   bvh_build_s=timings["bvh_build_s"],
                   kernel_ms=dev_ms["kernel"], call_ms=call_ms,
                   pack_kernel_ms=dev_ms["pack"], pack_ms=pack_ms,
                   pack_plain_ms=pack_plain_ms,
                   pack_bound_ms=pb["bound_ms"],
                   pack_bound_by=pb["bound_by"], **b)
        phase("traversal_vs_plain", rays=TRAV_RAYS, card=smi, **row)
        out[sub] = row
    for mesh, make, radius, seed in TIE_MESHES:
        for method in ("median", "sah", "lbvh"):
            scene, meta = tie_scene(pt, device, make, method)
            tris = scene.triangles
            corners = torch.cat([tris.a, tris.b, tris.c], 1).cpu().numpy()
            rays = tuple(torch.from_numpy(x).to(device) for x in
                         traversal_rays(TRAV_RAYS, seed, radius,
                                        corners[:, :3]))
            row, _, i_k = traversal_vs_plain(torch, scene, meta, rays,
                                             t_min, f"{mesh}, {method}")
            # Each triangle's copy: the rows of equal corners come in pairs.
            _, group = np.unique(corners.view(np.uint32), axis=0,
                                 return_inverse=True)
            order = np.argsort(group.ravel(), kind="stable")
            twin = np.empty(len(order), np.int64)
            twin[order[0::2]], twin[order[1::2]] = order[1::2], order[0::2]
            won = i_k[i_k >= 0]
            phase("traversal_vs_plain", case=mesh, rays=TRAV_RAYS,
                  bvh=method, builder=builder, card=smi,
                  lower_copy_share=float((won < twin[won]).mean()), **row)
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

    scene, meta = mesh_scene(MESH_SUBDIVISIONS[0], device)
    check(meta.traversal == "bvh", "the mesh scene has no BVH")
    cfg = pt.RenderConfig(**MESH_KW)
    renderer = pt.Renderer(scene, meta, cfg,
                           pt.Camera(eye=MESH_EYE, center=[0, 0, 0]))
    torch.cuda.synchronize()
    before = counts()
    start = time.perf_counter()
    fb = renderer.render_animation(frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches, pack_launches = launches_since(
        before, "bvh_closest_hit", "bvh_pack").values()
    fb_np = fb.cpu().numpy()
    img = renderer.display()
    png = os.path.join(REPO, "tpu_path_tracer_torch", "_build",
                       "chip_smoke_mesh_512.png")
    os.makedirs(os.path.dirname(png), exist_ok=True)
    renderer.save_png(png)
    phase("mesh_main_path", tris=scene.triangles.count, frames=frames,
          max_bounces=cfg.max_bounces, launches=launches,
          pack_launches=pack_launches, seconds=round(seconds, 4),
          fb_mean=fb_np.mean(0).tolist(),
          image_std=float(img.std()), png=os.path.relpath(png, REPO))
    check(launches == cfg.max_bounces * frames,
          f"traversal kernel launched {launches} times for {frames} frames "
          f"of {cfg.max_bounces} bounces")
    check(pack_launches == launches,
          f"packing kernel launched {pack_launches} times for {launches} "
          f"traversal launches")
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
    return launches, pack_launches


def mesh_timing_phase(torch, pt, device, smi):
    """Phase 12: median frame times at 512x512 and 81,920 triangles through
    the kernel and through the plain walk, in turns (plain, kernel,
    kernel, plain); through the kernel at 1024x1024 with 327,680
    triangles; the device time of a 512x512 mesh frame by kernel and the
    packing's time per launch."""
    from tpu_path_tracer_torch.integrator.render import render_frame
    from tpu_path_tracer_torch.kernels import traversal

    view = pt.Camera(eye=MESH_EYE, center=[0, 0, 0]).view_matrix
    scene, meta = mesh_scene(MESH_SUBDIVISIONS[0], device)
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

    dev_ms, rows = profile_device_ms(one_frame, 4,
                                     {"traversal": [TRAV_KERNEL],
                                      "pack": [PACK_KERNEL]})
    pack_ms = time_events(
        torch, lambda: traversal.pack_bvh(scene.bvh, scene.triangles), 20)
    phase("mesh_profile", tris=scene.triangles.count,
          size=f"{cfg.width}x{cfg.height}", frames=4,
          pack_ms_per_launch=pack_ms,
          pack_device_ms_per_frame=dev_ms["pack"],
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
    out["pack_device_ms_per_launch"] = (
        dev_ms["pack"] / cfg.max_bounces if rows else "not measured")
    out["bound_ms_per_launch"] = mesh_launches(torch, pt, scene, meta, cfg,
                                               view, smi)

    big, big_meta = mesh_scene(MESH_SUBDIVISIONS[1], device)
    big_cfg = cfg.replace(width=2 * cfg.width, height=2 * cfg.height)
    t = time_frames(torch, pt, device, big, big_meta, big_cfg, view, 1 + 4)
    phase("mesh_timing", version="kernel", tris=big.triangles.count,
          size=f"{big_cfg.width}x{big_cfg.height}", max_bounces=big_cfg.max_bounces,
          ms_per_frame=statistics.median(t[1:]), ms_min=min(t[1:]),
          ms_max=max(t[1:]), frames=len(t) - 1, card=smi)
    return out


def mesh_megakernel_phase(torch, pt, device, smi, ptxas, frames=8):
    """Phase 12's megakernel: the mesh scene through the forward kernel's
    BVH variant; returns its row of the kernels line."""
    import numpy as np
    from tpu_path_tracer_torch.core import rng
    from tpu_path_tracer_torch.integrator.render import pixel_grid
    from tpu_path_tracer_torch.kernels import megakernel as mk

    scene, meta = mesh_scene(MESH_SUBDIVISIONS[0], device)
    cfg = pt.RenderConfig(**MESH_KW, use_megakernel=True)
    camera = pt.Camera(eye=MESH_EYE, center=[0, 0, 0])
    view = torch.as_tensor(camera.view_matrix, device=device)
    check(mk.route(scene, meta, cfg, view, view.device).tracer == mk.BVH,
          "the mesh scene does not take the megakernel's BVH variant")
    renderer = pt.Renderer(scene, meta, cfg, camera)
    torch.cuda.synchronize()
    before = counts()
    start = time.perf_counter()
    renderer.render_animation(frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launches_since(before, "megakernel_fwd_bvh", "megakernel_fwd",
                              "bvh_closest_hit", "bvh_pack", "table_packs")
    check(launches == {"megakernel_fwd_bvh": frames, "megakernel_fwd": 0,
                       "bvh_closest_hit": 0, "bvh_pack": 1,
                       "table_packs": 1},
          f"{frames} mesh frames through the megakernel launched {launches}")

    pix, px, py = pixel_grid(cfg.width, cfg.height, device)
    state = rng.seed(pix, 3)
    with torch.no_grad():
        got = mk.path_trace_pixels_megakernel(state, view, px, py, scene,
                                              meta, cfg).cpu().numpy()
        ref = mk.path_trace_pixels_reference(state, view, px, py, scene,
                                             meta, cfg).cpu().numpy()
    bits = float((got.view(np.int32) == ref.view(np.int32)).all(-1).mean())
    share = float(np.isclose(got, ref, rtol=KERNEL_TOL,
                             atol=KERNEL_TOL).all(axis=-1).mean())
    max_err = float(np.abs(got - ref).max())
    check(share >= KERNEL_MIN_SHARE,
          f"mesh megakernel frame: only {share:.4f} of pixels within "
          f"{KERNEL_TOL}")
    check(np.allclose(got.mean(0), ref.mean(0), rtol=KERNEL_MEAN_RTOL,
                      atol=1e-6), "mesh megakernel frame: image means differ")

    # The bound counts the paths of frame 1 (megakernel_bound).
    state = rng.seed(pix, 1)

    def one_frame():
        with torch.no_grad():
            mk.path_trace_pixels_megakernel(state, view, px, py, scene, meta,
                                            cfg)

    dev_ms, _ = profile_device_ms(one_frame, 10,
                                  {"kernel": ["megakernel_fwd_bvh"]})
    b = megakernel_bound(scene, meta, cfg, MESH_EYE, backward=False)
    kernel_ms = dev_ms["kernel"]
    phase("mesh_megakernel", tris=scene.triangles.count,
          size=f"{cfg.width}x{cfg.height}", max_bounces=cfg.max_bounces,
          frames=frames, launches=launches, seconds=round(seconds, 4),
          bit_equal_share=bits, share_within_tol=share, tol=KERNEL_TOL,
          max_abs_err=max_err, device_ms_per_frame=kernel_ms,
          bound_ms=b["bound_ms"], bound_by=b["bound_by"],
          share_of_bound=(b["bound_ms"] / kernel_ms
                          if isinstance(kernel_ms, float) else
                          "not measured"),
          walk_rows=b["walk_rows"], walk_tri_tests=b["walk_tri_tests"],
          card=smi, ptxas={k: ptxas[k] for k in ("megakernel_fwd",
                                                 "megakernel_fwd_bvh")})
    return {"name": "megakernel_fwd_bvh", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
            "launches": launches["megakernel_fwd_bvh"],
            "max_abs_err": max_err, "bit_equal_share": bits,
            "ms": 1e3 * seconds / frames, "device_ms": kernel_ms,
            "plain_ms": None, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": None,
            **ptxas["megakernel_fwd_bvh"]}


def mesh_launches(torch, pt, scene, meta, cfg, view, smi):
    """Phase 12's launches of one mesh frame (frame 3), recorded and
    replayed one by one: live rays, the kernel's work (counted by its walk
    on the host) and device time, and each launch's bound.  Returns the
    launches' mean bound."""
    from tpu_path_tracer_torch.integrator.render import render_frame
    from tpu_path_tracer_torch.kernels import traversal

    calls = []
    with recorded_traversal(calls):
        render_frame(torch.zeros((cfg.width * cfg.height, 3),
                                 device=scene.bvh.mins.device), 3, True, view,
                     scene, meta, cfg)
    check(len(calls) == cfg.max_bounces, f"{len(calls)} traversal calls in "
          f"a frame of {cfg.max_bounces} bounces")
    bounds = []
    for bounce, (o, d, bvh, tris, t_min, t0) in enumerate(calls):
        rows, tri_rows = traversal.pack_bvh(bvh, tris)
        _, _, n_rows, n_tests = counted_walk(rows, tri_rows, o, d, t0,
                                             t_min)
        b = traversal_bound(o.shape[0], rows.shape[0], tris.count,
                            {"rows": n_rows, "tri_tests": n_tests})
        dev_ms, _ = profile_device_ms(
            lambda: traversal.closest_hit(o, d, bvh, tris, t_min, t0), 10,
            {"kernel": [TRAV_KERNEL]})
        live = max(int((t0 >= 0).sum()), 1)
        phase("mesh_launch", bounce=bounce, rays=o.shape[0], live_rays=live,
              row_fetches_per_live_ray=n_rows / live,
              tri_tests_per_live_ray=n_tests / live,
              kernel_ms=dev_ms["kernel"], card=smi, **b)
        bounds.append(b["bound_ms"])
    return statistics.mean(bounds)


def mesh_train_setup(torch, pt, device):
    """Phase 13's set-up: the mesh scene's target at frame 1, cli train's
    perturbation (geometry shifted, emission halved) and Adam."""
    from tpu_path_tracer_torch.diff.params import apply_params, extract_params
    from tpu_path_tracer_torch.dist import render_dist

    scene, meta = mesh_scene(MESH_SUBDIVISIONS[0], device)
    cfg = pt.RenderConfig(**MESH_KW)
    view = pt.Camera(eye=MESH_EYE, center=[0, 0, 0]).view_matrix
    frame = render_dist.make_sharded_frame_fn(None, meta, cfg)
    with torch.no_grad():
        target = frame(torch.zeros((render_dist.padded_pixels(cfg), 3),
                                   device=device), 1, True, view, scene)
    params = {k: (v + 0.05 if k.startswith("tri_") else v * 0.5)
              .detach().clone().requires_grad_(True)
              for k, v in extract_params(scene, MESH_GROUPS).items()}
    optimizer = torch.optim.Adam(params.values(), lr=5e-3)
    step = render_dist.make_train_step(None, scene, meta, cfg, apply_params,
                                       optimizer)
    return step, params, target, view, scene, cfg


def mesh_train_phase(torch, pt, device, steps=3):
    """Phase 13: the training path on the mesh scene: emission and vertex
    parameters, the BVH refit inside apply_params every step, the
    traversal kernel's launches counted around the steps alone."""
    import numpy as np

    step, params, target, view, scene, cfg = mesh_train_setup(torch, pt,
                                                              device)
    torch.cuda.synchronize()
    before = counts()
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
    launches, pack_launches = launches_since(
        before, "bvh_closest_hit", "bvh_pack").values()
    phase("mesh_train", tris=scene.triangles.count,
          size=f"{cfg.width}x{cfg.height}",
          max_bounces=cfg.max_bounces, groups=list(MESH_GROUPS), steps=steps,
          losses=losses, step_ms=step_ms, grad_max=grad_max,
          launches=launches, pack_launches=pack_launches)
    check(all(np.isfinite(losses)), "non-finite mesh training loss")
    check(all(g[k] > 0 for g in grad_max for k in ("tri_a", "tri_b",
                                                   "tri_c")),
          "zero vertex gradients")
    check(launches == cfg.max_bounces * steps,
          f"traversal kernel launched {launches} times in {steps} steps")
    check(pack_launches == launches,
          "the refit's tables were not packed for every launch")
    return statistics.median(step_ms)


def grads_gap(torch, a, b):
    """Two runs' gradients: equal bit for bit, and the largest difference
    over its group's largest."""
    gap = 0.0
    for x, y in zip(a, b):
        if x is not None:
            scale = max(float(x.abs().max()), GRAD_ATOL)
            gap = max(gap, float((x - y).abs().max()) / scale)
    return {"grads_bit_equal": all(
        (x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b)),
        "max_diff_over_group_max": gap}


def wavefront_bits_phase(torch, pt, device, smi, steps=3):
    """Phase 13 (end): whether the wavefront's train steps give the same
    bits twice from one start: the gradients of the harness's ``fwd_bwd``
    (the Cornell box) and ``fwd_bwd_mesh`` (the mirror icosphere's emission
    and vertices: the refit and the traversal kernel) losses at 512x512,
    and phase 13's steps (losses and parameters), held to the bit; each
    once more under the detector of nondeterministic torch ops."""
    from tpu_path_tracer_torch.bench import EYE, fwd_bwd_loss

    cfg = pt.RenderConfig(width=512, height=512, max_bounces=4,
                          importance_sampling=True, use_megakernel=False)
    cornell, cornell_meta, _ = pt.builtin.cornell_box(device=device)
    cases = {"fwd_bwd": (cornell, cornell_meta, ("emission", "bsdf")),
             "fwd_bwd_mesh": (*mesh_scene(MESH_SUBDIVISIONS[0], device),
                              ("emission", "vertices"))}
    out = {}
    for name, (scene, meta, groups) in cases.items():
        loss, params = fwd_bwd_loss(scene, meta, cfg, EYE, groups, device)

        def grads():
            leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in params.items()}
            return torch.autograd.grad(loss(leaves, 1), list(leaves.values()),
                                       allow_unused=True)

        out[name] = {**grads_gap(torch, grads(), grads()),
                     "detector": nondeterministic_ops(torch, grads)}
    runs = []
    for _ in range(2):
        step, params, target, view, _, _ = mesh_train_setup(torch, pt,
                                                            device)
        losses = torch.stack([step(params, target, 1, view)
                              for _ in range(steps)])
        runs.append((losses, [p.detach() for p in params.values()]))
    step, params, target, view, _, _ = mesh_train_setup(torch, pt, device)
    out["mesh_train"] = {
        "steps": steps,
        "losses_bit_equal": bool(torch.equal(runs[0][0], runs[1][0])),
        "params_bit_equal": all(torch.equal(a, b) for a, b in
                                zip(runs[0][1], runs[1][1])),
        "detector": nondeterministic_ops(
            torch, lambda: step(params, target, 1, view))}
    for name, row in out.items():
        phase("train_bits", case=name, size="512x512", card=smi, **row)
    for name, row in out.items():
        check(all(v for k, v in row.items() if k.endswith("bit_equal")),
              f"{name}: two runs from one start differ: {row}")
    return out


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
    """Keep ``(arguments, results, ray of each row)`` of every launch of a
    pair-sweep wrapper (``route``: "pair" or "pairbin") made inside the
    context.  The rays come from the emission (``emit_pairbin`` /
    ``emit_pair``), which lays out the rows of each launch just before it;
    -1 marks a padding row."""
    from tpu_path_tracer_torch.kernels import pair_sweep as ps

    name, emit_name = f"{route}_sweep", f"emit_{route}"
    sweep, emit = getattr(ps, name), getattr(ps, emit_name)
    rays = []

    def laying_out(*args):
        rows = emit(*args)
        rays.append(rows.ray)
        return rows

    def recording(*args):
        out = sweep(*args)
        calls.append((args, out, rays[-1]))
        return out

    setattr(ps, name, recording)
    setattr(ps, emit_name, laying_out)
    try:
        yield
    finally:
        setattr(ps, name, sweep)
        setattr(ps, emit_name, emit)


# The emission and reduction wrappers of each route and the C kernels each
# launches (csrc/pair_emit.cu).
EMIT_WRAPPERS = {"pairbin": ("emit_pairbin", "pairbin_best"),
                 "pair": ("emit_pair", "pair_advance")}
EMIT_WRAPPER_KERNELS = {
    "emit_pairbin": ("pairbin_emit_kernel", "pair_layout_kernel",
                     "pair_fill_kernel"),
    "emit_pair": ("pair_emit_kernel", "pair_layout_kernel",
                  "pair_fill_kernel"),
    "pairbin_best": ("pair_reduce_kernel", "pairbin_finalize_kernel"),
    "pair_advance": ("pair_reduce_kernel", "pair_advance_kernel")}


@contextlib.contextmanager
def torch_emission():
    """Route the pair entry points' emission and reduction through their
    plain versions (the torch emission) on the card; the sweeps still
    launch their kernels."""
    from tpu_path_tracer_torch.kernels import pair_sweep as ps

    names = [n for pair in EMIT_WRAPPERS.values() for n in pair]
    saved = {n: getattr(ps, n) for n in names}
    for n in names:
        setattr(ps, n, getattr(ps, f"{n}_plain"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ps, n, fn)


@contextlib.contextmanager
def recorded_emission(route, log):
    """Keep ``(wrapper, arguments before the call, result)`` of every call
    of the route's emission and reduction wrappers inside the context;
    tensors are cloned, and ``pair_advance``'s result is the state it
    leaves (running best, index, candidates taken)."""
    import torch
    from tpu_path_tracer_torch.kernels import pair_sweep as ps

    saved = {n: getattr(ps, n) for n in EMIT_WRAPPERS[route]}

    def wrap(name, fn):
        def call(*args):
            before = [x.clone() if torch.is_tensor(x) else x for x in args]
            out = fn(*args)
            after = out if out is not None else [x.clone()
                                                 for x in args[3:6]]
            log.append((name, before, after))
            return out
        return call

    for n, fn in saved.items():
        setattr(ps, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ps, n, fn)


def emission_against_plain(torch, ps, log):
    """Every recorded emission and reduction call against its plain version
    (the torch emission) on the same inputs, on the card: the rows row for
    row (segment keys, the ray of each row, both row arrays bit for bit),
    the reductions' results bit for bit.  Per wrapper: calls, equal, the
    largest difference, the plain version's ms per call, and the work of
    each call (rays, pairs, rows, histogram cells, operations, bytes)."""
    out = {}
    for name, before, after in log:
        plain = getattr(ps, f"{name}_plain")
        torch.cuda.synchronize()
        start = time.perf_counter()
        if name == "pair_advance":
            state = [x.clone() for x in before[3:6]]
            plain(*before[:3], *state, *before[6:])
            ref = state
        else:
            ref = plain(*before)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - start) * 1e3
        row = out.setdefault(name, {"calls": 0, "equal": True,
                                    "max_abs_err": 0.0, "plain_ms": 0.0,
                                    "work": []})
        row["calls"] += 1
        row["plain_ms"] += ms
        for x, y in zip(after, ref):
            same = x.shape == y.shape and bool(
                (x.view(torch.int32) == y.view(torch.int32)).all()
                if x.dtype == torch.float32 else (x == y).all())
            row["equal"] &= same
            if x.shape != y.shape:
                row["max_abs_err"] = float("inf")
            elif x.numel():
                row["max_abs_err"] = max(row["max_abs_err"], float(
                    (x.double() - y.double()).abs().max()))
        row["work"].append(emission_work(torch, name, before, after))
    for row in out.values():
        row["plain_ms"] /= row["calls"]
    return out


def emission_work(torch, name, before, after):
    """What one emission or reduction call needed, counted from its inputs
    and outputs: FP32 operations (a slab test 25, o x d 9 a pair, a compare
    1) and bytes (inputs read once, outputs written once; the histogram,
    one cell per key and ``EMIT_BLOCK`` rays, is an intermediate and not
    counted)."""
    from tpu_path_tracer_torch.kernels.pair_sweep import EMIT_BLOCK

    cells = 0
    if name == "emit_pairbin":
        o, n_bins, rows = before[0], before[3].shape[0], after
        n, n_rows = o.shape[0], rows.ray.shape[0]
        pairs = int((rows.ray >= 0).sum())
        flops = n * n_bins * PAIR_SLAB_FLOPS + pairs * 9 + n * PAIR_INV_FLOPS
        nbytes = n * 28 + n_bins * 24 + n_rows * 68 + n_rows // 32
        cells = n_bins * -(-n // EMIT_BLOCK)
    elif name == "emit_pair":
        o, rows = before[0], after
        n, n_rows = o.shape[0], rows.ray.shape[0]
        pairs = int((rows.ray >= 0).sum())
        flops = n + pairs * 9
        nbytes = n * 40 + pairs * 8 + n_rows * 68 + n_rows // 32
        cells = before[8] * -(-n // EMIT_BLOCK)
    else:
        rows = before[0]
        n, n_rows = before[3].shape[0], rows.ray.shape[0]
        pairs = int((rows.ray >= 0).sum())
        flops = n_rows + n
        nbytes = n_rows * 12 + (n * 16 if name == "pairbin_best"
                                else n * 44)
    return {"rays": n, "pairs": pairs, "rows": n_rows, "hist_cells": cells,
            "flops": flops, "bytes": nbytes}


def count_syncs(torch, ps, route, fn):
    """Host syncs of one call of ``fn``, counted with torch.cuda's sync
    debug mode (each sync warns once): (all of the call's, those from the
    route's first emission on, the number of emission calls, and where
    they were: {file:line: count})."""
    import warnings

    name = f"emit_{route}"
    emit = getattr(ps, name)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def marked(*args):
            caught.append("emission")
            return emit(*args)

        setattr(ps, name, marked)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            setattr(ps, name, emit)
    marks = [i for i, w in enumerate(caught) if w == "emission"]
    syncs = [i for i, w in enumerate(caught) if w != "emission"
             and "called a synchronizing CUDA operation" in str(w.message)]
    first = marks[0] if marks else len(caught)
    sites = collections.Counter(
        f"{os.path.basename(caught[i].filename)}:{caught[i].lineno}"
        for i in syncs)
    return len(syncs), sum(i > first for i in syncs), len(marks), dict(sites)


@contextlib.contextmanager
def pair_dispatch(route):
    """Route find_hit's BVH search through a pair sweep's entry point
    (``"pairbin"``, ``"pair"``; None: the BVH kernel) in place of
    ``traversal.closest_hit``, as tests/test_torch_pairs.py does."""
    from tpu_path_tracer_torch.kernels import pair_sweep, traversal

    before = traversal.closest_hit
    if route is not None:
        traversal.closest_hit = getattr(pair_sweep, f"{route}_closest_hit")
    try:
        yield
    finally:
        traversal.closest_hit = before


def one_sign_tests(torch, ps, pair_dm, cid, segs, real, table):
    """Tests of the real rows of segments ``segs`` against the triangles of
    their chunks ``cid[segs]`` whose three edge volumes share a strict sign:
    the tests edge_test (csrc/pair.cuh) carries past its sign check, found
    with the plain version's arithmetic (kernels/pair_sweep._edge_tests)."""
    dm = pair_dm.reshape(-1, ps.TRI_CHUNK, 8)
    total = 0
    for s in range(0, segs.numel(), ps.PLAIN_BLOCK):
        sg = segs[s:s + ps.PLAIN_BLOCK]
        tab = table[cid[sg].long()]
        ray = [dm[sg, :, k, None] for k in range(6)]

        def volume(k):
            v = ray[0] * tab[:, None, k]
            for i in range(1, 6):
                v = v + ray[i] * tab[:, None, k + i]
            return v

        s0, s1, s2 = volume(0), volume(6), volume(12)
        same = (((s0 > 0) & (s1 > 0) & (s2 > 0))
                | ((s0 < 0) & (s1 < 0) & (s2 < 0)))
        total += int((same & real[sg][:, :, None]).sum())
    return total


def pair_launch_work(torch, ps, route, args, out):
    """What one recorded launch of a pair-sweep wrapper needed, counted from
    its arguments: the FP32 operations of the row-triangle tests (and, for
    the pair-bin sweep, the chunk slab tests) of its real rows, each test
    its edge volumes and sign check and only those whose volumes share a
    sign the rest (:func:`one_sign_tests`; all of them when t_min <= 0,
    where edge_test takes no shortcut), and the bytes
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
        full_tests = one_sign_tests(torch, ps, pair_dm, seg,
                                    torch.nonzero(on)[:, 0], real, table)
        flops = 0
    else:
        boxes = args[3]
        on = (seg >= 0) & (seg < -(-n_chunks // ps.PAIR_G))
        o = pair_o1[:, :3].reshape(-1, chunk, 3)
        iv = ps.inv_dir(pair_dm[:, :3]).reshape(-1, chunk, 3)
        t_cur = pair_dm[:, 6].clone()
        i_cur = torch.full_like(out[1], -1)
        swept = torch.zeros(n_chunks, dtype=torch.bool, device=seg.device)
        tested = torch.zeros_like(swept)
        row_tests = slab_tests = full_tests = 0
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
            full_tests += one_sign_tests(torch, ps, pair_dm, cid,
                                         torch.nonzero(sweep)[:, 0], real,
                                         table)
            tested[cid[live]] = True
            swept[cid[sweep]] = True
        rows_on = on.repeat_interleave(chunk)
        check(bool((i_cur[rows_on] == out[1][rows_on]).all())
              and bool((t_cur[rows_on] == out[0][rows_on]).all()),
              "pairbin: the launch differs from its replay as gated pair "
              "sweeps")
        tables_read, boxes_read = int(swept.sum()), int(tested.sum())
        flops = (slab_tests * PAIR_SLAB_FLOPS
                 + int((real & on[:, None]).sum()) * PAIR_INV_FLOPS)
    if not t_min > 0:
        full_tests = row_tests
    flops += row_tests * EDGE_SIGN_FLOPS + full_tests * EDGE_REST_FLOPS
    nbytes = (int(on.sum()) * chunk * (64 + 8) + seg.shape[0] * 4
              + tables_read * ps.TABLE_ROWS * chunk * 4 + boxes_read * 24)
    return {"pairs": int(real.sum()), "rows": pair_dm.shape[0],
            "segments": seg.shape[0], "row_tests": row_tests,
            "slab_tests": slab_tests, "one_sign_tests": full_tests,
            "tables_read": tables_read,
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
        bit_equal &= bool((t_k.view(torch.int32)
                           == t_p.view(torch.int32)).all())
        err = max(err, float((t_k - t_p).abs().max()))
        work = pair_launch_work(torch, ps, route, args, (t_k, i_k))
        work["rays"] = int(torch.unique(ray[ray >= 0]).numel())
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
            "one_sign_share": (sum(w["one_sign_tests"] for w in served)
                               / max(1, sum(w["row_tests"] for w in served))),
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
        scene, _ = mesh_scene(sub, device)
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
        bvh_dev, _ = profile_device_ms(bvh_call, 5,
                                       {"kernel": [TRAV_KERNEL]})
        for route, entry in entries.items():
            calls, log = [], []
            with recorded_sweep(route, calls), recorded_emission(route, log):
                t_e, i_e = entry(o, d, bvh, tris, t_min, t0)
            torch.cuda.synchronize()
            check(calls, f"{route}: the entry point launched no sweep")
            # The kernel against its plain version, launch by launch.
            row = sweeps_against_plain(torch, ps, route, calls)
            n_launch = row["launches"]
            # The emission and the reduction against the torch emission,
            # call by call, and the entry point against the same route with
            # the torch emission, lane by lane.
            emitted = emission_against_plain(torch, ps, log)
            with torch_emission():
                t_p, i_p = entry(o, d, bvh, tris, t_min, t0)
            same_lanes = bool((i_e == i_p).all()) and bool(
                (t_e.view(torch.int32) == t_p.view(torch.int32)).all())
            syncs, round_syncs, rounds, sync_sites = count_syncs(
                torch, ps, route, lambda: entry(o, d, bvh, tris, t_min, t0))
            with torch_emission():
                torch_syncs, _, _, torch_sites = count_syncs(
                    torch, ps, route,
                    lambda: entry(o, d, bvh, tris, t_min, t0))

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
            # Kernel, the emission's kernels and every other device
            # operation of the call (the tables, caps, scans; the pair
            # route's candidates) from one profiled run; the same split
            # with the torch emission.
            groups = {"kernel": [kernel_names[route]],
                      "emit_kernels": sorted({
                          k for ks in EMIT_WRAPPER_KERNELS.values()
                          for k in ks})}
            dev_ms, rows_prof = profile_device_ms(call, 3, groups)
            with torch_emission():
                torch_call_ms = time_events(torch, call, 5)
                torch_dev, _ = profile_device_ms(call, 3, groups)
            measured = bool(rows_prof)

            def emission_ms(dev):
                return (dev["all"] - dev["kernel"] if measured
                        else "not measured")

            row.update(
                route=route, tris=tris.count,
                mask_mismatches=mask_diff, live_lanes=int(live.sum()),
                retired_all_miss=bool((i_e[~live] == -1).all()),
                same_as_torch_emission=same_lanes,
                emission={k: {f: v[f] for f in ("calls", "equal",
                                                  "max_abs_err", "plain_ms")}
                          for k, v in emitted.items()},
                host_syncs_per_call=syncs, host_syncs_in_rounds=round_syncs,
                rounds=rounds, host_sync_sites=sync_sites,
                host_syncs_torch_emission=torch_syncs,
                host_sync_sites_torch_emission=torch_sites,
                kernel_ms_per_launch=(dev_ms["kernel"] / n_launch
                                      if measured else "not measured"),
                kernel_ms_per_call=dev_ms["kernel"],
                emission_device_ms_per_call=emission_ms(dev_ms),
                emission_kernels_ms_per_call=dev_ms["emit_kernels"],
                device_ms_per_call=dev_ms["all"], call_ms=call_ms,
                torch_emission_device_ms_per_call=emission_ms(torch_dev),
                torch_emission_call_ms=torch_call_ms,
                bvh_kernel_ms=bvh_dev["kernel"], bvh_call_ms=bvh_call_ms)
            phase("pair_vs_plain", rays=TRAV_RAYS, card=smi, **row)
            name = f"{route} at {tris.count} triangles"
            check(all(v["equal"] for v in emitted.values()),
                  f"{name}: the emission on the card differs from the torch "
                  f"emission: {row['emission']}")
            check(same_lanes, f"{name}: the entry point differs from the "
                  f"same route with the torch emission")
            check(torch_syncs > 1, f"{name}: the sync counter saw "
                  f"{torch_syncs} syncs in the torch emission")
            check(syncs <= 1 if route == "pairbin"
                  else round_syncs <= rounds,
                  f"{name}: {syncs} host syncs in the call, {round_syncs} in "
                  f"{rounds} rounds")
            check(row["same_index"],
                  f"{name}: kernel and plain indices differ")
            check(row["t_bit_equal"],
                  f"{name}: kernel t differs from plain in its bits")
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

    scene, meta = mesh_scene(MESH_SUBDIVISIONS[0], device)
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
            before = counts()
            start = time.perf_counter()
            fb = renderer.render_animation(frames)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            launches = launches_since(before, "pairbin_sweep", "pair_sweep",
                                      "bvh_closest_hit",
                                      *EMIT_WRAPPER_KERNELS)
            calls, log = [], []
            with recorded_sweep(route, calls), recorded_emission(route,
                                                                 log):
                got = one_frame()
        own = f"{route}_sweep"
        mine = (own,) + EMIT_WRAPPERS[route]
        check(calls, f"{route}: a frame launched no sweep")
        row = sweeps_against_plain(torch, ps, route, calls)
        emitted = emission_against_plain(torch, ps, log)
        # The frame's emission calls replayed alone: their device time with
        # the torch operations around the kernels (the histogram's zeros,
        # its scan, the rows' allocation).
        emit_name = EMIT_WRAPPERS[route][0]
        replays = [b for name, b, _ in log if name == emit_name]
        wrapper = getattr(ps, emit_name)
        replay_ms, _ = profile_device_ms(
            lambda: [wrapper(*b) for b in replays], 2, {})
        emitted[emit_name]["call_device_ms"] = (
            replay_ms["all"] / len(replays)
            if isinstance(replay_ms["all"], float) else replay_ms["all"])
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
              frames=frames, launches=launches, seconds=round(seconds, 4),
              fb_mean=fb_np.mean(0).tolist(),
              frame_launches=frame_launches, **row, **served,
              share_within_tol=share, tol=KERNEL_TOL,
              mean_rel_diff=mean_rel, mean_route=got.mean(0).tolist(),
              mean_bvh=ref.mean(0).tolist(),
              emission={k: {f: v[f] for f in ("calls", "equal",
                                                "max_abs_err", "plain_ms",
                                                "call_device_ms") if f in v}
                        for k, v in emitted.items()})
        check(all(launches[k] > 0 for k in mine),
              f"{route}: a kernel of its route was never launched: {launches}")
        check(all(v == 0 for k, v in launches.items() if k not in mine),
              f"{route}: another traversal kernel ran: {launches}")
        check(all(v["equal"] for v in emitted.values()),
              f"{route}: the emission on the card differs from the torch "
              f"emission on the main path")
        if route == "pairbin":
            # One launch per bounce; a bounce whose rays reach no bin
            # launches nothing.
            check(launches[own] <= cfg.max_bounces * frames,
                  f"pairbin: {launches[own]} launches in {frames} frames")
        check(row["same_index"], f"{route}: kernel and plain indices differ "
              f"on the main path's launches")
        check(row["t_bit_equal"], f"{route}: kernel t differs from plain "
              f"in its bits on the main path's launches")
        check(row["max_abs_err"] <= PAIR_T_TOL, f"{route}: kernel t off "
              f"plain by {row['max_abs_err']} on the main path's launches")
        check(np.isfinite(fb_np).all(), f"{route}: non-finite framebuffer")
        check(mean_rel <= PAIR_FRAME_MEAN_RTOL,
              f"{route}: frame mean {mean_rel:.4f} from the BVH route's")
        out[own] = {"launches": launches[own],
                    "frame_launches": frame_launches,
                    "max_abs_err": row["max_abs_err"],
                    "plain_ms": row["plain_ms_per_launch"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                    "flops": row["flops"], "bytes": row["bytes"]}
        for wrapper, em in emitted.items():
            n_calls = em["calls"]
            flops = sum(w["flops"] for w in em["work"]) / n_calls
            nbytes = sum(w["bytes"] for w in em["work"]) / n_calls
            ms, by = bound(flops, nbytes)
            out[wrapper] = {"launches": launches[wrapper],
                            "frame_launches": n_calls,
                            "max_abs_err": em["max_abs_err"],
                            "plain_ms": em["plain_ms"], "bound_ms": ms,
                            "bound_by": by, "flops": flops, "bytes": nbytes,
                            "hist_cells": sum(w["hist_cells"]
                                              for w in em["work"]) / n_calls,
                            "route": route}
            if "call_device_ms" in em:
                out[wrapper]["call_device_ms"] = em["call_device_ms"]

    order = (None, "pairbin", "pair", "pair", "pairbin", None)
    samples = {r: [] for r in order}
    for route in order:
        with pair_dispatch(route):
            t = time_frames(torch, pt, device, scene, meta, cfg, view, 1 + 4)
        samples[route] += t[1:]
    kernels = {None: TRAV_KERNEL, "pairbin": "pairbin_sweep_kernel",
               "pair": "pair_sweep_kernel"}
    for route, t in samples.items():
        groups = {"kernel": [kernels[route]]}
        if route:
            groups.update({w: list(EMIT_WRAPPER_KERNELS[w])
                           for w in EMIT_WRAPPERS[route]})
        with pair_dispatch(route):
            dev_ms, rows = profile_device_ms(one_frame, 2, groups)
        ms = statistics.median(t)
        phase("pair_timing", route=route or "bvh",
              tris=scene.triangles.count, size=f"{cfg.width}x{cfg.height}",
              max_bounces=cfg.max_bounces, ms_per_frame=ms, ms_min=min(t),
              ms_max=max(t), frames=len(t),
              traversal_kernel_ms_per_frame=dev_ms["kernel"],
              emission_kernels_ms_per_frame={
                  w: dev_ms[w] for w in EMIT_WRAPPERS.get(route, ())},
              device_ms_per_frame=dev_ms["all"],
              device_busy_share=(dev_ms["all"] / ms if rows
                                 else "not measured"), card=smi)
        if route:
            for name, group in [(f"{route}_sweep", "kernel")] + [
                    (w, w) for w in EMIT_WRAPPERS[route]]:
                k = out[name]
                k["ms"] = (dev_ms[group] / k["frame_launches"] if rows
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


# Phase 18 (dist): the ranks of a group started from this script, each a
# process of its own with torch's launcher variables.  Each rank keeps its
# chunk on the card; (i) one rank over NCCL, (ii) two ranks sharing the one
# card over gloo (NCCL refuses two ranks on one GPU).
DIST_STEPS = 3
DIST_TIMEOUT = 300
# Two ranks' gradients are summed in another order than one process's.
DIST_GRAD_RTOL = 1e-5
DIST_SCALING = dict(iters=4, repeats=3)


def dist_train(torch, pt, device, mesh):
    """``cli train``'s set-up and DIST_STEPS steps over ``mesh`` (None:
    one process) at the training path's size, through both megakernels.
    Returns each step's loss, gradients and parameters after it, the ms of
    each step and the launch counts of the steps."""
    from tpu_path_tracer_torch.diff.params import apply_params, extract_params
    from tpu_path_tracer_torch.dist import render_dist
    from tpu_path_tracer_torch.dist.sharding import mesh_size, shard_scene

    scene, meta, _ = pt.builtin.cornell_box(device=device)
    if mesh is not None:
        scene = shard_scene(scene, mesh)
    cfg = pt.RenderConfig(**TRAIN_KW, use_megakernel=True)
    view = pt.Camera(eye=[0, 0, 3.2], center=[0, 0, 0]).view_matrix
    rows = render_dist.padded_pixels(cfg, mesh) // mesh_size(mesh)
    with torch.no_grad():
        target = render_dist.make_sharded_frame_fn(mesh, meta, cfg)(
            torch.zeros((rows, 3), device=device), 1, True, view, scene)
    params = {k: (v * 0.5).detach().clone().requires_grad_(True)
              for k, v in extract_params(scene, TRAIN_GROUPS).items()}
    step = render_dist.make_train_step(
        mesh, scene, meta, cfg, apply_params,
        torch.optim.Adam(params.values(), lr=5e-2))
    torch.cuda.synchronize()
    before = counts()
    steps, ms = [], []
    for _ in range(DIST_STEPS):
        start = time.perf_counter()
        loss = step(params, target, 1, view)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - start) * 1e3)
        steps.append((loss, {k: p.grad.clone() for k, p in params.items()
                             if p.grad is not None},
                      {k: p.detach().clone() for k, p in params.items()}))
    launches = launches_since(before, "megakernel_fwd", "megakernel_bwd")
    return steps, ms, launches


def train_gap(torch, got, ref):
    """Two train runs step by step: whether losses and parameters are
    equal bit for bit, the largest parameter difference and the largest
    gradient difference over its group's largest."""
    out = {"losses_bit_equal": True, "params_bit_equal": True,
           "max_param_abs_diff": 0.0, "max_grad_err_over_group_max": 0.0}
    for (loss, grads, params), (loss_r, grads_r, params_r) in zip(got, ref):
        out["losses_bit_equal"] &= bool(torch.equal(loss, loss_r))
        for k in params_r:
            out["params_bit_equal"] &= bool(torch.equal(params[k],
                                                        params_r[k]))
            out["max_param_abs_diff"] = max(
                out["max_param_abs_diff"],
                float((params[k] - params_r[k]).abs().max()))
        for k in grads_r:
            scale = max(float(grads_r[k].abs().max()), GRAD_ATOL)
            out["max_grad_err_over_group_max"] = max(
                out["max_grad_err_over_group_max"],
                float((grads[k] - grads_r[k]).abs().max()) / scale)
    return out


def sharding_identity(torch, pt, device, mesh):
    """What the sharding adds at one rank, bit for bit: the loss over the
    mesh against the one-process loss on the same parameters, and the
    gradients after the mesh's all-reduce against those before it."""
    from tpu_path_tracer_torch.diff.params import apply_params, extract_params
    from tpu_path_tracer_torch.dist import render_dist

    scene, meta, _ = pt.builtin.cornell_box(device=device)
    cfg = pt.RenderConfig(**TRAIN_KW, use_megakernel=True)
    view = pt.Camera(eye=[0, 0, 3.2], center=[0, 0, 0]).view_matrix
    n_pad = render_dist.padded_pixels(cfg, mesh)
    with torch.no_grad():
        target = render_dist.make_sharded_frame_fn(None, meta, cfg)(
            torch.zeros((n_pad, 3), device=device), 1, True, view, scene)
    params = {k: (v * 0.5).detach().clone().requires_grad_(True)
              for k, v in extract_params(scene, TRAIN_GROUPS).items()}
    losses = [render_dist.make_sharded_loss_fn(m, scene, meta, cfg,
                                               apply_params)(
        params, target, 1, view) for m in (None, mesh)]
    losses[1].backward()
    before = {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
              for k, p in params.items()}
    render_dist.sum_grads(list(params.values()), mesh)
    return {"loss_bit_equal": bool(torch.equal(losses[0].detach(),
                                               losses[1].detach())),
            "grads_bit_equal_after_all_reduce": all(
                torch.equal(p.grad, before[k]) for k, p in params.items())}


def dist_world1(torch, pt, device, mesh):
    """(i): the sharded train step on a one-rank NCCL mesh against the
    one-process step, and the one-process step against itself, bit for
    bit (every sum of the backward has a fixed order); what the sharding
    adds at one rank, bit for bit."""
    out, runs = {}, {}
    for name, m in (("one_process", None), ("sharded", mesh),
                    ("one_process_again", None)):
        runs[name], ms, launches = dist_train(torch, pt, device, m)
        out[name] = {"losses": [float(s[0]) for s in runs[name]],
                     "step_ms": ms, "launches": launches}
    out["sharded_vs_one_process"] = train_gap(torch, runs["sharded"],
                                              runs["one_process"])
    out["one_process_vs_itself"] = train_gap(
        torch, runs["one_process_again"], runs["one_process"])
    out["identity"] = sharding_identity(torch, pt, device, mesh)
    return out


def dist_frame(torch, pt, device, mesh, scene, meta, cfg, eye):
    """One frame through ``make_sharded_frame_fn`` over ``mesh`` on this
    rank's chunk; the gathered frame against the one-process frame of the
    same padded pixels (on the mesh's first rank).  Launch counts around
    the sharded frame alone."""
    from tpu_path_tracer_torch.dist.render_dist import (make_sharded_frame_fn,
                                                        padded_pixels)
    from tpu_path_tracer_torch.dist.sharding import (gather_rows, mesh_rank,
                                                     shard_scene)

    view = pt.Camera(eye=eye, center=[0, 0, 0]).view_matrix
    n_pad = padded_pixels(cfg, mesh)
    sharded = shard_scene(scene, mesh)
    frame = make_sharded_frame_fn(mesh, meta, cfg)
    fb = torch.zeros((n_pad // mesh.size(), 3), device=device)
    frame(fb, 1, True, view, sharded)  # warm-up: packing, layouts
    torch.cuda.synchronize()
    before = counts()
    start = time.perf_counter()
    frame(fb, 3, True, view, sharded)
    torch.cuda.synchronize()
    out = {"sharded_frame_ms": (time.perf_counter() - start) * 1e3,
           "launches": launches_since(before, "megakernel_fwd",
                                      "bvh_closest_hit"),
           "rows": n_pad, "rows_per_rank": fb.shape[0]}
    whole = gather_rows(fb, mesh)
    if mesh_rank(mesh) == 0:
        one = make_sharded_frame_fn(None, meta, cfg)(
            torch.zeros((n_pad, 3), device=device), 3, True, view, scene)
        out["bit_equal"] = bool(torch.equal(whole, one))
        out["rows_differing"] = int((whole != one).any(dim=1).sum())
        out["finite"] = bool(torch.isfinite(whole).all())
    return out


def dist_grads(torch, pt, device, mesh):
    """The sharded Cornell loss and its summed gradients against the
    one-process ones (on the mesh's first rank), each gradient against its
    group's largest; launch counts around the sharded loss and backward."""
    from tpu_path_tracer_torch.diff.params import apply_params, extract_params
    from tpu_path_tracer_torch.dist import render_dist
    from tpu_path_tracer_torch.dist.sharding import (gather_rows, mesh_rank,
                                                     shard_scene)

    scene, meta, _ = pt.builtin.cornell_box(device=device)
    sharded = shard_scene(scene, mesh)
    cfg = pt.RenderConfig(**TRAIN_KW, use_megakernel=True)
    view = pt.Camera(eye=[0, 0, 3.2], center=[0, 0, 0]).view_matrix
    rows = render_dist.padded_pixels(cfg, mesh) // mesh.size()
    with torch.no_grad():
        target = render_dist.make_sharded_frame_fn(mesh, meta, cfg)(
            torch.zeros((rows, 3), device=device), 1, True, view, sharded)

    def grads(m, s, t):
        params = {k: (v * 0.5).detach().clone().requires_grad_(True)
                  for k, v in extract_params(s, TRAIN_GROUPS).items()}
        loss = render_dist.make_sharded_loss_fn(m, s, meta, cfg,
                                                apply_params)(
            params, t, 1, view)
        loss.backward()
        if m is not None:
            render_dist.sum_grads(list(params.values()), m)
        return float(loss.detach()), {
            k: torch.zeros_like(p) if p.grad is None else p.grad
            for k, p in params.items()}

    grads(mesh, sharded, target)  # warm-up
    torch.cuda.synchronize()
    before = counts()
    loss, got = grads(mesh, sharded, target)
    torch.cuda.synchronize()
    out = {"loss": loss, "launches": launches_since(
        before, "megakernel_fwd", "megakernel_bwd")}
    whole_target = gather_rows(target, mesh)
    if mesh_rank(mesh) == 0:
        ref_loss, ref = grads(None, scene, whole_target)
        rel = 0.0
        for k in ref:
            scale = max(float(ref[k].abs().max()), GRAD_ATOL)
            rel = max(rel, float((got[k] - ref[k]).abs().max()) / scale)
        out.update(one_process_loss=ref_loss, max_err_over_group_max=rel,
                   loss_rel_err=abs(loss - ref_loss) / abs(ref_loss))
    return out


def dist_rank(job, out_dir):
    """One rank of phase 18 (``chip_smoke.py --dist-rank JOB OUT_DIR``):
    joins the group from the launcher's variables, runs JOB and writes its
    results to ``OUT_DIR/JOB.RANK.json``."""
    import torch
    import torch.distributed as dist

    import tpu_path_tracer_torch as pt
    from tpu_path_tracer_torch.dist import render_dist
    from tpu_path_tracer_torch.dist.sharding import (init_distributed,
                                                     make_mesh, rank_device)

    rank = init_distributed(device="cuda")
    mesh = make_mesh()
    device = rank_device(mesh)
    out = {"rank": rank, "world": dist.get_world_size(),
           "backend": dist.get_backend(), "device": str(device)}
    start = time.perf_counter()
    try:
        if job == "world1":
            out.update(dist_world1(torch, pt, device, mesh))
        elif job == "preview":
            out.update(preview_rank(pt, device, mesh))
        else:
            ref, ref_meta, _ = pt.builtin.reference_scene(device=device)
            out["reference_frame"] = dist_frame(
                torch, pt, device, mesh, ref, ref_meta,
                pt.RenderConfig(width=512, height=512, max_bounces=4,
                                use_megakernel=True), [0.5, 0.0, 2.5])
            big, big_meta = mesh_scene(MESH_SUBDIVISIONS[0], device)
            out["mesh_frame"] = dist_frame(torch, pt, device, mesh, big,
                                           big_meta,
                                           pt.RenderConfig(**MESH_KW),
                                           MESH_EYE)
            out["grads"] = dist_grads(torch, pt, device, mesh)
            out["scaling"] = render_dist.measure_scaling(**DIST_SCALING)
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - start
    with open(os.path.join(out_dir, f"{job}.{rank}.json"), "w") as f:
        json.dump(out, f)


def run_ranks(world, job, out_dir):
    """Starts ``world`` ranks of JOB on localhost and waits for them; a
    rank that fails or outlives DIST_TIMEOUT kills the others and fails the
    phase.  Returns each rank's results."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
        logs.append(os.path.join(out_dir, f"{job}.{rank}.log"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-rank",
                 job, out_dir], cwd=REPO, env=env, stdout=f,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DIST_TIMEOUT
    while any(p.poll() is None for p in procs):
        if (any(p.returncode not in (None, 0) for p in procs)
                or time.monotonic() > deadline):
            for p in procs:
                p.kill()
            break
        time.sleep(0.1)
    for rank, (p, log) in enumerate(zip(procs, logs)):
        p.wait()
        check(p.returncode == 0, f"dist {job}: rank {rank} exited "
              f"{p.returncode}:\n{open(log).read()[-3000:]}")
    out = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"{job}.{rank}.json")) as f:
            out.append(json.load(f))
    return out


def dist_phase(smi):
    """Phase 18: (i) one rank over NCCL, the sharded train step against
    the one-process step; (ii) two ranks over gloo on the one card, the
    reference and mesh frames and the Cornell gradients against one
    process; (iii) measure_scaling over the two ranks; then the render
    command over two ranks."""
    out_dir = os.path.join(REPO, "tpu_path_tracer_torch", "_build",
                           "chip_smoke_dist")
    os.makedirs(out_dir, exist_ok=True)
    start = time.perf_counter()
    one, = run_ranks(1, "world1", out_dir)
    phase("dist", case="world1", gpu=smi, backend=one["backend"],
          steps=DIST_STEPS, seconds=round(one["seconds"], 3),
          **{k: one[k] for k in ("one_process", "sharded",
                                 "one_process_again",
                                 "sharded_vs_one_process",
                                 "one_process_vs_itself", "identity")})
    check(one["backend"] == "nccl", f"world 1 ran {one['backend']}")
    check(one["sharded"]["launches"] == {"megakernel_fwd": DIST_STEPS,
                                         "megakernel_bwd": DIST_STEPS},
          f"world 1 launches {one['sharded']['launches']}")
    check(all(one["identity"].values()), "world 1: the sharding changed "
          f"bits: {one['identity']}")
    for key in ("sharded_vs_one_process", "one_process_vs_itself"):
        gap = one[key]
        check(gap["losses_bit_equal"] and gap["params_bit_equal"]
              and gap["max_grad_err_over_group_max"] == 0.0,
              f"world 1, {key}: the train steps differ: {gap}")
    two = run_ranks(2, "world2", out_dir)
    for key in ("reference_frame", "mesh_frame", "grads"):
        phase("dist", case=f"world2_{key}", gpu=smi,
              backend=two[0]["backend"], devices=[r["device"] for r in two],
              ranks=[r[key] for r in two])
    scaling = two[0]["scaling"]
    phase("dist", case="measure_scaling", gpu=smi, size="512x512",
          **DIST_SCALING, **scaling,
          seconds=round(time.perf_counter() - start, 3))
    check(all(r["backend"] == "gloo" for r in two), "world 2 is not gloo")
    ref0, mesh0, grads0 = (two[0][k] for k in ("reference_frame",
                                                "mesh_frame", "grads"))
    check(ref0["bit_equal"] and ref0["finite"], "world 2: the reference "
          f"frame differs on {ref0['rows_differing']} rows")
    check(mesh0["bit_equal"] and mesh0["finite"], "world 2: the mesh frame "
          f"differs on {mesh0['rows_differing']} rows")
    check(grads0["max_err_over_group_max"] <= DIST_GRAD_RTOL,
          f"world 2 gradients {grads0['max_err_over_group_max']} of the "
          f"group's largest")
    for r in two:
        check(r["reference_frame"]["launches"]["megakernel_fwd"] == 1,
              f"rank {r['rank']}: reference frame launches")
        check(r["mesh_frame"]["launches"]["bvh_closest_hit"] > 0,
              f"rank {r['rank']}: no traversal launch")
        check(r["grads"]["launches"] == {"megakernel_fwd": 1,
                                         "megakernel_bwd": 1},
              f"rank {r['rank']}: gradient launches")
    check("NOT a speedup" in scaling["kind"], "measure_scaling called ranks "
          "on one card a speedup")
    check(scaling["tput_1dev_rays_s"] > 0 and scaling["tput_ndev_rays_s"] > 0,
          "measure_scaling throughputs")
    dist_cli(smi, out_dir)


def dist_cli(smi, out_dir):
    """``render --devices 2 --megakernel`` on the card: the command starts
    two ranks itself; its PNG against the one-process renderer's image of
    the same frames."""
    import numpy as np
    import torch

    import tpu_path_tracer_torch as pt
    from tpu_path_tracer_torch.utils.image import read_png

    png = os.path.join(out_dir, "devices2.png")
    if os.path.exists(png):
        os.remove(png)
    cmd = [sys.executable, "-m", "tpu_path_tracer_torch", "render",
           "--devices", "2", "--megakernel", "--width", "128", "--height",
           "128", "--bounces", "4", "--frames", "2", "-o", png]
    start = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=DIST_TIMEOUT)
    seconds = time.perf_counter() - start
    check(proc.returncode == 0, f"render --devices 2 failed: {proc.stderr}")
    scene, meta, _ = pt.builtin.cornell_box(device=torch.device("cuda", 0))
    one = pt.Renderer(scene, meta, pt.RenderConfig(
        width=128, height=128, max_bounces=4, use_megakernel=True),
        pt.Camera(eye=[0.0, 0.0, 3.2], center=[0, 0, 0]))
    one.render_animation(2)
    levels = int(np.abs(read_png(png).astype(np.int32)
                        - one.display().astype(np.int32)).max())
    phase("dist", case="cli_devices", gpu=smi, seconds=round(seconds, 2),
          stdout=proc.stdout.strip().splitlines(),
          png_max_level_diff=levels)
    check(proc.stdout.count("wrote ") == 1
          and "on cuda:0 x 2 ranks" in proc.stdout,
          f"render --devices 2 printed {proc.stdout!r}")
    check(levels == 0, f"render --devices 2: the PNG is {levels} levels "
          f"from one process")


# Phase 19 (bench): the harness as a user runs it, a subprocess of its own.
# When what the script has used so far and BENCH_FULL_S would pass
# SMOKE_BUDGET_S, the phase runs BENCH_REDUCED alone, one --workload each.
# BENCH_FULL_S: the whole harness took 467 s on an H100 (NVIDIA H100 80GB
# HBM3, 700 W), 12 processes of its own; phases 1-18 take about 310 s.
SMOKE_BUDGET_S = 900
BENCH_FULL_S = 480
BENCH_TIMEOUT = 900
BENCH_REDUCED = ("fwd_bwd_megakernel", "mesh_bvh", "sol")
# Phase 20 (preview_ranks): keys of the scripted terminal, one list a
# frame, and the preview's renderer.
PREVIEW_KEYS = ([], ["a"], [], ["w"], ["left"], [], ["q"])
PREVIEW_KW = dict(width=128, height=96, max_bounces=4, use_megakernel=True)


def bench_phase(smi, started):
    """Phase 19: ``python -m tpu_path_tracer_torch bench`` on the card:
    exit 0, one parsable last line, every row there (the monkey row may be
    skipped for want of its asset), the headline equal to
    ``fwd_bwd_megakernel_mrays``, each row's device time measured, and
    fwd+bwd at least 1.5x the forward megakernel (bench.py's sanity
    gate).  In the reduced form, BENCH_REDUCED one process each."""
    from tpu_path_tracer_torch import bench

    start = time.perf_counter()
    if start - started + BENCH_FULL_S > SMOKE_BUDGET_S:
        for name in BENCH_REDUCED:
            proc = subprocess.run(
                [sys.executable, "-m", "tpu_path_tracer_torch.bench",
                 "--workload", name], cwd=REPO, capture_output=True,
                text=True, timeout=BENCH_TIMEOUT)
            res, err = bench.parse_child(proc.returncode, proc.stdout,
                                         proc.stderr)
            phase("bench", workload=name, card=smi, result=res, error=err)
            check(err is None, f"bench --workload {name}: {err}")
        phase("bench", reduced=list(BENCH_REDUCED),
              seconds=round(time.perf_counter() - start, 2))
        return
    proc = subprocess.run([sys.executable, "-m", "tpu_path_tracer_torch",
                           "bench"], cwd=REPO, capture_output=True,
                          text=True, timeout=BENCH_TIMEOUT)
    seconds = time.perf_counter() - start
    check(proc.returncode == 0, f"bench exited {proc.returncode}: "
          f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    phase("bench", seconds=round(seconds, 2), card=smi, line=line)
    extra = line["extra"]
    check(extra["errors"] is None, f"bench rows failed: {extra['errors']}")
    skipped = set(extra["skipped"] or ())
    check(skipped <= {"mesh_monkey"}, f"bench skipped {skipped}")
    for name in set(bench.WORKLOADS) - skipped - {"sol", "scaling"}:
        check(isinstance(extra.get(f"{name}_device_ms"), float),
              f"bench row {name}: device time "
              f"{extra.get(f'{name}_device_ms')}")
    for key in ("sol_frac_megakernel_fwd", "sol_frac_megakernel_fwd_bwd",
                "sol_frac_traversal", "scaling_efficiency"):
        check(isinstance(extra[key], float), f"bench {key}: {extra[key]}")
    check(line["value"] is not None
          and line["value"] == extra["fwd_bwd_megakernel_mrays"],
          f"bench headline {line['value']}")
    check(extra["fwd_bwd_megakernel_ms"] >= 1.5 * extra["fwd_pallas_ms"],
          "bench sanity gate: fwd+bwd under 1.5x the forward megakernel")
    check(extra["card"] == smi and extra["workload_rev"]
          == bench.WORKLOAD_REV, f"bench card {extra['card']}")


def scripted_preview(renderer, tty=True):
    """``preview.run_preview`` on ``renderer`` before a stand-in terminal:
    a tty (or, ``tty=False``, not one) whose keys come from PREVIEW_KEYS,
    one list a frame.  Returns what it painted and the camera (eye,
    center, up, moving, key_press) as each frame began and at the end."""
    import io
    import termios
    import types
    import tty as tty_module

    import numpy as np
    from tpu_path_tracer_torch import preview

    keys = iter(PREVIEW_KEYS)
    cams = []

    def camera():
        c = renderer.camera
        cams.append(np.concatenate([c.eye, c.center, c.up,
                                    [c.moving, c.key_press]])
                    .astype(np.float32))

    step = renderer.step

    def stepping(*args, **kwargs):
        camera()
        return step(*args, **kwargs)

    saved = (sys.stdin, termios.tcgetattr, termios.tcsetattr,
             tty_module.setcbreak, preview._read_keys)
    sys.stdin = types.SimpleNamespace(isatty=lambda: tty, fileno=lambda: 0)
    termios.tcgetattr = lambda fd: []
    termios.tcsetattr = lambda fd, when, attrs: None
    tty_module.setcbreak = lambda fd: None
    preview._read_keys = lambda timeout: next(keys)
    renderer.step = stepping
    painted = io.StringIO()
    try:
        with contextlib.redirect_stdout(painted):
            preview.run_preview(renderer, max_fps=1000.0)
    finally:
        (sys.stdin, termios.tcgetattr, termios.tcsetattr,
         tty_module.setcbreak, preview._read_keys) = saved
        renderer.step = step
    camera()
    return painted.getvalue(), np.stack(cams)


def preview_renderer(pt, device, mesh):
    scene, meta, _ = pt.builtin.cornell_box(device=device)
    return pt.Renderer(scene, meta, pt.RenderConfig(**PREVIEW_KW),
                       pt.Camera(eye=[0.0, 0.0, 3.2], center=[0, 0, 0]),
                       mesh=mesh)


def preview_rank(pt, device, mesh):
    """Phase 20 on one rank: the preview without a terminal (it must raise
    on every rank), then the scripted preview, with the forward
    megakernel's launches around it."""
    try:
        scripted_preview(preview_renderer(pt, device, mesh), tty=False)
        no_tty = None
    except RuntimeError as e:
        no_tty = str(e)
    renderer = preview_renderer(pt, device, mesh)
    before = counts()
    text, cams = scripted_preview(renderer)
    return {"no_tty": no_tty, "painted": text, "cameras": cams.tolist(),
            "frames": len(cams) - 1,
            "launches": launches_since(before,
                                       "megakernel_fwd")["megakernel_fwd"]}


def preview_phase(smi):
    """Phase 20: the scripted preview on two gloo ranks sharing the card
    against the one-process preview: what the first rank painted, bit for
    bit, and the camera on both ranks at every frame."""
    import numpy as np
    import torch

    import tpu_path_tracer_torch as pt

    out_dir = os.path.join(REPO, "tpu_path_tracer_torch", "_build",
                           "chip_smoke_dist")
    os.makedirs(out_dir, exist_ok=True)
    start = time.perf_counter()
    two = run_ranks(2, "preview", out_dir)
    text, cams = scripted_preview(preview_renderer(
        pt, torch.device("cuda", 0), None))
    frames = len(PREVIEW_KEYS)
    phase("preview_ranks", gpu=smi, backend=two[0]["backend"],
          devices=[r["device"] for r in two], size=f"{PREVIEW_KW['width']}x"
          f"{PREVIEW_KW['height']}", keys=list(PREVIEW_KEYS),
          frames=[r["frames"] for r in two],
          launches=[r["launches"] for r in two],
          painted_bytes=[len(r["painted"]) for r in two],
          painted_equal=two[0]["painted"] == text,
          cameras_equal=[bool(np.array_equal(np.float32(r["cameras"]), cams))
                         for r in two],
          no_tty=[r["no_tty"] for r in two],
          seconds=round(time.perf_counter() - start, 2))
    check(two[0]["painted"] == text and text.count("frame ") == frames,
          "preview over two ranks: the first rank painted other frames "
          "than one process")
    check(two[1]["painted"] == "", "the second rank painted")
    for r in two:
        check(np.array_equal(np.float32(r["cameras"]), cams),
              f"rank {r['rank']}: the camera differs from one process")
        check(r["frames"] == frames and r["launches"] == frames,
              f"rank {r['rank']}: {r['frames']} frames, {r['launches']} "
              f"forward launches for {frames} frames")
        check(r["no_tty"] is not None and "tty" in r["no_tty"],
              f"rank {r['rank']}: no error without a terminal")


def run():
    import torch

    started = time.perf_counter()
    smi = device_phase(torch)
    import tpu_path_tracer_torch as pt

    ptxas = build_phase()
    device = torch.device("cuda", 0)
    max_err = compare_phase(torch, pt, device)
    golden_phase(torch, pt, device)
    launches, frame_ms = main_path_phase(torch, pt, device)
    table_cache_phase(torch, pt, device)
    times = timing_phase(torch, pt, device, smi)
    fwd_device_ms = profile_phase(torch, pt, device, frame_ms)
    grad_abs, grad_rel = grad_phase(torch, pt, device)
    fold = bwd_fold_phase(torch, pt, device, smi, ptxas)
    train_launches = train_phase(torch, pt, device)
    train_times, kernel_ms = train_timing_phase(torch, pt, device, smi)
    trav = traversal_phase(torch, pt, device, smi)
    mesh_launches, pack_launches = mesh_main_path_phase(torch, pt, device)
    mesh_times = mesh_timing_phase(torch, pt, device, smi)
    mesh_megakernel = mesh_megakernel_phase(torch, pt, device, smi, ptxas)
    mesh_train_phase(torch, pt, device)
    wavefront_bits_phase(torch, pt, device, smi)
    mesh_cli_phase(pt)
    pair_phase(torch, pt, device, smi)
    pair_kernels = pair_main_path_phase(torch, pt, device, smi)
    user_layer_phase(torch, pt, device)
    dist_phase(smi)
    bench_phase(smi, started)
    preview_phase(smi)
    ref, ref_meta, _ = pt.builtin.reference_scene(device=device)
    fwd_bound = megakernel_bound(
        ref, ref_meta, pt.RenderConfig(width=512, height=512, max_bounces=4),
        [0.5, 0.0, 2.5], backward=False)
    cornell, cornell_meta, _ = pt.builtin.cornell_box(device=device)
    bwd_bound = megakernel_bound(cornell, cornell_meta,
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
        mesh_megakernel,
        {"name": "megakernel_bwd", "route": "cuda", "source": BWD_SOURCE,
         "replaces": BWD_REPLACES,
         "launches": train_launches["megakernel_bwd"],
         "max_abs_err": grad_abs, "max_err_over_group_max": grad_rel,
         "ms": train_times["kernel"]["bwd_ms"],
         "plain_ms": train_times["plain"]["bwd_ms"],
         "device_ms": kernel_ms["megakernel_bwd"],
         "bound_ms": bwd_bound["bound_ms"], "bound_by": bwd_bound["bound_by"],
         "library_ms": None, **ptxas["megakernel_bwd"]},
        {"name": "megakernel_bwd_fold", "route": "cuda",
         "source": BWD_SOURCE, "replaces": FOLD_REPLACES,
         "launches": train_launches["megakernel_bwd_fold"],
         "max_abs_err": fold["max_abs_err"], "ms": fold["ms"],
         "device_ms": kernel_ms["megakernel_bwd_fold"],
         "plain_ms": fold["plain_ms"], "bound_ms": fold["bound_ms"],
         "bound_by": fold["bound_by"], "library_ms": fold["library_ms"],
         **ptxas["megakernel_bwd_fold"]},
        {"name": "bvh_closest_hit", "route": "cuda", "source": TRAV_SOURCE,
         "replaces": TRAV_REPLACES, "launches": mesh_launches,
         "max_abs_err": trav["max_abs_err"], "ms": trav["kernel_ms"],
         "plain_ms": trav["plain_ms"], "bound_ms": trav["bound_ms"],
         "bound_by": trav["bound_by"], "library_ms": None,
         "main_path_ms_per_launch":
             mesh_times["kernel_device_ms_per_launch"],
         "main_path_bound_ms_per_launch": mesh_times["bound_ms_per_launch"],
         **ptxas["bvh_stack_walk"]},
        {"name": "bvh_pack", "route": "cuda", "source": TRAV_SOURCE,
         "replaces": PACK_REPLACES, "launches": pack_launches,
         "max_abs_err": trav["pack_max_abs_err"],
         "ms": trav["pack_kernel_ms"], "plain_ms": trav["pack_plain_ms"],
         "bound_ms": trav["pack_bound_ms"], "bound_by": trav["pack_bound_by"],
         "library_ms": None,
         "main_path_ms_per_launch":
             mesh_times["pack_device_ms_per_launch"], **ptxas["bvh_pack"]}] + [
        {"name": name, "route": "cuda", "source": PAIR_SOURCE,
         "replaces": replaces, "launches": pair_kernels[name]["launches"],
         "max_abs_err": pair_kernels[name]["max_abs_err"],
         "ms": pair_kernels[name]["ms"],
         "plain_ms": pair_kernels[name]["plain_ms"],
         "bound_ms": pair_kernels[name]["bound_ms"],
         "bound_by": pair_kernels[name]["bound_by"], "library_ms": None,
         "launches_per_frame": pair_kernels[name]["frame_launches"],
         **ptxas[name]}
        for name, replaces in (("pairbin_sweep", PAIRBIN_REPLACES),
                               ("pair_sweep", PAIR_REPLACES))] + [
        {"name": name, "route": "cuda", "source": EMIT_SOURCE,
         "replaces": EMIT_REPLACES[name],
         "launches": pair_kernels[name]["launches"],
         "max_abs_err": pair_kernels[name]["max_abs_err"],
         "ms": pair_kernels[name]["ms"],
         "plain_ms": pair_kernels[name]["plain_ms"],
         "bound_ms": pair_kernels[name]["bound_ms"],
         "bound_by": pair_kernels[name]["bound_by"], "library_ms": None,
         "launches_per_frame": pair_kernels[name]["frame_launches"],
         "call_device_ms": pair_kernels[name].get("call_device_ms"),
         "hist_cells": pair_kernels[name]["hist_cells"],
         "kernels": {k: ptxas[k] for k in ptxas
                     if k.split(".")[0] in EMIT_WRAPPER_KERNELS[name]}}
        for name in EMIT_REPLACES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main():
    if sys.argv[1:2] == ["--dist-rank"]:
        dist_rank(*sys.argv[2:4])
        return 0
    try:
        run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
