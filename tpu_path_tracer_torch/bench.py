"""The port's benchmark harness: the JAX package's ``bench.py`` workloads
through ``tpu_path_tracer_torch``, one process each, and one JSON line in
bench.py's shape (``metric``, ``value``, ``unit``, ``vs_baseline``,
``extra``)::

    python -m tpu_path_tracer_torch bench                # on the card
    python -m tpu_path_tracer_torch bench --device cpu   # plain versions
    python -m tpu_path_tracer_torch.bench --workload fwd_bwd_megakernel

Workloads, at bench.py's sizes (each function takes bench.py's
``width``, ``height``, ``bounces``, ``subdivisions`` and ``window`` where it
has them, and ``device``):

* ``fwd_bwd_megakernel`` (bench.py:146), the headline: Cornell 512x512,
  4 bounces, NEE; the MSE loss over the emission and BSDF parameters and
  the chained ``p - 1e-18 * g`` update, through both megakernels;
* ``fwd_bwd`` (:88): the same step through the eager wavefront;
* ``fwd_bwd_reference_scene`` (:156): the reference scene with its glass
  cube, NEE off, through both megakernels;
* ``fwd_bwd_mesh`` (:177): the 81,920-triangle mirror icosphere (median
  BVH), emission and vertices with the refit, through the traversal kernel;
* ``fwd_wavefront`` (:211), ``fwd_pallas`` (:272, the forward megakernel)
  and ``fwd_reference_scene`` (:238): chained forward frames;
* ``mesh_bvh`` (:301), ``mesh_bvh_327k`` (:568), ``mesh_bvh_327k_1024``
  (:418) and ``mesh_monkey`` (:365): mesh frames through the traversal
  kernel, with the mesh's generation, BVH build and upload times;
* ``sol`` (:424): the forward and fwd+bwd megakernel steps and one
  traversal call, each beside its bound from ``utils.bounds`` (the count
  ``chip_smoke.py`` holds the kernels to): bound over wall time, as
  bench.py defines it, and over the bounded kernels' device time;
* ``scaling`` (:550): ``dist.render_dist.measure_scaling`` over as many
  ranks as cards, at least two; ranks that share a card measure sharding
  overhead, never a speedup, and the line says so.

Timing follows bench.py: each step's output feeds the next, each run ends
with ``torch.cuda.synchronize()`` and a host copy of the chained state, and
a row's time is the marginal per-step time between a short and a long
run, or, where bench.py takes ``_marginal3``, the median of five marginals
with their spread.  Each row also gives its device ms per step or frame
(``torch.profiler``'s sum of CUDA kernel time over a few steps, by
kernel as well) and the kernels it launched in one step: every path is
host-bound, and host clocks move between calls.

Before a row times a kernel it checks it on its own inputs: 1024 rays of
the traversal kernel against the plain walk (``bvh_closest_hit``, the same
index and the same bits of t), and a 16x8 frame of the forward megakernel
against the eager wavefront (``tests/test_pallas.py:52``'s tolerance); on
the card a row also fails if its kernels did not launch.  A failure fails
that row alone, with its error.

Crash isolation as in bench.py: every workload runs in a process of its
own (``--workload NAME``, which prints one ``BENCH_RESULT`` line), and the
parent never touches the device; it builds the CUDA kernels and the
native BVH builder once before the first child.  A failed workload is
``null`` in the line with its error under ``extra.errors``.  Two
differences from bench.py:

1. The headline is ``fwd_bwd_megakernel``'s Mray/s or null; it never falls
   back to the wavefront's number (bench.py:668-670).
2. The command exits non-zero when any workload failed.  ``mesh_monkey``
   without its asset (bench.py:384's OBJ, looked up in the reference
   checkout under the home directory) is listed under ``extra.skipped``
   with the path, and is not a failure.

``extra`` keeps bench.py's keys where the meaning is the same;
``scaling_efficiency_8dev`` becomes ``scaling_efficiency`` with
``scaling_ranks`` and ``scaling_shares_device``.  It adds each row's
``*_device_ms``, the sol rows' bounds, each row's parity check and
launches, the card's name and power limit (nvidia-smi), the torch, CUDA
and nvcc versions, whether triton imports, and ``workload_rev``: the tag
of this H100 series, which no TPU row of ``BENCH_r0*.json`` compares with.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

WORKLOAD_REV = "h100-port-1"
BASELINE_MRAYS = 56.0   # BASELINE.md's derived anchor (bench.py:671)
WORKLOAD_TIMEOUT_S = 900
MONKEY_OBJ = os.path.join(os.path.expanduser("~"), "reference", "assets",
                          "monkey_smooth_15744.obj")
# The forward megakernel against its plain version: the per-pixel
# tolerance of the JAX package's own kernel parity tests
# (tests/test_pallas.py:52).  The kernel and the wavefront evaluate sinf,
# cosf and logf with different implementations (CUDA's libdevice inside
# the kernel, torch's kernels outside), which differ in the last ulp; a
# glass, fog or roulette decision taken right at its threshold can flip,
# and that one path then differs completely.  Those rare flips are the
# expected outliers, hence a share of pixels and not every pixel.
KERNEL_TOL = 2e-4
KERNEL_MIN_SHARE = 0.99
KERNEL_MEAN_RTOL = 1e-3
PARITY_RAYS = 1024
EYE = (0.0, 0.0, 3.2)
REFERENCE_EYE = (0.5, 0.0, 2.5)   # index.js:39
# Kernel-name groups of the device-time breakdown.
MEGAKERNELS = {"megakernel_fwd": ["megakernel_fwd"],
               "megakernel_bwd": ["megakernel_bwd"]}
TRAVERSAL = {"bvh_closest_hit": ["bvh_stack_walk_kernel"],
             "bvh_pack": ["bvh_pack_kernel"]}
# The sol rows: key prefix in the workload's result, name in the line.
SOL_ROWS = (("fwd", "megakernel_fwd"), ("fwd_bwd", "megakernel_fwd_bwd"),
            ("trav", "traversal"))


# ------------------------------------------------------------------ timing


def _marginal(run, n1, n2):
    """Marginal per-iteration seconds between a short and a long run."""
    t1 = run(n1)
    t2 = run(n2)
    return max((t2 - t1) / (n2 - n1), 1e-9)


def _marginal3(run, n1, n2):
    """Median of five marginals and their relative spread (bench.py:47)."""
    ms = sorted(_marginal(run, n1, n2) for _ in range(5))
    med = ms[2]
    return med, (ms[-1] - ms[0]) / max(med, 1e-12)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    return x


def _chain_run(step, init, device):
    """``run(iters)``: fold ``step`` serially from ``init``, wait for the
    device and copy the chained state to the host; returns seconds."""

    def run(iters):
        cur = init
        t0 = time.perf_counter()
        for _ in range(iters):
            cur = step(cur)
        _sync(device)
        _to_host(cur)
        return time.perf_counter() - t0

    return run


def _launch_counts():
    from .kernels import megakernel as mk
    from .kernels import traversal

    return {"megakernel_fwd": mk.LAUNCHES, "megakernel_bwd": mk.BWD_LAUNCHES,
            "bvh_closest_hit": traversal.LAUNCHES,
            "bvh_pack": traversal.PACK_LAUNCHES}


def _launches(fn, device, kernels):
    """Run ``fn`` once; the launches of each of ``kernels`` it made.  On
    the card every one of them must have launched."""
    before = _launch_counts()
    out = fn()
    _sync(device)
    after = _launch_counts()
    counts = {k: after[k] - before[k] for k in kernels}
    if device.type == "cuda" and not all(counts.values()):
        raise RuntimeError(f"the kernels of this row did not all launch: "
                           f"{counts}")
    return out, counts


def _measure(step, init, device, window, kernels, median_of_five):
    """Warm-up step (launch counts), the marginal ms per step over
    ``window``, and the device ms per step, all kernels and by group."""
    from .utils.profiling import profile_device_ms

    state, launches = _launches(lambda: _to_host(step(init)), device,
                                kernels)
    run = _chain_run(step, init, device)
    if median_of_five:
        dt, spread = _marginal3(run, *window)
    else:
        dt, spread = _marginal(run, *window), None
    chained = [init]

    def one():
        chained[0] = step(chained[0])

    if device.type == "cuda":
        dev_ms, _ = profile_device_ms(one, 3, kernels)
    else:   # a CPU run has no device time
        dev_ms = {k: "not measured" for k in [*kernels, "all"]}
    row = {"ms": dt * 1e3, "device_ms": dev_ms.pop("all"),
           "kernel_device_ms": dev_ms, "launches_per_step": launches}
    if spread is not None:
        row["spread_pct"] = spread * 100.0
    return row


# ---------------------------------------------------------- scenes, checks


def _device(device):
    if str(device) == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    return torch.device("cuda", 0)


def _room(b):
    """bench.py's mesh room: a red default, white back and front walls
    and the emissive quad.  Returns the white material."""
    from .core.config import LAMBERTIAN

    b.add_material("default", LAMBERTIAN, [1, 0, 0])
    white = b.add_material("white", LAMBERTIAN, [0.73, 0.73, 0.73])
    light = b.add_material("light", LAMBERTIAN, [0, 0, 0],
                           emission=[2, 2, 2])
    b.add_quad([-2, -2, -2], [4, 0, 0], [0, 4, 0], white)
    b.add_quad([-2, 2, -2], [4, 0, 0], [0, 0, 4], light)
    b.add_quad([-2, -2, 2], [4, 0, 0], [0, 0, -4], white)
    return white


def mesh_scene(subdivisions, device, timings=None):
    """bench.py:301's mesh scene: the room and a mirror icosphere of radius
    0.8 (20 * 4**subdivisions triangles), median BVH.  ``timings`` also
    receives ``mesh_gen_s``, the icosphere's generation."""
    from .core.config import MIRROR
    from .scene import procedural
    from .scene.builder import SceneBuilder

    b = SceneBuilder()
    _room(b)
    mirror = b.add_material("mirror", MIRROR, [0.9, 0.9, 0.9])
    start = time.perf_counter()
    mesh = procedural.icosphere(subdivisions=subdivisions, radius=0.8)
    if timings is not None:
        timings["mesh_gen_s"] = time.perf_counter() - start
    b.add_mesh(mesh, mirror)
    return b.build(bvh="median", timings=timings, device=device)


def monkey_scene(device, path=None):
    """bench.py:365's scene: the room and the reference's monkey OBJ,
    scaled by 1.1, median BVH.  Raises FileNotFoundError without it."""
    from .scene.builder import SceneBuilder
    from .scene.objreader import load_obj
    from .scene.transform import Transform

    path = path or MONKEY_OBJ
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    b = SceneBuilder()
    white = _room(b)
    b.add_mesh(load_obj(path), white,
               Transform().update(Transform.scale(1.1, 1.1, 1.1)))
    return b.build(bvh="median", device=device)


def _view(eye, device):
    from .core.camera import Camera

    return torch.as_tensor(Camera(eye=list(eye), center=[0, 0, 0])
                           .view_matrix, device=device)


def check_forward(scene, meta, cfg, eye, device):
    """A 16x8 frame of the forward megakernel against the eager wavefront
    from the same PCG states; raises when fewer than KERNEL_MIN_SHARE of
    the pixels are within KERNEL_TOL or the means differ."""
    from .core import rng
    from .integrator.render import pixel_grid
    from .kernels import megakernel as mk

    small = cfg.replace(width=16, height=8, use_megakernel=True)
    if not mk.supported(scene, meta, small):
        raise RuntimeError("the forward megakernel does not cover the scene")
    pix, px, py = pixel_grid(small.width, small.height, device)
    state, view = rng.seed(pix, 3), _view(eye, device)
    with torch.no_grad():
        got, _ = _launches(lambda: mk.path_trace_pixels_megakernel(
            state, view, px, py, scene, meta, small), device,
            ["megakernel_fwd"])
        ref = mk.path_trace_pixels_reference(state, view, px, py, scene,
                                             meta, small)
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    share = float(np.isclose(got, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL)
                  .all(axis=-1).mean())
    out = {"pixels": got.shape[0], "share_within_tol": share,
           "max_abs_err": float(np.abs(got - ref).max())}
    if (not np.isfinite(got).all() or share < KERNEL_MIN_SHARE
            or not np.allclose(got.mean(0), ref.mean(0),
                               rtol=KERNEL_MEAN_RTOL, atol=1e-6)):
        raise RuntimeError(f"forward megakernel against the wavefront: "
                           f"{out}")
    return out


def sphere_rays(n, seed, device, radius=0.81):
    """bench.py:518-525's traversal rays: origins on a sphere of
    ``radius`` about the origin, directions uniform, t_best0 1e9."""
    k = np.random.default_rng(seed)
    op = k.normal(size=(n, 3))
    op /= np.linalg.norm(op, axis=1, keepdims=True)
    dd = k.normal(size=(n, 3))
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    return (torch.from_numpy((op * radius).astype(np.float32)).to(device),
            torch.from_numpy(dd.astype(np.float32)).to(device),
            torch.full((n,), 1e9, dtype=torch.float32, device=device))


def check_traversal(scene, meta, cfg, device, n=PARITY_RAYS):
    """``n`` rays of the traversal kernel against the plain walk: the same
    triangle index on every lane and t equal bit for bit; raises
    otherwise."""
    from .kernels import traversal

    o, d, t0 = sphere_rays(n, 5, device)
    (t_k, i_k), _ = _launches(lambda: traversal.closest_hit(
        o, d, scene.bvh, scene.triangles, cfg.t_min, t0), device,
        ["bvh_closest_hit"])
    t_p, i_p = traversal.bvh_closest_hit(o, d, scene.bvh, scene.triangles,
                                         cfg.t_min, t0, meta.max_leaf)
    same_index = float((i_k == i_p).float().mean())
    t_bits = bool(torch.equal(t_k.view(torch.int32), t_p.view(torch.int32)))
    hits = float((i_p >= 0).float().mean())
    out = {"rays": n, "same_index": same_index, "t_bit_equal": t_bits,
           "hit_share": hits}
    if same_index != 1.0 or not t_bits or hits == 0.0:
        raise RuntimeError(f"traversal kernel against the walk: {out}")
    return out


# -------------------------------------------------------------- workloads


def fwd_bwd_loss(scene, meta, cfg, eye, groups, device):
    """bench.py:113's loss: the MSE of one frame against a black target,
    a function of the ``groups`` parameters (``diff.params``) and the
    frame number.  Returns ``(loss(params, frame_num), params)``, the
    parameters as the scene holds them."""
    from .core import rng
    from .diff.params import apply_params, extract_params
    from .integrator.render import path_trace_pixels, pixel_grid

    pix, px, py = pixel_grid(cfg.width, cfg.height, device)
    view = _view(eye, device)
    target = torch.zeros((pix.shape[0], 3), dtype=torch.float32,
                         device=device)

    def loss(params, frame_num):
        s = apply_params(scene, params)
        _, radiance = path_trace_pixels(rng.seed(pix, frame_num), view, px,
                                        py, s, meta, cfg)
        return torch.mean((radiance - target) ** 2)

    return loss, {k: v.detach().clone()
                  for k, v in extract_params(scene, groups).items()}


def _train_step(loss):
    """bench.py:126's chained step on ``(params, frame_num)``: the loss's
    gradients, ``p - 1e-18 * g`` (a nonzero factor keeps the backward in
    the chain without moving the parameters) and the next frame."""

    def step(state):
        params, frame_num = state
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        grads = torch.autograd.grad(loss(leaves, frame_num),
                                    list(leaves.values()), allow_unused=True)
        return ({k: p.detach() if g is None else p.detach() - 1e-18 * g
                 for (k, p), g in zip(leaves.items(), grads)}, frame_num + 1)

    return step


def bench_fwd_bwd(width=512, height=512, bounces=4, use_megakernel=False,
                  scene_builder=None, importance_sampling=True,
                  groups=("emission", "bsdf"), eye=EYE, window=(5, 35),
                  device="cuda"):
    """bench.py:88: fwd+bwd of the loss and the chained update, Cornell box
    unless ``scene_builder(device) -> (scene, meta)`` says otherwise."""
    from .core.config import RenderConfig
    from .kernels import megakernel as mk
    from .scene import builtin

    dev = _device(device)
    if scene_builder is None:
        scene, meta, _ = builtin.cornell_box(device=dev)
    else:
        scene, meta = scene_builder(dev)
    cfg = RenderConfig(width=width, height=height, max_bounces=bounces,
                       importance_sampling=importance_sampling,
                       use_megakernel=use_megakernel)
    out = {}
    if use_megakernel:
        if not mk.vjp_supported(scene, meta, cfg):
            raise RuntimeError("no differentiable megakernel route")
        out["parity"] = check_forward(scene, meta, cfg, eye, dev)
        kernels = MEGAKERNELS
    elif meta.traversal == "bvh":
        out["parity"] = check_traversal(scene, meta, cfg, dev)
        kernels = TRAVERSAL
    else:
        kernels = {}
    loss, params = fwd_bwd_loss(scene, meta, cfg, eye, groups, dev)
    row = _measure(_train_step(loss), (params, 1), dev, window, kernels,
                   median_of_five=True)
    n = width * height
    out.update(mrays=n / (row["ms"] * 1e-3) / 1e6, step_ms=row.pop("ms"),
               **row)
    return out


def bench_fwd_bwd_megakernel(width=512, height=512, bounces=4,
                             window=(10, 110), device="cuda"):
    """bench.py:146, the headline: both megakernels (the forward and its
    hand-written adjoint) through ``cfg.use_megakernel``."""
    return bench_fwd_bwd(width, height, bounces, use_megakernel=True,
                         window=window, device=device)


def bench_fwd_bwd_reference_scene(width=512, height=512, bounces=4,
                                  window=(10, 60), device="cuda"):
    """bench.py:156: the reference scene with its 12-triangle glass cube
    trained through both megakernels, NEE off."""
    from .scene import builtin

    def build(dev):
        scene, meta, _ = builtin.reference_scene(include_mesh=True,
                                                 device=dev)
        return scene, meta

    return bench_fwd_bwd(width, height, bounces, use_megakernel=True,
                         scene_builder=build, importance_sampling=False,
                         eye=REFERENCE_EYE, window=window, device=device)


def bench_fwd_bwd_mesh(width=512, height=512, bounces=4, subdivisions=6,
                       window=(1, 4), device="cuda"):
    """bench.py:177: the mirror icosphere's emission and vertex positions
    (the BVH refit every step) through the wavefront and the traversal
    kernel."""
    res = bench_fwd_bwd(width, height, bounces,
                        scene_builder=lambda dev: mesh_scene(subdivisions,
                                                             dev),
                        groups=("emission", "vertices"), window=window,
                        device=device)
    res["tris"] = 20 * 4 ** subdivisions
    return res


def _forward_frames(scene, meta, cfg, eye, dev, window, kernels,
                    megakernel):
    """Chained forward frames (bench.py:227-235): the radiance's first
    channel, truncated to an integer, is added to the PCG states."""
    from .core import rng
    from .integrator.render import path_trace_pixels, pixel_grid
    from .kernels import megakernel as mk

    pix, px, py = pixel_grid(cfg.width, cfg.height, dev)
    view = _view(eye, dev)
    trace = (mk.path_trace_pixels_megakernel if megakernel
             else lambda *a: path_trace_pixels(*a)[1])

    def step(rs):
        with torch.no_grad():
            r = trace(rs, view, px, py, scene, meta, cfg)
        return (rs + r[:, 0].to(torch.int64)) & rng.MASK

    row = _measure(step, rng.seed(pix, 7), dev, window, kernels,
                   median_of_five=False)
    row["mrays"] = cfg.width * cfg.height / (row["ms"] * 1e-3) / 1e6
    return row


def _forward_row(scene, meta, cfg, eye, dev, window, megakernel):
    out = {}
    if megakernel:
        out["parity"] = check_forward(scene, meta, cfg, eye, dev)
        kernels = {"megakernel_fwd": MEGAKERNELS["megakernel_fwd"]}
    elif meta.traversal == "bvh":
        out["parity"] = check_traversal(scene, meta, cfg, dev)
        kernels = TRAVERSAL
    else:
        kernels = {}
    row = _forward_frames(scene, meta, cfg, eye, dev, window, kernels,
                          megakernel)
    out.update(row)
    return out


def bench_fwd_wavefront(width=512, height=512, bounces=4, window=(3, 23),
                        device="cuda"):
    """bench.py:211: Cornell forward frames through the eager wavefront."""
    from .core.config import RenderConfig
    from .scene import builtin

    dev = _device(device)
    scene, meta, _ = builtin.cornell_box(device=dev)
    cfg = RenderConfig(width=width, height=height, max_bounces=bounces,
                       importance_sampling=True)
    out = _forward_row(scene, meta, cfg, EYE, dev, window, False)
    out["step_ms"] = out.pop("ms")
    return out


def bench_fwd_pallas(width=512, height=512, bounces=4, window=(10, 110),
                     device="cuda"):
    """bench.py:272: Cornell forward frames through the forward
    megakernel."""
    from .core.config import RenderConfig
    from .scene import builtin

    dev = _device(device)
    scene, meta, _ = builtin.cornell_box(device=dev)
    cfg = RenderConfig(width=width, height=height, max_bounces=bounces,
                       importance_sampling=True)
    out = _forward_row(scene, meta, cfg, EYE, dev, window, True)
    out["step_ms"] = out.pop("ms")
    return out


def bench_fwd_reference_scene(width=512, height=512, bounces=4,
                              window=(10, 110), device="cuda"):
    """bench.py:238: the reference scene with its glass cube through the
    forward megakernel, NEE off."""
    from .core.config import RenderConfig
    from .scene import builtin

    dev = _device(device)
    scene, meta, _ = builtin.reference_scene(include_mesh=True, device=dev)
    cfg = RenderConfig(width=width, height=height, max_bounces=bounces)
    out = _forward_row(scene, meta, cfg, REFERENCE_EYE, dev, window, True)
    out["step_ms"] = out.pop("ms")
    return out


def bench_mesh_bvh(width=512, height=512, bounces=4, subdivisions=6,
                   window=(1, 5), device="cuda"):
    """bench.py:301: mesh frames through the traversal kernel, with the
    icosphere's generation, the BVH build alone, the whole build and the
    wait for the upload after it, each in ms."""
    from .core.config import RenderConfig

    dev = _device(device)
    timings = {}
    start = time.perf_counter()
    scene, meta = mesh_scene(subdivisions, dev, timings)
    build_total_s = time.perf_counter() - start - timings["mesh_gen_s"]
    start = time.perf_counter()
    _sync(dev)
    upload_s = time.perf_counter() - start
    cfg = RenderConfig(width=width, height=height, max_bounces=bounces,
                       importance_sampling=True)
    out = _forward_row(scene, meta, cfg, EYE, dev, window, False)
    out.update(frame_ms=out.pop("ms"),
               mesh_gen_ms=timings["mesh_gen_s"] * 1e3,
               bvh_build_ms=timings["bvh_build_s"] * 1e3,
               build_total_ms=build_total_s * 1e3, upload_ms=upload_s * 1e3,
               tris=scene.triangles.count)
    return out


def bench_mesh_monkey(width=512, height=512, bounces=4, window=(2, 12),
                      device="cuda"):
    """bench.py:365: the reference's monkey OBJ through the OBJ, BVH and
    traversal path.  Raises FileNotFoundError without the asset."""
    from .core.config import RenderConfig

    dev = _device(device)
    scene, meta = monkey_scene(dev)
    cfg = RenderConfig(width=width, height=height, max_bounces=bounces,
                       importance_sampling=True)
    out = _forward_row(scene, meta, cfg, EYE, dev, window, False)
    out.update(frame_ms=out.pop("ms"), tris=scene.triangles.count)
    return out


def bench_mesh_bvh_327k(width=512, height=512, bounces=4, window=(1, 5),
                        device="cuda"):
    """bench.py:568: 327,680 triangles at 512x512."""
    return bench_mesh_bvh(width, height, bounces, 7, window, device)


def bench_mesh_bvh_327k_1024(width=1024, height=1024, bounces=4,
                             window=(1, 5), device="cuda"):
    """bench.py:418: 327,680 triangles at 1024x1024."""
    return bench_mesh_bvh(width, height, bounces, 7, window, device)


def _sol_row(prefix, row, b, kernels):
    """bench.py's sol keys for one measured step and its bound ``b``, over
    wall time and over the bounded kernels' device time."""
    kernel_ms = [row["kernel_device_ms"][k] for k in kernels]
    measured = all(isinstance(x, float) for x in kernel_ms)
    kernel_ms = sum(kernel_ms) if measured else "not measured"
    return {f"{prefix}_ms": row["ms"], f"{prefix}_device_ms":
            row["device_ms"], f"{prefix}_kernel_device_ms": kernel_ms,
            f"{prefix}_sol_us": b["bound_ms"] * 1e3,
            f"{prefix}_sol_frac": b["bound_ms"] / row["ms"],
            f"{prefix}_sol_frac_device": (b["bound_ms"] / kernel_ms
                                          if measured else "not measured"),
            f"{prefix}_bound_by": b["bound_by"], f"{prefix}_flops":
            b["flops"], f"{prefix}_bytes": b["bytes"],
            f"{prefix}_launches_per_step": row["launches_per_step"]}


def bench_sol(width=512, height=512, bounces=4, subdivisions=6,
              window=(10, 110), trav_window=(3, 13), device="cuda"):
    """bench.py:424: the forward megakernel's frame, the fwd+bwd train
    step and one traversal call over ``width * height`` rays of the mirror
    icosphere (bench.py:518-532), each beside its bound from
    ``utils.bounds``.  The fwd+bwd bound is the forward launch's and the
    backward launch's added, since the step runs them one after the
    other."""
    from .core.config import RenderConfig
    from .kernels import _build, traversal
    from .scene import builtin
    from .utils import bounds

    dev = _device(device)
    scene, meta, _ = builtin.cornell_box(device=dev)
    cfg = RenderConfig(width=width, height=height, max_bounces=bounces,
                       importance_sampling=True, use_megakernel=True)
    out = {"parity": {"forward": check_forward(scene, meta, cfg, EYE, dev)}}
    fwd = _forward_frames(scene, meta, cfg, EYE, dev, window,
                          {"megakernel_fwd": MEGAKERNELS["megakernel_fwd"]},
                          True)
    b_fwd = bounds.megakernel_bound(scene, meta, cfg, EYE, backward=False)
    out.update(_sol_row("fwd", fwd, b_fwd, ["megakernel_fwd"]))

    loss, params = fwd_bwd_loss(scene, meta, cfg, EYE, ("emission", "bsdf"),
                                dev)
    step = _measure(_train_step(loss), (params, 1), dev, window, MEGAKERNELS,
                    median_of_five=False)
    b_bwd = bounds.megakernel_bound(scene, meta, cfg, EYE, backward=True)
    flops, nbytes = (b_fwd["flops"] + b_bwd["flops"],
                     b_fwd["bytes"] + b_bwd["bytes"])
    b_step = {"bound_ms": b_fwd["bound_ms"] + b_bwd["bound_ms"],
              "bound_by": max((b_fwd, b_bwd),
                              key=lambda b: b["bound_ms"])["bound_by"],
              "flops": flops, "bytes": nbytes}
    out.update(_sol_row("fwd_bwd", step, b_step, list(MEGAKERNELS)))

    mscene, mmeta = mesh_scene(subdivisions, dev)
    out["parity"]["traversal"] = check_traversal(mscene, mmeta, cfg, dev)
    bvh, tris = mscene.bvh, mscene.triangles
    n = width * height
    o, d, t0 = sphere_rays(n, 11, dev)

    def trav(t):
        tt, ii = traversal.closest_hit(o, d, bvh, tris, cfg.t_min, t)
        return t + tt * 0.0 + ii.to(torch.float32) * 0.0

    row = _measure(trav, t0, dev, trav_window, TRAVERSAL,
                   median_of_five=False)
    rows, tri_rows = traversal.pack_bvh(bvh, tris)
    _, _, n_rows, n_tests = bounds.counted_walk(
        rows, tri_rows, o, d, t0, cfg.t_min,
        None if dev.type == "cuda" else _build.load_host_walk())
    b_trav = bounds.traversal_bound(n, rows.shape[0], tris.count,
                                    {"rows": n_rows, "tri_tests": n_tests})
    out.update(_sol_row("trav", row, b_trav, ["bvh_closest_hit"]),
               trav_rays=n, trav_tris=tris.count,
               trav_row_fetches_per_ray=n_rows / n,
               trav_tri_tests_per_ray=n_tests / n)
    return out


def _scaling_rank(args, mesh):
    """One rank of ``scaling``: ``measure_scaling`` over the group; the
    first rank writes the report."""
    from .dist.render_dist import measure_scaling
    from .dist.sharding import mesh_rank

    report = measure_scaling(width=args.width, height=args.height,
                             bounces=args.bounces, device_type=args.device)
    if mesh_rank(mesh) == 0:
        with open(args.out, "w") as f:
            json.dump(report, f)


def bench_scaling(width=256, height=256, bounces=4, device="cuda"):
    """bench.py:550: the sharded train step's throughput on one rank and
    on as many ranks as cards, at least two, each rank a process started
    here.  Where ranks share a device the efficiency is sharding overhead,
    not a speedup (``shares_device``)."""
    import tempfile
    import types

    from .cli import _run_ranks

    dev = _device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    world = max(2, cards)
    with tempfile.TemporaryDirectory() as tmp:
        args = types.SimpleNamespace(
            device=dev.type, multihost=False, width=width, height=height,
            bounces=bounces, out=os.path.join(tmp, "scaling.json"))
        _run_ranks(args, _scaling_rank, world)
        with open(args.out) as f:
            report = json.load(f)
    report.update(ranks=world, shares_device=world > cards)
    return report


WORKLOADS = {
    "fwd_bwd_megakernel": bench_fwd_bwd_megakernel,
    "fwd_bwd": bench_fwd_bwd,
    "fwd_bwd_reference_scene": bench_fwd_bwd_reference_scene,
    "fwd_bwd_mesh": bench_fwd_bwd_mesh,
    "fwd_wavefront": bench_fwd_wavefront,
    "fwd_pallas": bench_fwd_pallas,
    "fwd_reference_scene": bench_fwd_reference_scene,
    "mesh_bvh": bench_mesh_bvh,
    "mesh_bvh_327k": bench_mesh_bvh_327k,
    "mesh_monkey": bench_mesh_monkey,
    "mesh_bvh_327k_1024": bench_mesh_bvh_327k_1024,
    "sol": bench_sol,
    "scaling": bench_scaling,
}


# ------------------------------------------------------- child and parent


def run_workload(name, device):
    """Child side: one workload; its result or its error as a payload."""
    try:
        return {"ok": True, "result": WORKLOADS[name](device=device)}
    except Exception as e:  # noqa: BLE001 - reported; the parent decides
        traceback.print_exc()
        return {"ok": False, "error": f"{type(e).__name__}: {e}"[:500]}


def parse_child(returncode, stdout, stderr):
    """``(result, error)`` from a child's output: its last BENCH_RESULT
    line, or the end of its output when it died without one."""
    for line in reversed(stdout.splitlines()):
        if line.startswith("BENCH_RESULT "):
            try:
                payload = json.loads(line[len("BENCH_RESULT "):])
            except json.JSONDecodeError:
                break
            if payload.get("ok"):
                return payload["result"], None
            return None, payload.get("error", "unknown error")
    tail = (stderr or stdout or "").strip().splitlines()[-3:]
    return None, (f"process died rc={returncode}: " + " | ".join(tail))[:500]


def _spawn(name, device):
    """Run one workload in a process of its own; never raises."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_path_tracer_torch.bench",
             "--workload", name, "--device", device],
            capture_output=True, text=True, timeout=WORKLOAD_TIMEOUT_S,
            env=env)
    except subprocess.TimeoutExpired:
        return None, f"timeout after {WORKLOAD_TIMEOUT_S}s"
    return parse_child(proc.returncode, proc.stdout, proc.stderr)


def environment(device):
    """What the line records of the machine: the card's name and power
    limit (nvidia-smi), torch, CUDA and nvcc, and whether triton imports."""
    from .kernels import _build

    card = None
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60)
        if proc.returncode == 0 and proc.stdout.strip():
            card = proc.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    try:
        nvcc = _build.nvcc_path()
    except RuntimeError:
        nvcc = None
    try:
        import triton  # noqa: F401
        has_triton = True
    except ImportError:
        has_triton = False
    return {"device": device, "card": card, "torch": torch.__version__,
            "torch_cuda": torch.version.cuda, "nvcc": nvcc,
            "triton": has_triton, "workload_rev": WORKLOAD_REV}


def summarize(results, errors, skipped, gated, env):
    """The line: bench.py's shape and keys (bench.py:672-727), the
    headline ``fwd_bwd_megakernel``'s Mray/s or null."""

    def get(name, key):
        r = results.get(name)
        return r.get(key) if r else None

    def ratio(a, b):
        return a / b if a is not None and b else None

    headline = get("fwd_bwd_megakernel", "mrays")
    extra = {
        "fwd_bwd_megakernel_mrays": headline,
        "fwd_bwd_megakernel_ms": get("fwd_bwd_megakernel", "step_ms"),
        "fwd_bwd_wavefront_mrays": get("fwd_bwd", "mrays"),
        "fwd_bwd_reference_scene_mrays": get("fwd_bwd_reference_scene",
                                             "mrays"),
        "fwd_bwd_mesh_82k_tris_mrays": get("fwd_bwd_mesh", "mrays"),
        "fwd_bwd_mesh_step_ms": get("fwd_bwd_mesh", "step_ms"),
        "fwd_bwd_mesh_over_fwd_frame": ratio(get("fwd_bwd_mesh", "step_ms"),
                                             get("mesh_bvh", "frame_ms")),
        "fwd_wavefront_mrays": get("fwd_wavefront", "mrays"),
        "fwd_pallas_megakernel_mrays": get("fwd_pallas", "mrays"),
        "fwd_reference_scene_megakernel_mrays": get("fwd_reference_scene",
                                                    "mrays"),
        "fwd_mesh_bvh_82k_tris_mrays": get("mesh_bvh", "mrays"),
        "fwd_mesh_bvh_327k_tris_mrays": get("mesh_bvh_327k", "mrays"),
        "mesh_327k_frame_ms": get("mesh_bvh_327k", "frame_ms"),
        "mesh_327k_bvh_build_ms": get("mesh_bvh_327k", "bvh_build_ms"),
        "mesh_327k_tris": get("mesh_bvh_327k", "tris"),
        "fwd_bwd_step_ms": get("fwd_bwd", "step_ms"),
        "fwd_wavefront_ms": get("fwd_wavefront", "step_ms"),
        "fwd_pallas_ms": get("fwd_pallas", "step_ms"),
        "mesh_frame_ms": get("mesh_bvh", "frame_ms"),
        "mesh_bvh_build_ms": get("mesh_bvh", "bvh_build_ms"),
        "mesh_gen_ms": get("mesh_bvh", "mesh_gen_ms"),
        "mesh_upload_ms": get("mesh_bvh", "upload_ms"),
        "mesh_tris": get("mesh_bvh", "tris"),
        "mesh_monkey_mrays": get("mesh_monkey", "mrays"),
        "mesh_monkey_tris": get("mesh_monkey", "tris"),
        "mesh_327k_1024_mrays": get("mesh_bvh_327k_1024", "mrays"),
        "mesh_327k_1024_frame_ms": get("mesh_bvh_327k_1024", "frame_ms"),
        "sol_frac_megakernel_fwd": get("sol", "fwd_sol_frac"),
        "sol_frac_megakernel_fwd_bwd": get("sol", "fwd_bwd_sol_frac"),
        "sol_frac_traversal": get("sol", "trav_sol_frac"),
        "scaling_efficiency": get("scaling", "efficiency"),
        "scaling_ranks": get("scaling", "ranks"),
        "scaling_shares_device": get("scaling", "shares_device"),
        "scaling_kind": get("scaling", "kind"),
        "scaling_spread_pct": get("scaling", "spread_pct"),
        "headline_spread_pct": get("fwd_bwd_megakernel", "spread_pct"),
        "headline_sanity_gated": gated,
    }
    for name in WORKLOADS:
        if get(name, "device_ms") is not None:
            extra[f"{name}_device_ms"] = get(name, "device_ms")
            extra[f"{name}_kernel_device_ms"] = get(name, "kernel_device_ms")
            extra[f"{name}_launches_per_step"] = get(name,
                                                     "launches_per_step")
    sol = results.get("sol")
    for prefix, name in SOL_ROWS:
        extra[f"sol_frac_{name}_device"] = get("sol", f"{prefix}_sol_frac"
                                               "_device")
    extra["sol_bounds"] = ({name: {k: sol[f"{prefix}_{k}"] for k in (
        "sol_us", "bound_by", "flops", "bytes", "kernel_device_ms")}
        for prefix, name in SOL_ROWS} if sol else None)
    extra["parity"] = {name: r["parity"] for name, r in results.items()
                       if r and "parity" in r}
    extra.update(env, skipped=skipped or None, errors=errors or None)
    return {"metric": "Mray/s/chip fwd+bwd @4 bounces (Cornell 512x512, NEE)",
            "value": headline, "unit": "Mray/s",
            "vs_baseline": ratio(headline, BASELINE_MRAYS), "extra": extra}


def run_all(device):
    """The parent: every workload in a process of its own, the sanity gate
    (bench.py:649-665), and the line."""
    if device == "cuda":
        _device(device)   # raises without a card
        from .kernels import _build
        _build.build()    # once here, not in every child
    from .accel import native
    native.available()
    results, errors, skipped = {}, {}, {}
    for name in WORKLOADS:
        if name == "mesh_monkey" and not os.path.exists(MONKEY_OBJ):
            results[name] = None
            skipped[name] = f"asset absent: {MONKEY_OBJ}"
            print(f"# {name}: skipped ({skipped[name]})", file=sys.stderr,
                  flush=True)
            continue
        res, err = _spawn(name, device)
        results[name] = res
        if err:
            errors[name] = err
        print(f"# {name}: {res if res else 'FAILED: ' + str(err)}",
              file=sys.stderr, flush=True)
    # fwd+bwd can never be faster than 1.5x the forward megakernel; a
    # violation means the marginal caught a timing artifact, so measure
    # once more and keep the slower run.
    gated = False
    mk, fp = results.get("fwd_bwd_megakernel"), results.get("fwd_pallas")
    if mk and fp and mk["step_ms"] < 1.5 * fp["step_ms"]:
        gated = True
        again, _ = _spawn("fwd_bwd_megakernel", device)
        if again and again["step_ms"] > mk["step_ms"]:
            results["fwd_bwd_megakernel"] = again
    return summarize(results, errors, skipped, gated, environment(device))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tpu_path_tracer_torch.bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--workload", choices=sorted(WORKLOADS), default=None,
                   help="run one workload here and print its BENCH_RESULT "
                        "line (a child of the harness)")
    args = p.parse_args(argv)
    if args.workload:
        payload = run_workload(args.workload, args.device)
        print("BENCH_RESULT " + json.dumps(payload), flush=True)
        return 0 if payload["ok"] else 1
    line = run_all(args.device)
    print(json.dumps(line), flush=True)
    return 1 if line["extra"]["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
