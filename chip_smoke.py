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
   kernel's device time from torch.profiler.

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

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


class SmokeFailure(Exception):
    pass


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
    log = path.with_suffix(".log").read_text().splitlines()
    phase("build", seconds=round(seconds, 3), library=os.path.relpath(
        path, REPO), ptxas=[ln.strip() for ln in log if "Used" in ln
                            or "spill" in ln])


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
    Reports "not measured" where the profiler records no device time."""
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
    phase("profile", frames=frames,
          device_ms_per_frame=busy_ms if rows else "not measured",
          frame_wall_ms=frame_ms,
          device_busy_share=busy_ms / frame_ms if rows else "not measured",
          top=[{"name": e.key[:60], "calls": e.count,
                "ms_per_frame": device_us(e) / 1e3 / frames}
               for e in rows[:6]])


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


def run():
    import torch

    smi = device_phase(torch)
    import tpu_path_tracer_torch as pt

    build_phase()
    device = torch.device("cuda", 0)
    max_err = compare_phase(torch, pt, device)
    golden_phase(torch, pt, device)
    launches, frame_ms = main_path_phase(torch, pt, device)
    times = timing_phase(torch, pt, device, smi)
    profile_phase(torch, pt, device, frame_ms)
    grad_abs, grad_rel = grad_phase(torch, pt, device)
    train_launches = train_phase(torch, pt, device)
    train_times, kernel_ms = train_timing_phase(torch, pt, device, smi)
    print(json.dumps({"kernels": [
        {"name": "megakernel_fwd", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES,
         "launches": train_launches["megakernel_fwd"],
         "max_abs_err": max_err, "ms": times["kernel"],
         "plain_ms": times["plain"]},
        {"name": "megakernel_bwd", "route": "cuda", "source": BWD_SOURCE,
         "replaces": BWD_REPLACES,
         "launches": train_launches["megakernel_bwd"],
         "max_abs_err": grad_abs, "max_err_over_group_max": grad_rel,
         "ms": train_times["kernel"]["bwd_ms"],
         "plain_ms": train_times["plain"]["bwd_ms"],
         "device_ms": kernel_ms["megakernel_bwd"]}]}))
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
