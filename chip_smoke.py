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
   torch.profiler breakdown of the main path's device time.

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


def profile_phase(torch, pt, device, frame_ms, frames=8):
    """Device time of the main path by kernel (torch.profiler), and the
    share of a frame's wall time (phase 5, unprofiled) the device is busy.
    Reports "not measured" where the profiler records no device time."""
    from torch.autograd import DeviceType
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

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # Only the kernels themselves: a CPU op that launched a kernel reports
    # the same device time again.
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and device_us(e) > 0),
                  key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in rows) / 1e3 / frames
    phase("profile", frames=frames,
          device_ms_per_frame=busy_ms if rows else "not measured",
          frame_wall_ms=frame_ms,
          device_busy_share=busy_ms / frame_ms if rows else "not measured",
          top=[{"name": e.key[:60], "calls": e.count,
                "ms_per_frame": device_us(e) / 1e3 / frames}
               for e in rows[:6]])


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
    print(json.dumps({"kernels": [{
        "name": "megakernel_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": times["kernel"],
        "plain_ms": times["plain"]}]}))
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
