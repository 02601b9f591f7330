#!/usr/bin/env python3
"""Time the two megakernels of several source trees against each other on
one GPU, at the main path's shapes, and check that their forwards agree.

Run from the repository root::

    python3 kernel_ab.py --tree old=_scratch/parent --tree new=. \\
        [--tree NAME=DIR ...] [--bits] [--reps 10] [--out DIR]

Each ``--tree NAME=DIR`` is a checkout root holding
``tpu_path_tracer_torch/csrc``: another commit's sources (a ``git
archive`` unpacked under the gitignored ``_scratch/``), or a copy with one
edit to time what that edit costs.  The package's own build
(``kernels/_build.build``, the port's nvcc flags, one nvcc per source)
compiles every tree at once, each into a library of its own, and the
script calls the kernels through their C entry points, which every tree
shares, on the same inputs packed by this checkout's
``kernels.megakernel``:

* forward: ``reference_scene()`` at 512x512, 4 bounces, 1 spp, NEE off (the
  render main path's frame);
* backward: ``cornell_box()`` at 512x512, 4 bounces, NEE on (the training
  step's shapes), with a seeded cotangent.

Each kernel is timed in turns: the trees in order, then in reverse order;
each turn profiles ``--reps`` launches after two warm-up launches with
torch.profiler (CUDA events when the profiler sees no device time), and
the script prints per tree and kernel the median, minimum and maximum
device ms per launch, with the registers, static shared memory and spills
ptxas reported.  ``--bits`` saves each tree's forward radiance on the
512x512 frame and on chip_smoke.py phase 3's four 64x64 cases (frame 3 PCG
states) as ``.npy`` files under ``--out`` and counts, for every tree, the
pixels that differ in any bit from the first tree's; it also reports how
far each backward's table gradients lie from the first tree's.  The last
line is one JSON object with everything.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = {"fwd": "megakernel_fwd_kernel", "bwd": "megakernel_bwd_kernel"}


def csrc_of(tree):
    return os.path.join(tree, "tpu_path_tracer_torch", "csrc")


def build_all(trees, build_root):
    """Build every tree's library at once, each with the package's own
    build into a directory of its own; returns {name: (CDLL, {kernel:
    ptxas report})}."""
    from tpu_path_tracer_torch.kernels import _build

    def one(item):
        name, tree = item
        return _build.build(Path(csrc_of(tree)), Path(build_root) / name)

    with ThreadPoolExecutor(len(trees)) as pool:
        paths = dict(zip(trees, pool.map(one, trees.items())))
    libs = {}
    for name, path in paths.items():
        log = path.with_suffix(".log").read_text()
        libs[name] = (ctypes.CDLL(str(path)),
                      {k: _build.ptxas_report(log, v)
                       for k, v in KERNELS.items()})
    return libs


def inputs(torch, pt, device):
    """The packed arguments of both kernels at the main path's shapes."""
    import numpy as np
    from tpu_path_tracer_torch.core import rng
    from tpu_path_tracer_torch.integrator.render import pixel_grid
    from tpu_path_tracer_torch.kernels import megakernel as mk

    def args(scene_fn, eye, cfg, frame):
        scene, meta, _ = scene_fn(device=device)
        view = torch.as_tensor(pt.Camera(eye=eye, center=[0, 0, 0])
                               .view_matrix, device=device)
        pix, px, py = pixel_grid(cfg.width, cfg.height, device)
        tables = mk.pack_tables(scene) + (view.to(torch.float32),)
        flat, counts, st, px32, py32 = mk._prepare(rng.seed(pix, frame), px,
                                                   py, tables, scene)
        return (flat, counts, st, px32, py32,
                mk._scalar_args(scene, meta, cfg, px.shape[0]), cfg)

    B = pt.builtin
    fwd = args(B.reference_scene, [0.5, 0.0, 2.5],
               pt.RenderConfig(width=512, height=512, max_bounces=4), 1)
    bwd = args(B.cornell_box, [0, 0, 3.2],
               pt.RenderConfig(width=512, height=512, max_bounces=4,
                               importance_sampling=True), 1)
    n = bwd[3].shape[0]
    g = np.random.default_rng(5).normal(size=(n, 3)) * 1e-6
    gout = torch.as_tensor(g, dtype=torch.float32, device=device)
    # chip_smoke.py phase 3's four 64x64 cases, frame 3.
    small = {
        name: args(fn, eye, pt.RenderConfig(width=64, height=64, **kw), 3)
        for name, fn, eye, kw in (
            ("cornell_nee_off", B.cornell_box, [0, 0, 3.2],
             dict(max_bounces=4)),
            ("cornell_nee_on", B.cornell_box, [0, 0, 3.2],
             dict(max_bounces=4, importance_sampling=True)),
            ("reference_full", B.reference_scene, [0.5, 0.0, 2.5],
             dict(max_bounces=4)),
            ("cornell_stratified_spp4", B.cornell_box, [0, 0, 3.2],
             dict(max_bounces=3, samples_per_pixel=4, stratify=True)))}
    small["reference_full_512_frame3"] = args(
        B.reference_scene, [0.5, 0.0, 2.5],
        pt.RenderConfig(width=512, height=512, max_bounces=4), 3)
    return fwd, bwd, gout, small


def launch(torch, lib, kind, a, gout=None):
    """One launch of ``kind`` from library ``lib`` on packed arguments
    ``a``; returns the radiance or the table gradients."""
    from tpu_path_tracer_torch.kernels import megakernel as mk

    flat, counts, st, px32, py32, scalars, cfg = a
    n = px32.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    fwd, bwd = mk._bind(lib)
    if kind == "fwd":
        out = torch.empty((n, 3), dtype=torch.float32, device=px32.device)
        err = fwd(flat.data_ptr(), *counts, st.data_ptr(), px32.data_ptr(),
                  py32.data_ptr(), out.data_ptr(), *scalars, stream)
    else:
        out = torch.zeros_like(flat)
        # The largest record scratch any tree has used (14 words a bounce).
        rec = torch.empty((cfg.max_bounces * 14 * n,), dtype=torch.float32,
                          device=px32.device)
        err = bwd(flat.data_ptr(), *counts, st.data_ptr(), px32.data_ptr(),
                  py32.data_ptr(), gout.data_ptr(), rec.data_ptr(),
                  out.data_ptr(), *scalars, stream)
    if err:
        raise SystemExit(f"{kind} launch failed: CUDA error {err}")
    return out


def device_ms(torch, fn, kernel, reps):
    """Device ms of each of ``reps`` calls of ``fn`` that ran ``kernel``,
    from torch.profiler, else from CUDA events around each call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name]
    if len(times) == reps:
        return times, "torch.profiler"
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times, "cuda events"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR, a checkout root")
    ap.add_argument("--bits", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(REPO, "_scratch",
                                                  "kernel_ab", "out"))
    ap.add_argument("--build-dir",
                    default=os.path.join(REPO, "_scratch", "kernel_ab"))
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs a CUDA GPU")
    sys.path.insert(0, REPO)
    import tpu_path_tracer_torch as pt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trees = {}
    for spec in args.tree:
        name, tree = spec.split("=", 1)
        trees[name] = os.path.abspath(tree)
    names = list(trees)
    first = names[0]
    t0 = time.perf_counter()
    libs = build_all(trees, args.build_dir)
    print(json.dumps({"build_seconds": time.perf_counter() - t0}),
          flush=True)

    device = torch.device("cuda", 0)
    fwd_args, bwd_args, gout, small = inputs(torch, pt, device)
    kernel_args = {"fwd": (fwd_args, None), "bwd": (bwd_args, gout)}
    results = {}
    for kind in ("fwd", "bwd"):
        samples = {v: [] for v in names}
        how = set()
        for v in names + names[::-1]:
            a, g = kernel_args[kind]
            t, method = device_ms(torch, lambda: launch(
                torch, libs[v][0], kind, a, g), KERNELS[kind], args.reps)
            samples[v] += t
            how.add(method)
        for v in names:
            t = samples[v]
            row = {"tree": v, "kernel": KERNELS[kind],
                   "median_ms": statistics.median(t), "min_ms": min(t),
                   "max_ms": max(t), "launches": len(t),
                   "timed_by": sorted(how), **libs[v][1][kind],
                   "card": smi}
            results.setdefault(kind, []).append(row)
            print(json.dumps(row), flush=True)

    bits = {}
    if args.bits:
        os.makedirs(args.out, exist_ok=True)
        cases = {"reference_full_512": fwd_args, **small}
        for case, a in cases.items():
            outs = {}
            for v in names:
                out = launch(torch, libs[v][0], "fwd", a).cpu().numpy()
                np.save(os.path.join(args.out, f"{case}.{v}.npy"), out)
                outs[v] = out.view(np.uint32)
            bits[case] = {v: int((o != outs[first]).any(axis=-1).sum())
                          for v, o in outs.items() if v != first}
            print(json.dumps({"bits": case, "pixels": len(outs[first]),
                              "differing_pixels": bits[case]}), flush=True)
        grads = {v: launch(torch, libs[v][0], "bwd", bwd_args, gout)
                 .cpu().numpy() for v in names}
        scale = float(np.abs(grads[first]).max())
        bits["bwd_max_diff_over_max"] = {
            v: float(np.abs(g - grads[first]).max()) / scale
            for v, g in grads.items() if v != first}
        print(json.dumps({"bwd_max_diff_over_max":
                          bits["bwd_max_diff_over_max"]}), flush=True)
    print(json.dumps({"card": smi, "kernels": results, "bits": bits}))


if __name__ == "__main__":
    main()
