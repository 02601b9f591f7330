#!/usr/bin/env python3
"""Time the kernels of several source trees against each other on one GPU,
at the main path's shapes, and check that they agree.

Run from the repository root::

    python3 kernel_ab.py --tree old=_scratch/parent --tree new=. \\
        [--tree NAME=DIR ...] [--kernel megakernels|traversal|pairs] \\
        [--bits] [--reps 10] [--out DIR]

Each ``--tree NAME=DIR`` is a checkout root holding
``tpu_path_tracer_torch/csrc``: another commit's sources (a ``git
archive`` unpacked under the gitignored ``_scratch/``), or a copy with one
edit to time what that edit costs.  The package's own build
(``kernels/_build.build``, the port's nvcc flags, one nvcc per source)
compiles every tree at once, each into a library of its own.

``--kernel megakernels`` (the default) calls the two megakernels through
their C entry points, which every tree shares, on the same inputs packed
by this checkout's ``kernels.megakernel``:

* forward: ``reference_scene()`` at 512x512, 4 bounces, 1 spp, NEE off (the
  render main path's frame);
* backward: ``cornell_box()`` at 512x512, 4 bounces, NEE on (the training
  step's shapes), with a seeded cotangent.

``--kernel traversal`` times each tree's BVH traversal kernel through that
tree's own wrapper (its ``kernels/traversal.py`` ``_launch``, imported from
the tree under a name of its own and bound to the library built here), so
each tree's tables are packed by its own packer.  The inputs are
chip_smoke.py's: the 65,536-ray bundle at 81,920 and at 327,680 triangles
(phase 10), and the four launches of one 512x512 frame of the mesh main
path (phase 11's scene and frame 3, recorded from ``render_frame``).  Each
tree's packing is timed too (CUDA events around its ``pack_bvh``).

``--kernel pairs`` times each tree's two pair kernels through that tree's
own ``pair_sweep`` / ``pairbin_sweep`` wrappers, on the launches this
checkout's emission lays out for chip_smoke.py's 65,536-ray bundle at
both mesh sizes (phase 15), for one 512x512 frame of the mesh main
path through each pair route (phase 16's scene, frame 3) and for one
1024x1024 frame at 327,680 triangles (the mesh timing's large frame,
where the emission's histograms are largest); a case's
launches are timed together and reported per case and per launch.  Then
each tree's whole entry point (``pairbin_closest_hit``,
``pair_closest_hit``) is timed on the bundles, and each route's frame
through each tree's entry point, in turns (CUDA events, and the device
time of every kernel of one call from torch.profiler).

Each kernel is timed in turns: the trees in order, then in reverse order;
each turn profiles ``--reps`` launches after two warm-up launches with
torch.profiler (CUDA events when the profiler sees no device time), and
the script prints per tree and kernel the median, minimum and maximum
device ms per launch, with the registers, static shared memory, spills
and stack frame ptxas reported.  ``--bits`` with the megakernels saves each
tree's forward radiance on the 512x512 frame and on chip_smoke.py phase
3's four 64x64 cases (frame 3 PCG states) as ``.npy`` files under
``--out`` and counts, for every tree, the pixels that differ in any bit
from the first tree's; it also reports how far each backward's table
gradients lie from the first tree's.  ``--bits`` with the traversal counts,
for every tree and input, the lanes whose triangle index or any bit of t
differs from the first tree's, and with the pairs the rows.  The last line is one JSON object with
everything.  Imports nothing of JAX.
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
# The traversal kernel's name in each tree: the stack walk, or the
# skip-link walk of the trees before it.
TRAVERSAL_KERNELS = ("bvh_stack_walk_kernel", "bvh_closest_hit_kernel")


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
        report = {k: _build.ptxas_report(log, v) for k, v in KERNELS.items()}
        report["traversal"] = next(
            _build.ptxas_report(log, k) for k in TRAVERSAL_KERNELS
            if f"{k}" in log)
        for route, kernel in PAIR_KERNELS.items():
            if kernel in log:
                report[route] = _build.ptxas_report(log, kernel)
        libs[name] = (ctypes.CDLL(str(path)), report)
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
    """Device ms of each of ``reps`` calls of ``fn`` that ran ``kernel`` (a
    name, or a tuple of names any of which counts), from torch.profiler,
    else from CUDA events around each call."""
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
    names = (kernel,) if isinstance(kernel, str) else kernel
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and any(k in e.name for k in names)]
    if times and len(times) % reps == 0:
        # A call of several launches: the sum of its launches.
        per = len(times) // reps
        return [sum(times[i:i + per]) for i in range(0, len(times), per)], (
            "torch.profiler")
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


def tree_package(name, tree, lib, submodule="traversal"):
    """The port's package of source tree ``tree``, imported as a module of
    its own (``kernel_ab_<name>``; the package imports itself only
    relatively), with its kernels bound to ``lib``; returns its
    ``kernels.<submodule>``."""
    import importlib.util

    pkg = os.path.join(tree, "tpu_path_tracer_torch")
    alias = f"kernel_ab_{name}"
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    build = importlib.import_module(f"{alias}.kernels._build")
    build._lib = lib
    return importlib.import_module(f"{alias}.kernels.{submodule}")


def traversal_inputs(torch, pt, device):
    """chip_smoke.py's traversal inputs: {case: (origin, direction, bvh,
    triangles, t_min, t_best0)} for the 65,536-ray bundle at both mesh
    sizes and each launch of one 512x512 mesh main-path frame."""
    import chip_smoke as cs
    from tpu_path_tracer_torch.integrator.render import render_frame

    t_min = pt.RenderConfig().t_min
    cases = {}
    for sub in cs.MESH_SUBDIVISIONS:
        scene, _ = cs.mesh_scene(sub, device)
        o, d, t0 = (torch.from_numpy(x).to(device) for x in cs.traversal_rays(
            cs.TRAV_RAYS, sub, 0.8, scene.triangles.a.cpu().numpy()))
        cases[f"bundle_{scene.triangles.count}"] = (
            o, d, scene.bvh, scene.triangles, t_min, t0)
    scene, meta = cs.mesh_scene(cs.MESH_SUBDIVISIONS[0], device)
    cfg = pt.RenderConfig(**cs.MESH_KW)
    view = pt.Camera(eye=cs.MESH_EYE, center=[0, 0, 0]).view_matrix
    calls = []
    with cs.recorded_traversal(calls):
        render_frame(torch.zeros((cfg.width * cfg.height, 3), device=device),
                     3, True, view, scene, meta, cfg)
    for bounce, call in enumerate(calls):
        cases[f"frame_bounce{bounce}"] = call
    return cases


def traversal_ab(torch, pt, device, trees, libs, args, smi):
    """The traversal kernel of every tree in turns on every input, each
    tree's packing timed, and with ``--bits`` the lanes that differ from
    the first tree's."""
    names = list(trees)
    first = names[0]
    mods = {v: tree_package(v, trees[v], libs[v][0]) for v in names}
    cases = traversal_inputs(torch, pt, device)
    results, bits = [], {}
    for case, (o, d, bvh, tris, t_min, t0) in cases.items():
        samples = {v: [] for v in names}
        pack = {v: [] for v in names}
        how = set()
        for v in names + names[::-1]:
            mod = mods[v]
            t, method = device_ms(
                torch, lambda: mod._launch(o, d, bvh, tris, t_min, t0),
                TRAVERSAL_KERNELS, args.reps)
            samples[v] += t
            how.add(method)
            for _ in range(args.reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                mod.pack_bvh(bvh, tris)
                end.record()
                end.synchronize()
                pack[v].append(start.elapsed_time(end))
        for v in names:
            t = samples[v]
            row = {"tree": v, "case": case, "rays": o.shape[0],
                   "live_rays": int((t0 >= 0).sum()),
                   "tris": tris.count, "median_ms": statistics.median(t),
                   "min_ms": min(t), "max_ms": max(t), "launches": len(t),
                   "pack_ms": statistics.median(pack[v]),
                   "timed_by": sorted(how), **libs[v][1]["traversal"],
                   "card": smi}
            results.append(row)
            print(json.dumps(row), flush=True)
        if args.bits:
            outs = {v: [x.cpu().numpy() for x in mods[v]._launch(
                o, d, bvh, tris, t_min, t0)] for v in names}
            t_ref, i_ref = outs[first]
            bits[case] = {
                v: int(((i != i_ref) | (t.view("u4") != t_ref.view("u4")))
                       .sum()) for v, (t, i) in outs.items() if v != first}
            print(json.dumps({"bits": case, "lanes": len(i_ref),
                              "differing_lanes": bits[case]}), flush=True)
    return results, bits


PAIR_KERNELS = {"pairbin": "pairbin_sweep_kernel", "pair": "pair_sweep_kernel"}


def pair_inputs(torch, pt, device):
    """chip_smoke.py's pair inputs: {case: (route, scene, meta or None,
    rays or None, [sweep arguments of each launch])} for both routes on
    the 65,536-ray bundle at both mesh sizes, on one 512x512 mesh
    main-path frame (phase 16's scene and frame 3) and on one 1024x1024
    frame at 327,680 triangles, the launches recorded from this
    checkout's emission."""
    import chip_smoke as cs
    from tpu_path_tracer_torch.integrator.render import render_frame
    from tpu_path_tracer_torch.kernels import pair_sweep as ps

    t_min = pt.RenderConfig().t_min
    entries = {"pairbin": ps.pairbin_closest_hit, "pair": ps.pair_closest_hit}
    cases = {}
    for sub in cs.MESH_SUBDIVISIONS:
        scene, _ = cs.mesh_scene(sub, device)
        rays = tuple(torch.from_numpy(x).to(device) for x in cs.traversal_rays(
            cs.TRAV_RAYS, sub, 0.8, scene.triangles.a.cpu().numpy()))
        for route, entry in entries.items():
            calls = []
            with cs.recorded_sweep(route, calls):
                entry(rays[0], rays[1], scene.bvh, scene.triangles, t_min,
                      rays[2])
            cases[f"{route}_bundle_{scene.triangles.count}"] = (
                route, scene, None, rays, [c[0] for c in calls])
    view = pt.Camera(eye=cs.MESH_EYE, center=[0, 0, 0]).view_matrix
    for sub, scale, suffix in ((cs.MESH_SUBDIVISIONS[0], 1, ""),
                               (cs.MESH_SUBDIVISIONS[1], 2, "_1024")):
        scene, meta = cs.mesh_scene(sub, device)
        cfg = pt.RenderConfig(**cs.MESH_KW)
        cfg = cfg.replace(width=scale * cfg.width, height=scale * cfg.height)
        for route in entries:
            calls = []
            with cs.pair_dispatch(route), cs.recorded_sweep(route, calls):
                render_frame(torch.zeros((cfg.width * cfg.height, 3),
                                         device=device), 3, True, view,
                             scene, meta, cfg)
            cases[f"{route}_frame{suffix}"] = (
                route, scene, (meta, cfg, view), None, [c[0] for c in calls])
    return cases


def call_ms(torch, fn, reps):
    """Median ms of ``fn`` by CUDA events (after a warm-up call), and its
    device ms per call summed over every kernel (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    wall = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        wall.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA) / 1e3
    return statistics.median(wall), device


def pairs_ab(torch, pt, device, trees, libs, args, smi):
    """Each tree's two pair kernels, through that tree's own wrappers, in
    turns on every input (the case's launches summed), with ``--bits`` the
    rows that differ from the first tree's; then each tree's whole entry
    point on the bundles and each route's 512x512 frame through each
    tree's entry point, in turns."""
    import chip_smoke as cs
    from tpu_path_tracer_torch.kernels import traversal

    names = list(trees)
    first = names[0]
    mods = {v: tree_package(v, trees[v], libs[v][0], "pair_sweep")
            for v in names}
    cases = pair_inputs(torch, pt, device)
    results, bits, calls = [], {}, []
    for case, (route, scene, frame, rays, launches) in cases.items():
        samples = {v: [] for v in names}
        how = set()
        for v in names + names[::-1]:
            sweep = getattr(mods[v], f"{route}_sweep")
            t, method = device_ms(
                torch, lambda: [sweep(*a) for a in launches],
                PAIR_KERNELS[route], args.reps)
            samples[v] += t
            how.add(method)
        for v in names:
            t = samples[v]
            row = {"tree": v, "case": case, "kernel": PAIR_KERNELS[route],
                   "launches_per_case": len(launches),
                   "rows": [a[0].shape[0] for a in launches][:32],
                   "median_ms": statistics.median(t), "min_ms": min(t),
                   "max_ms": max(t),
                   "median_ms_per_launch": statistics.median(t) / len(
                       launches), "samples": len(t),
                   "timed_by": sorted(how),
                   **libs[v][1].get(route, {}), "card": smi}
            results.append(row)
            print(json.dumps(row), flush=True)
        if args.bits:
            outs = {v: [[x.cpu().numpy() for x in getattr(
                mods[v], f"{route}_sweep")(*a)] for a in launches]
                for v in names}
            bits[case] = {v: int(sum(
                ((i != i0) | (t.view("u4") != t0.view("u4"))).sum()
                for (t, i), (t0, i0) in zip(outs[v], outs[first])))
                for v in names if v != first}
            print(json.dumps({"bits": case, "rows": sum(
                a[0].shape[0] for a in launches),
                "differing_rows": bits[case]}), flush=True)
        # The whole entry point of each tree, in turns.
        entry = {v: getattr(mods[v], f"{route}_closest_hit") for v in names}
        timed = {v: [] for v in names}
        if frame is None:
            o, d, t0 = rays
            t_min = pt.RenderConfig().t_min
            for v in names + names[::-1]:
                timed[v].append(call_ms(torch, lambda: entry[v](
                    o, d, scene.bvh, scene.triangles, t_min, t0), args.reps))
            what = "entry_point_call"
        else:
            meta, cfg, view = frame
            for v in names + names[::-1]:
                before = traversal._PAIR_ROUTES[route]
                traversal._PAIR_ROUTES[route] = entry[v]
                try:
                    with cs.pair_dispatch(route):
                        timed[v].append(call_ms(torch, lambda: cs.time_frames(
                            torch, pt, device, scene, meta, cfg, view, 1),
                            max(2, args.reps // 3)))
                finally:
                    traversal._PAIR_ROUTES[route] = before
            what = "frame"
        for v in names:
            row = {"tree": v, "case": case, "what": what,
                   "ms": statistics.median(x[0] for x in timed[v]),
                   "ms_each_turn": [x[0] for x in timed[v]],
                   "device_ms": statistics.median(x[1] for x in timed[v]),
                   "card": smi}
            calls.append(row)
            print(json.dumps(row), flush=True)
    return results, bits, calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR, a checkout root")
    ap.add_argument("--kernel", choices=("megakernels", "traversal", "pairs"),
                    default="megakernels")
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
    if args.kernel == "pairs":
        results, bits, calls = pairs_ab(torch, pt, device, trees, libs, args,
                                        smi)
        print(json.dumps({"card": smi, "kernels": results, "bits": bits,
                          "calls": calls}))
        return
    if args.kernel == "traversal":
        results, bits = traversal_ab(torch, pt, device, trees, libs, args,
                                     smi)
        print(json.dumps({"card": smi, "kernels": results, "bits": bits}))
        return
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
