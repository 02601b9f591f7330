"""Command-line interface (``tpu_path_tracer.cli``), with the JAX
package's subcommands, flags and defaults::

    python -m tpu_path_tracer_torch render --scene reference -o out.png
    python -m tpu_path_tracer_torch render --scene mesh.obj --bvh median
    python -m tpu_path_tracer_torch render --devices 2
    torchrun --nproc-per-node 2 -m tpu_path_tracer_torch render --multihost
    python -m tpu_path_tracer_torch train --params emission,bsdf
    python -m tpu_path_tracer_torch grad-check
    python -m tpu_path_tracer_torch bench
    python -m tpu_path_tracer_torch info

Everything runs on the CUDA devices; without one it raises, and
``--device cpu`` is the only way onto the CPU.  ``bench`` runs the port's
benchmark harness (``tpu_path_tracer_torch.bench``), the counterpart of the
repository's ``bench.py``.  ``--megakernel`` routes
tracing, and training's gradients, through the CUDA megakernels (on the
CPU, through their plain version); an OBJ mesh goes through a BVH and the
CUDA traversal kernel.  ``render`` logs, checkpoints, resumes and previews
as the JAX command does.

Several ranks (``dist``): ``--devices N`` starts N local ranks from this
command, one card each (ranks beyond the cards share them over gloo), or N
gloo ranks under ``--device cpu``; ``--multihost`` joins the group of a
launcher (``torchrun``, or ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
``RANK`` set by hand) and spans all of it.  ``train`` spans every visible
card by default, as the JAX command spans every device.  The first rank
alone prints the report lines and writes the PNG and the checkpoint; a
rank that fails fails the command.  ``render --interactive`` over several
ranks reads the keys and paints on the first rank, which must have the
terminal (``preview``).  ``grad-check`` takes both flags and ignores them,
as in the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time


def _device(args):
    import torch

    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    return torch.device("cuda", 0)


def _build_scene(args, device):
    from .core.config import LAMBERTIAN
    from .scene import builtin
    from .scene.builder import SceneBuilder
    from .scene.objreader import load_obj

    if args.scene == "cornell":
        scene, meta, _ = builtin.cornell_box(bvh=args.bvh, device=device)
        eye = [0.0, 0.0, 3.2]
    elif args.scene == "reference":
        scene, meta, _ = builtin.reference_scene(bvh=args.bvh, device=device)
        eye = [0.5, 0.0, 2.5]  # index.js:39
    else:  # an OBJ path, in the JAX package's room
        b = SceneBuilder()
        white = b.add_material("white", LAMBERTIAN, [0.73, 0.73, 0.73])
        light = b.add_material("light", LAMBERTIAN, [0, 0, 0],
                               emission=(15, 15, 15))
        b.add_quad([-0.4, 0.999, -0.4], [0.8, 0, 0], [0, 0, 0.8], light)
        b.add_quad([-1, -1, -1], [2, 0, 0], [0, 2, 0], white)
        b.add_quad([-1, 1, -1], [2, 0, 0], [0, 0, 2], white)
        b.add_quad([1, -1, -1], [-2, 0, 0], [0, 0, 2], white)
        b.add_mesh(load_obj(args.scene), white)
        scene, meta = b.build(bvh=args.bvh, device=device)
        eye = [0.0, 0.0, 3.2]
    return scene, meta, eye


def _add_common(p):
    p.add_argument("--scene", default="cornell",
                   help="cornell | reference | path/to/mesh.obj")
    p.add_argument("--width", type=int, default=900)    # index.html:17
    p.add_argument("--height", type=int, default=600)   # index.html:18
    p.add_argument("--bounces", type=int, default=100)  # header.wgsl:10
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--bvh", default="auto",
                   choices=["auto", "median", "sah", "lbvh", "none"])
    p.add_argument("--importance-sampling", action="store_true")
    p.add_argument("--stratify", action="store_true")
    p.add_argument("--eye", type=float, nargs=3, default=None)
    p.add_argument("--devices", type=int, default=0,
                   help="shard rays over this many local ranks, started "
                        "by this command (0 = single)")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group of a launcher (torchrun; "
                        "MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK) and "
                        "span all of it")
    p.add_argument("--megakernel", action="store_true",
                   help="route tracing through the fused CUDA megakernels "
                        "(analytic scenes + small meshes)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run: the first CUDA device (raises "
                        "without one) or the CPU")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, body, args):
    """One rank that ``--devices`` started: join the group, run
    ``body(args, mesh)``, leave the group."""
    import torch
    import torch.distributed as dist
    from .dist.sharding import init_distributed, make_mesh

    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    if getattr(args, "interactive", False) and rank == 0:
        # A spawned process gets /dev/null as sys.stdin; its descriptor 0
        # is still the command's, the terminal the preview reads.
        sys.stdin = open(0, closefd=False)
    if args.device == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    init_distributed(f"127.0.0.1:{port}", world, rank, device=args.device)
    try:
        body(args, make_mesh(device_type=args.device))
    finally:
        dist.destroy_process_group()


def _run_ranks(args, body, ranks: int):
    """``body(args, mesh)`` over the ranks the flags ask for: the launcher's
    group under ``--multihost``, ``ranks`` local ranks started here when
    above 1, else this process with no mesh.  A failed rank raises here."""
    _device(args)  # the card, or --device cpu, before anything starts
    if args.multihost:
        import torch.distributed as dist
        from .dist.sharding import init_distributed, make_mesh

        rank = init_distributed(device=args.device)
        world = dist.get_world_size() if dist.is_initialized() else 1
        print(f"multihost: process {rank} of {world}")
        try:
            if args.devices not in (0, world):
                raise ValueError(f"--devices {args.devices} under "
                                 f"--multihost: the group has {world} ranks")
            mesh = make_mesh(device_type=args.device) if world > 1 else None
            return body(args, mesh)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    if ranks <= 1:
        return body(args, None)
    import torch.multiprocessing as mp

    if args.device == "cuda":
        # Build the kernels once here, not in every rank.
        from .accel import native
        from .kernels import _build
        _build.build()
        native.available()
    mp.start_processes(_rank_main, args=(ranks, _free_port(), body, args),
                       nprocs=ranks, join=True, start_method="spawn")


def _say(mesh, *msg):
    """Print on the first rank alone."""
    from .dist.sharding import mesh_rank
    if mesh_rank(mesh) == 0:
        print(*msg)


def _rank_device(args, mesh):
    if mesh is None:
        return _device(args)
    from .dist.sharding import rank_device
    return rank_device(mesh)


def _make_cfg(args):
    from .core.config import RenderConfig
    return RenderConfig(width=args.width, height=args.height,
                        samples_per_pixel=args.spp, max_bounces=args.bounces,
                        importance_sampling=args.importance_sampling,
                        stratify=args.stratify,
                        use_megakernel=getattr(args, "megakernel", False))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_render(args):
    _run_ranks(args, _render, args.devices)


def _render(args, mesh):
    from .core.camera import Camera
    from .dist.sharding import mesh_size
    from .renderer import Renderer

    device = _rank_device(args, mesh)
    scene, meta, eye = _build_scene(args, device)
    cfg = _make_cfg(args)
    r = Renderer(scene, meta, cfg, Camera(eye=args.eye or eye,
                                          center=[0, 0, 0]), mesh=mesh,
                 log_performance=args.log_performance,
                 log_count_of_samples=args.log_samples)
    if args.resume:
        r.load_checkpoint(args.resume)
        _say(mesh, f"resumed at frame {r.frame_num}")
    if args.interactive:
        from .preview import run_preview
        run_preview(r, max_fps=args.max_fps)
        r.save_png(args.output)
        _say(mesh, f"wrote {args.output}")
        return
    t0 = time.time()
    r.render_animation(args.frames, checkpoint_path=args.checkpoint,
                       checkpoint_every=args.checkpoint_every)
    _sync(device)
    dt = time.time() - t0
    n_rays = args.frames * cfg.width * cfg.height * cfg.samples_per_pixel
    ranks = f" x {mesh_size(mesh)} ranks" if mesh is not None else ""
    _say(mesh, f"{args.frames} frames ({r.frame_num} accumulated) in "
         f"{dt:.2f}s = {n_rays / dt / 1e6:.1f} Mray/s on {device}{ranks}")
    r.save_png(args.output)
    _say(mesh, f"wrote {args.output}")
    if args.checkpoint:
        r.save_checkpoint(args.checkpoint)
        _say(mesh, f"checkpoint -> {args.checkpoint}")


def cmd_bench(args):
    from .bench import main as bench_main

    sys.exit(bench_main(["--device", args.device]))


def _pixels(cfg, device):
    from .integrator.render import pixel_grid

    return pixel_grid(cfg.width, cfg.height, device)


def cmd_grad_check(args):
    """Finite differences against reverse mode on emitter radiance and BSDF
    albedo (BASELINE.json configs[3])."""
    import torch
    from .core import rng
    from .core.camera import Camera
    from .diff.params import apply_params, extract_params
    from .integrator.render import path_trace_pixels

    device = _device(args)
    scene, meta, eye = _build_scene(args, device)
    cfg = _make_cfg(args).replace(width=64, height=64,
                                  max_bounces=min(args.bounces, 4))
    view = torch.as_tensor(Camera(eye=args.eye or eye,
                                  center=[0, 0, 0]).view_matrix,
                           device=device)
    pix, px, py = _pixels(cfg, device)
    base = extract_params(scene, groups=("emission", "bsdf"))

    def loss(scale_e, scale_c):
        p = dict(base)
        p["emission"] = base["emission"] * scale_e
        p["color"] = base["color"] * scale_c
        s = apply_params(scene, p)
        _, radiance = path_trace_pixels(rng.seed(pix, 7), view, px, py, s,
                                        meta, cfg)
        return torch.mean(radiance)

    scales = [torch.tensor(1.0, device=device, requires_grad=True)
              for _ in range(2)]
    g_e, g_c = torch.autograd.grad(loss(*scales), scales)
    eps = 1e-3
    with torch.no_grad():
        fd_e = (loss(1 + eps, 1.0) - loss(1 - eps, 1.0)) / (2 * eps)
        fd_c = (loss(1.0, 1 + eps) - loss(1.0, 1 - eps)) / (2 * eps)
    rows = [("emission", float(g_e), float(fd_e)),
            ("albedo", float(g_c), float(fd_c))]
    ok = True
    for name, ad, fd in rows:
        rel = abs(ad - fd) / max(abs(fd), 1e-8)
        ok &= rel < 0.02
        print(f"{name:10s} autodiff={ad:+.6f} finite-diff={fd:+.6f} "
              f"rel-err={rel:.2e}")
    print("grad-check:", "PASS" if ok else "FAIL")
    sys.exit(0 if ok else 1)


def cmd_train(args):
    """Inverse rendering: recover emitter radiance and albedos from a
    target image rendered with known parameters.  Without ``--devices``
    it spans every visible card (``cli.py:207``)."""
    ranks = args.devices
    if not ranks and args.device == "cuda" and not args.multihost:
        import torch
        ranks = torch.cuda.device_count()
    _run_ranks(args, _train, ranks)


def _train(args, mesh):
    import torch
    from .core.camera import Camera
    from .diff.params import apply_params, extract_params
    from .dist.render_dist import (make_sharded_frame_fn, make_train_step,
                                   padded_pixels)
    from .dist.sharding import mesh_size, shard_scene

    device = _rank_device(args, mesh)
    scene, meta, eye = _build_scene(args, device)
    if mesh is not None:
        scene = shard_scene(scene, mesh)
    cfg = _make_cfg(args).replace(width=64, height=64,
                                  max_bounces=min(args.bounces, 4))
    view = torch.as_tensor(Camera(eye=args.eye or eye,
                                  center=[0, 0, 0]).view_matrix,
                           device=device)
    rows = padded_pixels(cfg, mesh) // mesh_size(mesh)

    # Target: the true scene rendered at a fixed seed (this rank's rows).
    frame = make_sharded_frame_fn(mesh, meta, cfg)
    with torch.no_grad():
        target = frame(torch.zeros((rows, 3), device=device), 1, True,
                       view, scene)

    # Perturb and recover.
    groups = tuple(g.strip() for g in args.params.split(",") if g.strip())
    true_params = extract_params(scene, groups=groups)

    def perturb(name, x):
        if name.startswith(("tri_", "sphere_", "quad_")):
            # Geometry: small additive offset, not a scale (x0.5 would
            # collapse the mesh through walls).
            return x + 0.05
        return x * 0.5

    params = {k: perturb(k, v).detach().clone().requires_grad_(True)
              for k, v in true_params.items()}
    optimizer = torch.optim.Adam(params.values(), lr=args.lr)
    step = make_train_step(mesh, scene, meta, cfg, apply_params, optimizer)
    for i in range(args.steps):
        loss = step(params, target, 1, view)
        if (i + 1) % max(args.steps // 10, 1) == 0:
            _say(mesh, f"step {i+1:4d}  loss {float(loss):.6f}")
    err = {k: float(torch.max(torch.abs(params[k].detach() - v)))
           for k, v in true_params.items()}
    _say(mesh, "max param error per group:",
         json.dumps({k: round(v, 4) for k, v in err.items()}))


def cmd_info(args):
    import torch
    from . import __version__
    from .kernels import _build

    print(f"tpu-path-tracer-torch {__version__}")
    cuda = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "none")
    print(f"torch {torch.__version__}, CUDA device: {cuda}")
    try:
        nvcc = _build.nvcc_path()
    except RuntimeError:
        nvcc = "missing"
    print(f"nvcc (CUDA kernels): {nvcc}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpu-path-tracer-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="progressive render to PNG")
    _add_common(pr)
    pr.add_argument("--output", "-o", default="render.png")
    pr.add_argument("--checkpoint", default=None)
    pr.add_argument("--checkpoint-every", type=int, default=0)
    pr.add_argument("--resume", default=None)
    pr.add_argument("--log-performance", action="store_true")
    pr.add_argument("--log-samples", action="store_true")
    pr.add_argument("--interactive", action="store_true",
                    help="terminal orbit-camera preview (a/d orbit, w/s "
                         "zoom, arrows pan, q quit)")
    pr.add_argument("--max-fps", type=float, default=0.0)
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("bench", help="run the benchmark harness: bench.py's "
                        "workloads through the port, one process each")
    pb.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the workloads run: the first CUDA device "
                         "(fails without one) or the CPU")
    pb.set_defaults(fn=cmd_bench)

    pg = sub.add_parser("grad-check",
                        help="autodiff vs finite differences")
    _add_common(pg)
    pg.set_defaults(fn=cmd_grad_check)

    pt = sub.add_parser("train", help="inverse-rendering demo")
    _add_common(pt)
    pt.add_argument("--steps", type=int, default=100)
    pt.add_argument("--lr", type=float, default=5e-2)
    pt.add_argument("--params", default="emission,bsdf",
                    help="comma-separated parameter groups to recover: "
                         "emission,bsdf,vertices,spheres,quads")
    pt.set_defaults(fn=cmd_train)

    pi = sub.add_parser("info", help="environment info")
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
