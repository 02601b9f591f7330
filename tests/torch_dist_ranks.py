"""The rank side of ``tests/test_torch_dist.py``: one process of a gloo
group on the CPU, run as::

    MASTER_ADDR=127.0.0.1 MASTER_PORT=... WORLD_SIZE=n RANK=r \\
        python tests/torch_dist_ranks.py JOB OUT_DIR

It joins the group through ``init_distributed`` (the launcher's variables),
runs JOB (``main``, ``frames``, ``resume``, ``preview``) over a mesh of
every rank and writes what it saw to ``OUT_DIR/JOB.RANK.npz``.  The cases
(scenes, sizes, parameter groups) are defined here once; the test file
imports them.  Imports no JAX.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

import tpu_path_tracer_torch as pt
from chip_smoke import scripted_preview
from tpu_path_tracer_torch.diff.params import apply_params, extract_params
from tpu_path_tracer_torch.dist import render_dist
from tpu_path_tracer_torch.dist.sharding import (gather_rows,
                                                 init_distributed,
                                                 make_mesh, mesh_size,
                                                 ray_sharding, shard_scene)

KW = dict(width=12, height=11, max_bounces=3, importance_sampling=True)
EYE = [0.0, 0.0, 3.2]
FRAME = 1
LR = 5e-2
TRAIN_STEPS = 3
TARGET_SEED = 11


def mirror_sphere_scene(pkg, device=None):
    """bench.py:301's mesh scene at subdivision 2 (320 triangles), median
    BVH, for either package."""
    b = pkg.SceneBuilder()
    b.add_material("default", pkg.LAMBERTIAN, [1, 0, 0])
    white = b.add_material("white", pkg.LAMBERTIAN, [0.73, 0.73, 0.73])
    light = b.add_material("light", pkg.LAMBERTIAN, [0, 0, 0],
                           emission=[2, 2, 2])
    mirror = b.add_material("mirror", pkg.MIRROR, [0.9, 0.9, 0.9])
    b.add_quad([-2, -2, -2], [4, 0, 0], [0, 4, 0], white)
    b.add_quad([-2, 2, -2], [4, 0, 0], [0, 0, 4], light)
    b.add_quad([-2, -2, 2], [4, 0, 0], [0, 0, -4], white)
    b.add_mesh(pkg.procedural.icosphere(subdivisions=2, radius=0.8), mirror)
    if device is None:
        return b.build(bvh="median")
    return b.build(bvh="median", device=device)


def port_scene(name):
    """(scene, meta) of a case on the CPU."""
    if name == "cornell":
        return pt.builtin.cornell_box(device="cpu")[:2]
    if name == "reference":
        return pt.builtin.reference_scene(mini=True, device="cpu")[:2]
    return mirror_sphere_scene(pt, "cpu")


# Sharded frames: name -> (scene, use_megakernel).
FRAMES = {"cornell_wavefront": ("cornell", False),
          "cornell_megakernel": ("cornell", True),
          "mesh": ("mesh", False)}
# Sharded losses: name -> (scene, parameter groups).
LOSSES = {"cornell": ("cornell", ("emission", "bsdf")),
          "reference": ("reference", ("spheres", "quads", "vertices")),
          "mesh": ("mesh", ("emission", "vertices"))}


def view():
    return pt.Camera(eye=EYE, center=[0, 0, 0]).view_matrix


def cfg(megakernel=False):
    return pt.RenderConfig(**KW, use_megakernel=megakernel)


def loss_target(n_pix):
    """The loss cases' target, global padded rows."""
    return (np.random.default_rng(TARGET_SEED)
            .uniform(0, 1, (n_pix, 3)).astype(np.float32))


def train_start(scene, meta, mesh, n_pad):
    """``cli train``'s set-up on the Cornell box: the target at frame 1
    of the true scene (this rank's rows of ``n_pad``) and emission and
    BSDF at half."""
    c = cfg()
    rows = n_pad // mesh_size(mesh)
    with torch.no_grad():
        target = render_dist.make_sharded_frame_fn(mesh, meta, c)(
            torch.zeros((rows, 3)), FRAME, True, view(), scene)
    params = {k: (v * 0.5).clone().requires_grad_(True)
              for k, v in extract_params(scene, ("emission",
                                                 "bsdf")).items()}
    return target, params


def _frames(mesh, out):
    for name, (scene_name, megakernel) in FRAMES.items():
        scene, meta = port_scene(scene_name)
        scene = shard_scene(scene, mesh)
        c = cfg(megakernel)
        rows = render_dist.padded_pixels(c, mesh) // mesh.size()
        fb = render_dist.make_sharded_frame_fn(mesh, meta, c)(
            torch.zeros((rows, 3)), FRAME, True, view(), scene)
        out[f"frame.{name}"] = gather_rows(fb, mesh)


def _losses(mesh, out):
    for name, (scene_name, groups) in LOSSES.items():
        scene, meta = port_scene(scene_name)
        scene = shard_scene(scene, mesh)
        c = cfg()
        target = ray_sharding(mesh)(
            loss_target(render_dist.padded_pixels(c, mesh)))
        params = {k: v.clone().requires_grad_(True)
                  for k, v in extract_params(scene, groups).items()}
        loss = render_dist.make_sharded_loss_fn(mesh, scene, meta, c,
                                                apply_params)(
            params, target, FRAME, view())
        loss.backward()
        render_dist.sum_grads(list(params.values()), mesh)
        out[f"loss.{name}"] = loss.detach()
        for k, p in params.items():
            out[f"grad.{name}.{k}"] = p.grad


def _train(mesh, out):
    scene, meta = port_scene("cornell")
    scene = shard_scene(scene, mesh)
    target, params = train_start(scene, meta, mesh,
                                 render_dist.padded_pixels(cfg(), mesh))
    step = render_dist.make_train_step(
        mesh, scene, meta, cfg(), apply_params,
        torch.optim.Adam(params.values(), lr=LR))
    for i in range(TRAIN_STEPS):
        out[f"train.loss.{i}"] = step(params, target, FRAME, view())
        for k, p in params.items():
            out[f"train.{i}.{k}"] = p.detach().clone()


def renderer(mesh, cfg_=None):
    scene, meta = port_scene("cornell")
    return pt.Renderer(scene, meta, cfg_ or cfg(),
                       pt.Camera(eye=EYE, center=[0, 0, 0]), mesh=mesh)


def _renderer(mesh, out, directory):
    r = renderer(mesh)
    r.render_animation(3)
    out["renderer.frames"] = r.frame_num
    out["renderer.fb3"] = gather_rows(r.framebuffer, mesh)
    out["renderer.display"] = r.display()
    r.camera.zoom(-1.0)
    r.step()
    out["renderer.moved_frames"] = r.frame_num
    out["renderer.moved"] = gather_rows(r.framebuffer, mesh)

    whole = renderer(mesh)
    path = os.path.join(directory, "port.npz")
    whole.render_animation(2, checkpoint_path=path, checkpoint_every=2)
    whole.render_animation(2)
    out["whole.fb"] = gather_rows(whole.framebuffer, mesh)
    out["whole.frames"] = whole.frame_num

    from_jax = renderer(mesh)
    from_jax.load_checkpoint(os.path.join(directory, "jax.npz"))
    out["from_jax.loaded"] = gather_rows(from_jax.framebuffer, mesh)
    out["from_jax.loaded_frames"] = from_jax.frame_num
    from_jax.step(reset=False)
    out["from_jax.fb"] = gather_rows(from_jax.framebuffer, mesh)


def _preview(mesh, out):
    """The preview without a terminal on the first rank (every rank must
    raise), then with a scripted one (chip_smoke.PREVIEW_KEYS)."""
    try:
        scripted_preview(renderer(mesh), tty=False)
    except RuntimeError as e:
        out["preview.no_tty"] = str(e)
    r = renderer(mesh)
    out["preview.painted"], out["preview.cameras"] = scripted_preview(r)
    out["preview.frames"] = r.frame_num


def _bootstrap(rank, out):
    import torch.distributed as dist

    out["bootstrap.rank"] = rank
    out["bootstrap.world"] = dist.get_world_size()
    total = torch.tensor([float(rank + 1)])
    dist.all_reduce(total)
    out["bootstrap.sum"] = total
    parts = [torch.zeros(1) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, torch.tensor([float(rank)]))
    out["bootstrap.gathered"] = torch.cat(parts)


def main(job, directory):
    torch.set_num_threads(1)
    import torch.distributed as dist

    rank = init_distributed(device="cpu")
    out = {}
    try:
        mesh = make_mesh(device_type="cpu")
        if job == "main":
            _bootstrap(rank, out)
            _frames(mesh, out)
            _losses(mesh, out)
            _train(mesh, out)
            _renderer(mesh, out, directory)
            out["scaling"] = json.dumps(render_dist.measure_scaling(
                width=16, height=8, bounces=2, iters=1, repeats=2,
                device_type="cpu"))
        elif job == "frames":
            _frames(mesh, out)
        elif job == "preview":
            _preview(mesh, out)
        elif job == "resume":
            r = renderer(mesh)
            r.load_checkpoint(os.path.join(directory, "port.npz"))
            out["resumed.at"] = r.frame_num
            r.render_animation(2)
            out["resumed.fb"] = gather_rows(r.framebuffer, mesh)
            out["resumed.frames"] = r.frame_num
        else:
            raise ValueError(f"unknown job {job!r}")
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(directory, f"{job}.{rank}.npz"),
             **{k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in out.items()})


if __name__ == "__main__":
    main(*sys.argv[1:])
