"""Sharded rendering and training over the ray axis
(``tpu_path_tracer.dist.render_dist``) on ``torch.distributed``.

Each rank owns a contiguous chunk of the padded framebuffer and traces the
global pixel indices of that chunk, seeded from those indices and the
frame number, so the chunks of n ranks are the one-process frame bit for
bit; the forward needs no communication (``render_dist.py:1-12``).  The
scene is replicated (``sharding.shard_scene``).  The loss is the mean over
the global padded pixel count; each rank's gradients cover its own pixels,
and the train step sums them over the ranks with one all-reduce before the
optimizer's update, where the JAX package lets ``shard_map`` transpose the
replicated inputs into a ``psum``.

``mesh=None`` is one process with no group.  Names and arguments are the
JAX module's.  One difference follows from torch: an optimizer owns its
state and updates the parameter tensors in place, so the train step takes
no optimizer state and returns only the loss.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.config import RenderConfig
from ..core.types import SceneData, SceneMeta
from ..integrator import film
from ..integrator.render import path_trace_pixels
from .sharding import (all_reduce_sum_, mesh_rank, mesh_size,
                       pad_to_multiple)

__all__ = ["make_sharded_frame_fn", "make_sharded_loss_fn", "make_train_step",
           "measure_scaling", "pad_to_multiple", "padded_pixels",
           "pixel_radiance", "sum_grads"]


def padded_pixels(cfg: RenderConfig, mesh=None) -> int:
    """Framebuffer length padded so every rank gets an equal chunk of a
    multiple of 8 rows (``render_dist.py:32-37``)."""
    return pad_to_multiple(cfg.width * cfg.height, mesh_size(mesh) * 8)


def _view(view_matrix, device):
    return torch.as_tensor(view_matrix, dtype=torch.float32, device=device)


def pixel_radiance(pix, frame_num, view_matrix, scene: SceneData,
                   meta: SceneMeta, cfg: RenderConfig):
    """Radiance ``[N, 3]`` of the global row-major pixel indices ``pix``
    (int64) in one progressive frame, the step every frame, loss and
    check takes: their (px, py), their PCG seeds from (pixel, frame)
    (``main.wgsl:16``) and ``path_trace_pixels``.  ``view_matrix`` is
    taken onto ``pix``'s device as float32 here, once."""
    rand_state = rng.seed(pix, frame_num)
    _, radiance = path_trace_pixels(rand_state, _view(view_matrix, pix.device),
                                    pix % cfg.width, pix // cfg.width, scene,
                                    meta, cfg)
    return radiance


# The name benchmark/tests/test_bench_correct.py plants its fault with.
_pixel_radiance = pixel_radiance


def _local_pixels(n_local: int, mesh, device):
    """This rank's global pixel indices, pad rows (``py == H``) included."""
    return (mesh_rank(mesh) * n_local
            + torch.arange(n_local, dtype=torch.int64, device=device))


def make_sharded_frame_fn(mesh, meta: SceneMeta, cfg: RenderConfig):
    """Returns ``frame(fb, frame_num, reset, view, scene) -> fb``
    (``render_dist.py:50-67``): ``fb`` is this rank's
    ``[padded_pixels / ranks, 3]`` chunk, updated in place."""

    def frame(fb, frame_num, reset, view_matrix, scene):
        pix = _local_pixels(fb.shape[0], mesh, fb.device)
        radiance = pixel_radiance(pix, frame_num, view_matrix, scene, meta,
                                  cfg)
        return film.accumulate(fb, radiance, reset)

    return frame


class _SumOverRanks(torch.autograd.Function):
    """The sum of a scalar over the mesh's ranks, whose gradient reaches
    this rank's scalar unchanged: the value is the global loss, and
    backward leaves each rank the gradient of its own pixels' share."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum_(x.detach().clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def make_sharded_loss_fn(mesh, base_scene: SceneData, meta: SceneMeta,
                         cfg: RenderConfig, apply_params):
    """Differentiable loss ``loss(params, target, frame_num, view)``
    (``render_dist.py:70-96``): the mean over the global padded pixels and
    channels of ``(radiance - target) ** 2`` of a one-frame estimate, pad
    rows included; ``target`` is this rank's chunk.  The value is the
    global loss on every rank; its gradients are this rank's share, which
    the ranks must sum (``make_train_step`` does).
    ``apply_params(scene, params) -> SceneData`` plugs the parameters
    (emission, BSDF tables, geometry) into the scene."""

    def loss(params, target, frame_num, view_matrix):
        scene = apply_params(base_scene, params)
        n_local = target.shape[0]
        pix = _local_pixels(n_local, mesh, target.device)
        radiance = pixel_radiance(pix, frame_num, view_matrix, scene, meta,
                                  cfg)
        share = (torch.sum((radiance - target) ** 2)
                 / float(n_local * mesh_size(mesh) * 3))
        return share if mesh is None else _SumOverRanks.apply(share, mesh)

    return loss


def sum_grads(tensors, mesh):
    """Sum the tensors' gradients over the mesh's ranks with one
    all-reduce of their concatenation."""
    grads = [torch.zeros_like(t) if t.grad is None else t.grad
             for t in tensors]
    flat = all_reduce_sum_(torch.cat([g.reshape(-1) for g in grads]), mesh)
    for t, part in zip(tensors, flat.split([g.numel() for g in grads])):
        t.grad = part.view_as(t)


def make_train_step(mesh, base_scene: SceneData, meta: SceneMeta,
                    cfg: RenderConfig, apply_params, optimizer):
    """Full forward, backward and update step (``render_dist.py:184-200``,
    ``torch.optim.Adam`` in place of ``optax.adam``).  ``optimizer`` holds
    the tensors of the ``params`` dict the step is called with, which are
    leaves that require grad.  Returns ``step(params, target, frame_num,
    view) -> loss``; the step updates ``params`` in place.  With a mesh,
    ``target`` is this rank's chunk and the gradients are summed over the
    ranks before the update, so Adam keeps the parameters equal on every
    rank."""
    loss_fn = make_sharded_loss_fn(mesh, base_scene, meta, cfg, apply_params)

    def step(params, target, frame_num, view_matrix):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, target, frame_num, view_matrix)
        loss.backward()
        if mesh is not None:
            sum_grads(list(params.values()), mesh)
        optimizer.step()
        return loss.detach()

    return step


def measure_scaling(width: int = 512, height: int = 512, bounces: int = 4,
                    iters: int = 8, repeats: int = 5,
                    device_type: str = "cuda"):
    """Scaling harness (``render_dist.py:98-181``): times the sharded train
    step on a mesh of rank 0 alone, then on every rank of the group,
    ``repeats`` blocks of ``iters`` steps each after a warm-up block, and
    reports the median throughputs in rays/s with the larger spread of the
    two (max - min over median, in percent).  Every rank of the group
    calls it (after ``sharding.init_distributed``) and gets the same dict.

    The step is the JAX harness's (Cornell box, NEE, emission and BSDF,
    Adam 1e-2) through the port's training path, the two megakernels (the
    wavefront's 512x512 step is two orders of magnitude slower on the
    card).  Where ranks share a device (the CPU, or one card under several
    ranks) the run measures sharding overhead (100 = the sharded step as
    fast as the unsharded one), never a speedup; otherwise it is linear
    scaling efficiency.
    """
    import socket
    import statistics
    import time

    import torch.distributed as dist

    from ..core.camera import Camera
    from ..diff.params import apply_params, extract_params
    from ..scene import builtin
    from .sharding import in_mesh, make_mesh, rank_device, shard_scene

    cfg = RenderConfig(width=width, height=height, max_bounces=bounces,
                       importance_sampling=True, use_megakernel=True)
    view = Camera(eye=[0, 0, 3.2], center=[0, 0, 0]).view_matrix

    def throughputs(mesh):
        device = rank_device(mesh)
        scene0, meta, _ = builtin.cornell_box(device=device)
        scene = shard_scene(scene0, mesh)
        n_pix = padded_pixels(cfg, mesh)
        target = torch.zeros((n_pix // mesh.size(), 3), device=device)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in extract_params(scene,
                                             ("emission", "bsdf")).items()}
        step = make_train_step(mesh, scene, meta, cfg, apply_params,
                               torch.optim.Adam(params.values(), lr=1e-2))

        def block(first_frame):
            for i in range(iters):
                loss = step(params, target, first_frame + i, view)
            float(loss)  # waits for the device and for the other ranks

        block(1)  # warm-up: builds, allocates, first launches
        block(100)
        out = []
        for r in range(repeats):
            start = time.perf_counter()
            block(2 + r * iters)
            out.append(n_pix * iters / (time.perf_counter() - start))
        return out

    one = make_mesh(n_devices=1, device_type=device_type)
    runs1 = throughputs(one) if in_mesh(one) else None
    everyone = make_mesh(device_type=device_type)
    n = everyone.size()
    runsn = throughputs(everyone)
    where = (socket.gethostname(),
             str(rank_device(everyone)) if device_type == "cuda" else "cpu")
    places = [None] * n
    dist.all_gather_object(places, where)
    shared = device_type != "cuda" or len(set(places)) < n
    report = [None]
    if dist.get_rank() == 0:
        tput1 = statistics.median(runs1)
        tputn = statistics.median(runsn)
        spread_pct = max((max(r) - min(r)) / m * 100.0
                         for r, m in ((runs1, tput1), (runsn, tputn)))
        if shared:
            eff = min(tputn / tput1 * 100.0, 100.0)
            kind = ("sharding overhead: the ranks share one device (100 = "
                    "sharded step no slower than unsharded; NOT a speedup)")
        else:
            eff = tputn / (n * tput1) * 100.0
            kind = "linear scaling efficiency (north star >= 80)"
        report = [{"devices": n, "tput_1dev_rays_s": tput1,
                   "tput_ndev_rays_s": tputn, "efficiency": eff,
                   "spread_pct": spread_pct, "kind": kind}]
    dist.broadcast_object_list(report, src=0)
    return report[0]
