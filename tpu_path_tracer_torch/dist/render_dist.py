"""Whole-frame rendering and the training step
(``tpu_path_tracer.dist.render_dist``), in one process on one device.

The JAX module shards the pixels over a device mesh with ``shard_map`` and
all-reduces the parameter gradients; that part waits for
``torch.distributed`` (ROADMAP Queue 1 item 11), so a ``mesh`` other than
None raises here.  Names and arguments are the JAX module's, so callers
read the same.  One difference follows from torch: an optimizer owns its
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

_NO_MESH = ("sharding pixels over a device mesh (torch.distributed): "
            "ROADMAP Queue 1 item 11")


def _single_device(mesh):
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def padded_pixels(cfg: RenderConfig, mesh=None) -> int:
    """Framebuffer length, padded to a multiple of 8 as the JAX package pads
    it for one device (``render_dist.py:32-37``)."""
    _single_device(mesh)
    return pad_to_multiple(cfg.width * cfg.height, 8)


def _pixel_radiance(pix, frame_num, view_matrix, scene, meta, cfg):
    """Trace the given flat pixel indices for one progressive frame."""
    px = pix % cfg.width
    py = pix // cfg.width
    rand_state = rng.seed(pix, frame_num)
    _, radiance = path_trace_pixels(rand_state, view_matrix, px, py, scene,
                                    meta, cfg)
    return radiance


def _view(view_matrix, device):
    return torch.as_tensor(view_matrix, dtype=torch.float32, device=device)


def make_sharded_frame_fn(mesh, meta: SceneMeta, cfg: RenderConfig):
    """Returns ``frame(fb, frame_num, reset, view, scene) -> fb`` for a
    ``[padded_pixels, 3]`` framebuffer, which it updates in place."""
    _single_device(mesh)

    def frame(fb, frame_num, reset, view_matrix, scene):
        pix = torch.arange(fb.shape[0], dtype=torch.int64, device=fb.device)
        radiance = _pixel_radiance(pix, frame_num,
                                   _view(view_matrix, fb.device), scene,
                                   meta, cfg)
        return film.accumulate(fb, radiance, reset)

    return frame


def make_sharded_loss_fn(mesh, base_scene: SceneData, meta: SceneMeta,
                         cfg: RenderConfig, apply_params):
    """Differentiable loss ``loss(params, target, frame_num, view)``: the
    mean over pixels and channels of ``(radiance - target) ** 2`` of a
    one-frame estimate (``render_dist.py:78-90``).
    ``apply_params(scene, params) -> SceneData`` plugs the parameters
    (emission, BSDF tables, geometry) into the scene."""
    _single_device(mesh)

    def loss(params, target, frame_num, view_matrix):
        scene = apply_params(base_scene, params)
        pix = torch.arange(target.shape[0], dtype=torch.int64,
                           device=target.device)
        radiance = _pixel_radiance(pix, frame_num,
                                   _view(view_matrix, target.device), scene,
                                   meta, cfg)
        return torch.mean((radiance - target) ** 2)

    return loss


def make_train_step(mesh, base_scene: SceneData, meta: SceneMeta,
                    cfg: RenderConfig, apply_params, optimizer):
    """Full forward, backward and update step (``render_dist.py:184-200``,
    ``torch.optim.Adam`` in place of ``optax.adam``).  ``optimizer`` holds
    the tensors of the ``params`` dict the step is called with, which are
    leaves that require grad.  Returns ``step(params, target, frame_num,
    view) -> loss``; the step updates ``params`` in place."""
    loss_fn = make_sharded_loss_fn(mesh, base_scene, meta, cfg, apply_params)

    def step(params, target, frame_num, view_matrix):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, target, frame_num, view_matrix)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
