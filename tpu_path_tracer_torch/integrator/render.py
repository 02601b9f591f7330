"""Camera ray generation and the per-frame render step
(``tpu_path_tracer.integrator.render``).

Ray generation follows ``shaders/shootRay.wgsl``: pixel centers at integer
coordinates, one jittered sample per pixel per frame (or a stratified
sqrt(spp) x sqrt(spp) sub-pixel grid when ``cfg.stratify``), and camera
rays through the view matrix with a 60-degree vertical FOV factor.  As in
the JAX package, the pixel y coordinate is the integer floor divide, not
the reference's float divide (``shaders/main.wgsl:5``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rng, vecmath as vm
from ..core.config import PI, RenderConfig
from ..core.types import Ray, SceneData, SceneMeta
from . import film
from .path_tracer import trace


def _fov_factor(cfg: RenderConfig) -> float:
    return float(np.float32(1.0 / math.tan(cfg.fov_degrees * (PI / 180.0)
                                           / 2.0)))


def camera_rays(rand_state, view_matrix, px, py, cfg: RenderConfig,
                sub_offset=None, sub_scale: float = 1.0):
    """Jittered primary rays through pixel coords (px, py); ``sub_offset``
    and ``sub_scale`` place the jitter in a stratified sub-pixel cell
    (``shootRay.wgsl:19-22``).  Returns (rand_state, Ray)."""
    w = float(np.float32(cfg.width))
    h = float(np.float32(cfg.height))
    aspect = float(np.float32(w) / np.float32(h))
    rand_state, u1 = rng.uniform(rand_state)
    rand_state, u2 = rng.uniform(rand_state)
    if sub_offset is not None:
        jx = sub_scale * (sub_offset[0] + u1)
        jy = sub_scale * (sub_offset[1] + u2)
    else:
        jx, jy = u1, u2
    s = aspect * (2.0 * ((px.to(torch.float32) - 0.5 + jx) / w) - 1.0)
    t = -1.0 * (2.0 * ((py.to(torch.float32) - 0.5 + jy) / h) - 1.0)

    # dir = normalize(viewMatrix @ [s, t, -fovFactor, 0]).xyz
    basis = view_matrix[:3, :3]  # columns: camera x, y, z axes
    d = (s[:, None] * basis[:, 0][None]
         + t[:, None] * basis[:, 1][None]
         - _fov_factor(cfg) * basis[:, 2][None])
    origin = view_matrix[:3, 3][None].expand(d.shape)
    return rand_state, Ray(origin=origin, dir=vm.normalize(d))


def path_trace_pixels(rand_state, view_matrix, px, py, scene: SceneData,
                      meta: SceneMeta, cfg: RenderConfig):
    """``pathTrace`` (``shootRay.wgsl:5-49``): average the samples of each
    pixel.  Returns (rand_state, radiance [N, 3]).

    With ``cfg.use_megakernel`` set and a scene the kernel supports, the
    whole trace is one launch of the CUDA megakernel, and its gradient one
    launch of the backward kernel (``kernels.megakernel``; on CPU tensors
    their plain version, this wavefront under autograd).  That route
    returns the caller's ``rand_state`` unchanged, as in the JAX package:
    callers reseed every frame from (pixel, frame)."""
    from ..kernels import megakernel as mk

    if cfg.use_megakernel and mk.supported(scene, meta, cfg):
        radiance = mk.path_trace_pixels_megakernel(
            rand_state, view_matrix, px, py, scene, meta, cfg)
        return rand_state, radiance

    total = torch.zeros((px.shape[0], 3), dtype=torch.float32,
                        device=px.device)
    if cfg.stratify:
        # A non-square spp renders floor(sqrt(spp))^2 samples, like the
        # reference (shootRay.wgsl:11-30).
        grid = max(int(cfg.samples_per_pixel ** 0.5), 1)
        for k in range(grid * grid):
            rand_state, ray = camera_rays(
                rand_state, view_matrix, px, py, cfg,
                sub_offset=(float(k // grid), float(k % grid)),
                sub_scale=1.0 / grid)
            rand_state, radiance = trace(rand_state, ray, scene, meta, cfg)
            total = total + radiance
        return rand_state, total / (grid * grid)

    for _ in range(cfg.samples_per_pixel):
        rand_state, ray = camera_rays(rand_state, view_matrix, px, py, cfg)
        rand_state, radiance = trace(rand_state, ray, scene, meta, cfg)
        total = total + radiance
    return rand_state, total / cfg.samples_per_pixel


def pixel_grid(width: int, height: int, device):
    """Row-major pixel indices and their (px, py), all int64 ``[W*H]``."""
    pix = torch.arange(width * height, dtype=torch.int64, device=device)
    return pix, pix % width, pix // width


def render_frame(framebuffer, frame_num: int, reset: bool, view_matrix,
                 scene: SceneData, meta: SceneMeta, cfg: RenderConfig):
    """One progressive frame (``renderer.js:187-188`` +
    ``shaders/main.wgsl``).

    ``framebuffer`` [H*W, 3] float32 holds the accumulated radiance and is
    updated in place (the JAX package donates it instead); it is also
    returned.  ``frame_num`` decorrelates the per-pixel PCG seeds across
    frames (``main.wgsl:16``); ``reset`` overwrites instead of
    accumulating.  ``view_matrix`` is the 4x4 camera matrix, taken onto the
    framebuffer's device as float32."""
    device = framebuffer.device
    view = torch.as_tensor(view_matrix, dtype=torch.float32, device=device)
    pix, px, py = pixel_grid(cfg.width, cfg.height, device)
    rand_state = rng.seed(pix, frame_num)
    _, radiance = path_trace_pixels(rand_state, view, px, py, scene, meta,
                                    cfg)
    return film.accumulate(framebuffer, radiance, reset)
