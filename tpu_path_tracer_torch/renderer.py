"""Renderer orchestration — the ``renderer.js`` equivalent
(``tpu_path_tracer.renderer``).

Owns the framebuffer, the frame counter and the camera-motion reset, and
maps the reference's loop (``renderer.js:163-215``) onto
``integrator.render.render_frame``.  The framebuffer lives on the scene's
device and is updated in place every frame.  Sharding across devices, the
FPS cap, frame statistics and logging, and checkpoints are not ported yet
(ROADMAP Queue 1 items 10-11).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.camera import Camera
from .core.config import RenderConfig
from .core.types import SceneData, SceneMeta
from .integrator import film
from .integrator.render import render_frame
from .utils.image import write_png


class Renderer:
    def __init__(self, scene: SceneData, meta: SceneMeta, cfg: RenderConfig,
                 camera: Optional[Camera] = None):
        self.scene = scene
        self.meta = meta
        self.cfg = cfg
        self.camera = camera or Camera(eye=[0.5, 0.0, 2.5])  # index.js:39
        self.frame_num = 0
        self.device = scene.quads.q.device
        self.framebuffer = torch.zeros((cfg.width * cfg.height, 3),
                                       dtype=torch.float32,
                                       device=self.device)

    def step(self, reset: Optional[bool] = None):
        """Advance one progressive frame.  ``reset`` defaults to the camera
        motion flags, like renderer.js:174-180."""
        if reset is None:
            reset = self.camera.consume_motion_flags()
        if reset:
            self.frame_num = 0
        self.frame_num += 1
        render_frame(self.framebuffer, self.frame_num, bool(reset),
                     self.camera.view_matrix, self.scene, self.meta,
                     self.cfg)
        return self.framebuffer

    def render_animation(self, num_frames: int):
        """The renderAnimation loop (renderer.js:163-215) for headless use:
        a fixed frame budget instead of requestAnimationFrame recursion."""
        for _ in range(num_frames):
            self.step()
        return self.framebuffer

    def render_single_frame(self, spp: Optional[int] = None):
        """One converged frame at high spp in a single call (the feature
        renderer.js:219-249 ships but marks not working)."""
        if spp is not None and spp != self.cfg.samples_per_pixel:
            self.cfg = self.cfg.replace(samples_per_pixel=spp)
        self.frame_num = 0
        return self.step(reset=True)

    def display(self) -> np.ndarray:
        """Tone-mapped uint8 image [H, W, 3] (fragment.js:22-36)."""
        img = film.to_uint8(film.display_transform(self.framebuffer,
                                                   self.frame_num))
        return img.cpu().numpy().reshape(self.cfg.height, self.cfg.width, 3)

    def save_png(self, path: str):
        write_png(path, self.display())
