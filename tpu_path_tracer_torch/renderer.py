"""Renderer orchestration — the ``renderer.js`` equivalent
(``tpu_path_tracer.renderer``).

Owns the framebuffer, the frame counter, the camera-motion reset, the FPS
cap, the stats, the periodic perf log and checkpoint/resume, and maps the
reference's loop (``renderer.js:163-215``) onto
``integrator.render.render_frame``:

* FPS cap via sleep (``renderer.js:206-209``);
* stats and perf logs behind the same flags as ``renderParams``
  (``index.js:27-34``); a frame's time is the host's clock around the step,
  ended by a synchronize of the framebuffer's CUDA device, and only under
  those flags (without them frames are enqueued and nothing waits);
* checkpoints in the JAX package's NPZ format (``utils.checkpoint``).

The framebuffer lives on the scene's device and is updated in place every
frame.  Sharding across devices is not ported yet (ROADMAP Queue 1 item
11): a ``mesh`` raises.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .core.camera import Camera
from .core.config import RenderConfig
from .core.types import SceneData, SceneMeta
from .integrator import film
from .integrator.render import render_frame
from .utils import checkpoint as ckpt
from .utils.image import write_png
from .utils.profiling import FrameStats


class Renderer:
    def __init__(self, scene: SceneData, meta: SceneMeta, cfg: RenderConfig,
                 camera: Optional[Camera] = None, mesh=None,
                 show_fps: bool = False, max_fps: float = 0.0,
                 log_count_of_samples: bool = False,
                 log_performance: bool = False):
        if mesh is not None:
            raise NotImplementedError(
                "rendering over a device mesh is not ported yet: ROADMAP "
                "Queue 1 item 11 (torch.distributed)")
        self.scene = scene
        self.meta = meta
        self.cfg = cfg
        self.camera = camera or Camera(eye=[0.5, 0.0, 2.5])  # index.js:39
        self.show_fps = show_fps
        self.max_fps = max_fps          # renderParams.maxFPS, index.js:30
        self.log_count_of_samples = log_count_of_samples
        self.log_performance = log_performance
        self.stats = FrameStats()
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
        if self.log_count_of_samples:  # renderer.js:169-170
            print(f"Total Samples: "
                  f"{self.frame_num * self.cfg.samples_per_pixel}")
        return self.framebuffer

    def render_animation(self, num_frames: int,
                         checkpoint_path: Optional[str] = None,
                         checkpoint_every: int = 0):
        """The renderAnimation loop (renderer.js:163-215) for headless use:
        a fixed frame budget instead of requestAnimationFrame recursion."""
        rays = (self.cfg.width * self.cfg.height
                * self.cfg.samples_per_pixel)
        for i in range(num_frames):
            self.stats.begin()
            self.step()
            if ((self.show_fps or self.log_performance)
                    and self.device.type == "cuda"):
                torch.cuda.synchronize(self.device)
            self.stats.end()
            if self.log_performance and self.stats.frames % 100 == 0:
                print(self.stats.report(rays))  # renderer.js:197-204
            if (checkpoint_every and checkpoint_path
                    and (i + 1) % checkpoint_every == 0):
                self.save_checkpoint(checkpoint_path)
            if self.max_fps > 0:  # renderer.js:206-209
                budget = 1.0 / self.max_fps
                elapsed = self.stats.times[-1] if self.stats.times else 0.0
                if elapsed < budget:
                    time.sleep(budget - elapsed)
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

    def save_checkpoint(self, path: str):
        ckpt.save_checkpoint(path, self.framebuffer, self.frame_num,
                             self.camera)

    def load_checkpoint(self, path: str):
        fb, frame_num, cam = ckpt.load_checkpoint(path)
        if fb.shape != tuple(self.framebuffer.shape):
            raise ValueError(
                f"checkpoint framebuffer {fb.shape} does not match "
                f"{tuple(self.framebuffer.shape)} of this renderer")
        self.framebuffer = torch.tensor(fb, dtype=torch.float32,
                                        device=self.device)
        self.frame_num = frame_num
        if cam is not None:
            self.camera = cam
