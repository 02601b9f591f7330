"""Renderer orchestration — the ``renderer.js`` equivalent
(``tpu_path_tracer.renderer``).

Owns the framebuffer, the frame counter, the camera-motion reset, the FPS
cap, the stats, the periodic perf log and checkpoint/resume, and maps the
reference's loop (``renderer.js:163-215``) onto the frame of
``dist.render_dist.make_sharded_frame_fn`` (in one process, the frame
``integrator.render.render_frame`` renders):

* FPS cap via sleep (``renderer.js:206-209``);
* stats and perf logs behind the same flags as ``renderParams``
  (``index.js:27-34``); a frame's time is the host's clock around the step,
  ended by a synchronize of the framebuffer's CUDA device, and only under
  those flags (without them frames are enqueued and nothing waits);
* checkpoints in the JAX package's NPZ format (``utils.checkpoint``).

The framebuffer lives on the scene's device and is updated in place every
frame.  With a ``mesh`` (``dist.sharding.make_mesh``) the renderer runs on
every rank of it, as the JAX one runs over a device mesh
(``renderer.py:58-70``): ``framebuffer`` is this rank's chunk of the padded
``[padded_pixels, 3]`` framebuffer, the scene is replicated from the first
rank, and ``display``, ``save_png`` and ``save_checkpoint`` gather the
chunks in rank order, so every rank must call them; only the first rank
writes files and prints logs.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .core.camera import Camera
from .core.config import RenderConfig
from .core.types import SceneData, SceneMeta
from .dist.render_dist import make_sharded_frame_fn, padded_pixels
from .dist.sharding import (gather_rows, mesh_rank, mesh_size, rank_device,
                            ray_sharding, shard_scene)
from .integrator import film
from .utils import checkpoint as ckpt
from .utils import profiling
from .utils.image import write_png


class Renderer:
    def __init__(self, scene: SceneData, meta: SceneMeta, cfg: RenderConfig,
                 camera: Optional[Camera] = None, mesh=None,
                 show_fps: bool = False, max_fps: float = 0.0,
                 log_count_of_samples: bool = False,
                 log_performance: bool = False):
        self.scene = scene
        self.meta = meta
        self.cfg = cfg
        self.camera = camera or Camera(eye=[0.5, 0.0, 2.5])  # index.js:39
        self.mesh = mesh
        self.show_fps = show_fps
        self.max_fps = max_fps          # renderParams.maxFPS, index.js:30
        self.log_count_of_samples = log_count_of_samples
        self.log_performance = log_performance
        self.stats = profiling.FrameStats()
        self.frame_num = 0
        if mesh is not None:
            self.device = rank_device(mesh)
            self.scene = shard_scene(scene, mesh)
            self._n_pixels = padded_pixels(cfg, mesh)
        else:
            self.device = scene.quads.q.device
            self._n_pixels = cfg.width * cfg.height
        self._root = mesh_rank(mesh) == 0
        self.framebuffer = torch.zeros((self._n_pixels // mesh_size(mesh), 3),
                                       dtype=torch.float32,
                                       device=self.device)

    def step(self, reset: Optional[bool] = None):
        """Advance one progressive frame.  ``reset`` defaults to the camera
        motion flags, like renderer.js:174-180.

        Through the megakernel the scene's tables are packed on the first
        frame and reused while its tensors keep their versions; after a
        write that leaves a version as it was (``.data``, a numpy view, a
        fused optimizer step on parameters held detached) call
        ``kernels.megakernel.clear_table_cache()``."""
        profiling.count("frames")
        with profiling.span("renderer.step"):
            if reset is None:
                reset = self.camera.consume_motion_flags()
            if reset:
                self.frame_num = 0
            self.frame_num += 1
            make_sharded_frame_fn(self.mesh, self.meta, self.cfg)(
                self.framebuffer, self.frame_num, bool(reset),
                self.camera.view_matrix, self.scene)
            if self.log_count_of_samples and self._root:  # renderer.js:169-170
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
                profiling.count("host_syncs")
                torch.cuda.synchronize(self.device)
            self.stats.end()
            if (self.log_performance and self._root
                    and self.stats.frames % 100 == 0):
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

    def _global_framebuffer(self):
        """The whole padded framebuffer, gathered from every rank."""
        if self.mesh is None:
            return self.framebuffer
        return gather_rows(self.framebuffer, self.mesh)

    def display(self) -> np.ndarray:
        """Tone-mapped uint8 image [H, W, 3] (fragment.js:22-36); with a
        mesh, of the gathered framebuffer's first W*H rows."""
        with profiling.span("renderer.display"):
            n = self.cfg.width * self.cfg.height
            img = film.to_uint8(film.display_transform(
                self._global_framebuffer()[:n], self.frame_num))
            # The copy waits for the frame on the device.
            profiling.count("host_syncs")
            with profiling.span("renderer.display.copy"):
                img = img.cpu()
        return img.numpy().reshape(self.cfg.height, self.cfg.width, 3)

    def save_png(self, path: str):
        img = self.display()
        if self._root:
            write_png(path, img)

    def save_checkpoint(self, path: str):
        """With a mesh: the gathered padded framebuffer, the JAX sharded
        renderer's layout, written by the first rank."""
        fb = self._global_framebuffer()
        if self._root:
            ckpt.save_checkpoint(path, fb, self.frame_num, self.camera)

    def load_checkpoint(self, path: str):
        fb, frame_num, cam = ckpt.load_checkpoint(path)
        if fb.shape != (self._n_pixels, 3):
            raise ValueError(
                f"checkpoint framebuffer {fb.shape} does not match "
                f"{(self._n_pixels, 3)} of this renderer")
        fb = torch.tensor(fb, dtype=torch.float32)
        if self.mesh is not None:
            self.framebuffer = ray_sharding(self.mesh)(fb)
        else:
            self.framebuffer = fb.to(self.device)
        self.frame_num = frame_num
        if cam is not None:
            self.camera = cam
