"""Checkpoint / resume for progressive renders
(``tpu_path_tracer.utils.checkpoint``), in the JAX package's file format:
one NPZ snapshot of ``framebuffer``, ``frame_num`` and the camera pose
(``eye``, ``center``, ``up``), so either package resumes the other's
render.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.camera import Camera


def save_checkpoint(path: str, framebuffer, frame_num: int,
                    camera: Optional[Camera] = None) -> None:
    """Atomic snapshot (write tmp + rename, preemption-safe).
    ``framebuffer``: a tensor on any device, or an array."""
    if isinstance(framebuffer, torch.Tensor):
        framebuffer = framebuffer.detach().cpu().numpy()
    payload = {
        "framebuffer": np.asarray(framebuffer),
        "frame_num": np.int64(frame_num),
    }
    if camera is not None:
        payload["eye"] = camera.eye
        payload["center"] = camera.center
        payload["up"] = camera.up
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str) -> Tuple[np.ndarray, int, Optional[Camera]]:
    """Returns (framebuffer, frame_num, camera-or-None)."""
    with np.load(path) as z:
        fb = z["framebuffer"]
        frame_num = int(z["frame_num"])
        cam = None
        if "eye" in z:
            cam = Camera(eye=z["eye"], center=z["center"], up=z["up"])
    return fb, frame_num, cam
