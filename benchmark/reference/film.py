"""Progressive accumulation and the display transform (the upstream's
``shaders/main.wgsl:22-27`` and ``fragment.js:22-36``): the framebuffer's
mean over the frames, the ACES fit of ``common.wgsl:273-282`` with its 0.6
pre-exposure, gamma 1/2.2, and 8 bits a channel."""

from __future__ import annotations

import torch


def accumulate(framebuffer, radiance, reset: bool):
    """The next framebuffer (a new tensor): ``radiance`` on reset, else the
    sum."""
    return radiance.clone() if reset else framebuffer + radiance


def display(framebuffer, frame_num: int):
    """[N, 3] accumulated radiance -> [N, 3] uint8."""
    v = framebuffer / float(max(int(frame_num), 1)) * 0.6
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    v = torch.clamp((v * (a * v + b)) / (v * (c * v + d) + e), 0.0, 1.0)
    v = v ** (1.0 / 2.2)
    return torch.clamp(torch.round(v * 255.0), 0, 255).to(torch.uint8)
