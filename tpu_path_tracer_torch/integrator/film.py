"""Progressive accumulation + display transform
(``tpu_path_tracer.integrator.film``).

Accumulation follows the compute pass (``shaders/main.wgsl:22-27``): add
this frame's estimate into the framebuffer, or overwrite it on reset.
Display follows the blit shader (``shaders/fragment.js:22-36``): mean =
buffer / frame count, ACES filmic curve (``common.wgsl:273-282``), gamma
1/2.2.
"""

from __future__ import annotations

import torch


def accumulate(framebuffer, frame_radiance, reset: bool):
    """Add ``frame_radiance`` [N, 3] into ``framebuffer`` [N, 3], or
    overwrite it when ``reset``.  Updates ``framebuffer`` in place (the
    read_write storage binding of the reference) and returns it."""
    if reset:
        return framebuffer.copy_(frame_radiance)
    return framebuffer.add_(frame_radiance)


def aces_approx(v):
    """ACES filmic tone map — ``common.wgsl:273-282`` (Narkowicz fit),
    including the 0.6 pre-exposure."""
    v1 = v * 0.6
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((v1 * (a * v1 + b)) / (v1 * (c * v1 + d) + e),
                       0.0, 1.0)


def display_transform(framebuffer, frame_num: int):
    """[N, 3] accumulated radiance -> [N, 3] display-ready in [0, 1]
    (``fragment.js:25-29``)."""
    mean = framebuffer / float(max(int(frame_num), 1))
    return aces_approx(mean) ** (1.0 / 2.2)


def to_uint8(img01):
    return torch.clamp(torch.round(img01 * 255.0), 0, 255).to(torch.uint8)
