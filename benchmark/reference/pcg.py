"""Per-lane PCG random numbers (the upstream's ``shaders/common.wgsl:7-12``
seeded as ``shaders/main.wgsl:16``).

The 32-bit state rides in an int64 tensor masked back to 32 bits after each
multiply and add, so ``>>`` stays logical.  A sample is returned in the
dtype asked for: the u32 is converted to it, then scaled.
"""

from __future__ import annotations

import torch

from .geometry import PI, normalize, sqrt

MASK = 0xFFFFFFFF
MULT = 747796405
INC = 2891336453
XSH = 277803737
SEED_STRIDE = 719393
INV_U32_MAX = 1.0 / 4294967295.0


def seed(pixel_index: torch.Tensor, frame_num) -> torch.Tensor:
    return (pixel_index.to(torch.int64)
            + (int(frame_num) & MASK) * SEED_STRIDE) & MASK


def uniform(state: torch.Tensor, dtype):
    state = (state * MULT + INC) & MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * XSH) & MASK
    out = ((word >> 22) ^ word).to(dtype)
    return state, out * INV_U32_MAX


def uniform_in_unit_sphere(state, dtype):
    state, r1 = uniform(state, dtype)
    state, r2 = uniform(state, dtype)
    phi = r1 * 2.0 * PI
    theta = torch.arccos(torch.clamp(2.0 * r2 - 1.0, -1.0, 1.0))
    sin_t = torch.sin(theta)
    d = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                     torch.cos(theta)], dim=-1)
    return state, normalize(d)


def cosine_wrt_z(state, dtype):
    state, r1 = uniform(state, dtype)
    state, r2 = uniform(state, dtype)
    phi = 2.0 * PI * r1
    sq = sqrt(r2)
    d = torch.stack([torch.cos(phi) * sq, torch.sin(phi) * sq,
                     sqrt(torch.clamp(1.0 - r2, min=0.0))], dim=-1)
    return state, d
