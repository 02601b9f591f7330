"""Per-lane PCG random numbers, bit-exact with ``tpu_path_tracer.core.rng``.

The reference seeds one 32-bit PCG state per pixel
(``shaders/main.wgsl:16``) and advances it with the PCG output hash
(``shaders/common.wgsl:7-12``).  Torch has no full set of ``uint32``
operators on the CPU (``+`` and ``>>`` are missing), so the state rides in
an ``int64`` tensor that always holds a value in ``[0, 2**32)``: each
multiply and add is masked back to 32 bits, which keeps ``>>`` logical.
Both multipliers are below 2**30, so no product overflows 63 bits.

All sampling helpers return ``(new_state, sample)``.
"""

from __future__ import annotations

import torch

from .config import PI
from . import vecmath as vm

MASK = 0xFFFFFFFF
MULT = 747796405
INC = 2891336453
XSH = 277803737
SEED_STRIDE = 719393
_INV_U32_MAX = 1.0 / 4294967295.0


def seed(pixel_index: torch.Tensor, frame_num) -> torch.Tensor:
    """Per-lane seeding — ``shaders/main.wgsl:16``.  Returns int64 states in
    ``[0, 2**32)``."""
    return (pixel_index.to(torch.int64)
            + (int(frame_num) & MASK) * SEED_STRIDE) & MASK


def uniform(state: torch.Tensor):
    """One PCG step per lane; returns (new_state, float32 in [0, 1]).

    The state is advanced first, then the output hash is applied to the new
    state.  The u32 -> f32 conversion of the masked int64 rounds to nearest
    even, as ``astype(float32)`` does in the JAX package."""
    state = (state * MULT + INC) & MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * XSH) & MASK
    out = ((word >> 22) ^ word).to(torch.float32)
    return state, out * _INV_U32_MAX


def uniform_in_unit_sphere(state):
    """``uniform_random_in_unit_sphere`` (``importanceSampling.wgsl:7-16``) —
    a uniform direction on the unit sphere (it normalizes)."""
    state, r1 = uniform(state)
    state, r2 = uniform(state)
    phi = r1 * 2.0 * PI
    theta = torch.arccos(torch.clamp(2.0 * r2 - 1.0, -1.0, 1.0))
    sin_t = torch.sin(theta)
    d = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                     torch.cos(theta)], dim=-1)
    return state, vm.normalize(d)


def cosine_wrt_z(state):
    """Cosine-weighted hemisphere sample about +Z
    (``cosine_sampling_wrt_Z``, ``importanceSampling.wgsl:35-45``)."""
    state, r1 = uniform(state)
    state, r2 = uniform(state)
    phi = 2.0 * PI * r1
    sq = vm.sqrt(r2)
    d = torch.stack([torch.cos(phi) * sq, torch.sin(phi) * sq,
                     vm.sqrt(torch.clamp(1.0 - r2, min=0.0))], dim=-1)
    return state, d
