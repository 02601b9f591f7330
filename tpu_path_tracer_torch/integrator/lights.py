"""Light sampling and the NEE pdf (``tpu_path_tracer.integrator.lights``).

The first emissive quad is "the light" (``get_lights``,
``shaders/common.wgsl:258-269``), resolved once at scene build.
"""

from __future__ import annotations

import torch

from ..core import rng, vecmath as vm
from ..core.config import MAX_FLOAT, MIN_FLOAT
from ..core.types import SceneData


def light_quad(scene: SceneData):
    """The light quad's raw fields (q, u, v); index clamped so a light-free
    scene stays valid (has_light gating happens upstream)."""
    li = min(max(scene.light_index, 0), max(scene.quads.count - 1, 0))
    return scene.quads.q[li], scene.quads.u[li], scene.quads.v[li]


def sample_on_quad(rand_state, q, u, v, origin):
    """``get_random_on_quad`` (importanceSampling.wgsl:78-81): uniform point
    on the parallelogram, returned as a unit direction from ``origin``."""
    rand_state, r1 = rng.uniform(rand_state)
    rand_state, r2 = rng.uniform(rand_state)
    p = q + r1[:, None] * u + r2[:, None] * v
    return rand_state, vm.normalize(p - origin)


def quad_light_pdf(origin, direction, q, u, v):
    """Solid-angle pdf of hitting the quad from ``origin`` along
    ``direction`` — ``light_pdf`` (importanceSampling.wgsl:88-125):
    dist^2 / (|cos| * area), MIN_FLOAT for any invalid configuration."""
    n_raw = vm.cross(u, v)
    normal = vm.normalize(n_raw)
    d_plane = vm.dot(normal, q)
    w = n_raw / vm.dot(n_raw, n_raw)[..., None]

    denom = vm.dot(normal, direction)
    grazing = torch.abs(denom) < 1e-8
    t = (d_plane - vm.dot(normal, origin)) / torch.where(grazing, 1.0, denom)
    p = origin + t[..., None] * direction
    rel = p - q
    alpha = vm.dot(w, vm.cross(rel, v))
    beta = vm.dot(w, vm.cross(u, rel))

    valid = ((vm.dot(direction, normal) <= 0.0)   # one-sided, imp.wgsl:90
             & (torch.abs(denom) >= 1e-8)
             & (t > 0.001) & (t < MAX_FLOAT)
             & (alpha >= 0.0) & (alpha <= 1.0)
             & (beta >= 0.0) & (beta <= 1.0))
    dist_sq = t * t * vm.dot(direction, direction)
    cosine = torch.abs(denom) / torch.clamp(vm.length(direction), min=1e-12)
    area = vm.length(n_raw)
    # Zero the numerator of invalid lanes before dividing: a lane whose
    # path has ended sits a miss distance (1e9) away, where dist_sq reaches
    # 1e27 and the division's backward overflows to inf, and 0 * inf would
    # put NaN into the quad gradients through the where below.
    dist_sq = torch.where(valid, dist_sq, 0.0)
    pdf = dist_sq / torch.clamp(cosine * area, min=1e-12)
    return torch.where(valid, pdf, MIN_FLOAT)
