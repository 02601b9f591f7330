"""Vector math over trailing-3 axes (``tpu_path_tracer.core.vecmath``).

Dot products are written out component by component, so the sum order is
fixed: ``x*x + y*y + z*z``, left to right.
"""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.  Torch's vectorized CPU
    ``sqrt`` is off by one ulp on about 0.6% of float32 inputs, while XLA's
    and CUDA's ``sqrtf`` round correctly; a double-precision root rounded
    once to float32 is exact, and keeps branch decisions aligned with both.
    """
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis; keeps no dims."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(x, 0))`` whose gradient is 0, not NaN, at ``x <= 0``."""
    pos = x > 0.0
    return torch.where(pos, sqrt(torch.where(pos, x, 1.0)), 0.0)


def length(v: torch.Tensor) -> torch.Tensor:
    return sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize: ``v * (1 / sqrt(max(|v|^2, eps)))``.  A reciprocal of
    a square root, not ``rsqrt``, for bit parity with the JAX package."""
    sq = torch.clamp(dot(v, v), min=eps)
    return v * (1.0 / sqrt(sq))[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection, WGSL ``reflect`` semantics (d - 2*dot(d,n)*n)."""
    return d - 2.0 * dot(d, n)[..., None] * n


def refract(uv: torch.Tensor, n: torch.Tensor,
            eta_ratio: torch.Tensor) -> torch.Tensor:
    """WGSL ``refract`` as the glass BSDF uses it
    (``shaders/scatterRay.wgsl:60``); ``uv`` and ``n`` unit length,
    ``eta_ratio`` per lane ``[...]``."""
    eta_ratio = eta_ratio[..., None]
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)[..., None]
    r_out_perp = eta_ratio * (uv + cos_theta * n)
    r_out_parallel = -safe_sqrt(
        1.0 - dot(r_out_perp, r_out_perp))[..., None] * n
    return r_out_perp + r_out_parallel


def mix(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """WGSL ``mix``: a + (b - a) * t."""
    return a + (b - a) * t


def onb_from_w(w: torch.Tensor):
    """Orthonormal basis from ``w`` (``onb_build_from_w``,
    ``importanceSampling.wgsl:60-67``): helper axis ``(0,1,0)`` when
    ``|w.x| > 0.9`` else ``(1,0,0)``; v = normalize(cross(w, a));
    u = cross(w, v).  Returns (u, v, unit_w)."""
    unit_w = normalize(w)
    big_x = (torch.abs(unit_w[..., 0]) > 0.9)[..., None]
    axis_y = unit_w.new_tensor([0.0, 1.0, 0.0])
    axis_x = unit_w.new_tensor([1.0, 0.0, 0.0])
    a = torch.where(big_x, axis_y, axis_x)
    v = normalize(cross(unit_w, a))
    u = cross(unit_w, v)
    return u, v, unit_w


def onb_local(u, v, w, a):
    """``onb_get_local`` (``importanceSampling.wgsl:69-71``)."""
    return u * a[..., 0:1] + v * a[..., 1:2] + w * a[..., 2:3]
