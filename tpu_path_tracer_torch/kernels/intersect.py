"""Vectorized ray/primitive intersection math
(``tpu_path_tracer.kernels.intersect``).

A ray batch ``[N]`` is tested against a primitive table ``[P]`` by
broadcasting, producing ``[N, P]`` hit distances with ``INF`` for misses,
which the caller min-reduces.  Misses are masked, not branched.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.config import MAX_FLOAT

# "No hit" sentinel beyond any valid t_max (the float32 value).
INF = float(np.float32(MAX_FLOAT * 1.01))
# Parallel-ray cull for Möller-Trumbore: absolute and tiny, since det scales
# with the unnormalized normal (~edge_len^2); see the JAX module.
DET_EPS = float(np.float32(1e-12))


def sphere_roots(origin, direction, center, radius):
    """Both quadratic roots of ray/sphere, broadcast; returns
    (root_near, root_far, discriminant) — ``common.wgsl:29-100``."""
    oc = origin - center
    a = vm.dot(direction, direction)
    half_b = vm.dot(direction, oc)
    c = vm.dot(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    sq = vm.safe_sqrt(disc)
    inv_a = 1.0 / a
    return (-half_b - sq) * inv_a, (-half_b + sq) * inv_a, disc


def sphere_t(origin, direction, center, radius, t_min, t_max):
    """Closest valid sphere hit distance, or INF (``common.wgsl:39-52``):
    the near root if it lies in (t_min, t_max), else the far root."""
    r0, r1, disc = sphere_roots(origin, direction, center, radius)
    near_ok = (r0 > t_min) & (r0 < t_max)
    root = torch.where(near_ok, r0, r1)
    ok = (disc >= 0.0) & (root > t_min) & (root < t_max)
    return torch.where(ok, root, INF)


def quad_t(origin, direction, q, u, v, normal, d, w, t_min, t_max):
    """One-sided quad hit distance, or INF — ``hit_quad``
    (``common.wgsl:148-187``)."""
    denom = vm.dot(normal, direction)
    t = (d - vm.dot(normal, origin)) / denom
    p = origin + t[..., None] * direction
    rel = p - q
    alpha = vm.dot(w, vm.cross(rel, v))
    beta = vm.dot(w, vm.cross(u, rel))
    ok = ((vm.dot(direction, normal) <= 0.0)
          & (torch.abs(denom) >= 1e-8)
          & (t > t_min) & (t < t_max)
          & (alpha >= 0.0) & (alpha <= 1.0)
          & (beta >= 0.0) & (beta <= 1.0))
    return torch.where(ok, t, INF)


def quad_derived(q, u, v):
    """Plane data of a quad, as the host packer computes it
    (``lib/primitives/quad.js:21-27``): normal, d, w."""
    n = vm.cross(u, v)
    normal = vm.normalize(n)
    d = vm.dot(normal, q)
    w = n / vm.dot(n, n)[..., None]
    return normal, d, w


def triangle_t(origin, direction, a, b, c, t_min, t_max):
    """Möller-Trumbore, broadcast; returns (t_or_INF, u, v, w).  Keeps the
    reference's barycentric guards against ``t_min`` (``common.wgsl:191-242``)
    and ``DET_EPS`` in place of its ``|det| < t_min``."""
    ab = b - a
    ac = c - a
    n = vm.cross(ab, ac)
    det = -vm.dot(direction, n)
    ao = origin - a
    dao = vm.cross(ao, direction)
    inv_det = 1.0 / det
    t = vm.dot(ao, n) * inv_det
    u = vm.dot(ac, dao) * inv_det
    v = -vm.dot(ab, dao) * inv_det
    w = 1.0 - u - v
    ok = ((torch.abs(det) >= DET_EPS)
          & (t >= t_min) & (t <= t_max)
          & (u >= t_min) & (v >= t_min) & (w >= t_min))
    return torch.where(ok, t, INF), u, v, w


def aabb_hit(origin, inv_dir, box_min, box_max, t_min, t_max):
    """Slab test — ``hit_aabb`` (``common.wgsl:245-256``).  ``t_max`` may be
    a per-ray running closest hit (the traversal passes t_best).  NaN
    propagates through ``torch.minimum``/``amax`` as through the JAX ops: a
    zero direction component with the origin on a box plane gives 0 * inf,
    and the box then misses."""
    t0 = (box_min - origin) * inv_dir
    t1 = (box_max - origin) * inv_dir
    smaller = torch.minimum(t0, t1)
    bigger = torch.maximum(t0, t1)
    lo = torch.clamp(torch.amax(smaller, dim=-1), min=t_min)
    hi = torch.minimum(torch.amin(bigger, dim=-1), t_max)
    return hi > lo


def volume_interval(origin, direction, center, radius, t_min, t_max):
    """Entry/exit interval of a medium sphere (``hit_volume``,
    ``common.wgsl:102-129``); returns (rec1, rec2, interval_valid)."""
    r0, r1, disc = sphere_roots(origin, direction, center, radius)
    ok = (disc >= 0.0) & (r1 > r0 + 0.0001)
    rec1 = torch.clamp(r0, min=t_min)
    rec2 = torch.minimum(r1, torch.as_tensor(t_max, dtype=r1.dtype,
                                             device=r1.device))
    ok = ok & (rec1 < rec2)
    rec1 = torch.clamp(rec1, min=0.0)
    return rec1, rec2, ok


def volume_t(origin, direction, center, radius, neg_inv_density, u, t_min,
             t_max):
    """Sampled scattering distance inside a medium sphere, or INF:
    ``hit_dist = neg_inv_density * log(u)`` (``common.wgsl:130-140``)."""
    rec1, rec2, ok = volume_interval(origin, direction, center, radius,
                                     t_min, t_max)
    ray_len = vm.length(direction)
    dist_inside = (rec2 - rec1) * ray_len
    hit_dist = neg_inv_density * torch.log(torch.clamp(u, min=1e-12))
    ok = ok & (hit_dist <= dist_inside)
    t = rec1 + hit_dist / ray_len
    return torch.where(ok, t, INF)
