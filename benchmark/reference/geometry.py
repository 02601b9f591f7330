"""Vector math and ray/primitive intersection over trailing-3 axes.

Dot products are summed x, y, z in that order.  A square root is taken in
float64 and rounded once to the input's dtype, which rounds it correctly.
Intersections broadcast a ray batch against a primitive table and give the
hit distance, or ``INF`` for a miss (the upstream's ``common.wgsl``).
"""

from __future__ import annotations

import numpy as np
import torch

PI = 3.1415926535897932385
MIN_FLOAT = 0.0001
MAX_FLOAT = 999999999.999
INF = float(np.float32(MAX_FLOAT * 1.01))
DET_EPS = float(np.float32(1e-12))


def sqrt(x):
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def safe_sqrt(x):
    pos = x > 0.0
    return torch.where(pos, sqrt(torch.where(pos, x, 1.0)), 0.0)


def length(v):
    return sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v, eps: float = 1e-20):
    sq = torch.clamp(dot(v, v), min=eps)
    return v * (1.0 / sqrt(sq))[..., None]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def reflect(d, n):
    return d - 2.0 * dot(d, n)[..., None] * n


def refract(uv, n, eta_ratio):
    eta_ratio = eta_ratio[..., None]
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)[..., None]
    r_out_perp = eta_ratio * (uv + cos_theta * n)
    r_out_parallel = -safe_sqrt(
        1.0 - dot(r_out_perp, r_out_perp))[..., None] * n
    return r_out_perp + r_out_parallel


def mix(a, b, t):
    return a + (b - a) * t


def onb_from_w(w):
    unit_w = normalize(w)
    big_x = (torch.abs(unit_w[..., 0]) > 0.9)[..., None]
    a = torch.where(big_x, unit_w.new_tensor([0.0, 1.0, 0.0]),
                    unit_w.new_tensor([1.0, 0.0, 0.0]))
    v = normalize(cross(unit_w, a))
    u = cross(unit_w, v)
    return u, v, unit_w


def onb_local(u, v, w, a):
    return u * a[..., 0:1] + v * a[..., 1:2] + w * a[..., 2:3]


def sphere_roots(origin, direction, center, radius):
    oc = origin - center
    a = dot(direction, direction)
    half_b = dot(direction, oc)
    c = dot(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    sq = safe_sqrt(disc)
    inv_a = 1.0 / a
    return (-half_b - sq) * inv_a, (-half_b + sq) * inv_a, disc


def sphere_t(origin, direction, center, radius, t_min, t_max):
    r0, r1, disc = sphere_roots(origin, direction, center, radius)
    near_ok = (r0 > t_min) & (r0 < t_max)
    root = torch.where(near_ok, r0, r1)
    ok = (disc >= 0.0) & (root > t_min) & (root < t_max)
    return torch.where(ok, root, INF)


def quad_t(origin, direction, q, u, v, normal, d, w, t_min, t_max):
    denom = dot(normal, direction)
    t = (d - dot(normal, origin)) / denom
    p = origin + t[..., None] * direction
    rel = p - q
    alpha = dot(w, cross(rel, v))
    beta = dot(w, cross(u, rel))
    ok = ((dot(direction, normal) <= 0.0) & (torch.abs(denom) >= 1e-8)
          & (t > t_min) & (t < t_max)
          & (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0))
    return torch.where(ok, t, INF)


def quad_derived(q, u, v):
    n = cross(u, v)
    normal = normalize(n)
    return normal, dot(normal, q), n / dot(n, n)[..., None]


def triangle_t(origin, direction, a, b, c, t_min, t_max):
    ab = b - a
    ac = c - a
    n = cross(ab, ac)
    det = -dot(direction, n)
    ao = origin - a
    dao = cross(ao, direction)
    inv_det = 1.0 / det
    t = dot(ao, n) * inv_det
    u = dot(ac, dao) * inv_det
    v = -dot(ab, dao) * inv_det
    w = 1.0 - u - v
    ok = ((torch.abs(det) >= DET_EPS) & (t >= t_min) & (t <= t_max)
          & (u >= t_min) & (v >= t_min) & (w >= t_min))
    return torch.where(ok, t, INF), u, v, w


def volume_interval(origin, direction, center, radius, t_min, t_max):
    r0, r1, disc = sphere_roots(origin, direction, center, radius)
    ok = (disc >= 0.0) & (r1 > r0 + 0.0001)
    rec1 = torch.clamp(r0, min=t_min)
    rec2 = torch.minimum(r1, torch.as_tensor(t_max, dtype=r1.dtype,
                                             device=r1.device))
    ok = ok & (rec1 < rec2)
    return torch.clamp(rec1, min=0.0), rec2, ok


def volume_t(origin, direction, center, radius, neg_inv_density, u, t_min,
             t_max):
    rec1, rec2, ok = volume_interval(origin, direction, center, radius,
                                     t_min, t_max)
    ray_len = length(direction)
    dist_inside = (rec2 - rec1) * ray_len
    hit_dist = neg_inv_density * torch.log(torch.clamp(u, min=1e-12))
    ok = ok & (hit_dist <= dist_inside)
    return torch.where(ok, rec1 + hit_dist / ray_len, INF)
