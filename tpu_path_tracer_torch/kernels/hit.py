"""Scene-level closest hit: discrete find + re-shade
(``tpu_path_tracer.kernels.hit``).

1. ``find_hit`` — the winner search, outside autograd.  Dense ``[N, P]``
   broadcasts per primitive family, min-reduced into a running
   ``(t_best, prim_type, prim_index)`` per lane in the reference's
   precedence order: strict ``<`` keeps the earlier primitive on ties, and
   ``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does.
2. ``shade_hit`` — recomputes t, hit point and shading normal of each
   lane's winner from raw geometry in closed form.

Triangles of a BVH scene go through ``traversal.closest_hit`` (the CUDA
kernel on the card, the plain skip-link walk on the CPU), those of a small
mesh through the brute-force sweep.
"""

from __future__ import annotations

import torch

from ..core import rng, vecmath as vm
from ..core.config import ISOTROPIC, RenderConfig
from ..core.types import HitRecord, Ray, SceneData, SceneMeta
from . import intersect, traversal

# Winner primitive-type codes (per-lane).
MISS, SPHERE, QUAD, TRIANGLE, VOLUME = -1, 0, 1, 2, 3


@torch.no_grad()
def find_hit(rand_state, ray: Ray, scene: SceneData, meta: SceneMeta,
             cfg: RenderConfig, alive=None):
    """Closest primitive per ray lane.  Returns ``(rand_state,
    prim_type [N] i64, prim_index [N] i64, vol_u [N] f32)``; ``vol_u`` is
    the uniform that produced a volumetric scattering event.

    Dead lanes (``alive`` False) start from ``t_best = -INF``, so every
    update fails, they report MISS, and the BVH walk leaves them at the
    root."""
    o, d = ray.origin, ray.dir
    n_rays = o.shape[0]
    t_min = cfg.t_min
    mats = scene.materials

    t_best = torch.full((n_rays,), cfg.t_max, dtype=torch.float32,
                        device=o.device)
    if alive is not None:
        t_best = torch.where(alive, t_best, -intersect.INF)
    ptype = torch.full((n_rays,), MISS, dtype=torch.int64, device=o.device)
    pidx = torch.zeros((n_rays,), dtype=torch.int64, device=o.device)

    def merge(t_new, i_new, code):
        nonlocal t_best, ptype, pidx
        upd = t_new < t_best
        t_best = torch.where(upd, t_new, t_best)
        ptype = torch.where(upd, code, ptype)
        pidx = torch.where(upd, i_new, pidx)
        return upd

    sph = scene.spheres
    if sph.count:
        # Solid spheres — the medium-type routing of hitRay.wgsl:8-24.
        is_vol = mats.mtype[sph.material_id] == ISOTROPIC
        ts = intersect.sphere_t(o[:, None], d[:, None], sph.center[None],
                                sph.radius[None], t_min, cfg.t_max)
        ts = torch.where(is_vol[None, :], intersect.INF, ts)
        merge(*torch.min(ts, dim=1), SPHERE)

    qd = scene.quads
    if qd.count:
        ts = intersect.quad_t(o[:, None], d[:, None], qd.q[None], qd.u[None],
                              qd.v[None], qd.normal[None], qd.d[None],
                              qd.w[None], t_min, cfg.t_max)
        merge(*torch.min(ts, dim=1), QUAD)

    tris = scene.triangles
    if tris.count and meta.traversal != "none":
        if meta.traversal == "bvh" and scene.bvh is not None:
            found = traversal.closest_hit(o, d, scene.bvh, tris, t_min,
                                          t_best)
        else:
            found = traversal.brute_force_closest_hit(o, d, tris, t_min,
                                                      t_best)
        # A miss comes back as t = INF, which never passes the merge.
        merge(*found, TRIANGLE)

    vol_u = torch.zeros((n_rays,), dtype=torch.float32, device=o.device)
    if sph.count and meta.has_volumes:
        # Volumetric pass clipped by the closest solid hit; one uniform per
        # sphere per lane, in sphere order (the draw-order contract).
        us = []
        for _ in range(sph.count):
            rand_state, u = rng.uniform(rand_state)
            us.append(u)
        us = torch.stack(us, dim=1)  # [N, S]
        neg_inv_density = mats.roughness[sph.material_id]
        is_vol = mats.mtype[sph.material_id] == ISOTROPIC
        tv = intersect.volume_t(o[:, None], d[:, None], sph.center[None],
                                sph.radius[None], neg_inv_density[None], us,
                                t_min, t_best[:, None])
        tv = torch.where(is_vol[None, :], tv, intersect.INF)
        t_v, i_v = torch.min(tv, dim=1)
        upd = merge(t_v, i_v, VOLUME)
        vol_u = torch.where(upd, torch.gather(us, 1, i_v[:, None])[:, 0],
                            vol_u)

    return rand_state, ptype, pidx, vol_u


def shade_hit(ray: Ray, ptype, pidx, vol_u, scene: SceneData,
              cfg: RenderConfig) -> HitRecord:
    """Recompute the hit record (``header.wgsl:119-125``) of each lane's
    winner: t, p, front-face-flipped shading normal, material id."""
    o, d = ray.origin, ray.dir
    n_rays = o.shape[0]
    t_min = cfg.t_min

    t = torch.full((n_rays,), cfg.t_max, dtype=torch.float32, device=o.device)
    normal = torch.zeros((n_rays, 3), dtype=torch.float32, device=o.device)
    normal[:, 2] = 1.0
    material_id = torch.zeros((n_rays,), dtype=torch.int64, device=o.device)

    sph = scene.spheres
    if sph.count:
        si = torch.clamp(pidx, 0, sph.count - 1)
        ctr = sph.center[si]
        rad = sph.radius[si]
        sel_s = ptype == SPHERE
        t_s = intersect.sphere_t(o, d, ctr, rad, t_min, cfg.t_max)
        # Mask unselected lanes to a finite dummy before deriving positions.
        t_s = torch.where(sel_s, t_s, 1.0)
        p_s = o + t_s[:, None] * d
        n_s = vm.normalize((p_s - ctr) / rad[:, None])  # common.wgsl:60
        t = torch.where(sel_s, t_s, t)
        normal = torch.where(sel_s[:, None], n_s, normal)
        sph_mid = sph.material_id[si]
        material_id = torch.where(sel_s, sph_mid, material_id)

        # Volumetric event on the same sphere table (common.wgsl:130-143).
        sel_v = ptype == VOLUME
        r0, _, _ = intersect.sphere_roots(o, d, ctr, rad)
        rec1 = torch.clamp(torch.clamp(r0, min=t_min), min=0.0)
        nid = scene.materials.roughness[sph_mid]
        hit_dist = nid * torch.log(torch.clamp(vol_u, min=1e-12))
        t_v = rec1 + hit_dist / vm.length(d)
        p_v = o + t_v[:, None] * d
        n_v = vm.normalize(p_v - ctr)
        t = torch.where(sel_v, t_v, t)
        normal = torch.where(sel_v[:, None], n_v, normal)
        material_id = torch.where(sel_v, sph_mid, material_id)

    qd = scene.quads
    if qd.count:
        qi = torch.clamp(pidx, 0, qd.count - 1)
        sel = ptype == QUAD
        nq, dq, _ = intersect.quad_derived(qd.q[qi], qd.u[qi], qd.v[qi])
        den = vm.dot(nq, d)
        t_q = (dq - vm.dot(nq, o)) / torch.where(sel, den, 1.0)
        t = torch.where(sel, t_q, t)
        normal = torch.where(sel[:, None], nq, normal)
        material_id = torch.where(sel, qd.material_id[qi], material_id)

    tris = scene.triangles
    if tris.count:
        ti = torch.clamp(pidx, 0, tris.count - 1)
        sel = ptype == TRIANGLE
        t_t, bu, bv, bw = intersect.triangle_t(
            o, d, tris.a[ti], tris.b[ti], tris.c[ti], t_min, cfg.t_max)
        t_t = torch.where(sel, t_t, 1.0)
        bu = torch.where(sel, bu, 1.0 / 3.0)
        bv = torch.where(sel, bv, 1.0 / 3.0)
        bw = torch.where(sel, bw, 1.0 / 3.0)
        # Smooth barycentric normal — common.wgsl:230.
        n_t = vm.normalize(tris.na[ti] * bw[:, None]
                           + tris.nb[ti] * bu[:, None]
                           + tris.nc[ti] * bv[:, None])
        t = torch.where(sel, t_t, t)
        normal = torch.where(sel[:, None], n_t, normal)
        material_id = torch.where(sel, tris.material_id[ti], material_id)

    hit = ptype != MISS
    p = o + t[:, None] * d
    # Front-face determination + normal flip (common.wgsl:64-68,179-183,
    # 233-237); volumetric hits force front_face (common.wgsl:143).
    is_vol_lane = ptype == VOLUME
    front = vm.dot(d, normal) < 0.0
    normal = torch.where((front | is_vol_lane)[:, None], normal, -normal)
    front = front | is_vol_lane
    return HitRecord(hit=hit, t=t, p=p, normal=normal, front_face=front,
                     material_id=material_id)
