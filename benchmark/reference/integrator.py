"""The wavefront path tracer (the upstream's ``shaders/traceRay.wgsl``,
``hitRay.wgsl``, ``scatterRay.wgsl``, ``importanceSampling.wgsl`` and
``shootRay.wgsl``) in plain PyTorch.

Every lane advances one bounce per step; retired lanes are masked and keep
drawing random numbers, so each lane's PCG stream advances by the same
count a bounce.  The draw order is: the volume pass (one uniform per
sphere, in sphere order), the BSDF's eight (r1, r2, u_spec, f1, f2,
u_refl, u_hg, u_phi), with NEE the light sample's two and the mixing
uniform, then Russian roulette's.  The hit search is outside autograd and
the winner is re-shaded in closed form, so gradients reach the scene's
tensors through the shading.

``work``, where given, is a dict whose entries count on the device, over
every bounce: live lanes (``lanes``), (lane, quad) pairs whose quad faces
the ray (``facing_quads``), (lane, fog sphere) pairs whose span lies
before the closest solid hit (``spans``) and those whose free flight ends
inside (``events``): the work that the kernels' early outs leave.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import pcg
from .geometry import (INF, MAX_FLOAT, MIN_FLOAT, PI, cross, dot, length,
                       mix, normalize, onb_from_w, onb_local, quad_derived,
                       quad_t, reflect, refract, safe_sqrt, sphere_roots,
                       sphere_t, triangle_t, volume_interval, volume_t)
from .scene import GLASS, ISOTROPIC, LAMBERTIAN, MIRROR, Scene

MISS, SPHERE, QUAD, TRIANGLE, VOLUME = -1, 0, 1, 2, 3
T_MIN = 0.000001
T_MAX = MAX_FLOAT
LIGHT_SAMPLE_PROB = 0.2
BACKGROUND = (0.0, 1.0, 1.0)


def _count(work, key, mask):
    if work is not None:
        work[key] = work.get(key, 0) + mask.sum()


@torch.no_grad()
def find_hit(state, o, d, scene: Scene, alive, work=None):
    """Closest primitive of each lane: (state, prim_type, prim_index,
    vol_u).  Dead lanes start from -INF and report a miss."""
    n = o.shape[0]
    dtype = o.dtype
    mats, sph, qd, tr = (scene.materials, scene.spheres, scene.quads,
                         scene.triangles)
    t_best = torch.where(alive, torch.full((n,), T_MAX, dtype=dtype,
                                           device=o.device), -INF)
    ptype = torch.full((n,), MISS, dtype=torch.int64, device=o.device)
    pidx = torch.zeros((n,), dtype=torch.int64, device=o.device)
    _count(work, "lanes", alive)

    def merge(t_new, i_new, code):
        nonlocal t_best, ptype, pidx
        upd = t_new < t_best
        t_best = torch.where(upd, t_new, t_best)
        ptype = torch.where(upd, code, ptype)
        pidx = torch.where(upd, i_new, pidx)
        return upd

    n_sph = sph["center"].shape[0]
    if n_sph:
        is_vol = mats["mtype"][sph["material_id"]] == ISOTROPIC
        ts = sphere_t(o[:, None], d[:, None], sph["center"][None],
                      sph["radius"][None], T_MIN, T_MAX)
        ts = torch.where(is_vol[None, :], INF, ts)
        merge(*torch.min(ts, dim=1), SPHERE)
    if qd["q"].shape[0]:
        if work is not None:
            den = (qd["normal"][None] * d[:, None]).sum(-1)
            _count(work, "facing_quads",
                   (den <= 0.0) & (den.abs() >= 1e-8) & alive[:, None])
        ts = quad_t(o[:, None], d[:, None], qd["q"][None], qd["u"][None],
                    qd["v"][None], qd["normal"][None], qd["d"][None],
                    qd["w"][None], T_MIN, T_MAX)
        merge(*torch.min(ts, dim=1), QUAD)
    if tr["a"].shape[0]:
        t, _, _, _ = triangle_t(o[:, None], d[:, None], tr["a"][None],
                                tr["b"][None], tr["c"][None], T_MIN,
                                t_best[:, None])
        t_tri, i_tri = torch.min(t, dim=1)
        hit = t_tri < t_best
        merge(torch.where(hit, t_tri, INF), torch.where(hit, i_tri, -1),
              TRIANGLE)

    vol_u = torch.zeros((n,), dtype=dtype, device=o.device)
    if n_sph and scene.has_volumes:
        us = []
        for _ in range(n_sph):
            state, u = pcg.uniform(state, dtype)
            us.append(u)
        us = torch.stack(us, dim=1)
        nid = mats["roughness"][sph["material_id"]]
        is_vol = mats["mtype"][sph["material_id"]] == ISOTROPIC
        args = (o[:, None], d[:, None], sph["center"][None],
                sph["radius"][None])
        tv = volume_t(*args, nid[None], us, T_MIN, t_best[:, None])
        if work is not None:
            _count(work, "spans", volume_interval(
                *args, T_MIN, t_best[:, None])[2] & is_vol)
            _count(work, "events", (tv < INF) & is_vol)
        tv = torch.where(is_vol[None, :], tv, INF)
        t_v, i_v = torch.min(tv, dim=1)
        upd = merge(t_v, i_v, VOLUME)
        vol_u = torch.where(upd, torch.gather(us, 1, i_v[:, None])[:, 0],
                            vol_u)
    return state, ptype, pidx, vol_u


def shade_hit(o, d, ptype, pidx, vol_u, scene: Scene):
    """The hit record of each lane's winner: (hit, p, front-face-flipped
    normal, front_face, material_id)."""
    n = o.shape[0]
    dtype = o.dtype
    t = torch.full((n,), T_MAX, dtype=dtype, device=o.device)
    normal = torch.zeros((n, 3), dtype=dtype, device=o.device)
    normal[:, 2] = 1.0
    material_id = torch.zeros((n,), dtype=torch.int64, device=o.device)
    mats, sph, qd, tr = (scene.materials, scene.spheres, scene.quads,
                         scene.triangles)

    n_sph = sph["center"].shape[0]
    if n_sph:
        si = torch.clamp(pidx, 0, n_sph - 1)
        ctr, rad = sph["center"][si], sph["radius"][si]
        sel_s = ptype == SPHERE
        t_s = torch.where(sel_s, sphere_t(o, d, ctr, rad, T_MIN, T_MAX), 1.0)
        p_s = o + t_s[:, None] * d
        n_s = normalize((p_s - ctr) / rad[:, None])
        t = torch.where(sel_s, t_s, t)
        normal = torch.where(sel_s[:, None], n_s, normal)
        sph_mid = sph["material_id"][si]
        material_id = torch.where(sel_s, sph_mid, material_id)
        sel_v = ptype == VOLUME
        r0, _, _ = sphere_roots(o, d, ctr, rad)
        rec1 = torch.clamp(torch.clamp(r0, min=T_MIN), min=0.0)
        nid = mats["roughness"][sph_mid]
        hit_dist = nid * torch.log(torch.clamp(vol_u, min=1e-12))
        t_v = rec1 + hit_dist / length(d)
        n_v = normalize(o + t_v[:, None] * d - ctr)
        t = torch.where(sel_v, t_v, t)
        normal = torch.where(sel_v[:, None], n_v, normal)
        material_id = torch.where(sel_v, sph_mid, material_id)

    n_q = qd["q"].shape[0]
    if n_q:
        qi = torch.clamp(pidx, 0, n_q - 1)
        sel = ptype == QUAD
        nq, dq, _ = quad_derived(qd["q"][qi], qd["u"][qi], qd["v"][qi])
        t_q = (dq - dot(nq, o)) / torch.where(sel, dot(nq, d), 1.0)
        t = torch.where(sel, t_q, t)
        normal = torch.where(sel[:, None], nq, normal)
        material_id = torch.where(sel, qd["material_id"][qi], material_id)

    n_t = tr["a"].shape[0]
    if n_t:
        ti = torch.clamp(pidx, 0, n_t - 1)
        sel = ptype == TRIANGLE
        t_t, bu, bv, bw = triangle_t(o, d, tr["a"][ti], tr["b"][ti],
                                     tr["c"][ti], T_MIN, T_MAX)
        t_t = torch.where(sel, t_t, 1.0)
        bu = torch.where(sel, bu, 1.0 / 3.0)
        bv = torch.where(sel, bv, 1.0 / 3.0)
        bw = torch.where(sel, bw, 1.0 / 3.0)
        n_tri = normalize(tr["na"][ti] * bw[:, None] + tr["nb"][ti]
                          * bu[:, None] + tr["nc"][ti] * bv[:, None])
        t = torch.where(sel, t_t, t)
        normal = torch.where(sel[:, None], n_tri, normal)
        material_id = torch.where(sel, tr["material_id"][ti], material_id)

    p = o + t[:, None] * d
    is_vol_lane = ptype == VOLUME
    front = dot(d, normal) < 0.0
    normal = torch.where((front | is_vol_lane)[:, None], normal, -normal)
    return ptype != MISS, p, normal, front | is_vol_lane, material_id


def _schlick(cosine, ref_idx):
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def _hg_cos(g, u):
    small = torch.abs(g) < 1e-4
    safe_g = torch.where(small, 1.0, g)
    frac = (1.0 - g * g) / (1.0 - g + 2.0 * g * u)
    general = (1.0 + g * g - frac * frac) / (2.0 * safe_g)
    return torch.clamp(torch.where(small, 1.0 - 2.0 * u, general), -1.0, 1.0)


def scatter(state, wi, normal, front, mid, mats):
    """Every material family's sample, selected by type: (state, dir,
    attenuation, skip_pdf, diffuse_dir)."""
    dtype = wi.dtype
    mtype = mats["mtype"][mid]
    color, spec_color = mats["color"][mid], mats["specular_color"][mid]
    spec_strength = mats["specular_strength"][mid]
    roughness, eta = mats["roughness"][mid], mats["eta"][mid]
    n = normal

    ub, vb, wb = onb_from_w(n)
    state, cos_local = pcg.cosine_wrt_z(state, dtype)
    diffuse_dir = normalize(onb_local(ub, vb, wb, cos_local))
    state, u_spec = pcg.uniform(state, dtype)
    do_specular = (u_spec < spec_strength).to(dtype)
    reflected = reflect(wi, n)
    specular_dir = normalize(mix(reflected, diffuse_dir, roughness[:, None]))
    lam_dir = normalize(mix(diffuse_dir, specular_dir, do_specular[:, None]))

    state, fuzz = pcg.uniform_in_unit_sphere(state, dtype)
    mirror_dir = normalize(reflected + roughness[:, None] * fuzz)

    ir = torch.where(front, 1.0 / torch.clamp(eta, min=1e-8), eta)
    unit = normalize(wi)
    cos_t = torch.clamp(dot(-unit, n), max=1.0)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    state, u_refl = pcg.uniform(state, dtype)
    must_reflect = (ir * sin_t > 1.0) | (_schlick(cos_t, ir) > u_refl)
    glass_dir = normalize(torch.where(must_reflect[:, None],
                                      reflect(unit, n),
                                      refract(unit, n, ir)))

    state, u_hg = pcg.uniform(state, dtype)
    cos_hg = _hg_cos(spec_strength, u_hg)
    sin_hg = safe_sqrt(1.0 - cos_hg * cos_hg)
    state, u_phi = pcg.uniform(state, dtype)
    phi = 2.0 * PI * u_phi
    hg_local = torch.stack([sin_hg * torch.cos(phi), sin_hg * torch.sin(phi),
                            cos_hg], dim=-1)
    uw, vw, ww = onb_from_w(wi)
    iso_dir = normalize(onb_local(uw, vw, ww, hg_local))

    mt = mtype[:, None]
    out_dir = torch.where(mt == LAMBERTIAN, lam_dir, torch.where(
        mt == MIRROR, mirror_dir, torch.where(mt == GLASS, glass_dir,
                                              iso_dir)))
    is_lam = mtype == LAMBERTIAN
    skip_pdf = torch.where(is_lam, do_specular > 0.5, True)
    do_spec_final = torch.where(is_lam, do_specular, 0.0)
    attenuation = mix(color, spec_color, do_spec_final[:, None])
    return state, out_dir, attenuation, skip_pdf, diffuse_dir


def _lambertian_pdf(direction, normal):
    cosine = dot(normalize(direction), normalize(normal))
    return torch.clamp(cosine / PI, min=0.0)


def _light_pdf(origin, direction, q, u, v):
    n_raw = cross(u, v)
    normal = normalize(n_raw)
    d_plane = dot(normal, q)
    w = n_raw / dot(n_raw, n_raw)[..., None]
    denom = dot(normal, direction)
    grazing = torch.abs(denom) < 1e-8
    t = (d_plane - dot(normal, origin)) / torch.where(grazing, 1.0, denom)
    rel = origin + t[..., None] * direction - q
    alpha = dot(w, cross(rel, v))
    beta = dot(w, cross(u, rel))
    valid = ((dot(direction, normal) <= 0.0) & (torch.abs(denom) >= 1e-8)
             & (t > 0.001) & (t < MAX_FLOAT)
             & (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0)
             & (beta <= 1.0))
    dist_sq = torch.where(valid, t * t * dot(direction, direction), 0.0)
    cosine = torch.abs(denom) / torch.clamp(length(direction), min=1e-12)
    pdf = dist_sq / torch.clamp(cosine * length(n_raw), min=1e-12)
    return torch.where(valid, pdf, MIN_FLOAT)


def trace(state, origin, direction, scene: Scene, max_bounces: int,
          nee: bool, rr_start: int, work=None):
    """Radiance along each ray: (state, radiance [N, 3])."""
    dtype, device = origin.dtype, origin.device
    background = torch.tensor(BACKGROUND, dtype=dtype, device=device)
    n = origin.shape[0]
    radiance = torch.zeros((n, 3), dtype=dtype, device=device)
    throughput = torch.ones_like(radiance)
    alive = torch.ones((n,), dtype=torch.bool, device=device)
    qd = scene.quads
    use_nee = nee and scene.light_index >= 0
    if use_nee:
        li = scene.light_index
        lq, lu, lv = qd["q"][li][None], qd["u"][li][None], qd["v"][li][None]
    emission_table = scene.materials["emission"]

    for bounce in range(max_bounces):
        state, ptype, pidx, vol_u = find_hit(state, origin, direction, scene,
                                             alive, work)
        hit, p, normal, front, mid = shade_hit(origin, direction, ptype,
                                               pidx, vol_u, scene)
        miss = alive & ~hit
        radiance = radiance + torch.where(miss[:, None],
                                          background * throughput, 0.0)
        live = alive & hit
        emission = torch.where(front[:, None], emission_table[mid], 0.0)
        radiance = radiance + torch.where(live[:, None],
                                          emission * throughput, 0.0)
        state, sdir, atten, skip_pdf, diffuse_dir = scatter(
            state, direction, normal, front, mid, scene.materials)
        if use_nee:
            state, r1 = pcg.uniform(state, dtype)
            state, r2 = pcg.uniform(state, dtype)
            light_dir = normalize(lq + r1[:, None] * lu + r2[:, None] * lv
                                  - p)
            state, u_mix = pcg.uniform(state, dtype)
            chosen = torch.where((u_mix > LIGHT_SAMPLE_PROB)[:, None],
                                 diffuse_dir, light_dir)
            lam_pdf = _lambertian_pdf(chosen, normal)
            l_pdf = _light_pdf(p, chosen, lq, lu, lv)
            pdf = (LIGHT_SAMPLE_PROB * l_pdf
                   + (1.0 - LIGHT_SAMPLE_PROB) * lam_pdf)
            mis_thr = throughput * (lam_pdf[:, None] * atten
                                    / torch.clamp(pdf, min=1e-12)[:, None])
            use_mis = live & ~skip_pdf
            new_dir = torch.where(use_mis[:, None], chosen, sdir)
            new_thr = torch.where(use_mis[:, None], mis_thr,
                                  throughput * atten)
            live = live & ~(use_mis & (pdf <= 1e-5))
        else:
            new_dir, new_thr = sdir, throughput * atten
        throughput = torch.where(live[:, None], new_thr, throughput)
        origin = torch.where(live[:, None], p, origin)
        direction = torch.where(live[:, None], new_dir, direction)
        alive = live
        state, u_rr = pcg.uniform(state, dtype)
        p_survive = torch.amax(throughput, dim=-1)
        if bounce >= rr_start:
            alive = alive & ~(u_rr > p_survive)
            throughput = torch.where(
                alive[:, None],
                throughput / torch.clamp(p_survive, min=1e-12)[:, None],
                throughput)
    return state, radiance


def fov_factor(fov_degrees: float = 60.0) -> float:
    return float(np.float32(1.0 / math.tan(fov_degrees * (PI / 180.0)
                                           / 2.0)))


def camera_rays(state, view, px, py, width, height, dtype, sub=None,
                sub_scale=1.0):
    """Jittered primary rays through pixels (px, py)
    (``shootRay.wgsl:19-60``); ``sub`` is a stratified cell."""
    w, h = float(np.float32(width)), float(np.float32(height))
    aspect = float(np.float32(w) / np.float32(h))
    state, u1 = pcg.uniform(state, dtype)
    state, u2 = pcg.uniform(state, dtype)
    if sub is not None:
        u1 = sub_scale * (sub[0] + u1)
        u2 = sub_scale * (sub[1] + u2)
    s = aspect * (2.0 * ((px.to(dtype) - 0.5 + u1) / w) - 1.0)
    t = -1.0 * (2.0 * ((py.to(dtype) - 0.5 + u2) / h) - 1.0)
    basis = view[:3, :3]
    d = (s[:, None] * basis[:, 0][None] + t[:, None] * basis[:, 1][None]
         - fov_factor() * basis[:, 2][None])
    return state, view[:3, 3][None].expand(d.shape), normalize(d)


def pixels_radiance(pix, frame_num, view, scene: Scene, job, work=None):
    """The radiance of the global pixel indices ``pix`` in frame
    ``frame_num`` (``job``: width, height, spp, bounces, nee, stratify,
    rr_start), averaged over the pixel's samples."""
    width = job["width"]
    px, py = pix % width, pix // width
    dtype = view.dtype
    state = pcg.seed(pix, frame_num)
    total = torch.zeros((pix.shape[0], 3), dtype=dtype, device=pix.device)
    if job.get("stratify"):
        grid = max(int(job["spp"] ** 0.5), 1)
        cells = [(float(k // grid), float(k % grid))
                 for k in range(grid * grid)]
    else:
        grid, cells = 1, [None] * job["spp"]
    for cell in cells:
        state, o, d = camera_rays(state, view, px, py, width, job["height"],
                                  dtype, cell, 1.0 / grid)
        state, rad = trace(state, o, d, scene, job["bounces"], job["nee"],
                           job["rr_start"], work)
        total = total + rad
    return total / len(cells)


def render(scene, frame_num, view, job, block, work=None, pixels=None):
    """One frame's radiance without gradients: ``[W*H, 3]``, or the rows
    ``pixels = (start, stop)`` of it (one rank's chunk)."""
    start, stop = pixels or (0, job["width"] * job["height"])
    out = []
    with torch.no_grad():
        for first in range(start, stop, block):
            pix = torch.arange(first, min(stop, first + block),
                               device=view.device)
            out.append(pixels_radiance(pix, frame_num, view, scene, job,
                                       work))
    return torch.cat(out)
