"""``integrator.py`` for scenes of many triangles: the same wavefront path
tracer, whose hit search tests the triangles block by block.

``integrator.find_hit`` tests every triangle against every ray as one
``[rays, triangles]`` broadcast, which at 81,920 triangles does not fit a
card.  Here ``find_hit`` walks the triangles in blocks of ``tri_block``
in index order and keeps a running best with strict ``<``, so a tie keeps
the earlier block's triangle, and ``torch.min`` keeps the first of equal
t inside a block: the same winner, and the same bits of t, as the search
over all triangles at once.  Spheres, quads, volumes, the re-shade (which
gathers the winning triangle alone) and the shading are
``integrator.py``'s own, imported; ``trace``, ``pixels_radiance`` and
``render`` are its functions with this ``find_hit`` in their loop and
``tri_block`` passed down.

A block is tested only on the rays that can hit it: an exact cull, which
never leaves out a closer hit.  Each block's bounding box is grown on
every side by ``pad`` times its extent and its coordinates' magnitude
(``pad``: ``CULL_PAD``, or 16 epsilons of a coarser dtype) and 1e-6, far
above the rounding of a hit point, and a ray is kept when its slab
interval against that box, in float64, meets ``[0, t_best * (1 + pad)]``
(a ray parallel to a slab is kept).  A triangle the ray hits at t in
``[T_MIN, t_best]`` lies in the box, so the ray's segment to it crosses
the box.  The cull changes which rays are computed, never what a kept
ray's t is.

``work``, where given, counts as ``integrator.py``'s does (``lanes``,
``facing_quads``, ``spans``, ``events``).
"""

from __future__ import annotations

import torch

from . import pcg
from .geometry import INF, normalize, quad_t, sphere_t, triangle_t, \
    volume_interval, volume_t
from .integrator import (LIGHT_SAMPLE_PROB, MISS, QUAD, SPHERE, T_MAX,
                         T_MIN, TRIANGLE, VOLUME, BACKGROUND, _count,
                         _lambertian_pdf, _light_pdf, camera_rays, scatter,
                         shade_hit)
from .scene import ISOTROPIC, Scene

CULL_PAD = 1e-4


def _pad(dtype) -> float:
    return max(CULL_PAD, 16 * torch.finfo(dtype).eps)


def block_boxes(tris, tri_block):
    """Each block's corners' bounding box in float64, grown as the
    module's docstring says: (lo [B, 3], hi [B, 3])."""
    pad = _pad(tris["a"].dtype)
    corners = torch.stack([tris["a"], tris["b"], tris["c"]], dim=1).double()
    los, his = [], []
    for first in range(0, corners.shape[0], tri_block):
        block = corners[first:first + tri_block].reshape(-1, 3)
        lo, hi = block.amin(0), block.amax(0)
        grow = pad * (hi - lo + torch.maximum(lo.abs(), hi.abs())) + 1e-6
        los.append(lo - grow)
        his.append(hi + grow)
    return torch.stack(los), torch.stack(his)


def _crosses(o, d, lo, hi, t_far):
    """Whether each ray's segment ``[0, t_far]`` meets the box; a ray
    parallel to a slab is kept (conservative)."""
    d64, o64 = d.double(), o.double()
    inv = 1.0 / d64
    t0 = (lo - o64) * inv
    t1 = (hi - o64) * inv
    flat = d64 == 0.0
    near = torch.where(flat, -INF, torch.minimum(t0, t1)).amax(-1)
    far = torch.where(flat, INF, torch.maximum(t0, t1)).amin(-1)
    return (near <= far) & (far >= 0.0) & (near <= t_far)


@torch.no_grad()
def triangle_search(o, d, tris, t_bound, tri_block, boxes=None):
    """The closest triangle of each ray up to ``t_bound``, block by block:
    (t, index), t = INF and index 0 where there is none, as ``torch.min``
    over all the triangles at once gives them."""
    n = o.shape[0]
    t_run = torch.full((n,), INF, dtype=o.dtype, device=o.device)
    i_run = torch.zeros((n,), dtype=torch.int64, device=o.device)
    lo, hi = boxes if boxes is not None else block_boxes(tris, tri_block)
    t_far = t_bound.double() * (1.0 + _pad(o.dtype))
    for k, first in enumerate(range(0, tris["a"].shape[0], tri_block)):
        rows = torch.nonzero(_crosses(o, d, lo[k], hi[k], t_far))[:, 0]
        if not rows.numel():
            continue
        blk = slice(first, first + tri_block)
        t, _, _, _ = triangle_t(o[rows, None], d[rows, None],
                                tris["a"][blk][None], tris["b"][blk][None],
                                tris["c"][blk][None], T_MIN,
                                t_bound[rows, None])
        t_blk, i_blk = torch.min(t, dim=1)
        better = t_blk < t_run[rows]
        t_run[rows] = torch.where(better, t_blk, t_run[rows])
        i_run[rows] = torch.where(better, i_blk + first, i_run[rows])
    return t_run, i_run


@torch.no_grad()
def find_hit(state, o, d, scene: Scene, alive, tri_block, work=None,
             boxes=None):
    """``integrator.find_hit`` with its triangle search in blocks of
    ``tri_block`` (``triangle_search``)."""
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
        t_tri, i_tri = triangle_search(o, d, tr, t_best, tri_block, boxes)
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


def trace(state, origin, direction, scene: Scene, max_bounces: int,
          nee: bool, rr_start: int, tri_block: int, work=None):
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
    boxes = (block_boxes(scene.triangles, tri_block)
             if scene.triangles["a"].shape[0] else None)

    for bounce in range(max_bounces):
        state, ptype, pidx, vol_u = find_hit(state, origin, direction, scene,
                                             alive, tri_block, work, boxes)
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


def pixels_radiance(pix, frame_num, view, scene: Scene, job, tri_block,
                    work=None):
    """``integrator.pixels_radiance`` through this ``trace``."""
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
                           job["rr_start"], tri_block, work)
        total = total + rad
    return total / len(cells)


def render(scene, frame_num, view, job, block, tri_block, work=None,
           pixels=None):
    """``integrator.render`` through this ``trace``: one frame's radiance
    without gradients, ``[W*H, 3]`` or the rows ``pixels = (start, stop)``;
    pixels in blocks of ``block``, triangles in blocks of ``tri_block``."""
    start, stop = pixels or (0, job["width"] * job["height"])
    out = []
    with torch.no_grad():
        for first in range(start, stop, block):
            pix = torch.arange(first, min(stop, first + block),
                               device=view.device)
            out.append(pixels_radiance(pix, frame_num, view, scene, job,
                                       tri_block, work))
    return torch.cat(out)
