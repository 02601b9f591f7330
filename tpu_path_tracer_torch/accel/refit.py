"""On-device BVH refit: recompute node bounds for moved vertices
(``tpu_path_tracer.accel.refit``).

Every node of the flattened BVH covers one contiguous range ``[prim_lo,
prim_hi)`` of the reordered triangle array (``accel/bvh.py``, ``finish``),
so a refit is a batch of range min/max queries with no tree walk: a sparse
table of doubling prefix min/max over the padded per-triangle AABBs in
``O(T log T)`` tensor ops, then two gathers per node.  Vertex training moves
the triangles every step; the topology stays, the bounds follow.
"""

from __future__ import annotations

import torch

from ..core.types import FlatBVH, Triangles

_PAD = 5e-5  # AABB.pad epsilon — lib/BVH/AABB.js:35-51


def _range_minmax(vals_min, vals_max, lo, hi):
    """Min/max of vals over each [lo, hi) range via a doubling sparse table.

    vals_min/vals_max: [T, 3]; lo/hi: [B] int64 with hi > lo.
    Returns ([B, 3] mins, [B, 3] maxs).
    """
    t = vals_min.shape[0]
    levels_min = [vals_min]
    levels_max = [vals_max]
    k = 1
    while k < t:
        prev_min, prev_max = levels_min[-1], levels_max[-1]
        shifted_min = torch.cat([prev_min[k:], prev_min[-k:]])
        shifted_max = torch.cat([prev_max[k:], prev_max[-k:]])
        levels_min.append(torch.minimum(prev_min, shifted_min))
        levels_max.append(torch.maximum(prev_max, shifted_max))
        k *= 2
    st_min = torch.stack(levels_min)  # [L, T, 3]
    st_max = torch.stack(levels_max)

    span = torch.clamp(hi - lo, min=1)
    # Level of the largest power of two <= span (spans are below 2**31).
    lvl = torch.clamp(torch.floor(torch.log2(span.to(torch.float64)))
                      .to(torch.int64), 0, len(levels_min) - 1)
    width = torch.ones_like(lvl) << lvl
    a = torch.clamp(lo, 0, t - 1)
    b = torch.clamp(hi - width, 0, t - 1)
    mins = torch.minimum(st_min[lvl, a], st_min[lvl, b])
    maxs = torch.maximum(st_max[lvl, a], st_max[lvl, b])
    return mins, maxs


@torch.no_grad()
def refit_bvh(bvh: FlatBVH, tris: Triangles) -> FlatBVH:
    """Return ``bvh`` with node bounds recomputed from current vertices.

    Topology (miss links, prim ranges, axes) is kept: valid while the
    triangle order is unchanged, which vertex-position training keeps.  The
    bounds stay correct as geometry drifts while the tree's quality falls;
    rebuild on the host when the drift is large.  The hit search is
    outside autograd, so the refit is too."""
    tmin = torch.minimum(torch.minimum(tris.a, tris.b), tris.c)
    tmax = torch.maximum(torch.maximum(tris.a, tris.b), tris.c)
    thin = (tmax - tmin) < _PAD
    tmin = torch.where(thin, tmin - _PAD / 2, tmin)
    tmax = torch.where(thin, tmax + _PAD / 2, tmax)
    mins, maxs = _range_minmax(tmin, tmax, bvh.prim_lo, bvh.prim_hi)
    return bvh._replace(mins=mins, maxs=maxs)
