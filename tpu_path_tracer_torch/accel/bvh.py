"""Host-side BVH construction (NumPy) + DFS-preorder flatten
(``tpu_path_tracer.accel.bvh``): the reference implementation of the
native builders in ``accel/bvh_native.cpp``.

Three builders over per-primitive AABBs:

* ``build_median`` — longest-axis median split, sorting each subrange by the
  AABB min along that axis; leaf at ``leaf_size`` primitives.  Semantics of
  the reference's active builder (``lib/BVH/bvhNode.js:28-73``, selected via
  ``bvhBuilder.js:12`` / ``bvhNode.js:21-26``; its leaves hold 1 primitive).
* ``build_sah`` — iterative binned SAH (8 bins, 7 candidate planes), leaf when
  the best split cost is no better than the parent cost — semantics of
  ``bvhNode.js:108-283``.
* ``build_lbvh`` — Morton-curve linearized builder (no reference equivalent):
  fully vectorized NumPy radix path for large meshes where the comparison
  builders' per-node Python cost dominates.

The flatten emits nodes in DFS preorder so ``left_child == node + 1``
(matching ``lib/BVH/bvhBuilder.js:37-54``) and computes skip pointers
(``miss``) for stackless traversal (semantics of ``populate_links``,
``bvhNode.js:76-93``).  Because preorder ids are sequential, the skip pointer
is simply ``node_id + subtree_size`` — the first preorder node outside the
subtree — with ``num_nodes`` as the exit sentinel.

Returned primitive ranges index the *reordered* primitive array; ``order`` is
the permutation to apply (the reference sorts its shared ``objs`` array in
place during the build, ``bvhNode.js:57-60``).
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np


class FlatBVHArrays(NamedTuple):
    mins: np.ndarray        # [B, 3] f32
    maxs: np.ndarray        # [B, 3] f32
    right: np.ndarray       # [B] i32, -1 for leaves
    prim_start: np.ndarray  # [B] i32, -1 for interior
    prim_count: np.ndarray  # [B] i32, 0 for interior
    miss: np.ndarray        # [B] i32, == B when traversal should exit
    axis: np.ndarray        # [B] i32
    order: np.ndarray       # [T] i64 permutation of the input primitives
    prim_lo: np.ndarray     # [B] i32 — subtree triangle range start
    prim_hi: np.ndarray     # [B] i32 — subtree triangle range end (excl.)


_PAD = 5e-5  # AABB.pad epsilon for degenerate-thin boxes — lib/BVH/AABB.js:35-51


def pad_aabbs(mins: np.ndarray, maxs: np.ndarray):
    """Expand near-degenerate extents, per ``AABB.pad``."""
    thin = (maxs - mins) < _PAD
    return (np.where(thin, mins - _PAD / 2, mins),
            np.where(thin, maxs + _PAD / 2, maxs))


def triangle_aabbs(a: np.ndarray, b: np.ndarray, c: np.ndarray):
    """Per-triangle padded bounds (``AABB.bbox_triangle`` + ``pad``)."""
    mins = np.minimum(np.minimum(a, b), c)
    maxs = np.maximum(np.maximum(a, b), c)
    return pad_aabbs(mins, maxs)


class _Builder:
    """Shared DFS-preorder emission machinery."""

    def __init__(self, mins, maxs, leaf_size):
        self.pmins = np.asarray(mins, np.float64)
        self.pmaxs = np.asarray(maxs, np.float64)
        self.cent = (self.pmins + self.pmaxs) * 0.5
        self.leaf_size = leaf_size
        n = len(self.pmins)
        self.order = np.arange(n, dtype=np.int64)
        cap = max(2 * n, 1)
        self.n_mins = np.empty((cap, 3), np.float64)
        self.n_maxs = np.empty((cap, 3), np.float64)
        self.right = np.full(cap, -1, np.int32)
        self.prim_start = np.full(cap, -1, np.int32)
        self.prim_count = np.zeros(cap, np.int32)
        self.axis = np.zeros(cap, np.int32)
        self.size = np.zeros(cap, np.int64)
        self.count = 0

    def _emit(self):
        i = self.count
        self.count += 1
        return i

    def _leaf(self, node, start, end):
        idx = self.order[start:end + 1]
        self.n_mins[node] = self.pmins[idx].min(axis=0)
        self.n_maxs[node] = self.pmaxs[idx].max(axis=0)
        self.prim_start[node] = start
        self.prim_count[node] = end - start + 1
        self.size[node] = 1
        return 1

    def finish(self) -> FlatBVHArrays:
        b = self.count
        ids = np.arange(b, dtype=np.int64)
        miss = np.minimum(ids + self.size[:b], b).astype(np.int32)
        # Subtree triangle ranges: in DFS preorder over the in-place
        # reordered primitive array, each subtree's triangles are one
        # contiguous range.  lo is a reverse scan (an interior node's first
        # leaf is its left child's first leaf, and left child == i + 1);
        # hi[i] == lo[miss[i]].  The refit answers these ranges
        # (accel/refit.py).
        n_prims = len(self.order)
        lo = np.empty(b + 1, np.int32)
        lo[b] = n_prims
        for i in range(b - 1, -1, -1):
            lo[i] = self.prim_start[i] if self.prim_count[i] > 0 else lo[i + 1]
        hi = lo[miss]
        return FlatBVHArrays(
            prim_lo=lo[:b],
            prim_hi=hi,
            mins=self.n_mins[:b].astype(np.float32),
            maxs=self.n_maxs[:b].astype(np.float32),
            right=self.right[:b],
            prim_start=self.prim_start[:b],
            prim_count=self.prim_count[:b],
            miss=miss,
            axis=self.axis[:b],
            order=self.order,
        )


def build_median(mins, maxs, leaf_size: int = 1) -> FlatBVHArrays:
    """Longest-axis median split (``bvhNode.js:28-73``)."""
    bld = _Builder(mins, maxs, leaf_size)
    n = len(bld.order)
    if n == 0:
        return bld.finish()

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))

    def rec(start, end):
        node = bld._emit()
        span = end - start
        if span + 1 <= bld.leaf_size:
            return bld._leaf(node, start, end)
        idx = bld.order[start:end + 1]
        lo = bld.pmins[idx].min(axis=0)
        hi = bld.pmaxs[idx].max(axis=0)
        extent = hi - lo
        ax = 0
        if extent[1] > extent[0]:
            ax = 1
        if extent[2] > extent[ax]:
            ax = 2
        # Sort the subrange by AABB min along the chosen axis — the
        # comparator at bvhNode.js:95-101 keys on bbox.axis(a)[0].
        key = bld.pmins[idx, ax]
        bld.order[start:end + 1] = idx[np.argsort(key, kind="stable")]
        mid = start + span // 2
        left_size = rec(start, mid)
        right_id = node + 1 + left_size
        right_size = rec(mid + 1, end)
        bld.right[node] = right_id
        bld.axis[node] = ax
        bld.n_mins[node] = np.minimum(bld.n_mins[node + 1], bld.n_mins[right_id])
        bld.n_maxs[node] = np.maximum(bld.n_maxs[node + 1], bld.n_maxs[right_id])
        bld.size[node] = 1 + left_size + right_size
        return bld.size[node]

    rec(0, n - 1)
    return bld.finish()


def _find_best_split(pmins, pmaxs, cent, idx, bins=8):
    """Binned SAH plane search — semantics of ``FindBestSplitPlane``
    (``bvhNode.js:222-283``), vectorized over the subrange."""
    best = (1e30, 0, 0.0)
    for ax in range(3):
        c = cent[idx, ax]
        cmin, cmax = c.min(), c.max()
        if cmin == cmax:
            continue
        scale = bins / (cmax - cmin)
        bidx = np.minimum((bins - 1),
                          ((c - cmin) * scale).astype(np.int64))
        counts = np.bincount(bidx, minlength=bins)
        bmin = np.full((bins, 3), 1e30)
        bmax = np.full((bins, 3), -1e30)
        np.minimum.at(bmin, bidx, pmins[idx])
        np.maximum.at(bmax, bidx, pmaxs[idx])

        def area(lo, hi, cnt):
            e = np.where(cnt[:, None] > 0, hi - lo, 0.0)
            return np.where(
                cnt > 0,
                2.0 * (e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2]
                       + e[:, 2] * e[:, 0]),
                0.0)

        lmin = np.minimum.accumulate(bmin, axis=0)
        lmax = np.maximum.accumulate(bmax, axis=0)
        lcnt = np.cumsum(counts)
        rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
        rcnt = np.cumsum(counts[::-1])[::-1]
        la = area(lmin[:-1], lmax[:-1], lcnt[:-1])
        ra = area(rmin[1:], rmax[1:], rcnt[1:])
        cost = lcnt[:-1] * la + rcnt[1:] * ra
        k = int(np.argmin(cost))
        if cost[k] < best[0]:
            best = (float(cost[k]), ax,
                    float(cmin + (cmax - cmin) / bins * (k + 1)))
    return best  # (cost, axis, split_pos)


def build_sah(mins, maxs, max_leaf: int = 16) -> FlatBVHArrays:
    """Iterative binned SAH (``bvhNode.js:108-283``).  The reference caps
    nothing — leaves form wherever splitting stops paying (``:145-152``); we
    additionally force a split above ``max_leaf`` primitives so the vectorized
    traversal's leaf loop stays bounded."""
    bld = _Builder(mins, maxs, leaf_size=1)
    n = len(bld.order)
    if n == 0:
        return bld.finish()

    def surface_area(lo, hi):
        e = hi - lo
        return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    def rec(start, end):
        node = bld._emit()
        idx = bld.order[start:end + 1]
        count = end - start + 1
        lo = bld.pmins[idx].min(axis=0)
        hi = bld.pmaxs[idx].max(axis=0)
        parent_cost = count * surface_area(lo, hi)
        cost, ax, pos = (_find_best_split(bld.pmins, bld.pmaxs, bld.cent, idx)
                         if count > 1 else (1e30, 0, 0.0))
        if (cost >= parent_cost and count <= max_leaf) or count == 1:
            return bld._leaf(node, start, end)
        # Partition by centroid <= split position along the axis; the
        # reference sorts then scans for the boundary (bvhNode.js:156-183).
        key = bld.cent[idx, ax]
        sort = np.argsort(key, kind="stable")
        idx = idx[sort]
        bld.order[start:end + 1] = idx
        split = int(np.searchsorted(bld.cent[idx, ax], pos, side="right"))
        split = min(max(split, 1), count - 1)  # never produce an empty side
        mid = start + split - 1
        left_size = rec(start, mid)
        right_id = node + 1 + left_size
        right_size = rec(mid + 1, end)
        bld.right[node] = right_id
        bld.axis[node] = ax
        bld.n_mins[node] = np.minimum(bld.n_mins[node + 1], bld.n_mins[right_id])
        bld.n_maxs[node] = np.maximum(bld.n_maxs[node + 1], bld.n_maxs[right_id])
        bld.size[node] = 1 + left_size + right_size
        return bld.size[node]

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))
    rec(0, n - 1)
    return bld.finish()


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit coords into 30-bit Morton codes (vectorized)."""
    def expand(v):
        v = v.astype(np.uint64)
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v
    return (expand(x[:, 0]) << np.uint64(2)) | (expand(x[:, 1]) << np.uint64(1)) \
        | expand(x[:, 2])


def build_lbvh(mins, maxs, leaf_size: int = 4) -> FlatBVHArrays:
    """Morton-ordered builder: sort primitives along the Z-curve once, then
    median-split the *sorted index range* recursively (no per-node sorting).
    Equivalent tree quality to spatial-median for most scenes, with all the
    O(n log n) work done by one vectorized radix sort."""
    pmins = np.asarray(mins, np.float64)
    pmaxs = np.asarray(maxs, np.float64)
    n = len(pmins)
    bld = _Builder(mins, maxs, leaf_size)
    if n == 0:
        return bld.finish()
    cent = bld.cent
    lo = cent.min(axis=0)
    hi = cent.max(axis=0)
    q = np.clip(((cent - lo) / np.maximum(hi - lo, 1e-30) * 1023.0), 0, 1023)
    codes = _morton3(q.astype(np.uint32))
    bld.order = np.argsort(codes, kind="stable").astype(np.int64)

    def rec(start, end):
        node = bld._emit()
        count = end - start + 1
        if count <= bld.leaf_size:
            return bld._leaf(node, start, end)
        idx = bld.order[start:end + 1]
        glo = pmins[idx].min(axis=0)
        ghi = pmaxs[idx].max(axis=0)
        ax = int(np.argmax(ghi - glo))
        mid = start + (count // 2) - 1
        left_size = rec(start, mid)
        right_id = node + 1 + left_size
        right_size = rec(mid + 1, end)
        bld.right[node] = right_id
        bld.axis[node] = ax
        bld.n_mins[node] = np.minimum(bld.n_mins[node + 1], bld.n_mins[right_id])
        bld.n_maxs[node] = np.maximum(bld.n_maxs[node + 1], bld.n_maxs[right_id])
        bld.size[node] = 1 + left_size + right_size
        return bld.size[node]

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))
    rec(0, n - 1)
    return bld.finish()


BUILDERS = {
    "median": build_median,
    "sah": build_sah,
    "lbvh": build_lbvh,
}
