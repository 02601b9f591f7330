"""Procedural mesh generators, host-side NumPy
(``tpu_path_tracer.scene.procedural``).

The reference ships binary ``.obj`` assets (``assets/``; the large ones are
stripped from the snapshot, ``.MISSING_LARGE_BLOBS``).  These generators
produce equivalent test/benchmark geometry without asset files: the unit-ish
cube the default scene uses (``assets/cube.obj`` is a Blender cube with
half-extent 0.270893), and subdivided icospheres whose triangle counts can be
dialed to bunny/dragon scale (69k / 298k triangles) for BVH and traversal
benchmarks mirroring ``benchmarks.txt``.
"""

from __future__ import annotations

import numpy as np

from .objreader import MeshData


def cube(half_extent: float = 0.270893) -> MeshData:
    """12-triangle axis-aligned cube, flat per-face normals — geometry
    equivalent of ``assets/cube.obj`` (same half-extent as the Blender export
    the reference scene loads at ``lib/scene.js:289``)."""
    h = half_extent
    corners = np.array(
        [[x, y, z] for x in (-h, h) for y in (-h, h) for z in (-h, h)],
        np.float32)
    # Each face: corner indices (two CCW triangles viewed from outside).
    faces = [
        ([1, 5, 7, 3], [0, 0, 1]),   # +z
        ([4, 0, 2, 6], [0, 0, -1]),  # -z
        ([5, 4, 6, 7], [1, 0, 0]),   # +x
        ([0, 1, 3, 2], [-1, 0, 0]),  # -x
        ([2, 3, 7, 6], [0, 1, 0]),   # +y
        ([0, 4, 5, 1], [0, -1, 0]),  # -y
    ]
    verts, norms = [], []
    for idx, n in faces:
        quad = corners[idx]
        for tri in ((0, 1, 2), (0, 2, 3)):
            for k in tri:
                verts.append(quad[k])
                norms.append(n)
    return MeshData(vertices=np.asarray(verts, np.float32),
                    normals=np.asarray(norms, np.float32))


def icosphere(subdivisions: int = 2, radius: float = 1.0,
              smooth: bool = True) -> MeshData:
    """Subdivided icosahedron: 20 * 4^s triangles (s=6 -> 81,920 — bunny
    scale; s=7 -> 327,680 — dragon scale)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)

    for _ in range(subdivisions):
        # Vectorized midpoint subdivision with shared-edge dedup.
        e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        e_sorted = np.sort(e, axis=1)
        uniq, inv = np.unique(e_sorted, axis=0, return_inverse=True)
        mids = v[uniq[:, 0]] + v[uniq[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        mid_idx = len(v) + inv  # per original edge slot
        m01 = mid_idx[:len(f)]
        m12 = mid_idx[len(f):2 * len(f)]
        m20 = mid_idx[2 * len(f):]
        v = np.concatenate([v, mids])
        f = np.concatenate([
            np.stack([f[:, 0], m01, m20], 1),
            np.stack([f[:, 1], m12, m01], 1),
            np.stack([f[:, 2], m20, m12], 1),
            np.stack([m01, m12, m20], 1),
        ])

    verts = (v[f.reshape(-1)] * radius).astype(np.float32)
    if smooth:
        norms = v[f.reshape(-1)].astype(np.float32)  # unit sphere: n == p
    else:
        a = verts[0::3]
        n = np.cross(verts[1::3] - a, verts[2::3] - a)
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
        norms = np.repeat(n, 3, axis=0)
    return MeshData(vertices=verts, normals=norms)


def cone(radius: float = 0.5, height: float = 1.0,
         segments: int = 32) -> MeshData:
    """Capped cone, apex +y — procedural stand-in for ``assets/cone.obj``
    (referenced by the preload dict, ``lib/scene.js:284-302``).  Smooth side
    normals, flat base."""
    ang = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    rim = np.stack([radius * np.cos(ang), np.full_like(ang, -height / 2),
                    radius * np.sin(ang)], axis=1).astype(np.float32)
    apex = np.array([0.0, height / 2, 0.0], np.float32)
    base_c = np.array([0.0, -height / 2, 0.0], np.float32)
    # Smooth cone-side normal at a rim point: slope the radial dir up.
    slope = radius / height
    rad_dir = rim - base_c
    rad_dir[:, 1] = 0.0
    rad_dir /= np.maximum(np.linalg.norm(rad_dir, axis=1, keepdims=True),
                          1e-20)
    side_n = rad_dir.copy()
    side_n[:, 1] = slope
    side_n /= np.linalg.norm(side_n, axis=1, keepdims=True)
    apex_n = np.array([0.0, 1.0, 0.0], np.float32)
    down = np.array([0.0, -1.0, 0.0], np.float32)

    verts, norms = [], []
    for i in range(segments):
        j = (i + 1) % segments
        # Side triangle (CCW from outside): rim_i, apex, rim_j.
        verts += [rim[i], apex, rim[j]]
        norms += [side_n[i], apex_n, side_n[j]]
        # Base triangle (CCW from below): center, rim_i, rim_j.
        verts += [base_c, rim[i], rim[j]]
        norms += [down, down, down]
    return MeshData(vertices=np.asarray(verts, np.float32),
                    normals=np.asarray(norms, np.float32))


def plate_with_hole(outer: float = 1.0, hole: float = 0.4,
                    thickness: float = 0.15, segments: int = 48) -> MeshData:
    """Square plate with a circular through-hole — procedural stand-in for
    ``assets/hole.obj`` (active in the reference's preload dict,
    ``lib/scene.js:284-302``).  Genus-1 geometry exercises BVH builds on
    non-convex topology."""
    ang = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    cx, cz = np.cos(ang), np.sin(ang)
    # Project each hole angle onto the square boundary.
    m = np.maximum(np.abs(cx), np.abs(cz))
    sx, sz = outer * cx / m, outer * cz / m
    hx, hz = hole * cx, hole * cz
    ytop, ybot = thickness / 2, -thickness / 2

    verts, norms = [], []

    def quad(p0, p1, p2, p3, n):
        for tri in ((p0, p1, p2), (p0, p2, p3)):
            for p in tri:
                verts.append(p)
                norms.append(n)

    up = np.array([0, 1.0, 0], np.float32)
    for i in range(segments):
        j = (i + 1) % segments
        so_i = np.array([sx[i], 0, sz[i]], np.float32)
        so_j = np.array([sx[j], 0, sz[j]], np.float32)
        hi_i = np.array([hx[i], 0, hz[i]], np.float32)
        hi_j = np.array([hx[j], 0, hz[j]], np.float32)
        yt = np.array([0, ytop, 0], np.float32)
        yb = np.array([0, ybot, 0], np.float32)
        # Top annulus ring (normal +y) and bottom (-y), reversed winding.
        quad(hi_i + yt, so_i + yt, so_j + yt, hi_j + yt, up)
        quad(hi_i + yb, hi_j + yb, so_j + yb, so_i + yb, -up)
        # Inner hole wall (normal points into the hole) — smooth.
        n_i = -np.array([cx[i], 0, cz[i]], np.float32)
        n_j = -np.array([cx[j], 0, cz[j]], np.float32)
        for tri, tn in (((hi_i + yt, hi_j + yt, hi_j + yb), (n_i, n_j, n_j)),
                        ((hi_i + yt, hi_j + yb, hi_i + yb), (n_i, n_j, n_i))):
            for p, nn in zip(tri, tn):
                verts.append(p)
                norms.append(nn)
        # Outer wall — flat normals from the square side.
        wall_n = np.array([sx[i] + sx[j], 0, sz[i] + sz[j]], np.float32)
        wall_n /= np.maximum(np.linalg.norm(wall_n), 1e-20)
        quad(so_i + yb, so_j + yb, so_j + yt, so_i + yt, wall_n)
    return MeshData(vertices=np.asarray(verts, np.float32),
                    normals=np.asarray(norms, np.float32))
