"""The JAX package's mesh benchmark (``bench.py:301``, ``bench_mesh_bvh``):
an icosphere of radius 0.8 in a mirror material, subdivided 6 times to
20 * 4**6 = 81,920 triangles, before a white back wall, under a ceiling
light of emission 2, above a white floor.  It stands in for the
upstream's bunny (69,451 triangles, ``benchmarks.txt:1-16``), whose OBJ
file the repository does not hold."""

from __future__ import annotations

import numpy as np

from ._describe import Description

LAMBERTIAN, MIRROR = 0, 1


def icosphere(subdivisions: int, radius: float):
    """The icosahedron subdivided ``subdivisions`` times at its edges'
    midpoints, each new vertex projected onto the unit sphere, then scaled
    to ``radius``: (vertices [T*3, 3], smooth normals [T*3, 3]) in float32,
    three corners a triangle, 20 * 4**subdivisions triangles."""
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
        # Each edge's midpoint once, shared by the edge's two faces.
        edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        unique, slot = np.unique(np.sort(edges, axis=1), axis=0,
                                 return_inverse=True)
        mids = v[unique[:, 0]] + v[unique[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        m01, m12, m20 = np.split(len(v) + slot.reshape(-1), 3)
        v = np.concatenate([v, mids])
        f = np.concatenate([np.stack([f[:, 0], m01, m20], 1),
                            np.stack([f[:, 1], m12, m01], 1),
                            np.stack([f[:, 2], m20, m12], 1),
                            np.stack([m01, m12, m20], 1)])
    corners = v[f.reshape(-1)]
    # On the unit sphere a point is its own normal.
    return ((corners * radius).astype(np.float32),
            corners.astype(np.float32))


def describe(args: dict) -> dict:
    s = Description()
    s.material("default", LAMBERTIAN, [1, 0, 0])
    white = s.material("white", LAMBERTIAN, [0.73, 0.73, 0.73])
    light = s.material("light", LAMBERTIAN, [0, 0, 0], emission=[2, 2, 2])
    mirror = s.material("mirror", MIRROR, [0.9, 0.9, 0.9])
    s.quad([-2, -2, -2], [4, 0, 0], [0, 4, 0], white)   # back wall
    s.quad([-2, 2, -2], [4, 0, 0], [0, 0, 4], light)    # ceiling light
    s.quad([-2, -2, 2], [4, 0, 0], [0, 0, -4], white)   # floor
    vertices, normals = icosphere(args.get("subdivisions", 6),
                                  args.get("radius", 0.8))
    s.mesh(vertices, normals, mirror)
    return s.done()
