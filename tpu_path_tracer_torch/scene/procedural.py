"""Procedural meshes (host-side NumPy), from
``tpu_path_tracer.scene.procedural``.  Only the cube of the reference scene
is ported so far."""

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
