"""Mesh data container (``tpu_path_tracer.scene.objreader.MeshData``).

OBJ file loading is not ported yet (ROADMAP Queue 1 item 7); procedural
meshes fill this container directly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class MeshData(NamedTuple):
    """Flat de-indexed streams, 9 floats per triangle — the layout consumed by
    mesh assembly (``lib/primitives/mesh.js:19-50``)."""
    vertices: np.ndarray  # [T*3, 3] f32, per-corner positions
    normals: np.ndarray   # [T*3, 3] f32, per-corner shading normals

    @property
    def num_triangles(self) -> int:
        return self.vertices.shape[0] // 3
