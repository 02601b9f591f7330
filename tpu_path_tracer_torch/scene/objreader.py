"""Wavefront OBJ loading, host-side NumPy
(``tpu_path_tracer.scene.objreader``).

Feature parity with ``lib/primitives/objReader.js:21-68``: parses ``v``,
``vn``, and ``f`` records and de-indexes them into flat per-corner vertex and
normal streams (one entry per triangle corner).  Superset extensions over the
reference (which silently mis-parses some of these): supports ``v/vt/vn``,
``v//vn``, and bare ``v`` face encodings, negative (relative) indices, and
fan-triangulation of polygons with more than 3 vertices.  ``vt`` and material
statements are skipped, like the reference.
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


def parse_obj(text: str, use_native: bool = True) -> MeshData:
    """Parse OBJ text into de-indexed corner streams.  Large texts go
    through the C++ de-indexer (``accel/bvh_native.cpp``, ``tpt_obj_parse``,
    the same semantics); the Python below is the reference implementation
    and runs when the native library cannot be built."""
    if use_native and len(text) > 1 << 16:
        from ..accel.native import parse_obj_native
        out = parse_obj_native(text)
        if out is not None:
            return MeshData(vertices=out[0], normals=out[1])

    verts: list = []
    norms: list = []
    face_v: list = []
    face_n: list = []

    for raw in text.split("\n"):
        line = raw.strip()
        if not line or line[0] == "#":
            continue
        if line.startswith("v "):
            parts = line.split()
            verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif line.startswith("vn "):
            parts = line.split()
            norms.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif line.startswith("f "):
            corners = line.split()[1:]
            vi = []
            ni = []
            for c in corners:
                comp = c.split("/")
                vi.append(int(comp[0]))
                if len(comp) >= 3 and comp[2]:
                    ni.append(int(comp[2]))
                else:
                    ni.append(0)  # 0 = "no normal" sentinel (OBJ is 1-based)
            # Fan-triangulate n-gons: (0, k, k+1).
            for k in range(1, len(vi) - 1):
                face_v.append((vi[0], vi[k], vi[k + 1]))
                face_n.append((ni[0], ni[k], ni[k + 1]))

    v = np.asarray(verts, np.float32).reshape(-1, 3)
    vn = (np.asarray(norms, np.float32).reshape(-1, 3)
          if norms else np.zeros((0, 3), np.float32))

    fv = np.asarray(face_v, np.int64).reshape(-1, 3)
    fn = np.asarray(face_n, np.int64).reshape(-1, 3)

    # Resolve 1-based / negative-relative indices.
    fv = np.where(fv > 0, fv - 1, fv + len(v))
    flat_v = v[fv.reshape(-1)]

    if len(vn):
        has_n = fn != 0
        fn = np.where(fn > 0, fn - 1, np.where(fn < 0, fn + len(vn), 0))
        flat_n = vn[fn.reshape(-1)]
        has_n = has_n.reshape(-1)
    else:
        flat_n = np.zeros_like(flat_v)
        has_n = np.zeros(len(flat_v), bool)

    # Corners with no vn record get the face's geometric normal (the reference
    # would produce undefined entries here; we choose the sane default).
    if not has_n.all():
        a = flat_v[0::3]
        bc = flat_v[1::3] - a
        cc = flat_v[2::3] - a
        geo = np.cross(bc, cc)
        geo /= np.maximum(np.linalg.norm(geo, axis=-1, keepdims=True), 1e-20)
        geo3 = np.repeat(geo, 3, axis=0)
        flat_n = np.where(has_n[:, None], flat_n, geo3)

    return MeshData(vertices=flat_v.astype(np.float32),
                    normals=flat_n.astype(np.float32))


def load_obj(path: str) -> MeshData:
    """File-path equivalent of ``ObjReader.load_model`` (fetch+parse,
    ``objReader.js:10-14``)."""
    with open(path, "r") as f:
        return parse_obj(f.read())


def save_obj(path: str, mesh: MeshData) -> None:
    """Write flat de-indexed MeshData as a ``v``/``vn``/``f v//vn`` OBJ —
    the exact dialect the reference's parser reads (``objReader.js:21-60``).
    With :func:`parse_obj` this round-trips procedural geometry into real
    asset files for tests and external tools."""
    v = np.asarray(mesh.vertices, np.float32)
    n = np.asarray(mesh.normals, np.float32)
    lines = ["# tpu-path-tracer OBJ export"]
    lines += [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in v]
    lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in n]
    lines += [f"f {i}//{i} {i+1}//{i+1} {i+2}//{i+2}"
              for i in range(1, len(v) + 1, 3)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
