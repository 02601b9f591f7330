"""Helpers that write a scene description, in the order the upstream's
builder methods take (``lib/scene.js:261``)."""

from __future__ import annotations

import numpy as np


class Description:
    def __init__(self):
        self.materials, self.spheres, self.quads, self.meshes = [], [], [], []

    def material(self, name, mtype, color, specular_color=(0.0, 0.0, 0.0),
                 emission=(0.0, 0.0, 0.0), specular_strength=0.0,
                 roughness=0.0, eta=0.0) -> int:
        self.materials.append({
            "name": name, "type": int(mtype),
            "color": [float(x) for x in color],
            "specular_color": [float(x) for x in specular_color],
            "emission": [float(x) for x in emission],
            "specular_strength": float(specular_strength),
            "roughness": float(roughness), "eta": float(eta)})
        return len(self.materials) - 1

    def find(self, name) -> int:
        """The last material of that name."""
        return max(i for i, m in enumerate(self.materials)
                   if m["name"] == name)

    def sphere(self, center, radius, material):
        self.spheres.append({"center": [float(x) for x in center],
                             "radius": float(radius),
                             "material": int(material)})

    def quad(self, q, u, v, material):
        self.quads.append({"q": [float(x) for x in q],
                           "u": [float(x) for x in u],
                           "v": [float(x) for x in v],
                           "material": int(material)})

    def mesh(self, vertices, normals, material, model=None):
        self.meshes.append({
            "vertices": np.asarray(vertices, np.float32),
            "normals": np.asarray(normals, np.float32),
            "material": int(material),
            "model": (np.eye(4) if model is None
                      else np.asarray(model, np.float64))})

    def done(self) -> dict:
        return {"materials": self.materials, "spheres": self.spheres,
                "quads": self.quads, "meshes": self.meshes}


def cube(half_extent: float = 0.270893):
    """The 12-triangle cube of the upstream's ``assets/cube.obj`` (a
    Blender cube of half-extent 0.270893), flat face normals: (vertices
    [36, 3], normals [36, 3])."""
    h = half_extent
    corners = np.array([[x, y, z] for x in (-h, h) for y in (-h, h)
                        for z in (-h, h)], np.float32)
    faces = [([1, 5, 7, 3], [0, 0, 1]), ([4, 0, 2, 6], [0, 0, -1]),
             ([5, 4, 6, 7], [1, 0, 0]), ([0, 1, 3, 2], [-1, 0, 0]),
             ([2, 3, 7, 6], [0, 1, 0]), ([0, 4, 5, 1], [0, -1, 0])]
    verts, norms = [], []
    for idx, n in faces:
        quad = corners[idx]
        for tri in ((0, 1, 2), (0, 2, 3)):
            for k in tri:
                verts.append(quad[k])
                norms.append(n)
    return np.asarray(verts, np.float32), np.asarray(norms, np.float32)


def rotation(theta: float, axis) -> np.ndarray:
    """Axis-angle rotation, gl-matrix ``mat4.fromRotation``, float64."""
    axis = np.asarray(axis, np.float64)
    x, y, z = axis / np.linalg.norm(axis)
    c, s = np.cos(theta), np.sin(theta)
    t = 1.0 - c
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = [[t * x * x + c, t * x * y - s * z, t * x * z + s * y],
                 [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
                 [t * x * z - s * y, t * y * z + s * x, t * z * z + c]]
    return m
