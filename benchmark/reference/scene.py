"""A scene description (the plain data a recipe under ``benchmark/scenes``
gives) made into the reference's tensors, as the upstream's host code does
(``lib/scene.js``, ``lib/primitives/quad.js:21-36``): quad plane data in
float64, triangles baked to world space through the model matrix in
float64, and the first emissive quad as the light.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LAMBERTIAN, MIRROR, GLASS, ISOTROPIC = 0, 1, 2, 3
MATERIAL_FIELDS = ("color", "specular_color", "emission",
                   "specular_strength", "roughness", "eta")


class Scene(NamedTuple):
    materials: dict   # the MATERIAL_FIELDS and "mtype" [M]
    spheres: dict     # center [S, 3], radius [S], material_id [S]
    quads: dict       # q, u, v, normal [Q, 3], d [Q], w [Q, 3], material_id
    triangles: dict   # a, b, c, na, nb, nc [T, 3], material_id [T]
    light_index: int  # the light quad, or -1
    has_volumes: bool


def bake_triangles(meshes):
    """Each mesh's corners and normals through its model matrix (normals
    through the inverse's transpose, ``common.wgsl:231``), in float64 and
    rounded once to float32.  Returns six ``[T, 3]`` arrays and the
    material of each triangle."""
    cols = [[] for _ in range(7)]
    for mesh in meshes:
        model = np.asarray(mesh["model"], np.float64)
        inv = np.linalg.inv(model)
        verts = np.asarray(mesh["vertices"], np.float32).astype(np.float64)
        norms = np.asarray(mesh["normals"], np.float32).astype(np.float64)
        verts = (verts @ model[:3, :3].T + model[:3, 3]).astype(np.float32)
        norms = (norms @ inv[:3, :3]).astype(np.float32)
        for k in range(3):
            cols[k].append(verts[k::3])
            cols[3 + k].append(norms[k::3])
        cols[6].append(np.full(len(verts) // 3, mesh["material"], np.int64))
    if not meshes:
        return [np.zeros((0, 3), np.float32)] * 6 + [np.zeros(0, np.int64)]
    return [np.concatenate(c) for c in cols]


def build(desc, device, dtype=torch.float32) -> Scene:
    """The reference scene of a description, its floats in ``dtype``."""
    def f(x, shape):
        return torch.as_tensor(np.asarray(x, np.float32).reshape(shape),
                               device=device).to(dtype)

    def i(x):
        return torch.as_tensor(np.asarray(x, np.int64).reshape(-1),
                               device=device)

    mats = desc["materials"]
    materials = {k: f([m[k] for m in mats], (len(mats), -1) if k in (
        "color", "specular_color", "emission") else (len(mats),))
        for k in MATERIAL_FIELDS}
    materials["mtype"] = i([m["type"] for m in mats])

    sph = desc["spheres"]
    spheres = {"center": f([s["center"] for s in sph], (-1, 3)),
               "radius": f([s["radius"] for s in sph], (-1,)),
               "material_id": i([s["material"] for s in sph])}

    qd = desc["quads"]
    q = np.asarray([x["q"] for x in qd], np.float32).reshape(-1, 3)
    u = np.asarray([x["u"] for x in qd], np.float32).reshape(-1, 3)
    v = np.asarray([x["v"] for x in qd], np.float32).reshape(-1, 3)
    q64, u64, v64 = (x.astype(np.float64) for x in (q, u, v))
    n = np.cross(u64, v64)
    normal = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    d = np.sum(normal * q64, axis=-1)
    w = n / np.maximum(np.sum(n * n, axis=-1, keepdims=True), 1e-30)
    qmat = np.asarray([x["material"] for x in qd], np.int64)
    quads = {"q": f(q, (-1, 3)), "u": f(u, (-1, 3)), "v": f(v, (-1, 3)),
             "normal": f(normal, (-1, 3)), "d": f(d, (-1,)),
             "w": f(w, (-1, 3)), "material_id": i(qmat)}

    a, b, c, na, nb, nc, tmat = bake_triangles(desc.get("meshes", []))
    triangles = {"a": f(a, (-1, 3)), "b": f(b, (-1, 3)), "c": f(c, (-1, 3)),
                 "na": f(na, (-1, 3)), "nb": f(nb, (-1, 3)),
                 "nc": f(nc, (-1, 3)), "material_id": i(tmat)}

    emission = np.asarray([m["emission"] for m in mats], np.float32)
    light = next((k for k, mid in enumerate(qmat) if emission[mid][0] > 0.0),
                 -1)
    mtypes = np.asarray([m["type"] for m in mats], np.int64)
    smat = np.asarray([s["material"] for s in sph], np.int64)
    has_volumes = bool(len(smat)) and bool((mtypes[smat] == ISOTROPIC).any())
    return Scene(materials, spheres, quads, triangles, light, has_volumes)


def with_materials(scene: Scene, params: dict) -> Scene:
    """The scene with some material fields replaced (training's
    parameters, keyed by ``MATERIAL_FIELDS``)."""
    return scene._replace(materials={**scene.materials, **params})


def target_to(eye, target, up):
    """gl-matrix ``mat4.targetTo`` (``lib/camera.js:32``) in float32: the
    4x4 view matrix, columns x, y, z and the eye."""
    eye = np.asarray(eye, np.float32)
    z = eye - np.asarray(target, np.float32)
    zlen = np.dot(z, z)
    if zlen > 0:
        z = z / np.sqrt(zlen)
    x = np.cross(np.asarray(up, np.float32), z)
    xlen = np.dot(x, x)
    if xlen > 0:
        x = x / np.sqrt(xlen)
    y = np.cross(z, x)
    ylen = np.dot(y, y)
    if ylen > 0:
        y = y / np.sqrt(ylen)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, eye
    return m
