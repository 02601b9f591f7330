"""Scene construction: host-side DSL -> device SoA tensors.

Counterpart of ``tpu_path_tracer.scene.builder``.  The materials table,
primitive order, quad plane data, light choice, BVH and triangle order are
computed exactly as there, so the two packages build equal arrays.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..accel import bvh as bvh_mod
from ..accel.native import build_bvh_native
from ..core.config import ISOTROPIC
from ..core.types import FlatBVH, Materials, Quads, SceneData, SceneMeta, \
    Spheres, Triangles
from .objreader import MeshData
from .transform import Transform

# Up to this many triangles "auto" takes the dense [N, T] sweep and builds
# no BVH (tpu_path_tracer/scene/builder.py:34).
BRUTE_FORCE_MAX_TRIS = 256
BVH_CHOICES = ("auto", "median", "sah", "lbvh", "none")


@dataclasses.dataclass
class _MeshEntry:
    data: MeshData
    material: int
    transform: Transform


class SceneBuilder:
    """Programmatic scene description, mirroring the reference's builder
    methods but declarative and host-side only."""

    def __init__(self):
        self._mat = {
            "color": [], "specular_color": [], "emission": [],
            "specular_strength": [], "roughness": [], "eta": [], "mtype": [],
        }
        self.material_names = {}
        self._spheres: List = []
        self._quads: List = []
        self._meshes: List[_MeshEntry] = []

    # -- materials -----------------------------------------------------
    def add_material(self, name, material_type, color,
                     specular_color=(0.0, 0.0, 0.0),
                     emission=(0.0, 0.0, 0.0),
                     specular_strength=0.0, roughness=0.0,
                     eta=0.0) -> int:
        """Same signature order as ``Scene.add_material``
        (``lib/scene.js:261``); returns the material id."""
        mat_id = len(self._mat["mtype"])
        self.material_names[name] = mat_id
        self._mat["color"].append(tuple(color))
        self._mat["specular_color"].append(tuple(specular_color))
        self._mat["emission"].append(tuple(emission))
        self._mat["specular_strength"].append(float(specular_strength))
        self._mat["roughness"].append(float(roughness))
        self._mat["eta"].append(float(eta))
        self._mat["mtype"].append(int(material_type))
        return mat_id

    def material(self, name: str) -> int:
        """Lookup by name — the reference's ``material_dict``."""
        return self.material_names[name]

    # -- primitives ----------------------------------------------------
    def add_sphere(self, center, radius, material: int) -> int:
        self._spheres.append((np.asarray(center, np.float32), float(radius),
                              int(material)))
        return len(self._spheres) - 1

    def add_quad(self, q, u, v, material: int) -> int:
        self._quads.append((np.asarray(q, np.float32),
                            np.asarray(u, np.float32),
                            np.asarray(v, np.float32), int(material)))
        return len(self._quads) - 1

    def add_mesh(self, data: MeshData, material: int,
                 transform: Optional[Transform] = None) -> _MeshEntry:
        entry = _MeshEntry(data=data, material=int(material),
                           transform=transform or Transform())
        self._meshes.append(entry)
        return entry

    # -- build ---------------------------------------------------------
    def _bake_triangles(self):
        """Explode meshes to world-space triangles (transforms baked in)."""
        cols = [[] for _ in range(7)]  # a b c na nb nc material
        for entry in self._meshes:
            verts = entry.transform.apply_points(
                entry.data.vertices.astype(np.float64)).astype(np.float32)
            norms = entry.transform.apply_normals(
                entry.data.normals.astype(np.float64)).astype(np.float32)
            for k in range(3):
                cols[k].append(verts[k::3])
                cols[3 + k].append(norms[k::3])
            cols[6].append(np.full(len(verts) // 3, entry.material, np.int64))
        if not self._meshes:
            zero3 = np.zeros((0, 3), np.float32)
            return (zero3,) * 6 + (np.zeros((0,), np.int64),)
        return tuple(np.concatenate(c) for c in cols)

    def build(self, bvh: str = "auto", max_leaf: int = 4,
              timings: Optional[dict] = None, device="cuda"):
        """Returns ``(SceneData, SceneMeta)`` with every tensor on ``device``.

        ``bvh``: "auto" | "median" | "sah" | "lbvh" | "none".  "auto" takes
        the dense brute-force sweep up to ``BRUTE_FORCE_MAX_TRIS`` triangles
        and an LBVH above.  The native C++ builders run when ``g++`` can
        build them, else the NumPy ones (``accel``).  ``timings``: an
        optional dict that receives ``bake_s`` (meshes to world-space
        triangles) and ``bvh_build_s`` (the BVH construction alone); the
        upload to ``device`` is in neither.
        """
        if bvh not in BVH_CHOICES:
            raise ValueError(f"bvh={bvh!r}; expected one of {BVH_CHOICES}")

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        def i64(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=device)

        m = self._mat
        materials = Materials(
            color=f32(m["color"]).reshape(-1, 3),
            specular_color=f32(m["specular_color"]).reshape(-1, 3),
            emission=f32(m["emission"]).reshape(-1, 3),
            specular_strength=f32(m["specular_strength"]),
            roughness=f32(m["roughness"]), eta=f32(m["eta"]),
            mtype=i64(m["mtype"]))

        if self._spheres:
            centers = np.stack([s[0] for s in self._spheres])
            radii = [s[1] for s in self._spheres]
            smat = np.asarray([s[2] for s in self._spheres], np.int64)
        else:
            centers, radii = np.zeros((0, 3)), []
            smat = np.zeros((0,), np.int64)
        spheres = Spheres(center=f32(centers).reshape(-1, 3),
                          radius=f32(radii), material_id=i64(smat))

        # Quads with plane data precomputed in float64
        # (lib/primitives/quad.js:21-27).
        if self._quads:
            q = np.stack([x[0] for x in self._quads]).astype(np.float64)
            u = np.stack([x[1] for x in self._quads]).astype(np.float64)
            v = np.stack([x[2] for x in self._quads]).astype(np.float64)
            qmat = np.asarray([x[3] for x in self._quads], np.int64)
            n = np.cross(u, v)
            normal = n / np.maximum(
                np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            d = np.sum(normal * q, axis=-1)
            w = n / np.maximum(np.sum(n * n, axis=-1, keepdims=True), 1e-30)
        else:
            q = u = v = normal = w = np.zeros((0, 3), np.float64)
            d = np.zeros((0,), np.float64)
            qmat = np.zeros((0,), np.int64)
        quads = Quads(q=f32(q), u=f32(u), v=f32(v), normal=f32(normal),
                      d=f32(d), w=f32(w), material_id=i64(qmat))

        t_bake = time.perf_counter()
        a, b, c, na, nb, nc, tmat = self._bake_triangles()
        if timings is not None:
            timings["bake_s"] = time.perf_counter() - t_bake
        n_tris = len(a)
        flat_bvh, traversal, leaf_bound = None, "none", 1
        if n_tris:
            if bvh == "auto":
                bvh = "none" if n_tris <= BRUTE_FORCE_MAX_TRIS else "lbvh"
            traversal = "brute"
        if n_tris and bvh != "none":
            t_bvh = time.perf_counter()
            arrs = _build_bvh(bvh, *bvh_mod.triangle_aabbs(a, b, c),
                              max_leaf)
            if timings is not None:
                timings["bvh_build_s"] = time.perf_counter() - t_bvh
            order = arrs.order
            a, b, c = a[order], b[order], c[order]
            na, nb, nc = na[order], nb[order], nc[order]
            tmat = tmat[order]
            flat_bvh = FlatBVH(
                mins=f32(arrs.mins), maxs=f32(arrs.maxs),
                right=i64(arrs.right), prim_start=i64(arrs.prim_start),
                prim_count=i64(arrs.prim_count), miss=i64(arrs.miss),
                axis=i64(arrs.axis), prim_lo=i64(arrs.prim_lo),
                prim_hi=i64(arrs.prim_hi))
            traversal = "bvh"
            leaf_bound = int(arrs.prim_count.max())
        triangles = Triangles(a=f32(a), b=f32(b), c=f32(c), na=f32(na),
                              nb=f32(nb), nc=f32(nc), material_id=i64(tmat))

        # First emissive quad is "the light" (common.wgsl:258-269).
        emissions = np.asarray(m["emission"], np.float32).reshape(-1, 3)
        light_index = next(
            (i for i, mid in enumerate(qmat) if emissions[mid][0] > 0.0), -1)

        mtypes = np.asarray(m["mtype"], np.int64)
        has_volumes = bool(len(smat)) and bool(
            (mtypes[smat] == ISOTROPIC).any())

        scene = SceneData(materials=materials, spheres=spheres, quads=quads,
                          triangles=triangles, bvh=flat_bvh,
                          light_index=light_index)
        meta = SceneMeta(has_volumes=has_volumes, traversal=traversal,
                         max_leaf=leaf_bound, has_light=light_index >= 0)
        return scene, meta


def _build_bvh(method, mins, maxs, max_leaf) -> bvh_mod.FlatBVHArrays:
    """The native builder when it is available, else the NumPy one, with the
    JAX package's leaf parameters: 1 for the median split (the reference's
    leaves hold one primitive), ``max_leaf`` otherwise."""
    arrs = build_bvh_native(method, mins, maxs,
                            1 if method == "median" else max_leaf)
    if arrs is not None:
        return arrs
    if method == "median":
        return bvh_mod.build_median(mins, maxs)
    if method == "sah":
        return bvh_mod.build_sah(mins, maxs, max_leaf=max_leaf)
    return bvh_mod.build_lbvh(mins, maxs, leaf_size=max_leaf)
