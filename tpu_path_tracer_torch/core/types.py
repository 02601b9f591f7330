"""Scene and ray containers: NamedTuples of torch tensors.

Counterpart of ``tpu_path_tracer.core.types`` with the same fields and
layouts.  Every float is float32 and every index int64 (torch's index
type); triangles are baked to world space at build time, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


class Ray(NamedTuple):
    """A batch of rays — SoA equivalent of WGSL ``Ray`` (header.wgsl:48-51)."""
    origin: torch.Tensor  # [N, 3] f32
    dir: torch.Tensor     # [N, 3] f32


class Materials(NamedTuple):
    """SoA of WGSL ``Material`` (header.wgsl:53-61) minus padding lanes."""
    color: torch.Tensor              # [M, 3] f32 — diffuse color
    specular_color: torch.Tensor     # [M, 3] f32
    emission: torch.Tensor           # [M, 3] f32
    specular_strength: torch.Tensor  # [M] f32 — percentSpecular
    roughness: torch.Tensor          # [M] f32 (-1/density for ISOTROPIC)
    eta: torch.Tensor                # [M] f32 — refractive index
    mtype: torch.Tensor              # [M] i64 — LAMBERTIAN..ISOTROPIC

    @property
    def count(self) -> int:
        return self.color.shape[0]


class Spheres(NamedTuple):
    """SoA of WGSL ``Sphere`` (header.wgsl:68-74)."""
    center: torch.Tensor       # [S, 3] f32
    radius: torch.Tensor       # [S] f32
    material_id: torch.Tensor  # [S] i64

    @property
    def count(self) -> int:
        return self.center.shape[0]


class Quads(NamedTuple):
    """SoA of WGSL ``Quad`` (header.wgsl:76-86).  ``normal``/``d``/``w`` are
    precomputed on host exactly as ``lib/primitives/quad.js:21-36``."""
    q: torch.Tensor            # [Q, 3] f32 — corner point
    u: torch.Tensor            # [Q, 3] f32 — edge 1
    v: torch.Tensor            # [Q, 3] f32 — edge 2
    normal: torch.Tensor       # [Q, 3] f32 — normalize(cross(u, v))
    d: torch.Tensor            # [Q] f32 — plane offset, dot(normal, q)
    w: torch.Tensor            # [Q, 3] f32 — n / dot(n, n)
    material_id: torch.Tensor  # [Q] i64

    @property
    def count(self) -> int:
        return self.q.shape[0]


class Triangles(NamedTuple):
    """SoA of WGSL ``Triangle`` (header.wgsl:88-98), baked to world space.
    ``material_id`` is pre-resolved from the owning mesh."""
    a: torch.Tensor            # [T, 3] f32
    b: torch.Tensor            # [T, 3] f32
    c: torch.Tensor            # [T, 3] f32
    na: torch.Tensor           # [T, 3] f32 — per-corner shading normals
    nb: torch.Tensor           # [T, 3] f32
    nc: torch.Tensor           # [T, 3] f32
    material_id: torch.Tensor  # [T] i64

    @property
    def count(self) -> int:
        return self.a.shape[0]


class FlatBVH(NamedTuple):
    """Flattened DFS-preorder BVH (``accel.bvh``), fields as in the JAX
    package: the left child of node i is i + 1, ``miss`` is the first node
    past i's subtree, and i's triangles are ``[prim_lo, prim_hi)`` of the
    reordered triangle table.  ``SceneBuilder.build`` fills it for BVH
    scenes (else ``SceneData.bvh`` is None); ``kernels.traversal`` walks
    it and ``accel.refit`` recomputes its bounds."""
    mins: torch.Tensor        # [B, 3] f32
    maxs: torch.Tensor        # [B, 3] f32
    right: torch.Tensor       # [B] i64 — right-child index (interior), -1 leaf
    prim_start: torch.Tensor  # [B] i64 — first triangle (leaf), -1 interior
    prim_count: torch.Tensor  # [B] i64 — triangle count (leaf), 0 interior
    miss: torch.Tensor        # [B] i64 — skip pointer; num_nodes = done
    axis: torch.Tensor        # [B] i64 — split axis
    prim_lo: torch.Tensor     # [B] i64 — subtree triangle range start
    prim_hi: torch.Tensor     # [B] i64 — subtree triangle range end

    @property
    def count(self) -> int:
        return self.mins.shape[0]


class SceneData(NamedTuple):
    """Everything the integrator needs on the device."""
    materials: Materials
    spheres: Spheres
    quads: Quads
    triangles: Triangles
    bvh: Optional[FlatBVH]
    # The first emissive quad is "the light" (shaders/common.wgsl:258-269);
    # index into quads, or -1.  A Python int: it selects host-side code.
    light_index: int


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static facts about a scene that select code paths."""
    has_volumes: bool = False        # any ISOTROPIC-material sphere present
    traversal: str = "brute"         # "brute" | "bvh" | "none" (no triangles)
    max_leaf: int = 1                # static leaf-primitive bound of the BVH
    has_light: bool = False          # an emissive quad exists (NEE possible)


class HitRecord(NamedTuple):
    """SoA of WGSL ``HitRecord`` (header.wgsl:119-125) over a ray batch."""
    hit: torch.Tensor          # [N] bool
    t: torch.Tensor            # [N] f32
    p: torch.Tensor            # [N, 3] f32
    normal: torch.Tensor       # [N, 3] f32 (front-face flipped)
    front_face: torch.Tensor   # [N] bool
    material_id: torch.Tensor  # [N] i64 (0 when no hit)


def _tensor(x, device) -> torch.Tensor:
    x = np.asarray(x)
    dtype = np.float32 if np.issubdtype(x.dtype, np.floating) else np.int64
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def scene_from_numpy(np_scene, device) -> SceneData:
    """Turn a ``SceneData`` of numpy arrays — the JAX package's scene after
    ``jax.tree.map(np.asarray, scene)`` — into the port's, on ``device``.

    Floats come out float32 and indices int64 whatever the input width, so
    a float64 array never reaches the integrator."""
    def conv(group, cls):
        return cls(*(_tensor(getattr(group, f), device) for f in cls._fields))

    bvh = None if np_scene.bvh is None else conv(np_scene.bvh, FlatBVH)
    return SceneData(
        materials=conv(np_scene.materials, Materials),
        spheres=conv(np_scene.spheres, Spheres),
        quads=conv(np_scene.quads, Quads),
        triangles=conv(np_scene.triangles, Triangles),
        bvh=bvh,
        light_index=int(np.asarray(np_scene.light_index)))
