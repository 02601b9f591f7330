"""Differentiable scene parameters (``tpu_path_tracer.diff.params``).

``extract_params`` pulls the requested groups out of a ``SceneData`` into a
flat dict of tensors, with the JAX package's group names and dict keys;
``apply_params`` splices a (possibly partial) dict back.  Everything not
extracted stays constant, and the discrete hit search is detached inside
the kernels regardless (``kernels/hit.py``).  To train, make the extracted
tensors leaves that require grad and rebuild the scene from them with
``apply_params`` on every step.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from ..accel.refit import refit_bvh
from ..core import vecmath as vm
from ..core.types import SceneData

GROUPS = ("emission", "bsdf", "vertices", "spheres", "quads")


def extract_params(scene: SceneData,
                   groups: Iterable[str] = ("emission", "bsdf")) -> Dict:
    params: Dict = {}
    g = set(groups)
    unknown = g - set(GROUPS)
    if unknown:
        raise ValueError(f"unknown param groups {unknown}; valid: {GROUPS}")
    if "emission" in g:
        params["emission"] = scene.materials.emission
    if "bsdf" in g:
        params["color"] = scene.materials.color
        params["specular_color"] = scene.materials.specular_color
        params["specular_strength"] = scene.materials.specular_strength
        params["roughness"] = scene.materials.roughness
        params["eta"] = scene.materials.eta
    if "vertices" in g:
        params["tri_a"] = scene.triangles.a
        params["tri_b"] = scene.triangles.b
        params["tri_c"] = scene.triangles.c
    if "spheres" in g:
        params["sphere_center"] = scene.spheres.center
        params["sphere_radius"] = scene.spheres.radius
    if "quads" in g:
        params["quad_q"] = scene.quads.q
        params["quad_u"] = scene.quads.u
        params["quad_v"] = scene.quads.v
    return params


def apply_params(scene: SceneData, params: Dict) -> SceneData:
    """Splice a (possibly partial) parameter dict back into the scene.

    For quads the stored plane data (``normal``, ``d``, ``w``) is
    recomputed from ``q``, ``u`` and ``v`` with the formulas of the JAX
    package (``quad.js:21-27``).  The megakernel reads quad geometry through
    those stored columns, so this is the only way its quad gradients reach
    ``q``, ``u`` and ``v``.  Moving the vertices of a BVH scene refits the
    BVH's bounds to them (``accel.refit``, on the scene's device, outside
    autograd), so every training path keeps the traversal right."""
    mats = scene.materials
    if "emission" in params:
        mats = mats._replace(emission=params["emission"])
    if "color" in params:
        mats = mats._replace(
            color=params["color"],
            specular_color=params["specular_color"],
            specular_strength=params["specular_strength"],
            roughness=params["roughness"],
            eta=params["eta"])
    scene = scene._replace(materials=mats)
    if "tri_a" in params:
        scene = scene._replace(triangles=scene.triangles._replace(
            a=params["tri_a"], b=params["tri_b"], c=params["tri_c"]))
        if scene.bvh is not None:
            scene = scene._replace(bvh=refit_bvh(scene.bvh, scene.triangles))
    if "sphere_center" in params:
        scene = scene._replace(spheres=scene.spheres._replace(
            center=params["sphere_center"], radius=params["sphere_radius"]))
    if "quad_q" in params:
        q, u, v = params["quad_q"], params["quad_u"], params["quad_v"]
        n = vm.cross(u, v)
        normal = n / torch.clamp(vm.length(n), min=1e-20)[..., None]
        d = torch.sum(normal * q, dim=-1)
        w = n / torch.clamp(torch.sum(n * n, dim=-1), min=1e-30)[..., None]
        scene = scene._replace(quads=scene.quads._replace(
            q=q, u=u, v=v, normal=normal, d=d, w=w))
    return scene
