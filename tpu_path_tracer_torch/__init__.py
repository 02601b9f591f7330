"""tpu_path_tracer_torch: the path tracer on PyTorch and CUDA.

A port of ``tpu_path_tracer`` (JAX/Pallas for TPU) that imports no JAX.
Plain tensor code is PyTorch; the fused megakernel and its backward are
hand-written CUDA for Hopper (``csrc/megakernel_fwd.cu``,
``csrc/megakernel_bwd.cu``).  Training: ``diff.params``,
``dist.render_dist.make_train_step`` and ``python -m tpu_path_tracer_torch
train``.  Public API re-exports below, matching the JAX package for what
is ported; see README.md.
"""

from .core.camera import Camera
from .core.config import GLASS, ISOTROPIC, LAMBERTIAN, MIRROR, RenderConfig
from .core.types import (FlatBVH, HitRecord, Materials, Quads, Ray, SceneData,
                         SceneMeta, Spheres, Triangles, scene_from_numpy)
from .scene.builder import SceneBuilder
from .scene.objreader import MeshData
from .scene import builtin, procedural
from .scene.transform import Transform
from .integrator.render import render_frame
from .renderer import Renderer
from .integrator import film

__version__ = "0.1.0"
