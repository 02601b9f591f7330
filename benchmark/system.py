"""The system under test: the PyTorch and CUDA port,
``tpu_path_tracer_torch``.  Everything the benchmark takes from the program
goes through here: its scene builder fed with a recipe's description, its
render configuration and its camera's view matrix.
"""

from __future__ import annotations

import importlib


def program():
    """The program's package, imported on first use."""
    return importlib.import_module("tpu_path_tracer_torch")


def build_scene(desc: dict, device):
    """The program's (SceneData, SceneMeta) of a scene description, built
    by its own ``SceneBuilder`` on ``device``."""
    pt = program()
    from tpu_path_tracer_torch.scene.objreader import MeshData

    b = pt.SceneBuilder()
    for m in desc["materials"]:
        b.add_material(m["name"], m["type"], m["color"], m["specular_color"],
                       m["emission"], m["specular_strength"], m["roughness"],
                       m["eta"])
    for s in desc["spheres"]:
        b.add_sphere(s["center"], s["radius"], s["material"])
    for q in desc["quads"]:
        b.add_quad(q["q"], q["u"], q["v"], q["material"])
    for mesh in desc["meshes"]:
        b.add_mesh(MeshData(vertices=mesh["vertices"],
                            normals=mesh["normals"]), mesh["material"],
                   pt.Transform().update(mesh["model"]))
    return b.build(device=device)


def render_config(job: dict):
    """The program's RenderConfig of a traffic mix, through its main path
    (the fused megakernel)."""
    return program().RenderConfig(
        width=job["width"], height=job["height"],
        samples_per_pixel=job["spp"], max_bounces=job["bounces"],
        importance_sampling=job["nee"], stratify=job.get("stratify", False),
        rr_start_bounce=job["rr_start"], use_megakernel=True)


def join_ranks(address: str, world: int, rank: int, device: str):
    """This process as rank ``rank`` of ``world`` through the program's
    ``init_distributed`` (card ``LOCAL_RANK``, NCCL; gloo on the CPU);
    returns the program's 1-D mesh over every rank and the device it keeps
    this rank's tensors on."""
    from tpu_path_tracer_torch.dist.sharding import (init_distributed,
                                                      make_mesh, rank_device)

    init_distributed(address, world, rank, device=device)
    mesh = make_mesh(device_type=device)
    return mesh, rank_device(mesh)


def build_kernels():
    """The program's CUDA library and native BVH builder, built once before
    the ranks start (as its ``render --devices`` does), not in each."""
    from tpu_path_tracer_torch.accel import native
    from tpu_path_tracer_torch.kernels import _build

    _build.build()
    native.available()


def camera(config: dict):
    return program().Camera(eye=config["eye"], center=config["center"],
                            up=config.get("up", [0.0, 1.0, 0.0]))

