"""Fused path-tracing megakernel: the whole trace of a frame in one launch.

Port of ``tpu_path_tracer/kernels/pallas/megakernel.py``, forward only.
The kernel is CUDA C++ (``csrc/megakernel_fwd.cu``, built by
``kernels._build``): one thread per pixel runs camera ray generation, the
sample and bounce loops, the hit search over the packed scene tables,
shading and Russian roulette, so ray state never leaves registers.  Its
contract is the JAX kernel's (``megakernel.py:23-28``): draw for draw the
same PCG stream and bounce algebra as the wavefront integrator, which is
therefore its plain version here (:func:`path_trace_pixels_reference`).

Routing, with no fallback: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  Gradients are not ported yet: the
autograd node raises in ``backward`` (ROADMAP Queue 2 item 2).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..core.config import PI, RenderConfig
from ..core.types import SceneData, SceneMeta

# Scene-table columns (megakernel.py:148-161).
# Sphere row: cx cy cz r | col3 spec3 emi3 sstr rough eta mtype  (17)
SPH_COLS = 17
# Quad row: q3 u3 v3 n3 d w3 | col3 spec3 emi3 sstr rough eta mtype (29)
QUAD_COLS = 29
# Triangle row: a3 b3 c3 na3 nb3 nc3 | mat13 (31)
TRI_COLS = 31
LIGHT_COLS = 9
CAM_COLS = 16
# The triangle loop is a plain loop over shared memory; this bound keeps
# the JAX package's routing (megakernel.py:161).
MAX_MEGAKERNEL_TRIS = 64
# Dynamic shared memory a block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232448

# Launches of the CUDA kernel in this process.
LAUNCHES = 0

_BACKWARD_MISSING = "megakernel backward: ROADMAP Queue 2 item 2"


def _mat_cols(materials, mid):
    """One 13-column material row per primitive."""
    return [materials.color[mid], materials.specular_color[mid],
            materials.emission[mid], materials.specular_strength[mid, None],
            materials.roughness[mid, None], materials.eta[mid, None],
            materials.mtype[mid, None].to(torch.float32)]


def pack_tables(scene: SceneData):
    """Flatten the scene into the kernel's packed tables
    ``(sph [S,17], quad [Q,29], tri [T,31], light [1,9])``, with the column
    layout of the JAX package.  An empty family packs no rows (the JAX
    package pads one zero row for its TPU block shapes).  Without quads the
    light row is zeros.  Differentiable torch ops, so table gradients would
    reach the scene."""
    device = scene.quads.q.device

    def table(count, cols, parts):
        if not count:
            return torch.zeros((0, cols), dtype=torch.float32, device=device)
        return torch.cat([p.reshape(count, -1) for p in parts], dim=1)

    m = scene.materials
    sph, qd, tr = scene.spheres, scene.quads, scene.triangles
    sph_tab = table(sph.count, SPH_COLS,
                    [sph.center, sph.radius] + _mat_cols(m, sph.material_id))
    quad_tab = table(qd.count, QUAD_COLS,
                     [qd.q, qd.u, qd.v, qd.normal, qd.d, qd.w]
                     + _mat_cols(m, qd.material_id))
    tri_tab = table(tr.count, TRI_COLS,
                    [tr.a, tr.b, tr.c, tr.na, tr.nb, tr.nc]
                    + _mat_cols(m, tr.material_id))
    if qd.count:
        li = min(max(scene.light_index, 0), qd.count - 1)
        light_tab = torch.cat([qd.q[li], qd.u[li], qd.v[li]])[None]
    else:
        light_tab = torch.zeros((1, LIGHT_COLS), dtype=torch.float32,
                                device=device)
    return sph_tab, quad_tab, tri_tab, light_tab


def resolved_spp(cfg: RenderConfig) -> int:
    """Samples a pixel takes: floor(sqrt(spp))^2 when stratified."""
    return (max(int(cfg.samples_per_pixel ** 0.5), 1) ** 2
            if cfg.stratify else cfg.samples_per_pixel)


def supported(scene: SceneData, meta: SceneMeta, cfg: RenderConfig) -> bool:
    """Whether the megakernel covers this scene: spheres, quads and at most
    ``MAX_MEGAKERNEL_TRIS`` triangles, and at least one primitive."""
    return (scene.triangles.count <= MAX_MEGAKERNEL_TRIS
            and (scene.spheres.count + scene.quads.count
                 + scene.triangles.count) > 0)


def path_trace_pixels_reference(rand_state, view_matrix, px, py,
                                 scene: SceneData, meta: SceneMeta,
                                 cfg: RenderConfig):
    """The kernel's plain version: the port's wavefront
    ``integrator.render.path_trace_pixels``.  Returns radiance ``[N, 3]``."""
    from ..integrator.render import path_trace_pixels

    _, radiance = path_trace_pixels(rand_state, view_matrix, px, py, scene,
                                    meta, cfg.replace(use_megakernel=False))
    return radiance


def _bind(lib):
    fn = lib.tpt_megakernel_fwd
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([p, i, i, i, p, p, p, p, i]
                       + [i] * 6 + [f] * 13 + [p])
        fn.restype = ctypes.c_int
    return fn


def _launch(rand_state, px, py, tables, scene: SceneData, meta: SceneMeta,
            cfg: RenderConfig):
    """Launch the CUDA kernel on the current stream; returns ``[N, 3]``."""
    global LAUNCHES
    from . import _build

    device = px.device
    n = px.shape[0]
    counts = (scene.spheres.count, scene.quads.count, scene.triangles.count)
    flat = torch.cat([t.detach().reshape(-1) for t in tables])
    flat = flat.to(device=device, dtype=torch.float32).contiguous()
    if flat.numel() * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"megakernel scene tables take {flat.numel() * 4} "
                         f"bytes of shared memory, above the "
                         f"{MAX_SMEM_BYTES} a block may use")
    for name, t in (("rand_state", rand_state), ("px", px), ("py", py)):
        if t.device != device or t.shape != (n,):
            raise ValueError(f"{name} must be [{n}] on {device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    # The uint32 states as int32 bit patterns.
    state = rand_state.to(torch.int64) & 0xFFFFFFFF
    state = torch.where(state >= 2 ** 31, state - 2 ** 32, state)
    state = state.to(torch.int32).contiguous()
    px32 = px.to(torch.int32).contiguous()
    py32 = py.to(torch.int32).contiguous()
    out = torch.empty((n, 3), dtype=torch.float32, device=device)

    spp = resolved_spp(cfg)
    grid_n = max(int(cfg.samples_per_pixel ** 0.5), 1) if cfg.stratify else 0
    w, h = np.float32(cfg.width), np.float32(cfg.height)
    fov_factor = np.float32(
        1.0 / math.tan(cfg.fov_degrees * (PI / 180.0) / 2.0))
    bg = [float(x) for x in np.asarray(cfg.background, np.float32)]
    stream = torch.cuda.current_stream(device).cuda_stream

    fn = _bind(_build.load())
    err = fn(flat.data_ptr(), *counts, state.data_ptr(), px32.data_ptr(),
             py32.data_ptr(), out.data_ptr(), n,
             spp, cfg.max_bounces, grid_n,
             int(cfg.importance_sampling and meta.has_light),
             int(meta.has_volumes), cfg.rr_start_bounce,
             float(np.float32(cfg.t_min)), float(np.float32(cfg.t_max)),
             float(np.float32(cfg.t_max * 1.01)),
             float(np.float32(cfg.light_sample_prob)), *bg,
             float(w / h), float(fov_factor), float(w), float(h),
             float(np.float32(1.0 / max(grid_n, 1))),
             float(np.float32(1.0 / spp)), stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


class _Megakernel(torch.autograd.Function):
    """Autograd node over the packed tables: forward runs ``run`` (the
    kernel, or its plain version on CPU); backward is not ported yet."""

    @staticmethod
    def forward(ctx, run, *tables):
        return run()

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(_BACKWARD_MISSING)


def path_trace_pixels_megakernel(rand_state, view_matrix, px, py,
                                 scene: SceneData, meta: SceneMeta,
                                 cfg: RenderConfig):
    """Radiance ``[N, 3]`` of pixels (px, py) from PCG states
    ``rand_state`` (int64 in ``[0, 2**32)``), through the megakernel.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.  Asking for gradients raises in backward."""
    tables = pack_tables(scene) + (view_matrix.to(torch.float32),)
    device = px.device
    if device.type == "cpu":
        def run():
            return path_trace_pixels_reference(rand_state, view_matrix, px,
                                               py, scene, meta, cfg)
    elif device.type == "cuda":
        def run():
            return _launch(rand_state, px, py, tables, scene, meta, cfg)
    else:
        raise ValueError(f"megakernel: no route for device {device}")
    return _Megakernel.apply(run, *tables)
