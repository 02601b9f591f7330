"""Fused path-tracing megakernel: the whole trace of a frame in one launch,
and its gradient in a second.

Port of ``tpu_path_tracer/kernels/pallas/megakernel.py``.  Both kernels are
CUDA C++ built by ``kernels._build`` and share one tracer body
(``csrc/tracer.cuh``): one thread per pixel runs camera ray generation, the
sample and bounce loops, the hit search over the packed scene tables,
shading and Russian roulette, so ray state never leaves registers.

* forward (``csrc/megakernel_fwd.cu``, the JAX ``_fwd_call``): radiance
  ``[N, 3]``;
* backward (``csrc/megakernel_bwd.cu``, the JAX ``_bwd_call``): a
  hand-written adjoint that replays the same PCG stream and returns the
  gradients of the five packed tables; ``pack_tables``' torch ops carry
  them to the scene tensors, as the JAX custom VJP ``_megakernel`` does.

Their contract is the JAX kernel's (``megakernel.py:23-28``): draw for draw
the same PCG stream and bounce algebra as the wavefront integrator, which
is therefore the plain version of both (:func:`path_trace_pixels_reference`
and :func:`vjp_reference`).

Routing, with no fallback: a CPU tensor takes the plain version (the
wavefront, differentiable by autograd); a CUDA tensor launches the kernels
or raises, and a backward that cannot launch raises too.
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

# Bounce x sample budget of the differentiable route (megakernel.py:79-82).
# The JAX backward unrolls max_bounces * spp bounce bodies; the CUDA adjoint
# keeps one record per bounce in scratch and has no such limit, but keeps
# the JAX routing until lifting it is measured (ROADMAP).
MAX_UNROLL_BOUNCES = 64

# Launches of the CUDA kernels in this process: the forward and the
# backward.
LAUNCHES = 0
BWD_LAUNCHES = 0

# Words per bounce record of the backward's scratch (csrc/megakernel_bwd.cu).
REC_FIELDS = 14
# Invariants the kernels derive from the tables into shared memory
# (csrc/tracer.cuh prepare_scene): per triangle, per sphere, of the light.
TRI_PRE, SPH_PRE, LIGHT_PRE = 9, 1, 11
# The backward's block and its per-thread gradient slots: the widest row,
# the light and the camera's 12 entries (csrc/megakernel_bwd.cu).
BWD_THREADS = 128
SLOT_FLOATS = TRI_COLS + LIGHT_COLS + 12


def _table_floats(scene: SceneData) -> int:
    return (scene.spheres.count * SPH_COLS + scene.quads.count * QUAD_COLS
            + scene.triangles.count * TRI_COLS + LIGHT_COLS + CAM_COLS)


def bwd_smem_bytes(scene: SceneData) -> int:
    """Dynamic shared memory of a backward block (``bwd_smem_bytes`` in
    ``csrc/megakernel_bwd.cu``, held to this by a test): the tables and
    their invariants (``scene_floats`` in ``csrc/tracer.cuh``), the block's
    table gradients and the threads' slots."""
    invariants = (scene.triangles.count * TRI_PRE
                  + scene.spheres.count * SPH_PRE + LIGHT_PRE)
    return 4 * (2 * _table_floats(scene) + invariants
                + SLOT_FLOATS * (BWD_THREADS + 1))


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


def vjp_supported(scene: SceneData, meta: SceneMeta,
                  cfg: RenderConfig) -> bool:
    """Whether the differentiable megakernel route applies: the JAX
    backward kernel unrolls ``max_bounces * spp`` bounce bodies, so deep
    configurations keep the wavefront (megakernel.py:756-762)."""
    return (supported(scene, meta, cfg)
            and cfg.max_bounces * resolved_spp(cfg) <= MAX_UNROLL_BOUNCES)


def path_trace_pixels_reference(rand_state, view_matrix, px, py,
                                 scene: SceneData, meta: SceneMeta,
                                 cfg: RenderConfig):
    """The forward kernel's plain version: the port's wavefront
    ``integrator.render.path_trace_pixels``.  Returns radiance ``[N, 3]``,
    differentiable by autograd."""
    from ..integrator.render import path_trace_pixels

    _, radiance = path_trace_pixels(rand_state, view_matrix, px, py, scene,
                                    meta, cfg.replace(use_megakernel=False))
    return radiance


def vjp_reference(rand_state, view_matrix, px, py, scene: SceneData,
                  meta: SceneMeta, cfg: RenderConfig, grad_radiance,
                  inputs):
    """The backward kernel's plain version, for tests and
    ``chip_smoke.py``: autograd of the wavefront.  Returns the gradients of
    ``sum(radiance * grad_radiance)`` with respect to ``inputs`` (tensors
    the scene or ``view_matrix`` were built from, e.g. the parameters
    given to ``diff.params.apply_params``); None where one gets none."""
    radiance = path_trace_pixels_reference(rand_state, view_matrix, px, py,
                                           scene, meta, cfg)
    return torch.autograd.grad(radiance, list(inputs), grad_radiance,
                               allow_unused=True)


def _wants_grad(scene: SceneData, view_matrix) -> bool:
    """Whether autograd records a graph through this render."""
    if not torch.is_grad_enabled():
        return False
    groups = (scene.materials, scene.spheres, scene.quads, scene.triangles)
    return view_matrix.requires_grad or any(
        t.requires_grad for g in groups for t in g
        if isinstance(t, torch.Tensor))


def _check_unroll_budget(cfg: RenderConfig):
    spp = resolved_spp(cfg)
    if cfg.max_bounces * spp > MAX_UNROLL_BOUNCES:
        raise NotImplementedError(
            f"megakernel backward unrolls max_bounces*spp = "
            f"{cfg.max_bounces * spp} bounce bodies (budget "
            f"{MAX_UNROLL_BOUNCES}); use the wavefront integrator "
            f"(use_megakernel=False) for deep-bounce training")


def _int32(x):
    """The uint32 values of an int64 tensor as int32 bit patterns."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = torch.where(x >= 2 ** 31, x - 2 ** 32, x)
    return x.to(torch.int32).contiguous()


def _scalar_args(scene: SceneData, meta: SceneMeta, cfg: RenderConfig,
                 n: int):
    """The launch arguments after the buffers, as both C entry points
    take them: n, spp, max_bounces, grid_n, use_nee, has_volumes,
    rr_start_bounce, then the float parameters."""
    spp = resolved_spp(cfg)
    grid_n = max(int(cfg.samples_per_pixel ** 0.5), 1) if cfg.stratify else 0
    w, h = np.float32(cfg.width), np.float32(cfg.height)
    fov_factor = np.float32(
        1.0 / math.tan(cfg.fov_degrees * (PI / 180.0) / 2.0))
    bg = [float(x) for x in np.asarray(cfg.background, np.float32)]
    return (n, spp, cfg.max_bounces, grid_n,
            int(cfg.importance_sampling and meta.has_light),
            int(meta.has_volumes), cfg.rr_start_bounce,
            float(np.float32(cfg.t_min)), float(np.float32(cfg.t_max)),
            float(np.float32(cfg.t_max * 1.01)),
            float(np.float32(cfg.light_sample_prob)), *bg,
            float(w / h), float(fov_factor), float(w), float(h),
            float(np.float32(1.0 / max(grid_n, 1))),
            float(np.float32(1.0 / spp)))


def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    scalars = [i] * 7 + [f] * 13
    fwd, bwd = lib.tpt_megakernel_fwd, lib.tpt_megakernel_bwd
    if fwd.argtypes is None:
        fwd.argtypes = [p, i, i, i, p, p, p, p] + scalars + [p]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [p, i, i, i, p, p, p, p, p, p] + scalars + [p]
        bwd.restype = ctypes.c_int
    return fwd, bwd


def _prepare(rand_state, px, py, tables, scene: SceneData):
    """Device buffers both kernels read: the flat tables and the int32
    state and pixel coordinates."""
    device = px.device
    n = px.shape[0]
    flat = torch.cat([t.detach().reshape(-1) for t in tables])
    flat = flat.to(device=device, dtype=torch.float32).contiguous()
    smem = bwd_smem_bytes(scene)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"megakernel scene tables take {flat.numel() * 4} "
                         f"bytes; the backward's block holds them, their "
                         f"invariants, their gradients and its threads' "
                         f"slots in {smem} bytes of shared memory, at most "
                         f"{MAX_SMEM_BYTES} bytes a block may use")
    for name, t in (("rand_state", rand_state), ("px", px), ("py", py)):
        if t.device != device or t.shape != (n,):
            raise ValueError(f"{name} must be [{n}] on {device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    counts = (scene.spheres.count, scene.quads.count, scene.triangles.count)
    return flat, counts, _int32(rand_state), _int32(px), _int32(py)


def _launch_fwd(flat, counts, state, px32, py32, scene, meta, cfg):
    """Launch the forward kernel on the current stream; returns
    ``[N, 3]``."""
    global LAUNCHES
    from . import _build

    n = px32.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=px32.device)
    stream = torch.cuda.current_stream(px32.device).cuda_stream
    fwd, _ = _bind(_build.load())
    err = fwd(flat.data_ptr(), *counts, state.data_ptr(), px32.data_ptr(),
              py32.data_ptr(), out.data_ptr(),
              *_scalar_args(scene, meta, cfg, n), stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def _launch_bwd(flat, counts, state, px32, py32, grad_out, scene, meta,
                cfg):
    """Launch the backward kernel on the current stream; returns the
    gradient of ``sum(radiance * grad_out)`` for the flat tables."""
    global BWD_LAUNCHES
    from . import _build

    n = px32.shape[0]
    device = px32.device
    grad_out = grad_out.to(device=device, dtype=torch.float32).contiguous()
    if grad_out.shape != (n, 3):
        raise ValueError(f"radiance cotangent must be [{n}, 3], got "
                         f"{tuple(grad_out.shape)}")
    grad = torch.zeros_like(flat)
    rec = torch.empty((max(cfg.max_bounces, 1) * REC_FIELDS * n,),
                      dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    _, bwd = _bind(_build.load())
    err = bwd(flat.data_ptr(), *counts, state.data_ptr(), px32.data_ptr(),
              py32.data_ptr(), grad_out.data_ptr(), rec.data_ptr(),
              grad.data_ptr(), *_scalar_args(scene, meta, cfg, n), stream)
    if err != 0:
        raise RuntimeError(f"megakernel backward launch failed: CUDA error "
                           f"{err}")
    BWD_LAUNCHES += 1
    return grad


class _Megakernel(torch.autograd.Function):
    """Autograd node over the packed tables (the JAX custom VJP
    ``_megakernel``): forward launches the forward kernel, backward the
    adjoint kernel, which returns one gradient per table."""

    @staticmethod
    def forward(ctx, launch, *tables):
        ctx.launch = launch
        return launch["fwd"]()

    @staticmethod
    def backward(ctx, grad):
        flat_grad = ctx.launch["bwd"](grad)
        grads, k = [], 0
        for shape in ctx.launch["shapes"]:
            size = math.prod(shape)
            grads.append(flat_grad[k:k + size].reshape(shape))
            k += size
        return (None, *grads)


def path_trace_pixels_megakernel(rand_state, view_matrix, px, py,
                                 scene: SceneData, meta: SceneMeta,
                                 cfg: RenderConfig):
    """Radiance ``[N, 3]`` of pixels (px, py) from PCG states
    ``rand_state`` (int64 in ``[0, 2**32)``), through the megakernel.

    CPU tensors run the plain version, the wavefront, which autograd
    differentiates; CUDA tensors launch the forward kernel, and the
    backward kernel when gradients are taken, or raise.  Asking for
    gradients of a configuration over the unroll budget raises on both."""
    if _wants_grad(scene, view_matrix):
        _check_unroll_budget(cfg)
    device = px.device
    if device.type == "cpu":
        return path_trace_pixels_reference(rand_state, view_matrix, px, py,
                                           scene, meta, cfg)
    if device.type != "cuda":
        raise ValueError(f"megakernel: no route for device {device}")
    tables = pack_tables(scene) + (view_matrix.to(torch.float32),)
    flat, counts, state, px32, py32 = _prepare(rand_state, px, py, tables,
                                               scene)
    launch = {
        "fwd": lambda: _launch_fwd(flat, counts, state, px32, py32, scene,
                                   meta, cfg),
        "bwd": lambda g: _launch_bwd(flat, counts, state, px32, py32, g,
                                     scene, meta, cfg),
        "shapes": [tuple(t.shape) for t in tables],
    }
    return _Megakernel.apply(launch, *tables)
