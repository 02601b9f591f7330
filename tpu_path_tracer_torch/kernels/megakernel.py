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
  Each block writes its sums to a row of its own, and a second kernel
  (:func:`fold_rows`) folds the rows in a fixed order, so the gradients
  have the same bits every run, as the JAX kernel's sequential grid gives.

Routing by scene, decided once per render by :func:`route`: the forward
kernel takes spheres, quads and at most ``MAX_MEGAKERNEL_TRIS`` triangles,
tested one by one from shared memory; and, in a second instantiation
(``megakernel_fwd_bvh_kernel``) behind the same entry point, a scene with a
BVH above that, whose hit search walks the BVH as the traversal kernel
does (``csrc/bvh_walk.cuh``), so a mesh frame is one launch.  The backward
covers only the first kind: training on a BVH scene keeps the wavefront.
Scenes of 65 to 256 triangles (the builder's brute-force sweep, no BVH)
keep the wavefront.

Without gradients, the CUDA route packs a scene's tables once and reuses
the flat buffer while the scene's tensors are unchanged
(:func:`_scene_tables`); the kernel takes the view matrix apart, so no
frame copies the tables.  The BVH's node and triangle rows are packed
with the tables and kept beside them; a refit or an edit repacks.  A
write that leaves a tensor's version counter as it was goes unseen: call
:func:`clear_table_cache` after one.

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
import operator
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import PI, RenderConfig
from ..core.types import SceneData, SceneMeta
from ..utils import profiling

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
# the JAX package's routing (megakernel.py:161).  Above it a scene with a
# BVH takes the forward kernel's BVH variant.
MAX_MEGAKERNEL_TRIS = 64
# Dynamic shared memory a block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232448

# Bounce x sample budget of the differentiable route (megakernel.py:79-82).
# The JAX backward unrolls max_bounces * spp bounce bodies; the CUDA adjoint
# keeps one record per bounce in scratch and has no such limit, but keeps
# the JAX routing until lifting it is measured (ROADMAP).
MAX_UNROLL_BOUNCES = 64

# Words per bounce record of the backward's scratch (csrc/megakernel_bwd.cu).
REC_FIELDS = 14
# Invariants the kernels derive from the tables into shared memory
# (csrc/tracer.cuh prepare_scene): per triangle, per sphere, of the light.
TRI_PRE, SPH_PRE, LIGHT_PRE = 9, 1, 11
# The backward's block, its warps (a gradient table each) and its
# per-thread gradient slots: the widest row (which takes the camera's 12
# entries too) and the light (csrc/megakernel_bwd.cu).
BWD_THREADS = 128
BWD_WARPS = BWD_THREADS // 32
SLOT_FLOATS = TRI_COLS + LIGHT_COLS
# The fold of the block rows: column j of the sum is FOLD_PARTS partial
# sums, part k over rows k, k + FOLD_PARTS, ... in order, then the parts in
# order (csrc/megakernel_bwd.cu fold_part, fold_parts).
FOLD_PARTS = 32


def _table_floats(scene: SceneData) -> int:
    return (scene.spheres.count * SPH_COLS + scene.quads.count * QUAD_COLS
            + scene.triangles.count * TRI_COLS + LIGHT_COLS + CAM_COLS)


def bwd_smem_bytes(scene: SceneData) -> int:
    """Dynamic shared memory of a backward block (``bwd_smem_bytes`` in
    ``csrc/megakernel_bwd.cu``, held to this by a test): the tables and
    their invariants (``scene_floats`` in ``csrc/tracer.cuh``), one table
    of gradients per warp and the threads' slots."""
    invariants = (scene.triangles.count * TRI_PRE
                  + scene.spheres.count * SPH_PRE + LIGHT_PRE)
    return 4 * ((1 + BWD_WARPS) * _table_floats(scene) + invariants
                + SLOT_FLOATS * (BWD_THREADS + 1))


def fwd_bvh_smem_bytes(scene: SceneData) -> int:
    """Dynamic shared memory of a block of the forward kernel's BVH
    variant: the tables without their triangles and their invariants
    (``scene_floats`` of ``bvh_shared_params`` in ``csrc/bvh_walk.cuh``)."""
    return 4 * (scene.spheres.count * (SPH_COLS + SPH_PRE)
                + scene.quads.count * QUAD_COLS + LIGHT_COLS + CAM_COLS
                + LIGHT_PRE)


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
    profiling.count("table_packs")
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


# The tracers a render may take (:func:`route`).
WAVEFRONT, TABLES, BVH = "wavefront", "tables", "bvh"


class Route(NamedTuple):
    """What :func:`route` decided for one render: its tracer
    (``WAVEFRONT``, ``TABLES`` or ``BVH``) and whether autograd records a
    graph through it."""

    tracer: str
    grad: bool


def route(scene: SceneData, meta: SceneMeta, cfg: RenderConfig,
          view_matrix, device, required: bool = False) -> Route:
    """Which tracer takes a render, decided once per call:

    * ``TABLES``: the fused kernel over the scene's tables in shared
      memory (spheres, quads, at most ``MAX_MEGAKERNEL_TRIS`` triangles),
      and with gradients its backward;
    * ``BVH``: the fused kernel whose hit search walks the scene's BVH, for
      a BVH scene above ``MAX_MEGAKERNEL_TRIS`` triangles without
      gradients (the backward does not cover it);
    * ``WAVEFRONT``: the rest: ``cfg.use_megakernel`` off, a scene of 65 to
      256 triangles (no BVH), a scene without primitives, or a BVH scene
      with gradients.

    ``integrator.render.path_trace_pixels`` asks.  With ``required``
    (:func:`path_trace_pixels_megakernel` called as it is) the megakernel
    takes the render whatever ``cfg.use_megakernel`` and the scene's size
    say, and gradients of a BVH scene raise instead.

    A kernel on a device other than the CPU (its plain version) or CUDA
    raises ``ValueError``.  Gradients the backward cannot take raise
    ``NotImplementedError``: of a BVH scene, and of a configuration over
    the unroll budget, since the JAX backward kernel unrolls
    ``max_bounces * spp`` bounce bodies (megakernel.py:756-762)."""
    n_tri = scene.triangles.count
    walks = (n_tri > MAX_MEGAKERNEL_TRIS and meta.traversal == "bvh"
             and scene.bvh is not None)
    if not required and (
            not cfg.use_megakernel or (n_tri > MAX_MEGAKERNEL_TRIS
                                       and not walks)
            or scene.spheres.count + scene.quads.count + n_tri == 0):
        return Route(WAVEFRONT, False)
    grad = _wants_grad(scene, view_matrix)
    if walks and grad and not required:
        return Route(WAVEFRONT, grad)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"megakernel: no route for device {device}")
    if grad and walks:
        raise NotImplementedError(
            f"the megakernel backward takes at most {MAX_MEGAKERNEL_TRIS} "
            f"triangles, not a BVH scene of {n_tri}; "
            f"integrator.render.path_trace_pixels sends training on it "
            f"through the wavefront")
    spp = resolved_spp(cfg)
    if grad and cfg.max_bounces * spp > MAX_UNROLL_BOUNCES:
        raise NotImplementedError(
            f"megakernel backward unrolls max_bounces*spp = "
            f"{cfg.max_bounces * spp} bounce bodies (budget "
            f"{MAX_UNROLL_BOUNCES}); use the wavefront integrator "
            f"(use_megakernel=False) for deep-bounce training")
    return Route(BVH if walks else TABLES, grad)


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


# The last scene whose tables were packed without gradients, per device:
# {device: (stream and light index, the scene's tensors, their stamps,
# the flat tables)}.  A buffer here is never written in place.
_packed = {}


def clear_table_cache():
    """Forget every scene's packed tables, so the next frame of each packs
    anew.  Needed only after a write to a scene tensor that leaves its
    version counter as it was: through ``.data``, a numpy view or a raw
    pointer, or a fused optimizer step (``Adam(fused=True)``) on parameters
    that the scene holds detached (``p.detach()``)."""
    _packed.clear()


def _stamps(scene: SceneData, bvh: bool):
    """The tensors ``pack_tables`` reads from ``scene`` (and, with ``bvh``,
    those of its BVH, which ``traversal.pack_bvh`` reads), and each one's
    version counter and storage; (None, None) where a tensor keeps no
    version counter (an inference tensor) or may be written without
    bumping it: a tensor that requires grad is a parameter, and a fused
    optimizer step (``Adam(fused=True)``) leaves its version as it was.
    Under ``no_grad`` a preview renders such parameters without a graph,
    so the route's own test for gradients does not answer this one."""
    groups = (scene.materials, scene.spheres, scene.quads, scene.triangles)
    tensors = [t for g in groups + ((scene.bvh,) if bvh else ()) for t in g]
    if any(t.is_inference() or t.requires_grad for t in tensors):
        return None, None
    return tensors, [(t._version, t.data_ptr()) for t in tensors]


def _scene_tables(scene: SceneData, device, bvh: bool = False):
    """The scene's tables ``(sph, quad, tri, light)`` flattened into one
    float32 buffer on ``device``, in a tuple; with ``bvh``, followed by the
    BVH's node and triangle rows (``traversal.pack_bvh``).  Packed on a
    miss, and reused while the scene holds the same tensor objects at the
    same versions and storage, with the same light, on the same stream: an
    edit in place bumps a tensor's version and repacks, and so does a new
    scene with equal values, or a refit's new bounds."""
    key = (torch.cuda.current_stream(device).cuda_stream, scene.light_index,
           bvh)
    tensors, stamps = _stamps(scene, bvh)
    held = _packed.get(device)
    if (held is not None and stamps is not None and held[0] == key
            and held[2] == stamps and all(map(operator.is_, held[1],
                                              tensors))):
        profiling.count("table_cache_hits")
        return held[3]
    flat = torch.cat([t.reshape(-1) for t in pack_tables(scene)])
    packed = (flat.to(device=device, dtype=torch.float32),)
    if bvh:
        from . import traversal

        packed += tuple(t.to(device) for t in traversal.pack_bvh(
            scene.bvh, scene.triangles))
    if stamps is None:
        _packed.pop(device, None)
    else:
        _packed[device] = (key, tensors, stamps, packed)
    return packed


def _wants_grad(scene: SceneData, view_matrix) -> bool:
    """Whether autograd records a graph through this render."""
    if not torch.is_grad_enabled():
        return False
    groups = (scene.materials, scene.spheres, scene.quads, scene.triangles)
    return view_matrix.requires_grad or any(
        t.requires_grad for g in groups for t in g
        if isinstance(t, torch.Tensor))


def _int32(x):
    """The uint32 values of an int64 tensor as int32 bit patterns."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = torch.where(x >= 2 ** 31, x - 2 ** 32, x)
    return x.to(torch.int32).contiguous()


def _scalar_args(scene: SceneData, meta: SceneMeta, cfg: RenderConfig,
                 n: int):
    """The launch arguments after the buffers, as the forward and backward
    entry points take them: n, spp, max_bounces, grid_n, use_nee,
    has_volumes, rr_start_bounce, then the float parameters."""
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
    fold = lib.tpt_megakernel_bwd_fold
    if fwd.argtypes is None:
        fwd.argtypes = [p, i, i, i, p, p, p, p] + scalars + [p] * 4
        fwd.restype = ctypes.c_int
        bwd.argtypes = [p, i, i, i, p, p, p, p, p, p] + scalars + [p]
        bwd.restype = ctypes.c_int
        fold.argtypes = [p, i, i, p, p]
        fold.restype = ctypes.c_int
    return fwd, bwd, fold


def _pixels(rand_state, px, py):
    """The int32 state and pixel coordinates every kernel reads."""
    device = px.device
    n = px.shape[0]
    for name, t in (("rand_state", rand_state), ("px", px), ("py", py)):
        if t.device != device or t.shape != (n,):
            raise ValueError(f"{name} must be [{n}] on {device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    return _int32(rand_state), _int32(px), _int32(py)


def _counts(scene: SceneData):
    return (scene.spheres.count, scene.quads.count, scene.triangles.count)


def _check_smem(scene: SceneData, walks: bool):
    """Raise where a block's shared memory cannot hold what the kernel puts
    there: for the BVH variant the tables without their triangles; else
    what the backward's block holds, the forward's budget too."""
    if walks:
        smem = fwd_bvh_smem_bytes(scene)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"the megakernel's BVH variant holds the "
                             f"spheres, quads, light and camera in {smem} "
                             f"bytes of shared memory, at most "
                             f"{MAX_SMEM_BYTES} bytes a block may use")
        return
    smem = bwd_smem_bytes(scene)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"megakernel scene tables take "
                         f"{_table_floats(scene) * 4} bytes; the backward's "
                         f"block holds them, their invariants, their "
                         f"gradients and its threads' slots in {smem} bytes "
                         f"of shared memory, at most {MAX_SMEM_BYTES} bytes "
                         f"a block may use")


def _prepare(rand_state, px, py, tables, scene: SceneData):
    """Device buffers the backward reads, and the forward beside it: the
    flat tables with the view matrix last, and the int32 state and pixel
    coordinates."""
    flat = torch.cat([t.detach().reshape(-1) for t in tables])
    flat = flat.to(device=px.device, dtype=torch.float32).contiguous()
    _check_smem(scene, False)
    return (flat, _counts(scene), *_pixels(rand_state, px, py))


def _launch_fwd(packed, view, state, px32, py32, scene, meta, cfg):
    """Launch the forward kernel on the current stream: ``packed`` is the
    flat tables sph | quad | tri | light, followed, for the BVH variant, by
    the BVH's node and triangle rows; ``view`` holds the 16 floats of the
    view matrix.  Returns ``[N, 3]``."""
    from . import _build

    with profiling.span("megakernel.launch"):
        flat, *bvh_rows = packed
        n = px32.shape[0]
        out = torch.empty((n, 3), dtype=torch.float32, device=px32.device)
        stream = torch.cuda.current_stream(px32.device).cuda_stream
        rows = [t.data_ptr() for t in bvh_rows] or [None, None]
        fwd = _bind(_build.load())[0]
        err = fwd(flat.data_ptr(), *_counts(scene), state.data_ptr(),
                  px32.data_ptr(), py32.data_ptr(), out.data_ptr(),
                  *_scalar_args(scene, meta, cfg, n), view.data_ptr(),
                  *rows, stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    profiling.count("megakernel_fwd_bvh" if bvh_rows else "megakernel_fwd")
    return out


def _launch_bwd_rows(flat, counts, state, px32, py32, grad_out, scene,
                     meta, cfg):
    """Launch the backward kernel on the current stream; returns each
    block's table gradients, ``[blocks, tables]``, for :func:`fold_rows`."""
    from . import _build

    n = px32.shape[0]
    device = px32.device
    grad_out = grad_out.to(device=device, dtype=torch.float32).contiguous()
    if grad_out.shape != (n, 3):
        raise ValueError(f"radiance cotangent must be [{n}, 3], got "
                         f"{tuple(grad_out.shape)}")
    rows = torch.empty((-(-n // BWD_THREADS), flat.numel()),
                       dtype=torch.float32, device=device)
    rec = torch.empty((max(cfg.max_bounces, 1) * REC_FIELDS * n,),
                      dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    bwd = _bind(_build.load())[1]
    err = bwd(flat.data_ptr(), *counts, state.data_ptr(), px32.data_ptr(),
              py32.data_ptr(), grad_out.data_ptr(), rec.data_ptr(),
              rows.data_ptr(), *_scalar_args(scene, meta, cfg, n), stream)
    if err != 0:
        raise RuntimeError(f"megakernel backward launch failed: CUDA error "
                           f"{err}")
    profiling.count("megakernel_bwd")
    return rows


def fold_rows_plain(rows):
    """The fold kernel's plain version: the sum over the rows of ``rows``
    ``[blocks, n]`` in the kernel's order, so of the same bits: part k sums
    rows k, k + FOLD_PARTS, ... in order, then the parts are summed in
    order.  (Zero rows pad the last chunk: a sum that starts at +0 is never
    -0, so adding +0 keeps its bits.)"""
    blocks, n = rows.shape
    pad = rows.new_zeros((-blocks % FOLD_PARTS, n))
    parts = rows.new_zeros((FOLD_PARTS, n))
    for chunk in torch.cat([rows, pad]).view(-1, FOLD_PARTS, n):
        parts += chunk
    out = rows.new_zeros((n,))
    for part in parts:
        out += part
    return out


def fold_rows(rows):
    """The sum over the rows of ``rows`` ``[blocks, n]`` (float32) in a
    fixed order, the backward's sum over its blocks: CPU tensors take the
    plain version, CUDA tensors launch the fold kernel."""
    if rows.device.type == "cpu":
        return fold_rows_plain(rows)
    if rows.device.type != "cuda":
        raise ValueError(f"fold_rows runs on the CPU or a CUDA device, not "
                         f"{rows.device}")
    from . import _build

    rows = rows.to(torch.float32).contiguous()
    blocks, n = rows.shape
    out = torch.empty((n,), dtype=torch.float32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    fold = _bind(_build.load())[2]
    err = fold(rows.data_ptr(), blocks, n, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"backward fold launch failed: CUDA error {err}")
    profiling.count("megakernel_bwd_fold")
    return out


def _launch_bwd(flat, counts, state, px32, py32, grad_out, scene, meta,
                cfg):
    """The backward kernel and its fold on the current stream; returns the
    gradient of ``sum(radiance * grad_out)`` for the flat tables."""
    return fold_rows(_launch_bwd_rows(flat, counts, state, px32, py32,
                                      grad_out, scene, meta, cfg))


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
                                 cfg: RenderConfig, chosen: Route = None):
    """Radiance ``[N, 3]`` of pixels (px, py) from PCG states
    ``rand_state`` (int64 in ``[0, 2**32)``), through the megakernel, by
    the tracer ``chosen`` (:func:`route`; decided here, with ``required``,
    when not given).

    CPU tensors run the plain version, the wavefront, which autograd
    differentiates; CUDA tensors launch the forward kernel, and the
    backward kernel when gradients are taken, or raise.  Asking for
    gradients of a configuration over the unroll budget, or of a scene
    whose BVH the forward walks, raises on both.

    Without gradients the CUDA route reuses the scene's packed tables
    while its tensors are the same objects at the same versions: a write
    that leaves the version as it was (``.data``, a numpy view, a fused
    optimizer step on parameters held detached) goes unseen until
    :func:`clear_table_cache`."""
    if chosen is None:
        chosen = route(scene, meta, cfg, view_matrix, px.device,
                       required=True)
    if px.device.type == "cpu":
        return path_trace_pixels_reference(rand_state, view_matrix, px, py,
                                           scene, meta, cfg)
    return _kernel_route(rand_state, view_matrix, px, py, scene, meta, cfg,
                         chosen)


def _kernel_route(rand_state, view_matrix, px, py, scene: SceneData,
                  meta: SceneMeta, cfg: RenderConfig, chosen: Route = None):
    """The CUDA route of :func:`path_trace_pixels_megakernel` for the
    tracer ``chosen`` (decided here when not given).  Without gradients:
    the scene's tables, and for the BVH variant its BVH's rows, packed once
    per scene, the view matrix apart, and one launch.  With gradients: the
    tables packed through differentiable ops every call, with the view
    last, and the autograd node that launches the forward and the
    backward."""
    if chosen is None:
        chosen = route(scene, meta, cfg, view_matrix, px.device,
                       required=True)
    if view_matrix.shape != (4, 4):
        raise ValueError(f"view_matrix must be [4, 4], got "
                         f"{tuple(view_matrix.shape)}")
    walks = chosen.tracer == BVH
    if not chosen.grad:
        with profiling.span("megakernel.pack_tables"):
            packed = _scene_tables(scene, px.device, walks)
            view = view_matrix.detach().to(device=px.device,
                                           dtype=torch.float32).contiguous()
        with profiling.span("megakernel.prepare"):
            _check_smem(scene, walks)
            state, px32, py32 = _pixels(rand_state, px, py)
        return _launch_fwd(packed, view, state, px32, py32, scene, meta, cfg)
    with profiling.span("megakernel.pack_tables"):
        tables = pack_tables(scene) + (view_matrix.to(torch.float32),)
    with profiling.span("megakernel.prepare"):
        flat, counts, state, px32, py32 = _prepare(rand_state, px, py,
                                                   tables, scene)
    launch = {
        "fwd": lambda: _launch_fwd((flat,), flat[-CAM_COLS:], state, px32,
                                   py32, scene, meta, cfg),
        "bwd": lambda g: _launch_bwd(flat, counts, state, px32, py32, g,
                                     scene, meta, cfg),
        "shapes": [tuple(t.shape) for t in tables],
    }
    return _Megakernel.apply(launch, *tables)
