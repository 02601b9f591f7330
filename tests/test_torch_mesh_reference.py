"""The port's mesh route against the benchmark's reference for scenes of
many triangles (``benchmark/reference/integrator_mesh.py``), the recipe of
its 81,920-triangle icosphere (``benchmark/scenes/icosphere81k.py``), the
mesh route's spans and counters (``utils.profiling``), and the forward
megakernel's BVH variant (built for the CPU) and its routing.

Above 64 triangles the port's builder makes an LBVH.  A frame without
gradients then runs the forward megakernel's BVH variant, whose hit
search walks the BVH (on CPU tensors its plain version, the wavefront
integrator with the plain skip-link walk); training keeps the wavefront
with the BVH walk.  The reference searches the triangles in blocks in
index order; over all triangles at once (``integrator.py``) it gives the
same bits.
"""

import ctypes
import shutil
import types

import numpy as np
import pytest
import torch

from benchmark import system
from benchmark.reference import integrator as ri
from benchmark.reference import integrator_mesh as rm
from benchmark.reference import pcg
from benchmark.reference import scene as rs
from benchmark.scenes import icosphere81k

import tpu_path_tracer_torch as pt
from tpu_path_tracer_torch.core import rng
from tpu_path_tracer_torch.integrator.render import (path_trace_pixels as
                                                     tptp, pixel_grid,
                                                     render_frame)
from tpu_path_tracer_torch.kernels import _build, megakernel, traversal
from tpu_path_tracer_torch.scene import procedural
from tpu_path_tracer_torch.scene.builder import BRUTE_FORCE_MAX_TRIS
from tpu_path_tracer_torch.utils import profiling

from test_torch_traversal import _left_chain
from torch_kernel_route import kernel_route  # noqa: F401

# Radiance: tests/test_pallas.py:52's parity tolerance.  The walk meets
# the triangles in the BVH's order and the reference in the recipe's, so
# on a tie (a ray through a shared edge or corner) each may name the other
# triangle, whose interpolated normal differs from it by rounding.
RAD_TOL = 2e-4
EYE = [0.0, 0.0, 3.2]
MAX_TRIS = megakernel.MAX_MEGAKERNEL_TRIS


def _job(**kw):
    return dict(dict(width=16, height=16, spp=1, bounces=4, nee=True,
                     stratify=False, rr_start=3), **kw)


def _view():
    return torch.as_tensor(rs.target_to(EYE, [0, 0, 0], [0, 1, 0]))


def _tracer(scene, meta, cfg, grad=False, required=False, device="cpu"):
    """The tracer ``megakernel.route`` picks for a render whose view
    matrix requires grad where ``grad`` is set."""
    view = _view().float().requires_grad_(grad)
    return megakernel.route(scene, meta, cfg, view, torch.device(device),
                            required).tracer


@pytest.mark.parametrize("nee", [True, False])
def test_mesh_route_equals_the_blocked_reference(nee):
    """The recipe's room with a 320-triangle icosphere: the port's LBVH
    route (render_frame with use_megakernel set) against the reference's
    blocked search, over two frames."""
    desc = icosphere81k.describe({"subdivisions": 2})
    scene, meta = system.build_scene(desc, "cpu")
    job = _job(nee=nee)
    cfg = system.render_config(job)
    assert scene.triangles.count == 320 > BRUTE_FORCE_MAX_TRIS
    assert meta.traversal == "bvh" and scene.bvh is not None
    assert _tracer(scene, meta, cfg) == megakernel.BVH
    assert _tracer(scene, meta, cfg, grad=True) == megakernel.WAVEFRONT
    ref = rs.build(desc, "cpu")
    pix = torch.arange(job["width"] * job["height"])
    for frame_num in (1, 9):
        fb = torch.zeros((pix.shape[0], 3))
        ours = render_frame(fb, frame_num, True, _view(), scene, meta, cfg)
        theirs = rm.pixels_radiance(pix, frame_num, _view(), ref, job,
                                    tri_block=64)
        assert float(theirs.abs().sum()) > 0
        torch.testing.assert_close(ours, theirs, rtol=RAD_TOL, atol=RAD_TOL)


def _twice(subdivisions):
    """The recipe's room with its icosphere added twice: every hit on the
    sphere is an exact tie between triangle i and i + T/2."""
    desc = icosphere81k.describe({"subdivisions": subdivisions})
    desc["meshes"] = desc["meshes"] * 2
    return desc


@pytest.mark.parametrize("tri_block", [3, 7, 20, 64])
@pytest.mark.parametrize("nee", [True, False])
def test_blocked_reference_equals_the_whole_search(tri_block, nee):
    """At 40 triangles (at most 64, where ``integrator.py``'s broadcast is
    small) the blocked search gives the same winners, the same radiance
    bit for bit and the same work as the search over all triangles at
    once, with block edges inside the mesh and every sphere hit a tie
    across blocks."""
    ref = rs.build(_twice(0), "cpu")
    assert ref.triangles["a"].shape[0] == 40
    job = _job(width=24, bounces=5, nee=nee)
    pix = torch.arange(job["width"] * job["height"])
    whole, blocked = {}, {}
    a = ri.pixels_radiance(pix, 3, _view(), ref, job, whole)
    b = rm.pixels_radiance(pix, 3, _view(), ref, job, tri_block, blocked)
    assert torch.equal(a, b)
    assert {k: int(v) for k, v in whole.items()} == {
        k: int(v) for k, v in blocked.items()}

    state, o, d = ri.camera_rays(pcg.seed(pix, 7), _view(), pix % 24,
                                 pix // 24, 24, 16, torch.float32)
    alive = torch.ones(pix.shape[0], dtype=torch.bool)
    _, p1, i1, _ = ri.find_hit(state, o, d, ref, alive)
    _, p2, i2, _ = rm.find_hit(state, o, d, ref, alive, tri_block)
    tri = p1 == ri.TRIANGLE
    assert tri.any() and torch.equal(p1, p2) and torch.equal(i1, i2)
    assert (i1[tri] < 20).all()  # the earlier of each tied pair


def test_recipe_tessellates_the_icosphere():
    """Six subdivisions: 81,920 triangles over 40,962 distinct vertices,
    every vertex at radius 0.8 (float32 rounding of 0.8 times a unit
    vector, well inside 1e-6), unit smooth normals; the port's own
    ``procedural.icosphere(6, 0.8)`` gives the same bits."""
    vertices, normals = icosphere81k.icosphere(6, 0.8)
    assert vertices.shape == normals.shape == (3 * 81920, 3)
    assert len(np.unique(vertices, axis=0)) == 40962
    radius = np.linalg.norm(vertices.astype(np.float64), axis=1)
    assert np.abs(radius - 0.8).max() < 1e-6
    length = np.linalg.norm(normals.astype(np.float64), axis=1)
    assert np.abs(length - 1.0).max() < 1e-6
    mesh = procedural.icosphere(6, 0.8)
    assert np.array_equal(vertices, mesh.vertices)
    assert np.array_equal(normals, mesh.normals)
    desc = icosphere81k.describe({})
    assert len(desc["meshes"]) == 1 and len(desc["quads"]) == 3
    assert desc["meshes"][0]["vertices"].shape == (3 * 81920, 3)


@pytest.fixture
def walk_route(monkeypatch):
    """The BVH walk's CUDA route (``traversal._launch``) on CPU tensors,
    its kernel a stand-in that reports a miss on every lane: the packing
    runs in its plain version and everything else as on the card."""
    def walk(*args):
        n, t_out, idx_out = args[5], args[8], args[9]
        np.ctypeslib.as_array((ctypes.c_float * n).from_address(
            t_out)).fill(np.inf)
        ctypes.memset(idx_out, 0xFF, 4 * n)
        return 0

    def closest_hit(origin, direction, bvh, tris, t_min, t_best0, _):
        return traversal._launch(origin, direction, bvh, tris, t_min,
                                 t_best0)

    monkeypatch.setattr(traversal, "bvh_closest_hit", closest_hit)
    monkeypatch.setattr(_build, "load", lambda: None)
    monkeypatch.setattr(traversal, "_bind", lambda lib: walk)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("route", ["walk", "plain"])
def test_mesh_frame_spans_and_counters(route, request):
    """A mesh frame records ``wavefront.trace`` inside ``renderer.step``,
    and, on the walk's CUDA route, ``traversal.pack`` then
    ``traversal.launch`` directly inside it once a bounce; every bounce
    counts ``wavefront_bounces``, every walk ``bvh_closest_hit``."""
    if route == "walk":
        request.getfixturevalue("walk_route")
    desc = icosphere81k.describe({"subdivisions": 2})
    scene, meta = system.build_scene(desc, "cpu")
    cfg = system.render_config(_job(width=8, height=4, bounces=3))
    r = pt.Renderer(scene, meta, cfg, camera=pt.Camera(eye=EYE))
    profiling.reset()
    with profiling.recording():
        for _ in range(2):
            r.step()
            r.display()
    spans = profiling.spans()
    traces = [i for i, s in enumerate(spans) if s.name == "wavefront.trace"]
    assert len(traces) == 2
    walk = ["traversal.pack", "traversal.launch"] * 3
    for i in traces:
        assert spans[spans[i].parent].name == "renderer.step"
        children = [s.name for s in spans if s.parent == i]
        assert children == (walk if route == "walk" else [])
    counts = profiling.counts()
    assert counts["wavefront_bounces"] == 2 * 3
    assert counts["bvh_closest_hit"] == (6 if route == "walk" else 0)
    assert counts["bvh_pack"] == 0  # the plain packing launches nothing
    profiling.reset()


# ------------------------------------- the forward megakernel's BVH variant


def _chain_scene():
    """The recipe's room (no icosphere) with a hand-built tree as deep as
    the walk's stack: ``test_torch_traversal._left_chain``'s 65 triangles
    at z = -0.01 j over x, y in [0, 1], white, facing +z.  A ray that
    enters the common box pushes every right leaf."""
    desc = icosphere81k.describe({"subdivisions": 0})
    desc["meshes"] = []
    scene, meta = system.build_scene(desc, "cpu")
    _, _, bvh, tris = _left_chain(traversal.STACK_DEPTH)
    up = torch.zeros_like(tris.a)
    up[:, 2] = 1.0
    white = [m["name"] for m in desc["materials"]].index("white")
    tris = tris._replace(na=up, nb=up, nc=up.clone(),
                         material_id=torch.full_like(tris.material_id,
                                                     white))
    meta = pt.SceneMeta(has_volumes=meta.has_volumes, traversal="bvh",
                        max_leaf=1, has_light=meta.has_light)
    return scene._replace(triangles=tris, bvh=bvh), meta


def _bvh_scene(name):
    if name == "chain":
        return _chain_scene()
    desc = (icosphere81k.describe({"subdivisions": 2}) if name == "room"
            else _twice(2))
    return system.build_scene(desc, "cpu")


@pytest.fixture(scope="module")
def host_tracer(tmp_path_factory):
    """``traversal.cu`` built for the CPU: its host entry point
    ``tpt_megakernel_fwd_host``, the forward kernel's entry point on the
    CPU (the BVH variant where it is given the BVH's rows, the
    shared-memory variant where they are null)."""
    if shutil.which("g++") is None:
        pytest.skip("needs a C++ compiler (g++)")
    walk = _build.load_host_walk(
        build_dir=tmp_path_factory.mktemp("host_bvh"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    walk.tpt_megakernel_fwd_host.argtypes = (
        [p, i, i, i] + [p] * 4 + [i] * 7 + [f] * 13 + [p] * 3)
    walk.tpt_megakernel_fwd_host.restype = None
    return walk.tpt_megakernel_fwd_host


# With NEE the tracer's light-plane and pdf arithmetic rounds a few lanes
# a few ULP away from the wavefront's torch operations (the shared-memory
# variant does so on the Cornell box too: test_torch_render's
# test_forward_kernel_source_on_cpu); the hit search does not.
NEE_TOL = 2e-6


@pytest.mark.parametrize("nee", [True, False])
@pytest.mark.parametrize("name", ["room", "twice", "chain"])
def test_bvh_megakernel_source_on_cpu(host_tracer, name, nee):
    """The forward kernel's BVH variant (``csrc/megakernel_fwd.cu``'s
    tracer with ``bvh_walk.cuh``'s hit search, built for the CPU) over the
    recipe's room at 320 triangles, the same with the icosphere added
    twice (every sphere hit an exact tie) and a tree as deep as the
    walk's stack: on frames 1 and 9 at 16x16, the same bits as the
    shared-memory variant's triangle loop, and the wavefront's radiance,
    bit for bit without NEE and within ``NEE_TOL`` with it."""
    scene, meta = _bvh_scene(name)
    cfg = system.render_config(_job(nee=nee))
    assert _tracer(scene, meta, cfg) == megakernel.BVH
    view = _view().to(torch.float32).contiguous()
    pix, px, py = pixel_grid(16, 16, "cpu")
    n = pix.shape[0]
    flat = torch.cat([t.reshape(-1) for t in megakernel.pack_tables(scene)])
    rows, tri_rows = traversal.pack_bvh(scene.bvh, scene.triangles)
    args = megakernel._scalar_args(scene, meta, cfg, n)
    for frame_num in (1, 9):
        state = rng.seed(pix, frame_num)
        ref = megakernel.path_trace_pixels_reference(
            state, view, px, py, scene, meta, cfg)
        st, x, y = megakernel._pixels(state, px, py)
        got, loop = torch.empty((n, 3)), torch.empty((n, 3))
        for out, bvh_rows in ((got, (rows, tri_rows)), (loop, None)):
            host_tracer(flat.data_ptr(), *megakernel._counts(scene),
                        st.data_ptr(), x.data_ptr(), y.data_ptr(),
                        out.data_ptr(), *args, view.data_ptr(),
                        *([t.data_ptr() for t in bvh_rows] if bvh_rows
                          else [None, None]))
        assert float(ref.abs().sum()) > 0
        assert torch.equal(got.view(torch.int32), loop.view(torch.int32))
        if nee:
            torch.testing.assert_close(got, ref, rtol=NEE_TOL, atol=NEE_TOL)
        else:
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def _route_frames(scene, meta, cfg, frames=3):
    fb = torch.zeros((cfg.width * cfg.height, 3))
    for k in range(1, frames + 1):
        render_frame(fb, k, k == 1, _view(), scene, meta, cfg)


def test_bvh_scene_takes_the_kernel_route(kernel_route, monkeypatch):
    """A BVH scene without gradients takes the megakernel's route with the
    BVH variant: three frames launch it three times, pack the tables and
    the BVH's rows once and reuse them (the same buffers), hand it the
    tables without a copy of the view, and step no wavefront bounce."""
    packs = []

    def pack_bvh(bvh, tris):
        packs.append(bvh)
        return traversal.pack_bvh_plain(bvh, tris)

    monkeypatch.setattr(traversal, "pack_bvh", pack_bvh)
    scene, meta = _bvh_scene("room")
    cfg = system.render_config(_job(width=8, height=4))
    profiling.reset()
    _route_frames(scene, meta, cfg)
    counts = profiling.counts()
    assert len(kernel_route) == 3 and len(kernel_route.bvh) == 3
    assert len(packs) == 1
    assert len(set(kernel_route.bvh)) == 1
    assert (counts["table_packs"], counts["table_cache_hits"]) == (1, 2)
    assert counts["wavefront_bounces"] == 0
    fresh = torch.cat([t.reshape(-1) for t in megakernel.pack_tables(scene)]
                      + [_view().reshape(-1).float()])
    for flat in kernel_route:
        assert torch.equal(flat, fresh)
    profiling.reset()


def test_bvh_scene_with_gradients_takes_the_wavefront(kernel_route):
    """The same scene with an emission that requires grad: the frame runs
    the wavefront with the BVH walk (no launch), and the gradient
    reaches the parameter."""
    scene, meta = _bvh_scene("room")
    emission = scene.materials.emission.clone().requires_grad_()
    scene = scene._replace(
        materials=scene.materials._replace(emission=emission))
    cfg = system.render_config(_job(width=8, height=4))
    assert _tracer(scene, meta, cfg) == megakernel.WAVEFRONT
    profiling.reset()
    fb = render_frame(torch.zeros((32, 3)), 1, True, _view(), scene, meta,
                      cfg)
    assert len(kernel_route) == 0
    assert profiling.counts()["wavefront_bounces"] == cfg.max_bounces
    fb.sum().backward()
    assert emission.grad is not None and float(emission.grad.abs().sum()) > 0
    pix, px, py = pixel_grid(2, 2, "cpu")
    with pytest.raises(NotImplementedError, match="BVH scene of 320"):
        megakernel.path_trace_pixels_megakernel(
            rng.seed(pix, 1), _view(), px, py, scene, meta, cfg)
    profiling.reset()


def test_brute_force_scene_takes_the_wavefront(kernel_route):
    """A scene of 65-256 triangles has no BVH (the builder's brute-force
    sweep): the megakernel does not take it, with gradients or without."""
    scene, meta = system.build_scene(
        icosphere81k.describe({"subdivisions": 1}), "cpu")
    assert MAX_TRIS < scene.triangles.count <= BRUTE_FORCE_MAX_TRIS
    assert meta.traversal == "brute" and scene.bvh is None
    cfg = system.render_config(_job(width=8, height=4))
    assert _tracer(scene, meta, cfg) == megakernel.WAVEFRONT
    profiling.reset()
    _route_frames(scene, meta, cfg, frames=2)
    assert len(kernel_route) == 0
    assert profiling.counts()["wavefront_bounces"] == 2 * cfg.max_bounces
    profiling.reset()


def _route_scene(name):
    if name == "cornell":
        return pt.builtin.cornell_box(device="cpu")[:2]
    if name == "brute":
        return system.build_scene(
            icosphere81k.describe({"subdivisions": 1}), "cpu")
    return _bvh_scene(name)


DEEP = {"max_bounces": megakernel.MAX_UNROLL_BOUNCES + 1}
# name: (scene, config changes, gradients, required, device, the tracer or
# the error raised).
ROUTE_CASES = {
    "tables": ("cornell", {}, False, False, "cpu", megakernel.TABLES),
    "tables_grad": ("cornell", {}, True, False, "cpu", megakernel.TABLES),
    "off": ("cornell", {"use_megakernel": False}, True, False, "cpu",
            megakernel.WAVEFRONT),
    "deep": ("cornell", DEEP, False, False, "cpu", megakernel.TABLES),
    "deep_grad": ("cornell", DEEP, True, False, "cpu",
                  (NotImplementedError, "65 bounce bodies")),
    "no_device": ("cornell", {}, False, False, "meta",
                  (ValueError, "no route for device meta")),
    "bvh": ("room", {}, False, False, "cpu", megakernel.BVH),
    "bvh_grad": ("room", {}, True, False, "cpu", megakernel.WAVEFRONT),
    "bvh_grad_required": ("room", {}, True, True, "cpu",
                          (NotImplementedError, "BVH scene of 320")),
    "brute": ("brute", {}, False, False, "cpu", megakernel.WAVEFRONT),
    "brute_grad": ("brute", {}, True, False, "cpu", megakernel.WAVEFRONT),
    "brute_required": ("brute", {}, False, True, "cpu", megakernel.TABLES),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_decides_the_tracer_once(case, monkeypatch):
    """``megakernel.route`` picks the tracer of each kind of render, or
    raises what the route raises; ``path_trace_pixels`` on CPU tensors
    (``path_trace_pixels_megakernel`` where the megakernel is required)
    asks it once and finds out at most once whether gradients are
    wanted."""
    name, changes, grad, required, device, want = ROUTE_CASES[case]
    scene, meta = _route_scene(name)
    cfg = system.render_config(_job(width=2, height=2)).replace(**changes)
    if isinstance(want, tuple):
        with pytest.raises(want[0], match=want[1]):
            _tracer(scene, meta, cfg, grad, required, device)
        return
    assert _tracer(scene, meta, cfg, grad, required, device) == want
    asked = []
    wants_grad = megakernel._wants_grad
    monkeypatch.setattr(megakernel, "_wants_grad",
                        lambda *a: asked.append(a) or wants_grad(*a))
    pix, px, py = pixel_grid(2, 2, "cpu")
    args = (rng.seed(pix, 1), _view().float().requires_grad_(grad), px, py,
            scene, meta, cfg)
    rad = (megakernel.path_trace_pixels_megakernel(*args) if required
           else tptp(*args)[1])
    assert rad.shape == (4, 3) and rad.requires_grad == grad
    assert len(asked) == (0 if case in ("off", "brute", "brute_grad")
                          else 1)
