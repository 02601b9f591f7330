"""The port's mesh route against the benchmark's reference for scenes of
many triangles (``benchmark/reference/integrator_mesh.py``), the recipe of
its 81,920-triangle icosphere (``benchmark/scenes/icosphere81k.py``), and
the mesh route's spans and counters (``utils.profiling``).

Above 64 triangles the port takes neither the megakernel nor the dense
sweep: its builder makes an LBVH, and a frame runs the wavefront
integrator with the BVH walk (on CPU tensors the plain skip-link walk).
The reference searches the triangles in blocks in index order; over all
triangles at once (``integrator.py``) it gives the same bits.
"""

import ctypes
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
from tpu_path_tracer_torch.integrator.render import render_frame
from tpu_path_tracer_torch.kernels import _build, megakernel, traversal
from tpu_path_tracer_torch.scene import procedural
from tpu_path_tracer_torch.scene.builder import BRUTE_FORCE_MAX_TRIS
from tpu_path_tracer_torch.utils import profiling

# Radiance: tests/test_pallas.py:52's parity tolerance.  The walk meets
# the triangles in the BVH's order and the reference in the recipe's, so
# on a tie (a ray through a shared edge or corner) each may name the other
# triangle, whose interpolated normal differs from it by rounding.
RAD_TOL = 2e-4
EYE = [0.0, 0.0, 3.2]


def _job(**kw):
    return dict(dict(width=16, height=16, spp=1, bounces=4, nee=True,
                     stratify=False, rr_start=3), **kw)


def _view():
    return torch.as_tensor(rs.target_to(EYE, [0, 0, 0], [0, 1, 0]))


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
    assert not megakernel.supported(scene, meta, cfg)
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
