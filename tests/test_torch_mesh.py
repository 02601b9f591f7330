"""Port parity, mesh layer: OBJ files and procedural meshes, the BVH
builders, the BVH walk and its CUDA kernel's source, the refit, and a BVH
scene's render and vertex gradients, against the JAX package.

Inputs are made with numpy from fixed seeds and fed to both packages.  The
JAX functions run op by op (``jax.disable_jit``), where they round every
operation as the port does.  Traversal is held to the ROADMAP's contract,
the same hit and triangle index on every lane; here, on the CPU, t is
equal bit for bit.  Radiance: rtol = atol = 2e-4 (``tests/test_pallas.py:
52``).

Tests that need an NVIDIA GPU carry the ``cuda`` marker and skip here;
``python3 chip_smoke.py`` runs the traversal kernel against its plain
version on the card.
"""

import ctypes
import dataclasses
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_path_tracer as tpt
from tpu_path_tracer.accel import bvh as jbvh
from tpu_path_tracer.accel import native as jnative
from tpu_path_tracer.accel.refit import refit_bvh as jrefit
from tpu_path_tracer.core import rng as jrng
from tpu_path_tracer.diff import params as jparams
from tpu_path_tracer.integrator.render import path_trace_pixels as jptp
from tpu_path_tracer.kernels import traversal as jtrav
from tpu_path_tracer.scene import objreader as jobj
from tpu_path_tracer.scene import procedural as jproc

import tpu_path_tracer_torch as pt
from chip_smoke import traversal_rays
from tpu_path_tracer_torch.accel import bvh as tbvh
from tpu_path_tracer_torch.accel import native as tnative
from tpu_path_tracer_torch.accel.refit import refit_bvh as trefit
from tpu_path_tracer_torch.core import rng as trng
from tpu_path_tracer_torch.diff import params as tparams
from tpu_path_tracer_torch.integrator.render import (path_trace_pixels as
                                                     tptp, pixel_grid)
from tpu_path_tracer_torch.kernels import _build, intersect, traversal
from tpu_path_tracer_torch.scene import builder as tbuilder
from tpu_path_tracer_torch.scene import objreader as tobj
from tpu_path_tracer_torch.scene import procedural as tproc
from tpu_path_tracer_torch.utils import profiling

from test_bvh import check_invariants, random_triangles

RAD_TOL = 2e-4       # tests/test_pallas.py:52
GRAD_RTOL = 1e-3     # tests/test_grad.py:238
T_MIN = 1e-4         # tests/test_pallas.py:277


def _needs_native():
    if not (tnative.available() and jnative.available()):
        pytest.skip("needs a C++ compiler (g++) for the native builders")


def _mesh_builder(pkg, mesh_jax, mesh_port):
    """One white mesh (the JAX package's MeshData for JAX, the port's for
    the port) beside an emissive quad."""
    b = pkg.SceneBuilder()
    white = b.add_material("white", pkg.LAMBERTIAN, [0.73, 0.73, 0.73])
    light = b.add_material("light", pkg.LAMBERTIAN, [0, 0, 0],
                           emission=(5, 5, 5))
    b.add_quad([-2, 2, -2], [4, 0, 0], [0, 0, 4], light)
    b.add_mesh(mesh_jax if pkg is tpt else mesh_port, white)
    return b


def _both_scenes(make_mesh, bvh, **kw):
    """The same mesh scene built by both packages (the port's on the
    CPU)."""
    jscene, jmeta = _mesh_builder(tpt, make_mesh(jproc), None).build(
        bvh=bvh, **kw)
    tscene, tmeta = _mesh_builder(pt, None, make_mesh(tproc)).build(
        bvh=bvh, device="cpu", **kw)
    return jscene, jmeta, tscene, tmeta


def _plate_and_sphere(proc):
    """A genus-1 plate and an icosphere in one mesh: non-convex topology
    and a fine tessellation."""
    plate = proc.plate_with_hole()
    ico = proc.icosphere(2, 0.5)
    return type(plate)(
        vertices=np.concatenate([plate.vertices, ico.vertices + 0.3]),
        normals=np.concatenate([plate.normals, ico.normals]))


# ---------------------------------------------------------------- builders


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("method", ["median", "sah", "lbvh"])
def test_bvh_and_triangle_order_equal_jax(method, native, monkeypatch):
    """The scene's FlatBVH arrays, triangle order and meta are the JAX
    package's, array for array, with the native builders on both sides and
    with the NumPy builders on both sides."""
    if native:
        _needs_native()
    else:
        monkeypatch.setenv("TPT_NO_NATIVE", "1")
        monkeypatch.setattr(tbuilder, "build_bvh_native",
                            lambda *args: None)
    jscene, jmeta, tscene, tmeta = _both_scenes(_plate_and_sphere, method,
                                                max_leaf=3)
    assert dataclasses.asdict(tmeta) == dataclasses.asdict(jmeta)
    assert tmeta.traversal == "bvh"
    for f in pt.FlatBVH._fields:
        np.testing.assert_array_equal(getattr(tscene.bvh, f).numpy(),
                                      np.asarray(getattr(jscene.bvh, f)),
                                      err_msg=f)
    for f in pt.Triangles._fields:
        np.testing.assert_array_equal(getattr(tscene.triangles, f).numpy(),
                                      np.asarray(getattr(jscene.triangles, f)),
                                      err_msg=f)


@pytest.mark.parametrize("builder,kw", [
    ("median", {}),
    ("sah", {"max_leaf": 8}),
    ("lbvh", {"leaf_size": 4}),
])
def test_port_build_invariants(builder, kw):
    """tests/test_bvh.py's invariants on the port's NumPy builders, and
    the same arrays as the JAX package's builders."""
    a, b, c = random_triangles(257, seed=3)
    mins, maxs = tbvh.triangle_aabbs(a, b, c)
    arrs = tbvh.BUILDERS[builder](mins, maxs, **kw)
    check_invariants(arrs, 257)
    ref = jbvh.BUILDERS[builder](*jbvh.triangle_aabbs(a, b, c), **kw)
    for f in tbvh.FlatBVHArrays._fields:
        np.testing.assert_array_equal(getattr(arrs, f), getattr(ref, f),
                                      err_msg=f)


def test_port_median_leaf_is_single_primitive():
    a, b, c = random_triangles(64, seed=1)
    arrs = tbvh.build_median(*tbvh.triangle_aabbs(a, b, c))
    leaves = arrs.right < 0
    assert (arrs.prim_count[leaves] == 1).all()
    assert leaves.sum() == 64
    assert len(arrs.mins) == 127  # 2n-1 nodes


def test_native_library_name_depends_on_host_cpu():
    """The native library is built with -march=native, so its name carries
    the host's CPU: two hosts' target options give two libraries, and a
    library built on one host is never loaded on another."""
    a = tnative.library_path("-march= \t\tskylake-avx512\n")
    b = tnative.library_path("-march= \t\tznver3\n")
    assert a != b and a.parent == b.parent == tnative.BUILD_DIR
    assert a.name.startswith("libtptbvh_") and a.suffix == ".so"
    gxx = shutil.which("g++")
    if gxx is not None:
        key = tnative.host_key(gxx)
        assert "-march=" in key
        assert tnative.library_path(key) not in (a, b)


def test_port_native_builders_match_numpy():
    """tests/test_renderer.py::test_native_builders_match_numpy on the
    port's native library: the invariants for every method, and the median
    split's node count (native and NumPy median need not agree beyond
    it)."""
    _needs_native()
    r = np.random.default_rng(5)
    a = r.uniform(-5, 5, (500, 3)).astype(np.float32)
    b = a + r.uniform(-1, 1, (500, 3)).astype(np.float32)
    c = a + r.uniform(-1, 1, (500, 3)).astype(np.float32)
    mins, maxs = tbvh.triangle_aabbs(a, b, c)
    for method, leaf in [("median", 1), ("sah", 8), ("lbvh", 4)]:
        check_invariants(tnative.build_bvh_native(method, mins, maxs, leaf),
                         500)
    arrs = tnative.build_bvh_native("median", mins, maxs, 1)
    assert len(arrs.mins) == len(tbvh.build_median(mins, maxs).mins) == 999


def test_builder_auto_and_bad_choice():
    """"auto" keeps the dense sweep up to BRUTE_FORCE_MAX_TRIS triangles
    and builds an LBVH above, as the JAX builder does; an unknown builder
    name raises."""
    small = pt.procedural.icosphere(1)   # 80 triangles
    big = pt.procedural.icosphere(3)     # 1,280 triangles
    for mesh, traversal in ((small, "brute"), (big, "bvh")):
        b = pt.SceneBuilder()
        b.add_mesh(mesh, b.add_material("w", pt.LAMBERTIAN, [1, 1, 1]))
        scene, meta = b.build(device="cpu")
        assert meta.traversal == traversal
        assert (scene.bvh is None) == (traversal == "brute")
    with pytest.raises(ValueError, match="bvh='bvh4'"):
        b.build(bvh="bvh4", device="cpu")


# ------------------------------------------------------- meshes and files


@pytest.mark.parametrize("name,args", [
    ("icosphere", (2,)), ("icosphere", (3, 0.8)), ("icosphere", (4,)),
    ("icosphere_flat", (2, 1.0, False)), ("cone", ()),
    ("plate_with_hole", ()), ("cube", ()),
])
def test_procedural_meshes_equal_jax(name, args):
    fn = name.replace("_flat", "")
    got = getattr(tproc, fn)(*args)
    ref = getattr(jproc, fn)(*args)
    np.testing.assert_array_equal(got.vertices, ref.vertices)
    np.testing.assert_array_equal(got.normals, ref.normals)
    assert got.vertices.dtype == got.normals.dtype == np.float32


OBJ_TEXT = ("# corners in every face encoding\n"
            "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nv 0.5 0.5 1\n"
            "vn 0 0 1\nvn 0 0 -1\nvt 0.5 0.5\n"
            "f 1//1 2//1 3//1\nf 1/1/2 2/1/2 4/1/2\nf 1 2 3\n"
            "f -1 -2 -3\nf 1 2 4 3\nusemtl nothing\n")


@pytest.mark.parametrize("use_native", [False, True])
def test_obj_parse_and_roundtrip_equal_jax(tmp_path, use_native):
    """parse_obj on the face encodings, negative indices and an n-gon, and
    save_obj/load_obj round trips of a procedural mesh, equal to the JAX
    package's; a text above 64 KiB goes through the native de-indexer when
    use_native is set."""
    if use_native:
        _needs_native()
    got = tobj.parse_obj(OBJ_TEXT, use_native=use_native)
    ref = jobj.parse_obj(OBJ_TEXT, use_native=use_native)
    np.testing.assert_array_equal(got.vertices, ref.vertices)
    np.testing.assert_array_equal(got.normals, ref.normals)
    assert got.num_triangles == 6

    mesh = tproc.icosphere(4 if use_native else 1, 0.8)  # 5,120 or 80 tris
    tobj.save_obj(str(tmp_path / "port.obj"), mesh)
    jobj.save_obj(str(tmp_path / "jax.obj"), jproc.icosphere(
        4 if use_native else 1, 0.8))
    text = (tmp_path / "port.obj").read_text()
    assert text == (tmp_path / "jax.obj").read_text()
    assert (len(text) > 1 << 16) == use_native
    back = tobj.load_obj(str(tmp_path / "port.obj"))
    np.testing.assert_array_equal(back.vertices, mesh.vertices)
    np.testing.assert_array_equal(back.normals, mesh.normals)
    jback = jobj.load_obj(str(tmp_path / "port.obj"))
    np.testing.assert_array_equal(back.vertices, jback.vertices)


# -------------------------------------------------------------- traversal


@pytest.fixture(scope="module", params=[2, 5], ids=["subdiv2", "subdiv5"])
def walk_case(request):
    """An icosphere (320 or 20,480 triangles), median BVH, in both
    packages; its traversal bundle; and the JAX walk's result, op by op."""
    b = tpt.SceneBuilder()
    b.add_mesh(jproc.icosphere(request.param, 0.8),
               b.add_material("w", tpt.LAMBERTIAN, [1, 1, 1]))
    jscene, jmeta = b.build(bvh="median")
    tscene = pt.scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu")
    o, d, t0 = traversal_rays(1024, request.param, 0.8,
                              np.asarray(jscene.triangles.a))
    with jax.disable_jit():
        jt, ji = jtrav.bvh_closest_hit(
            jnp.asarray(o), jnp.asarray(d), jscene.bvh, jscene.triangles,
            T_MIN, jnp.asarray(t0), jmeta.max_leaf)
    return (tscene, jmeta.max_leaf, (o, d, t0),
            (np.asarray(jt), np.asarray(ji)))


def test_bvh_walk_equals_jax(walk_case):
    """The plain walk against the JAX walk: every index and every bit of
    t, retired lanes misses; the bundle hits the mesh on live lanes, and
    the last 16 lanes reach the NaN slab (0 * inf) and hit the mesh."""
    scene, max_leaf, (o, d, t0), (jt, ji) = walk_case
    stats = {}
    t, i = traversal.bvh_closest_hit(
        torch.from_numpy(o), torch.from_numpy(d), scene.bvh, scene.triangles,
        T_MIN, torch.from_numpy(t0), max_leaf, stats=stats)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(t.numpy(), jt)
    dead = t0 < 0
    assert (i.numpy()[dead] == -1).all()
    assert (t.numpy()[dead] == intersect.INF).all()
    assert (i.numpy()[~dead] >= 0).mean() > 0.3
    assert (i.numpy()[-16:] >= 0).sum() >= 8
    with np.errstate(divide="ignore", invalid="ignore"):
        slab = ((scene.bvh.mins.numpy()[None] - o[-16:, None])
                / d[-16:, None])
    assert np.isnan(slab).any(axis=(1, 2)).all()
    assert stats["node_visits"] > stats["tri_tests"] > 0


def test_closest_hit_routes_by_device(walk_case):
    """On CPU tensors the wrapper runs the plain walk, with no launch; a
    device other than CPU or CUDA has no route."""
    scene, _, (o, d, t0), (jt, ji) = walk_case
    before = profiling.counts()["bvh_closest_hit"]
    t, i = traversal.closest_hit(torch.from_numpy(o), torch.from_numpy(d),
                                 scene.bvh, scene.triangles, T_MIN,
                                 torch.from_numpy(t0))
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(t.numpy(), jt)
    assert profiling.counts()["bvh_closest_hit"] == before
    meta_o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no route"):
        traversal.closest_hit(meta_o, meta_o, scene.bvh, scene.triangles,
                              T_MIN, torch.zeros(4, device="meta"))


# The traversal kernel's source built as plain C++ for the CPU:
# csrc/traversal.cu keeps the packing and the per-ray walk in __host__
# __device__ code, leaves out the kernels without nvcc, and has host entry
# points that drive both over every node, triangle and ray.


def build_host_walk(out_dir, csrc_dir):
    """``csrc_dir/traversal.cu`` built with g++ (``_build.load_host_walk``)
    and loaded; None without g++."""
    if shutil.which("g++") is None:
        return None
    lib = _build.load_host_walk(csrc_dir, out_dir)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpt_bvh_pack_host.argtypes = [p] * 7 + [i] + [p] * 3 + [i, p, p]
    lib.tpt_bvh_pack_host.restype = None
    lib.tpt_bvh_walk_host.argtypes = [p] * 5 + [i, f, f, p, p, p]
    lib.tpt_bvh_walk_host.restype = None
    lib.tpt_bvh_limits.argtypes = [p]
    lib.tpt_bvh_limits.restype = None
    return lib


@pytest.fixture(scope="module")
def host_walk(tmp_path_factory):
    csrc = pathlib.Path(traversal.__file__).resolve().parent.parent / "csrc"
    lib = build_host_walk(tmp_path_factory.mktemp("host_walk"), csrc)
    if lib is None:
        pytest.skip("needs a C++ compiler (g++)")
    return lib


def host_pack(lib, bvh, tris):
    """The packing kernel's code over every node and triangle on the CPU;
    returns (node rows, triangle rows) as ``pack_bvh`` lays them out."""
    row_of, n_rows = traversal._layout(bvh, tris)
    rows = torch.empty((n_rows, traversal.NODE_ROW))
    tri_rows = torch.empty((tris.count, traversal.TRI_ROW))
    fields = [bvh.mins.contiguous(), bvh.maxs.contiguous(),
              *(x.to(torch.int64).contiguous() for x in (
                  bvh.right, bvh.prim_start, bvh.prim_count, bvh.prim_lo,
                  row_of))]
    corners = [x.contiguous() for x in (tris.a, tris.b, tris.c)]
    lib.tpt_bvh_pack_host(*(x.data_ptr() for x in fields), bvh.count,
                          *(x.data_ptr() for x in corners), tris.count,
                          rows.data_ptr(), tri_rows.data_ptr())
    return rows, tri_rows


def run_host_walk(lib, scene, o, d, t0, work=None):
    """The kernel's walk over every ray on the CPU, on tables from the
    packing kernel's code; ``work`` (int64 [2]) receives the node rows
    fetched and the triangle tests."""
    rows, tri_rows = host_pack(lib, scene.bvh, scene.triangles)
    o, d, t0 = (torch.from_numpy(np.ascontiguousarray(x)) for x in (o, d, t0))
    t = torch.empty(o.shape[0])
    i = torch.empty(o.shape[0], dtype=torch.int32)
    lib.tpt_bvh_walk_host(o.data_ptr(), d.data_ptr(), t0.data_ptr(),
                          rows.data_ptr(), tri_rows.data_ptr(), o.shape[0],
                          T_MIN, float(intersect.INF), t.data_ptr(),
                          i.data_ptr(),
                          None if work is None else work.data_ptr())
    return t.numpy(), i.numpy()


def test_traversal_kernel_source_on_cpu(host_walk, walk_case):
    """The kernel's walk, built for the CPU, against the plain walk (here
    equal to the JAX walk): every index and every bit of t, on the mixed
    bundle with retired lanes and the NaN-slab lanes."""
    scene, _, (o, d, t0), (jt, ji) = walk_case
    t, i = run_host_walk(host_walk, scene, o, d, t0)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(t, jt)


# ------------------------------------------------- refit and whole frames


def test_refit_equals_jax_and_contains_moved_triangles():
    """refit_bvh against the JAX refit on moved vertices, bit for bit, and
    tests/test_grad.py:143-176's containment: every node's bounds hold its
    [prim_lo, prim_hi) triangles; the topology is untouched."""
    b = tpt.SceneBuilder()
    b.add_mesh(jproc.icosphere(2, 0.8),
               b.add_material("d", tpt.LAMBERTIAN, [1, 1, 1]))
    jscene, _ = b.build(bvh="median")
    tscene = pt.scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu")
    shift = np.random.default_rng(3).normal(
        scale=0.2, size=np.asarray(jscene.triangles.a).shape).astype(
        np.float32)
    moved = {k: np.asarray(getattr(jscene.triangles, k)) + shift
             for k in ("a", "b", "c")}
    with jax.disable_jit():
        ref = jrefit(jscene.bvh, jscene.triangles._replace(
            **{k: jnp.asarray(v) for k, v in moved.items()}))
    new = trefit(tscene.bvh, tscene.triangles._replace(
        **{k: torch.from_numpy(v) for k, v in moved.items()}))
    for f in pt.FlatBVH._fields:
        np.testing.assert_array_equal(getattr(new, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    tmin = np.minimum(np.minimum(moved["a"], moved["b"]), moved["c"])
    tmax = np.maximum(np.maximum(moved["a"], moved["b"]), moved["c"])
    lo, hi = new.prim_lo.numpy(), new.prim_hi.numpy()
    for k in range(new.count):
        assert (new.mins[k].numpy() <= tmin[lo[k]:hi[k]].min(0)).all(), k
        assert (new.maxs[k].numpy() >= tmax[lo[k]:hi[k]].max(0)).all(), k
    assert not np.array_equal(new.mins.numpy(), tscene.bvh.mins.numpy())


def _mirror_sphere_scene(pkg, subdivisions, bvh, device=None):
    """bench.py:301's mesh scene: white back and front walls, the emissive
    quad and a mirror icosphere of radius 0.8."""
    proc = jproc if pkg is tpt else tproc
    b = pkg.SceneBuilder()
    b.add_material("default", pkg.LAMBERTIAN, [1, 0, 0])
    white = b.add_material("white", pkg.LAMBERTIAN, [0.73, 0.73, 0.73])
    light = b.add_material("light", pkg.LAMBERTIAN, [0, 0, 0],
                           emission=[2, 2, 2])
    mirror = b.add_material("mirror", pkg.MIRROR, [0.9, 0.9, 0.9])
    b.add_quad([-2, -2, -2], [4, 0, 0], [0, 4, 0], white)
    b.add_quad([-2, 2, -2], [4, 0, 0], [0, 0, 4], light)
    b.add_quad([-2, -2, 2], [4, 0, 0], [0, 0, -4], white)
    b.add_mesh(proc.icosphere(subdivisions=subdivisions, radius=0.8), mirror)
    if pkg is tpt:
        return b.build(bvh=bvh)
    return b.build(bvh=bvh, device=device)


def test_mesh_render_matches_jax():
    """A whole frame of a BVH mesh scene (icosphere subdivision 3, median,
    16x16, 3 bounces, NEE) through the port's wavefront and the plain walk,
    against the JAX wavefront and its walk run op by op."""
    kw = dict(width=16, height=16, max_bounces=3, importance_sampling=True)
    jscene, jmeta = _mirror_sphere_scene(tpt, 3, "median")
    tscene, tmeta = _mirror_sphere_scene(pt, 3, "median", "cpu")
    assert tmeta.traversal == "bvh"
    view = pt.Camera(eye=[0, 0, 3.2], center=[0, 0, 0]).view_matrix
    pix = jnp.arange(16 * 16, dtype=jnp.uint32)
    with jax.disable_jit():
        _, ref = jptp(jrng.seed(pix, 5), jnp.asarray(view),
                      (pix % 16).astype(jnp.int32),
                      (pix // 16).astype(jnp.int32), jscene, jmeta,
                      tpt.RenderConfig(**kw, use_pallas=False))
    tpix, px, py = pixel_grid(16, 16, "cpu")
    _, got = tptp(trng.seed(tpix, 5), torch.as_tensor(view), px, py, tscene,
                  tmeta, pt.RenderConfig(**kw))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RAD_TOL, atol=RAD_TOL)
    assert ref.std() > 0.05  # the mirror sphere is in the frame


def _vertex_grads(pkg, bvh):
    """Gradients of mean radiance with respect to the vertices, through
    diff.params.apply_params (which refits a BVH scene); the scene of
    tests/test_grad.py:179-238 with NEE on, 24x24, 2 bounces."""
    kw = dict(width=24, height=24, max_bounces=2, importance_sampling=True)
    b = pkg.SceneBuilder()
    white = b.add_material("white", pkg.LAMBERTIAN, [0.73, 0.73, 0.73])
    light = b.add_material("light", pkg.LAMBERTIAN, [0, 0, 0],
                           emission=(5, 5, 5))
    b.add_quad([-2, 2, -2], [4, 0, 0], [0, 0, 4], light)
    proc = jproc if pkg is tpt else tproc
    b.add_mesh(proc.icosphere(subdivisions=2, radius=0.8), white)
    view = pt.Camera(eye=[0, 0, 3.0], center=[0, 0, 0]).view_matrix
    if pkg is tpt:
        scene, meta = b.build(bvh=bvh)
        pix = jnp.arange(24 * 24, dtype=jnp.uint32)
        px = (pix % 24).astype(jnp.int32)
        py = (pix // 24).astype(jnp.int32)

        def loss(p):
            s = jparams.apply_params(scene, p)
            return jnp.mean(jptp(jrng.seed(pix, 7), jnp.asarray(view), px,
                                 py, s, meta, tpt.RenderConfig(**kw))[1])

        with jax.disable_jit():
            g = jax.grad(loss)(jparams.extract_params(scene, ("vertices",)))
        return {k: np.asarray(v) for k, v in g.items()}
    scene, meta = b.build(bvh=bvh, device="cpu")
    params = {k: v.clone().requires_grad_(True) for k, v in
              tparams.extract_params(scene, ("vertices",)).items()}
    pix, px, py = pixel_grid(24, 24, "cpu")
    s = tparams.apply_params(scene, params)
    loss = torch.mean(tptp(trng.seed(pix, 7), torch.as_tensor(view), px, py,
                           s, meta, pt.RenderConfig(**kw))[1])
    return {k: g.numpy() for k, g in
            zip(params, torch.autograd.grad(loss, list(params.values())))}


def test_vertex_gradients_through_bvh_with_refit():
    """Vertex gradients through the BVH walk with the refit: finite,
    nonzero, equal in norm to the brute-force route's on the same scene
    (the BVH reorders triangles), as tests/test_grad.py:179-238 holds the
    JAX package; and equal to the JAX package's within 1e-3 of each
    group's largest."""
    got = _vertex_grads(pt, "median")
    brute = _vertex_grads(pt, "none")
    ref = _vertex_grads(tpt, "median")
    for k in got:
        assert np.isfinite(got[k]).all(), k
        n_bvh, n_brute = (float(np.linalg.norm(x)) for x in (got[k],
                                                               brute[k]))
        assert abs(n_bvh - n_brute) <= GRAD_RTOL * max(n_brute, 1e-12), k
        scale = float(np.abs(ref[k]).max())
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)
    assert np.abs(got["tri_a"]).max() > 0


# ----------------------------------------------------------------- on card


@pytest.mark.cuda
def test_cuda_traversal_matches_plain_walk():
    """The CUDA kernel against the plain walk on the card, from the same
    rays: the same index on every lane, t within 1e-5, one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run python3 chip_smoke.py there)")
    b = pt.SceneBuilder()
    b.add_mesh(pt.procedural.icosphere(4, 0.8),
               b.add_material("w", pt.LAMBERTIAN, [1, 1, 1]))
    scene, meta = b.build(bvh="median", device="cuda")
    o, d, t0 = (torch.from_numpy(x).cuda() for x in traversal_rays(
        4096, 4, 0.8, scene.triangles.a.cpu().numpy()))
    before = profiling.counts()["bvh_closest_hit"]
    t, i = traversal.closest_hit(o, d, scene.bvh, scene.triangles, T_MIN, t0)
    torch.cuda.synchronize()
    assert profiling.counts()["bvh_closest_hit"] == before + 1
    tp, ip = traversal.bvh_closest_hit(o, d, scene.bvh, scene.triangles,
                                       T_MIN, t0, meta.max_leaf)
    np.testing.assert_array_equal(i.cpu().numpy(), ip.cpu().numpy())
    np.testing.assert_allclose(t.cpu().numpy(), tp.cpu().numpy(), rtol=1e-5,
                               atol=1e-5)
