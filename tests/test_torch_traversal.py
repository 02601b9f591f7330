"""Port parity, traversal kernel: the CUDA traversal kernel's walk
(``csrc/traversal.cu``, built with g++ for the CPU) against the JAX
package's skip-link walk, op by op (``jax.disable_jit``), on every builder
and on meshes whose hits all tie.

Every case is held to the ROADMAP's contract at its strictest: the same
triangle index on every lane and t equal bit for bit.  Two meshes make
every hit an exact tie between two triangles: an icosphere added twice at
the same place, and ``procedural.cube()`` added twice (axis-aligned
triangles, hits on the planes of box faces).  The skip-link walk meets
triangles in ascending index order and keeps the first of equal t, so a
walk that visits the tree in another order must break ties by index to
agree with it.  Each mesh runs through the median, SAH and LBVH builders,
NumPy and native (g++).
"""

import contextlib
import ctypes
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_path_tracer as tpt
from tpu_path_tracer.accel import native as jnative
from tpu_path_tracer.kernels import traversal as jtrav
from tpu_path_tracer.scene import procedural as jproc

import tpu_path_tracer_torch as pt
from chip_smoke import traversal_rays
from tpu_path_tracer_torch.kernels import intersect, traversal

from test_torch_mesh import host_pack, host_walk, run_host_walk  # noqa: F401

T_MIN = 1e-4         # tests/test_pallas.py:277
RAYS = 1024

# name: (mesh maker, copies, radius the rays aim at, ray seed)
MESHES = {
    "subdiv2": (lambda: jproc.icosphere(2, 0.8), 1, 0.8, 2),
    "subdiv5": (lambda: jproc.icosphere(5, 0.8), 1, 0.8, 5),
    "ico_twice": (lambda: jproc.icosphere(2, 0.8), 2, 0.8, 3),
    "cube_twice": (jproc.cube, 2, 0.270893, 7),
}
TIES = ("ico_twice", "cube_twice")


@contextlib.contextmanager
def _builders(native):
    """The JAX SceneBuilder's native (g++) builders, or its NumPy ones."""
    before = os.environ.get("TPT_NO_NATIVE")
    if native:
        os.environ.pop("TPT_NO_NATIVE", None)
    else:
        os.environ["TPT_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("TPT_NO_NATIVE", None)
        else:
            os.environ["TPT_NO_NATIVE"] = before


@pytest.fixture(scope="module",
                params=[(m, b, n) for m in MESHES
                        for b in ("median", "sah", "lbvh")
                        for n in ("numpy", "native")],
                ids=lambda p: "-".join(p))
def case(request):
    """One mesh through one builder in the JAX package, the port's scene
    made from it on the CPU, the mesh's traversal bundle and the JAX walk's
    result, op by op."""
    mesh, method, builder = request.param
    make, copies, radius, seed = MESHES[mesh]
    if builder == "native" and not jnative.available():
        pytest.skip("needs a C++ compiler (g++) for the native builders")
    b = tpt.SceneBuilder()
    white = b.add_material("w", tpt.LAMBERTIAN, [1, 1, 1])
    for _ in range(copies):
        b.add_mesh(make(), white)
    with _builders(builder == "native"):
        jscene, jmeta = b.build(bvh=method)
    tscene = pt.scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu")
    o, d, t0 = traversal_rays(RAYS, seed, radius,
                              np.asarray(jscene.triangles.a))
    with jax.disable_jit():
        jt, ji = jtrav.bvh_closest_hit(
            jnp.asarray(o), jnp.asarray(d), jscene.bvh, jscene.triangles,
            T_MIN, jnp.asarray(t0), jmeta.max_leaf)
    return (mesh, tscene, jmeta.max_leaf, (o, d, t0),
            (np.asarray(jt), np.asarray(ji)))


def exact_ties(scene, o, d, t, i):
    """Lanes whose winning t is reached exactly by another triangle too
    (the dense Möller-Trumbore of every lane against every triangle)."""
    tris = scene.triangles
    tt, _, _, _ = intersect.triangle_t(
        torch.from_numpy(o)[:, None], torch.from_numpy(d)[:, None],
        tris.a[None], tris.b[None], tris.c[None], T_MIN,
        torch.full((o.shape[0], 1), 1e9))
    equal = (tt.numpy() == t[:, None]).sum(axis=1)
    return (i >= 0) & (equal >= 2)


def test_kernel_walk_equals_jax_on_every_builder(host_walk, case):
    """The kernel's walk, built for the CPU, against the JAX walk: every
    index and every bit of t, retired lanes misses.  On the doubled meshes
    nearly every hit is an exact tie, which only the lower index may
    win."""
    mesh, scene, _, (o, d, t0), (jt, ji) = case
    t, i = run_host_walk(host_walk, scene, o, d, t0)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(t, jt)
    live = t0 > 0
    assert (i[~live] == -1).all()
    assert (i[live] >= 0).mean() > 0.3
    if mesh in TIES:
        tied = exact_ties(scene, o, d, jt, ji)
        assert tied.sum() >= 0.9 * (ji >= 0).sum()


def test_plain_walk_equals_jax_on_every_builder(case):
    """The plain walk (the kernel's oracle on the card) against the JAX
    walk: every index and every bit of t."""
    _, scene, max_leaf, (o, d, t0), (jt, ji) = case
    t, i = traversal.bvh_closest_hit(
        torch.from_numpy(o), torch.from_numpy(d), scene.bvh, scene.triangles,
        T_MIN, torch.from_numpy(t0), max_leaf)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(t.numpy(), jt)


# ------------------------------------------------------ hand-built trees


def _trees(mins, maxs, right, prim_start, miss, prim_lo, prim_hi, corners):
    """One FlatBVH and its triangles from numpy arrays, for both packages:
    (JAX bvh, JAX triangles, port bvh, port triangles)."""
    ints = dict(right=right, prim_start=prim_start,
                prim_count=np.where(np.asarray(right) < 0, 1, 0), miss=miss,
                axis=np.zeros(len(right)), prim_lo=prim_lo, prim_hi=prim_hi)
    a, b, c = (np.asarray(x, np.float32) for x in corners)
    normals = np.zeros_like(a)
    jb = tpt.FlatBVH(mins=jnp.asarray(mins, jnp.float32),
                     maxs=jnp.asarray(maxs, jnp.float32),
                     **{k: jnp.asarray(v, jnp.int32) for k, v in ints.items()})
    jt = tpt.Triangles(a=jnp.asarray(a), b=jnp.asarray(b), c=jnp.asarray(c),
                       na=jnp.asarray(normals), nb=jnp.asarray(normals),
                       nc=jnp.asarray(normals),
                       material_id=jnp.zeros(len(a), jnp.int32))
    tb = pt.FlatBVH(mins=torch.tensor(mins, dtype=torch.float32),
                    maxs=torch.tensor(maxs, dtype=torch.float32),
                    **{k: torch.as_tensor(np.asarray(v), dtype=torch.int64)
                       for k, v in ints.items()})
    tt = pt.Triangles(a=torch.from_numpy(a), b=torch.from_numpy(b),
                      c=torch.from_numpy(c), na=torch.from_numpy(normals),
                      nb=torch.from_numpy(normals),
                      nc=torch.from_numpy(normals),
                      material_id=torch.zeros(len(a), dtype=torch.int64))
    return jb, jt, tb, tt


def _flat(z, x0=0.0):
    """A right triangle in the plane z at x in [x0, x0 + 1], y in [0, 1]."""
    return ([x0, 0, z], [x0 + 1, 0, z], [x0, 1, z])


def _face_tie_tree():
    """Root 0 -> (L 1, B 4); L -> (A 2, X 3).  Triangle 0 (in A) and
    triangle 2 (in B) are the same triangle in the plane z = 0; triangle 1
    (in X) lies off the rays.  A's box has its top face at z = 0, so a ray
    down the z axis enters it exactly at the hit, t = 1; B's box is entered
    earlier, so a front-to-back walk takes B first and finds triangle 2,
    then tests A's box at t_best = 1 = its entry."""
    lo = [[-1, -1, -0.5], [-1, -1, -0.5], [-1, -1, -0.5], [5, -1, -0.5],
          [-1, -1, -0.5]]
    hi = [[6, 1, 0.5], [6, 1, 0], [1, 1, 0], [6, 1, 0], [1, 1, 0.5]]
    tris = [_flat(0.0), _flat(-0.4, 5.0), _flat(0.0)]
    return _trees(lo, hi, right=[4, 3, -1, -1, -1],
                  prim_start=[-1, -1, 0, 1, 2], miss=[5, 4, 3, 4, 5],
                  prim_lo=[0, 0, 0, 1, 2], prim_hi=[3, 2, 1, 2, 3],
                  corners=list(zip(*tris)))


def _left_chain(levels):
    """Interior nodes 0 .. levels - 1, each the left child of the one
    before; node ``levels`` is the deepest leaf (triangle 0) and node
    ``levels + j`` the right leaf of interior node ``levels - j``
    (triangle j).  Every box is the same, and triangle j lies at z =
    -0.01 j, so a walk that goes left first pushes every right leaf."""
    n = 2 * levels + 1
    ids = np.arange(n)
    interior = ids < levels
    right = np.where(interior, 2 * levels - ids, -1)
    prim_start = np.where(interior, -1, ids - levels)
    miss = np.where(interior, 2 * levels - ids + 1, ids + 1)
    prim_lo = np.where(interior, 0, ids - levels)
    prim_hi = np.where(interior, levels - ids + 1, ids - levels + 1)
    tris = [_flat(-0.01 * j) for j in range(levels + 1)]
    return _trees([[-1, -1, -1]] * n, [[1, 1, 0]] * n, right, prim_start,
                  miss, prim_lo, prim_hi, list(zip(*tris)))


def _down_rays():
    """Rays down the z axis from z = 1 onto the triangles' interiors."""
    xy = np.array([[0.25, 0.25], [0.1, 0.3], [0.5, 0.2], [0.3, 0.6]])
    o = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)
    d = np.tile([0.0, 0.0, -1.0], (len(xy), 1))
    t0 = np.array([1e9, 1e9, 1.5, -1e9])
    return (o.astype(np.float32), d.astype(np.float32),
            t0.astype(np.float32))


@pytest.mark.parametrize("tree", ["face_tie", "left_chain_64"])
def test_kernel_walk_equals_jax_on_hand_built_trees(host_walk, tree):
    """Trees the builders do not make: a tie whose box is entered exactly
    at the hit (the strict slab test alone would cull the lower index
    there), and a tree as deep as the kernel's stack, every level of which
    it fills.  The kernel's walk against the JAX walk and the plain walk,
    every index and every bit of t."""
    jb, jt, tb, tt = (_face_tie_tree() if tree == "face_tie"
                      else _left_chain(traversal.STACK_DEPTH))
    o, d, t0 = _down_rays()
    with jax.disable_jit():
        rt, ri = jtrav.bvh_closest_hit(jnp.asarray(o), jnp.asarray(d), jb,
                                       jt, T_MIN, jnp.asarray(t0), 1)
    rt, ri = np.asarray(rt), np.asarray(ri)
    scene = pt.SceneData(None, None, None, tt, tb, -1)
    t, i = run_host_walk(host_walk, scene, o, d, t0)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(t, rt)
    pt_t, pt_i = traversal.bvh_closest_hit(
        torch.from_numpy(o), torch.from_numpy(d), tb, tt, T_MIN,
        torch.from_numpy(t0), 1)
    np.testing.assert_array_equal(pt_i.numpy(), ri)
    np.testing.assert_array_equal(pt_t.numpy(), rt)
    assert (ri[:3] == 0).all() and (rt[:3] == 1.0).all() and ri[3] == -1
    assert int(traversal.tree_depth(tb)) == (
        2 if tree == "face_tie" else traversal.STACK_DEPTH)


def test_pack_refuses_a_tree_deeper_than_the_stack():
    """A tree one level deeper than the kernel's stack raises, naming both
    depths; the packer never falls back."""
    _, _, tb, tt = _left_chain(traversal.STACK_DEPTH + 1)
    with pytest.raises(ValueError, match=f"depth {traversal.STACK_DEPTH + 1}"
                       f" .* stack of {traversal.STACK_DEPTH}"):
        traversal.pack_bvh(tb, tt)


def test_pack_plain_equals_kernel_source_and_limits(host_walk, case):
    """The packing kernel's code (built for the CPU) against its plain
    version, bit for bit on every row; the wrapper's limits are the C
    code's; the tree fits the stack (the doubled meshes under LBVH, equal
    Morton codes, are the deepest trees here)."""
    _, scene, _, _, _ = case
    rows, tri_rows = traversal.pack_bvh(scene.bvh, scene.triangles)
    h_rows, h_tris = host_pack(host_walk, scene.bvh, scene.triangles)
    np.testing.assert_array_equal(rows.view(torch.int32).numpy(),
                                  h_rows.view(torch.int32).numpy())
    np.testing.assert_array_equal(tri_rows.view(torch.int32).numpy(),
                                  h_tris.view(torch.int32).numpy())
    limits = (ctypes.c_int * 2)()
    host_walk.tpt_bvh_limits(limits)
    assert list(limits) == [traversal.STACK_DEPTH, traversal.LEAF_MAX]
    assert 0 < int(traversal.tree_depth(scene.bvh)) <= traversal.STACK_DEPTH
