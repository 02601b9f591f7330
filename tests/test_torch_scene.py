"""Port parity, scene layer: built-in scenes, the numpy bridge and the
megakernel's packed tables, array for array against the JAX package."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import tpu_path_tracer as tpt
from tpu_path_tracer.kernels.pallas import megakernel as jmk

import tpu_path_tracer_torch as pt
from tpu_path_tracer_torch.kernels import megakernel as tmk

SCENES = {
    "reference": (lambda m, **kw: m.builtin.reference_scene(**kw), {}),
    "reference_mini": (
        lambda m, **kw: m.builtin.reference_scene(mini=True, **kw), {}),
    "reference_no_mesh": (
        lambda m, **kw: m.builtin.reference_scene(include_mesh=False, **kw),
        {}),
    "cornell": (lambda m, **kw: m.builtin.cornell_box(**kw), {}),
}


def _leaves(scene):
    """(path, array) of every scene field except the light index."""
    out = []
    for group in ("materials", "spheres", "quads", "triangles"):
        g = getattr(scene, group)
        for f in g._fields:
            out.append((f"{group}.{f}", getattr(g, f)))
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_builtin_scene_equals_jax(name):
    """Tolerance: none.  Floats come out float32 and indices int64; the
    numpy bridge of the JAX scene gives the same arrays."""
    build, _ = SCENES[name]
    jscene, jmeta, _ = build(tpt)
    tscene, tmeta, _ = build(pt, device="cpu")
    bridged = pt.scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu")
    assert dataclasses.asdict(tmeta) == dataclasses.asdict(jmeta)
    assert tscene.light_index == int(jscene.light_index)
    assert bridged.light_index == tscene.light_index
    assert tscene.bvh is None and bridged.bvh is None
    for (path, t), (_, b), (_, j) in zip(_leaves(tscene), _leaves(bridged),
                                         _leaves(jscene)):
        j = np.asarray(j)
        want = torch.float32 if np.issubdtype(j.dtype, np.floating) \
            else torch.int64
        assert t.dtype == want and b.dtype == want, path
        np.testing.assert_array_equal(t.numpy(), j, err_msg=path)
        np.testing.assert_array_equal(b.numpy(), j, err_msg=path)


def test_scene_from_numpy_casts_float64():
    """A float64 array (as ``Camera.view_matrix`` math can produce) comes
    out float32, and an int32 index array int64."""
    jscene, _, _ = tpt.builtin.cornell_box()
    np_scene = jax.tree.map(lambda x: np.asarray(x).astype(
        np.float64 if np.issubdtype(np.asarray(x).dtype, np.floating)
        else np.int32), jscene)
    scene = pt.scene_from_numpy(np_scene, "cpu")
    assert scene.quads.q.dtype == torch.float32
    assert scene.quads.material_id.dtype == torch.int64


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pack_tables_equal(name):
    """Tolerance: none — the JAX column layout, column for column.  An
    empty family is the one difference: the JAX package pads it with a
    zero row for its TPU block shapes, the port packs no rows."""
    build, _ = SCENES[name]
    jscene, _, _ = build(tpt)
    tscene, _, _ = build(pt, device="cpu")
    counts = (tscene.spheres.count, tscene.quads.count,
              tscene.triangles.count, 1)
    for j, t, n in zip(jmk.pack_tables(jscene), tmk.pack_tables(tscene),
                       counts):
        j = np.asarray(j)
        assert t.shape == (n, j.shape[1])
        np.testing.assert_array_equal(t.numpy(), j[:n])
        assert not j[n:].any()


def test_empty_families_pack_no_rows():
    b = pt.SceneBuilder()
    m = b.add_material("white", pt.LAMBERTIAN, [0.7, 0.7, 0.7])
    b.add_sphere([0, 0, 0], 0.5, m)
    scene, meta = b.build(device="cpu")
    sph, quad, tri, light = tmk.pack_tables(scene)
    assert sph.shape == (1, tmk.SPH_COLS)
    assert quad.shape == (0, tmk.QUAD_COLS)
    assert tri.shape == (0, tmk.TRI_COLS)
    assert light.shape == (1, tmk.LIGHT_COLS) and not light.any()
    assert meta.traversal == "none" and not meta.has_light


def test_bvh_scene_raises():
    """A scene beyond the brute-force sweep gets a BVH, as in the JAX
    package: "auto" builds an LBVH over its triangles, and "sah" on a
    small mesh builds what it names; only a builder that does not exist
    raises.  The BVH and the triangle order are the JAX package's."""
    from tpu_path_tracer_torch.scene.builder import BRUTE_FORCE_MAX_TRIS

    builders = (tpt.SceneBuilder(), pt.SceneBuilder())
    cube = pt.procedural.cube()
    for b, pkg in zip(builders, (tpt, pt)):
        m = b.add_material("white", pt.LAMBERTIAN, [0.7, 0.7, 0.7])
        for k in range(BRUTE_FORCE_MAX_TRIS // cube.num_triangles + 1):
            b.add_mesh(pkg.procedural.cube(), m, pkg.Transform().update(
                pkg.Transform.translate(3.0 * k, 0, 0)))
    (jscene, jmeta), (scene, meta) = (builders[0].build(),
                                      builders[1].build(device="cpu"))
    assert meta.traversal == jmeta.traversal == "bvh"
    np.testing.assert_array_equal(scene.bvh.miss.numpy(),
                                  np.asarray(jscene.bvh.miss))
    np.testing.assert_array_equal(scene.triangles.a.numpy(),
                                  np.asarray(jscene.triangles.a))
    small = pt.SceneBuilder()
    small.add_mesh(cube, small.add_material("w", pt.LAMBERTIAN, [1, 1, 1]))
    _, meta = small.build(bvh="sah", device="cpu")
    assert meta.traversal == "bvh"
    with pytest.raises(ValueError, match="expected one of"):
        small.build(bvh="kd", device="cpu")
