"""Port parity, integrator layer: hit search and shading, BSDF sampling and
whole-pixel radiance, against the JAX wavefront.

Inputs are made with numpy from fixed seeds and fed to both packages.  The
JAX functions run op by op (``jax.disable_jit``): inside a compiled
function XLA's CPU backend contracts ``a*b+c`` into fused multiply-adds,
which the port (like the CUDA kernel, built with ``--fmad=false``) does not
do; op by op both round every operation alike.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_path_tracer as tpt
from tpu_path_tracer.core import rng as jrng
from tpu_path_tracer.core.types import HitRecord as JHitRecord, Ray as JRay
from tpu_path_tracer.integrator import bsdf as jbsdf
from tpu_path_tracer.integrator.render import path_trace_pixels as jptp
from tpu_path_tracer.kernels import hit as jhit

import tpu_path_tracer_torch as pt
from tpu_path_tracer_torch.core import rng as trng
from tpu_path_tracer_torch.core.types import HitRecord, Ray
from tpu_path_tracer_torch.integrator import bsdf as tbsdf
from tpu_path_tracer_torch.integrator.render import (path_trace_pixels as
                                                     tptp, pixel_grid)
from tpu_path_tracer_torch.kernels import hit as thit

# Radiance tolerance of the JAX package's kernel parity tests
# (tests/test_pallas.py:52).
RAD_TOL = 2e-4


def _port(jscene, jmeta):
    return (pt.scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu"),
            pt.SceneMeta(**dataclasses.asdict(jmeta)))


@pytest.fixture(scope="module")
def reference_scenes():
    """The full reference scene (spheres, volumes, quads, 12 triangles) in
    both packages."""
    jscene, jmeta, _ = tpt.builtin.reference_scene()
    return jscene, jmeta, *_port(jscene, jmeta)


def _random_rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    o[: n // 4] = [0.5, 0.0, 2.5]  # a quarter from the reference eye
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    s = r.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    return o, d, s


def test_find_and_shade_hit_match(reference_scenes):
    """Random rays through the full reference scene: the same winner type
    and index on every lane, t within 1e-5, the same volume draws, and the
    shaded record within 1e-5."""
    jscene, jmeta, tscene, tmeta = reference_scenes
    o, d, s = _random_rays(4096, 0)
    alive = np.random.default_rng(1).uniform(size=4096) > 0.1
    jcfg, tcfg = tpt.RenderConfig(), pt.RenderConfig()
    jray = JRay(origin=jnp.asarray(o), dir=jnp.asarray(d))
    tray = Ray(origin=torch.from_numpy(o), dir=torch.from_numpy(d))
    with jax.disable_jit():
        js, jtype, jidx, jvol = jhit.find_hit(
            jnp.asarray(s), jray, jscene, jmeta, jcfg,
            alive=jnp.asarray(alive))
        jrec = jhit.shade_hit(jray, jtype, jidx, jvol, jscene, jcfg)
    ts, ttype, tidx, tvol = thit.find_hit(
        torch.from_numpy(s.astype(np.int64)), tray, tscene, tmeta, tcfg,
        alive=torch.from_numpy(alive))
    trec = thit.shade_hit(tray, ttype, tidx, tvol, tscene, tcfg)

    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(ttype.numpy(), np.asarray(jtype))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tvol.numpy(), np.asarray(jvol))
    # Every primitive family is exercised, and dead lanes report a miss.
    assert set(np.unique(np.asarray(jtype))) == {-1, 0, 1, 2, 3}
    assert (np.asarray(jtype)[~alive] == -1).all()
    hit = np.asarray(jrec.hit)
    np.testing.assert_array_equal(trec.hit.numpy(), hit)
    np.testing.assert_array_equal(trec.front_face.numpy(),
                                  np.asarray(jrec.front_face))
    np.testing.assert_array_equal(trec.material_id.numpy(),
                                  np.asarray(jrec.material_id))
    np.testing.assert_allclose(trec.t.numpy()[hit], np.asarray(jrec.t)[hit],
                               rtol=1e-5, atol=1e-5)
    for f in ("p", "normal"):
        np.testing.assert_allclose(getattr(trec, f).numpy()[hit],
                                   np.asarray(getattr(jrec, f))[hit],
                                   rtol=1e-5, atol=1e-5)


def test_material_scatter_matches(reference_scenes):
    """All four BSDFs over random hit records: the same 8 draws per lane
    (states equal), directions within 1e-5, attenuation and skip flags
    equal."""
    jscene, _, tscene, _ = reference_scenes
    n = 4096
    r = np.random.default_rng(3)
    nrm = r.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    wi = r.normal(size=(n, 3)).astype(np.float32)
    mid = r.integers(0, tscene.materials.count, n)
    front = r.uniform(size=n) > 0.3
    s = r.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    p = np.zeros((n, 3), np.float32)
    jrec = JHitRecord(hit=jnp.ones(n, bool), t=jnp.ones(n), p=jnp.asarray(p),
                      normal=jnp.asarray(nrm), front_face=jnp.asarray(front),
                      material_id=jnp.asarray(mid, jnp.int32))
    trec = HitRecord(hit=torch.ones(n, dtype=torch.bool), t=torch.ones(n),
                     p=torch.from_numpy(p), normal=torch.from_numpy(nrm),
                     front_face=torch.from_numpy(front),
                     material_id=torch.from_numpy(mid))
    with jax.disable_jit():
        js, jsr = jbsdf.material_scatter(jnp.asarray(s), jnp.asarray(wi),
                                         jrec, jscene.materials)
    ts, tsr = tbsdf.material_scatter(torch.from_numpy(s.astype(np.int64)),
                                     torch.from_numpy(wi), trec,
                                     tscene.materials)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(tsr.skip_pdf.numpy(),
                                  np.asarray(jsr.skip_pdf))
    np.testing.assert_array_equal(tsr.attenuation.numpy(),
                                  np.asarray(jsr.attenuation))
    for f in ("dir", "diffuse_dir"):
        np.testing.assert_allclose(getattr(tsr, f).numpy(),
                                   np.asarray(getattr(jsr, f)),
                                   rtol=1e-5, atol=1e-5)


PIXEL_CASES = {
    "cornell_nee_off": (lambda: tpt.builtin.cornell_box(), [0, 0, 3.2],
                        dict(width=16, height=8, max_bounces=4)),
    "cornell_nee_on": (lambda: tpt.builtin.cornell_box(), [0, 0, 3.2],
                       dict(width=16, height=8, max_bounces=4,
                            importance_sampling=True)),
    "reference_mini": (
        lambda: tpt.builtin.reference_scene(include_mesh=False, mini=True),
        [0.5, 0.0, 2.5], dict(width=8, height=8, max_bounces=3)),
    "reference_mini_cube": (
        lambda: tpt.builtin.reference_scene(include_mesh=True, mini=True),
        [0.5, 0.0, 2.5], dict(width=8, height=8, max_bounces=3)),
    "cornell_stratified_spp4": (
        lambda: tpt.builtin.cornell_box(), [0, 0, 3.2],
        dict(width=8, height=8, max_bounces=3, samples_per_pixel=4,
             stratify=True)),
}


@pytest.mark.parametrize("name", sorted(PIXEL_CASES))
def test_path_trace_pixels_matches_jax_wavefront(name):
    """Radiance per pixel at rtol = atol = 2e-4 on every pixel, and the
    advanced PCG states equal."""
    build, eye, kw = PIXEL_CASES[name]
    jscene, jmeta, _ = build()
    tscene, tmeta = _port(jscene, jmeta)
    jcfg, tcfg = tpt.RenderConfig(**kw), pt.RenderConfig(**kw)
    view = tpt.Camera(eye=eye, center=[0, 0, 0]).view_matrix
    w, h = kw["width"], kw["height"]
    pix = np.arange(w * h, dtype=np.uint32)
    with jax.disable_jit():
        js, ref = jptp(jrng.seed(jnp.asarray(pix), jnp.int32(3)),
                       jnp.asarray(view), jnp.asarray(pix % w, jnp.int32),
                       jnp.asarray(pix // w, jnp.int32), jscene, jmeta, jcfg)
    tpix, px, py = pixel_grid(w, h, "cpu")
    ts, got = tptp(trng.seed(tpix, 3), torch.as_tensor(view), px, py,
                   tscene, tmeta, tcfg)
    ref = np.asarray(ref)
    assert got.shape == (w * h, 3) and got.dtype == torch.float32
    assert ref.max() > 0.0  # something was lit
    np.testing.assert_allclose(got.numpy(), ref, rtol=RAD_TOL, atol=RAD_TOL)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))


@pytest.mark.parametrize("case", ["no_primitives", "zero_bounces"])
def test_degenerate_renders_match_jax(case):
    """A scene with a material and no primitive renders the background;
    ``max_bounces=0`` renders zeros.  Exact values, so JAX runs compiled
    here (neither package can take an op-by-op zero-length loop)."""
    jb, tb = tpt.SceneBuilder(), pt.SceneBuilder()
    if case == "no_primitives":
        for b in (jb, tb):
            b.add_material("white", pt.LAMBERTIAN, [0.7, 0.7, 0.7])
        (jscene, jmeta), (tscene, tmeta) = jb.build(), tb.build(
            device="cpu")
        kw = dict(width=4, height=2, max_bounces=3, use_megakernel=True)
    else:
        jscene, jmeta, _ = tpt.builtin.cornell_box()
        tscene, tmeta, _ = pt.builtin.cornell_box(device="cpu")
        kw = dict(width=4, height=2, max_bounces=0)
    view = tpt.Camera(eye=[0, 0, 3.2]).view_matrix
    pix = np.arange(8, dtype=np.uint32)
    _, ref = jptp(jrng.seed(jnp.asarray(pix), jnp.int32(1)),
                  jnp.asarray(view), jnp.asarray(pix % 4, jnp.int32),
                  jnp.asarray(pix // 4, jnp.int32), jscene, jmeta,
                  tpt.RenderConfig(**kw))
    tpix, px, py = pixel_grid(4, 2, "cpu")
    _, got = tptp(trng.seed(tpix, 1), torch.as_tensor(view), px, py, tscene,
                  tmeta, pt.RenderConfig(**kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    expect = [0.0, 1.0, 1.0] if case == "no_primitives" else [0.0, 0.0, 0.0]
    np.testing.assert_array_equal(got.numpy(), np.tile(expect, (8, 1)))
