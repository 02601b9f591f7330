"""The reference under ``benchmark/reference`` against the program it
judges, at small sizes on the CPU: the same scenes, the same radiance bit
for bit, the same gradients, the same work counts and bounds, the same
display, and Adam as ``torch.optim.Adam`` computes it."""

import numpy as np
import pytest
import torch

from benchmark import system
from benchmark.reference import adam as ra
from benchmark.reference import film as rf
from benchmark.reference import integrator as ri
from benchmark.reference import scene as rs
from benchmark.reference import train as rt
from benchmark.reference import work as rw
from benchmark.scenes import cornell_box, reference_scene

import tpu_path_tracer_torch as pt
from tpu_path_tracer_torch.diff.params import apply_params, extract_params
from tpu_path_tracer_torch.integrator import film
from tpu_path_tracer_torch.integrator.render import (path_trace_pixels,
                                                     pixel_grid)
from tpu_path_tracer_torch.core import rng
from tpu_path_tracer_torch.utils import bounds

SCENES = {"cornell": (cornell_box, pt.builtin.cornell_box, [0, 0, 3.2]),
          "reference": (reference_scene, pt.builtin.reference_scene,
                        [0.5, 0, 2.5])}


def _job(**kw):
    job = dict(width=12, height=8, spp=1, bounces=4, nee=True,
               stratify=False, rr_start=3)
    job.update(kw)
    return job


def _both(name):
    recipe, _, eye = SCENES[name]
    desc = recipe.describe({})
    scene, meta = system.build_scene(desc, "cpu")
    view = torch.as_tensor(rs.target_to(eye, [0, 0, 0], [0, 1, 0]))
    return desc, scene, meta, view


@pytest.mark.parametrize("name", sorted(SCENES))
def test_recipes_build_the_builtin_scenes(name):
    recipe, builtin, eye = SCENES[name]
    desc = recipe.describe({})
    ours, meta = system.build_scene(desc, "cpu")
    theirs, meta2, _ = builtin(device="cpu")
    ref = rs.build(desc, "cpu")
    assert meta == meta2
    assert ref.light_index == theirs.light_index
    assert ref.has_volumes == meta.has_volumes
    for group in ("materials", "spheres", "quads", "triangles"):
        a, b = getattr(ours, group), getattr(theirs, group)
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), (group, f)
            assert torch.equal(getattr(ref, group)[f], getattr(b, f)), \
                (group, f)
    cam = pt.Camera(eye=eye, center=[0, 0, 0])
    assert np.array_equal(rs.target_to(eye, [0, 0, 0], [0, 1, 0]),
                          cam.view_matrix)


@pytest.mark.parametrize("name,kw", [
    ("cornell", {}), ("cornell", {"nee": False, "bounces": 6}),
    ("reference", {"nee": False, "bounces": 6}), ("reference", {}),
    ("cornell", {"spp": 4, "stratify": True, "bounces": 2}),
    ("reference", {"spp": 2, "bounces": 3})])
def test_radiance_equals_the_program_wavefront(name, kw):
    desc, scene, meta, view = _both(name)
    job = _job(**kw)
    cfg = system.render_config(job).replace(use_megakernel=False)
    pix, px, py = pixel_grid(job["width"], job["height"], "cpu")
    with torch.no_grad():
        _, theirs = path_trace_pixels(rng.seed(pix, 9), view, px, py, scene,
                                      meta, cfg)
        ours = ri.pixels_radiance(pix, 9, view, rs.build(desc, "cpu"), job)
    assert torch.equal(ours, theirs)


@pytest.mark.parametrize("name,nee", [("cornell", True),
                                      ("reference", False)])
def test_gradients_equal_autograd_of_the_program(name, nee):
    desc, scene, meta, view = _both(name)
    job = _job(nee=nee)
    cfg = system.render_config(job).replace(use_megakernel=False)
    n = job["width"] * job["height"]
    target = torch.rand((n, 3), generator=torch.Generator().manual_seed(0))
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in extract_params(scene).items()}
    pix, px, py = pixel_grid(job["width"], job["height"], "cpu")
    _, rad = path_trace_pixels(rng.seed(pix, 5), view, px, py,
                               apply_params(scene, params), meta, cfg)
    loss = torch.sum((rad - target) ** 2) / float(n * 3)
    loss.backward()
    ref = rs.build(desc, "cpu")
    ours_loss, grads = rt.loss_and_grads(
        ref, {k: ref.materials[k] for k in params}, target, 5, view, job,
        block=40)
    assert float(ours_loss) == pytest.approx(float(loss.detach()), rel=1e-6)
    for k, p in params.items():
        want = torch.zeros_like(p) if p.grad is None else p.grad
        torch.testing.assert_close(grads[k], want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name,nee", [("cornell", True),
                                      ("reference", False),
                                      ("reference", True)])
@pytest.mark.parametrize("backward", [False, True])
def test_work_and_bound_equal_the_program_arithmetic(name, nee, backward):
    desc, scene, meta, view = _both(name)
    job = _job(nee=nee, bounces=5)
    cfg = system.render_config(job)
    theirs = bounds.megakernel_bound(scene, meta, cfg,
                                     SCENES[name][2], backward)
    ref = rs.build(desc, "cpu")
    work = {}
    pix = torch.arange(job["width"] * job["height"])
    with torch.no_grad():
        ri.pixels_radiance(pix, 1, view, ref, job, work)
    work = {k: int(work.get(k, 0)) for k in ("lanes", "facing_quads",
                                             "spans", "events")}
    assert work["lanes"] == theirs["lane_bounces"]
    for k in ("facing_quads", "spans", "events"):
        assert work[k] == theirs[k]
    ours = rw.megakernel_bound(work, rw.scene_counts(ref), pix.shape[0],
                               nee, backward)
    for k in ("bound_ms", "bound_by", "flops", "bytes"):
        assert ours[k] == theirs[k]


def test_film_equals_the_program():
    g = torch.Generator().manual_seed(1)
    fb = torch.rand((64, 3), generator=g) * 40.0
    rad = torch.rand((64, 3), generator=g) * 3.0
    assert torch.equal(rf.accumulate(fb, rad, False),
                       film.accumulate(fb.clone(), rad, False))
    assert torch.equal(rf.accumulate(fb, rad, True),
                       film.accumulate(fb.clone(), rad, True))
    assert torch.equal(rf.display(fb, 17),
                       film.to_uint8(film.display_transform(fb, 17)))


def test_adam_follows_torch():
    g = torch.Generator().manual_seed(2)
    p0 = {"a": torch.randn((5, 3), generator=g),
          "b": torch.randn((4,), generator=g)}
    leaves = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    opt = torch.optim.Adam(leaves.values(), lr=0.05)
    ours = ra.Adam({k: v.clone() for k, v in p0.items()}, lr=0.05)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in p0.items()}
        for k, v in leaves.items():
            v.grad = grads[k].clone()
        opt.step()
        ours.step(grads)
    for k in p0:
        torch.testing.assert_close(ours.params[k], leaves[k].detach(),
                                   rtol=1e-6, atol=1e-7)
