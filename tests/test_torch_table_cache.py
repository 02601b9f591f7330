"""The megakernel wrapper's cache of packed scene tables: without
gradients its CUDA route packs a scene once and reuses the flat tables
while the scene's tensors are unchanged, and every frame's flat buffer
holds the bytes a fresh pack gives.

The route runs on CPU tensors with the launch's ctypes call replaced by a
stand-in that copies out the flat tables it was handed (the
``kernel_route`` fixture of ``torch_kernel_route.py``).
"""

import pytest
import torch

import tpu_path_tracer_torch as pt
from tpu_path_tracer_torch.diff.params import apply_params, extract_params
from tpu_path_tracer_torch.integrator.render import render_frame
from tpu_path_tracer_torch.kernels import megakernel as mk
from tpu_path_tracer_torch.utils import profiling

from torch_kernel_route import kernel_route  # noqa: F401

CFG = pt.RenderConfig(width=8, height=4, max_bounces=2,
                      importance_sampling=True, use_megakernel=True)
EYES = ([0.0, 0.0, 3.2], [0.3, -0.2, 2.9])


@pytest.fixture(autouse=True)
def clean_record():
    profiling.reset()
    mk.clear_table_cache()
    yield
    profiling.reset()
    mk.clear_table_cache()


def _scene(make="cornell_box"):
    scene, meta, _ = getattr(pt.builtin, make)(device="cpu")
    return scene, meta


def _view(eye=EYES[0]):
    return pt.Camera(eye=eye).view_matrix


def _frame(scene, meta, view, frame=1):
    fb = torch.zeros((CFG.width * CFG.height, 3))
    return render_frame(fb, frame, frame == 1, view, scene, meta, CFG)


def _fresh(scene, view):
    """The flat tables as the wrapper packed them on every frame before it
    cached them: the five tables of a fresh pack, concatenated."""
    tables = mk.pack_tables(scene) + (torch.as_tensor(view),)
    return torch.cat([t.detach().reshape(-1).float() for t in tables])


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _packs_and_hits():
    c = profiling.counts()
    return c["table_packs"], c["table_cache_hits"]


@pytest.mark.parametrize("make", ["cornell_box", "reference_scene"])
@pytest.mark.parametrize("moving", [False, True], ids=["static", "camera"])
def test_a_static_scene_packs_once(kernel_route, make, moving):
    """Five frames of one scene pack its tables on the first frame and
    reuse them on the other four, the camera still or moving between
    frames; each frame's flat tables equal a fresh pack's bit for bit, the
    view's 16 floats those of its own frame."""
    scene, meta = _scene(make)
    views = [_view(EYES[moving and f % 2]) for f in range(5)]
    for f, view in enumerate(views):
        _frame(scene, meta, view, f + 1)
    assert _packs_and_hits() == (1, 4)
    assert len(kernel_route) == 5
    for flat, view in zip(kernel_route, views):
        assert _same_bits(flat, _fresh(scene, view))
    cams = {tuple(flat[-mk.CAM_COLS:].tolist()) for flat in kernel_route}
    assert len(cams) == 1 + moving


def _emission_scaled(scene):
    with torch.no_grad():
        scene.materials.emission.mul_(2.0)
    return scene


def _material_swapped(scene):
    return scene._replace(materials=scene.materials._replace(
        color=scene.materials.color.flip(0)))


def _light_moved(scene):
    return scene._replace(light_index=scene.light_index + 1)


def _rebuilt(scene):
    return _scene()[0]


@pytest.mark.parametrize("change", [_emission_scaled, _material_swapped,
                                    _light_moved, _rebuilt],
                         ids=["edit_in_place", "new_tensor", "new_light",
                              "equal_new_scene"])
def test_a_changed_scene_repacks(kernel_route, change):
    """An edit in place (the version counter moves), another tensor, another
    light and a new scene with equal values each repack, and the flat
    tables are then the changed scene's."""
    scene, meta = _scene()
    view = _view()
    _frame(scene, meta, view)
    _frame(scene, meta, view)
    changed = change(scene)
    _frame(changed, meta, view)
    _frame(changed, meta, view)
    assert _packs_and_hits() == (2, 2)
    assert _same_bits(kernel_route[0], kernel_route[1])
    assert _same_bits(kernel_route[2], _fresh(changed, view))
    assert _same_bits(kernel_route[3], kernel_route[2])
    if change is not _rebuilt:
        assert not _same_bits(kernel_route[2], kernel_route[0])


def _trained(fused):
    """Parameters that require grad, as a training job holds them, and an
    Adam over them."""
    scene, meta = _scene()
    params = {k: v.clone().requires_grad_()
              for k, v in extract_params(scene, ("emission", "bsdf")).items()}
    return scene, meta, params, torch.optim.Adam(params.values(), lr=0.05,
                                                 fused=fused)


@pytest.mark.parametrize("fused", [False, True], ids=["adam", "fused_adam"])
def test_a_preview_of_parameters_repacks(kernel_route, fused):
    """A preview renders the parameters through ``apply_params`` under
    ``no_grad``: they may change without their version counter moving (a
    fused Adam step keeps it), so each frame packs, and the frame after an
    Adam step holds the stepped values."""
    scene, meta, params, adam = _trained(fused)
    view = _view()
    with torch.no_grad():
        _frame(apply_params(scene, params), meta, view)
        _frame(apply_params(scene, params), meta, view)
    for p in params.values():
        p.grad = torch.ones_like(p)
    adam.step()
    with torch.no_grad():
        stepped = apply_params(scene, params)
        _frame(stepped, meta, view)
        assert _packs_and_hits() == (3, 0)
        assert _same_bits(kernel_route[2], _fresh(stepped, view))
    assert not _same_bits(kernel_route[2], kernel_route[1])


def test_a_detached_preview_is_cleared_by_hand(kernel_route):
    """A preview scene built once over parameters held detached
    (``p.detach()``) requires no grad and is cached; a fused Adam step
    writes the parameters without moving their version counter, so the
    next frame reuses the old tables, as ``clear_table_cache`` documents,
    and after it the frame packs the stepped values."""
    scene, meta, params, adam = _trained(True)
    view = _view()
    preview = apply_params(scene, {k: p.detach() for k, p in params.items()})
    with torch.no_grad():
        _frame(preview, meta, view)
    for p in params.values():
        p.grad = torch.ones_like(p)
    adam.step()
    with torch.no_grad():
        _frame(preview, meta, view)
        mk.clear_table_cache()
        _frame(preview, meta, view)
    assert _packs_and_hits() == (2, 1)
    stepped = _fresh(preview, view)
    assert _same_bits(kernel_route[1], kernel_route[0])
    assert not _same_bits(kernel_route[1], stepped)
    assert _same_bits(kernel_route[2], stepped)


def test_gradients_pack_every_call(kernel_route):
    """With a graph wanted the route packs through the differentiable ops
    on every call, and never reads the cache."""
    scene, meta, params, _ = _trained(False)
    view = _view()
    for f in range(3):
        radiance = _frame(apply_params(scene, params), meta, view, f + 1)
        assert radiance.requires_grad
    assert _packs_and_hits() == (3, 0)
    assert mk._packed == {}
    for flat in kernel_route:
        assert _same_bits(flat, _fresh(scene, view))


def test_inference_tensors_are_not_cached(kernel_route):
    """A scene of inference tensors keeps no version counter, so it packs
    on every frame."""
    with torch.inference_mode():
        scene, meta = _scene()
    view = _view()
    for f in range(3):
        _frame(scene, meta, view, f + 1)
    assert _packs_and_hits() == (3, 0)
    assert _same_bits(kernel_route[2], _fresh(scene, view))


def test_two_scenes_in_turn_repack(kernel_route):
    """The cache holds the last scene of a device: two scenes rendered in
    turn repack on every frame, each frame with its own scene's tables."""
    scenes = [_scene("cornell_box"), _scene("reference_scene")]
    view = _view()
    for f in range(4):
        _frame(*scenes[f % 2], view, f + 1)
    assert _packs_and_hits() == (4, 0)
    for f, flat in enumerate(kernel_route):
        assert _same_bits(flat, _fresh(scenes[f % 2][0], view))


def test_the_wavefront_touches_neither_counter():
    """``use_megakernel=False`` (and, on CPU tensors, the megakernel's own
    plain version) neither packs nor reads the cache."""
    scene, meta = _scene()
    for f in range(3):
        fb = torch.zeros((CFG.width * CFG.height, 3))
        render_frame(fb, f + 1, f == 0, _view(), scene, meta,
                     CFG.replace(use_megakernel=f == 2))
    assert _packs_and_hits() == (0, 0)
    assert mk._packed == {}
