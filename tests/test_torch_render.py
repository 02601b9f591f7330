"""Port parity, render layer: the progressive Renderer, the committed JAX
goldens, megakernel routing, and the port's independence from JAX.

Tests that need an NVIDIA GPU carry the ``cuda`` marker and skip here with
a reason; ``python3 chip_smoke.py`` runs the same checks on the card at
full size.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import tpu_path_tracer as tpt
from tpu_path_tracer.integrator import film as jfilm
from tpu_path_tracer.integrator.render import render_frame as jrender_frame

import tpu_path_tracer_torch as pt
from tpu_path_tracer_torch.core import rng as trng
from tpu_path_tracer_torch.integrator.render import pixel_grid
from tpu_path_tracer_torch.kernels import megakernel as mk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
RAD_TOL = 2e-4  # tests/test_pallas.py:52


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run python3 chip_smoke.py there)")
    return torch.device("cuda", 0)


def test_renderer_progressive_matches_jax():
    """Three progressive frames with a camera move (reset) between the
    second and the third, against the JAX ``render_frame`` loop run op by
    op: framebuffer at rtol = atol = 2e-4, the displayed uint8 image
    equal."""
    cfg_kw = dict(width=16, height=8, max_bounces=4, importance_sampling=True)
    tscene, tmeta, _ = pt.builtin.cornell_box(device="cpu")
    renderer = pt.Renderer(tscene, tmeta, pt.RenderConfig(**cfg_kw),
                           camera=pt.Camera(eye=[0, 0, 3.2]))
    jscene, jmeta, _ = tpt.builtin.cornell_box()
    jcfg = tpt.RenderConfig(**cfg_kw, use_pallas=False)
    jcam = tpt.Camera(eye=[0, 0, 3.2])
    fb = jnp.zeros((16 * 8, 3), jnp.float32)
    frame = 0
    for k in range(3):
        if k == 2:
            renderer.camera.zoom(1.0)
            jcam.zoom(1.0)
        reset = jcam.consume_motion_flags()
        frame = 1 if reset else frame + 1
        with jax.disable_jit():
            fb = jrender_frame(fb, jnp.int32(frame), jnp.bool_(reset),
                               jnp.asarray(jcam.view_matrix), jscene, jmeta,
                               jcfg)
        renderer.step()
        assert renderer.frame_num == frame
        np.testing.assert_allclose(renderer.framebuffer.numpy(),
                                   np.asarray(fb), rtol=RAD_TOL, atol=RAD_TOL)
    with jax.disable_jit():
        jimg = np.asarray(jfilm.to_uint8(jfilm.display_transform(fb, frame)))
    np.testing.assert_array_equal(renderer.display(),
                                  jimg.reshape(8, 16, 3))


def test_renderer_save_png_and_single_frame(tmp_path):
    scene, meta, _ = pt.builtin.cornell_box(device="cpu")
    renderer = pt.Renderer(scene, meta,
                           pt.RenderConfig(width=8, height=4, max_bounces=2),
                           camera=pt.Camera(eye=[0, 0, 3.2]))
    renderer.render_animation(2)
    assert renderer.frame_num == 2
    renderer.render_single_frame(spp=2)
    assert renderer.frame_num == 1 and renderer.cfg.samples_per_pixel == 2
    path = tmp_path / "out.png"
    renderer.save_png(str(path))
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# Goldens: tests/test_golden.py's settings and per-pixel tolerance.  The
# goldens come from JAX compiled by XLA's CPU backend, which contracts a*b+c
# into fused multiply-adds; the port rounds each operation alone.  That
# moves the self-intersection of rays leaving sphere surfaces, so some
# paths differ (test_golden_gap_is_xla_contraction shows it).  The golden
# checks therefore hold a share of pixels and the image mean, with the
# bounds chip_smoke.py holds the card to.
GOLDEN_CASES = {"cornell_box": (pt.builtin.cornell_box, [0, 0, 3.2]),
                "reference_scene": (pt.builtin.reference_scene,
                                    [0.5, 0.0, 2.5])}
GOLDEN_KW = dict(width=64, height=64, max_bounces=6,
                 importance_sampling=False)


def _golden_view(eye):
    return pt.Camera(eye=eye, center=[0, 0, 0]).view_matrix


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_port_against_jax_goldens(name):
    scene_fn, eye = GOLDEN_CASES[name]
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    scene, meta, _ = scene_fn(device="cpu")
    cfg = pt.RenderConfig(**GOLDEN_KW)
    fb = torch.zeros((64 * 64, 3))
    for f in range(1, 9):
        pt.render_frame(fb, f, f == 1, _golden_view(eye), scene, meta, cfg)
    img = (fb / 8).numpy().reshape(golden.shape)
    assert np.isfinite(img).all()
    share = np.isclose(img, golden, rtol=chip_smoke.GOLDEN_RTOL,
                       atol=chip_smoke.GOLDEN_ATOL).all(-1).mean()
    assert share >= chip_smoke.GOLDEN_MIN_SHARE, share
    np.testing.assert_allclose(img.mean((0, 1)), golden.mean((0, 1)),
                               rtol=chip_smoke.GOLDEN_MEAN_RTOL)


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_golden_gap_is_xla_contraction(name):
    """Why the golden checks hold a share of pixels.  At the golden
    settings (64x64, 6 bounces, NEE off; one frame) the port equals JAX
    run op by op on every pixel (rtol = atol = 2e-4).  JAX compiled by
    XLA, which made the goldens (test_golden.py holds jitted JAX to them
    on every pixel), leaves the port on exactly the pixels where it
    leaves JAX op by op, and on fewer than the golden bound allows."""
    scene_fn, eye = GOLDEN_CASES[name]
    scene, meta, _ = scene_fn(device="cpu")
    fb = torch.zeros((64 * 64, 3))
    port = pt.render_frame(fb, 1, True, _golden_view(eye), scene, meta,
                           pt.RenderConfig(**GOLDEN_KW)).numpy()
    jscene, jmeta, _ = getattr(tpt.builtin, name)()
    jcfg = tpt.RenderConfig(**GOLDEN_KW, use_pallas=False)
    args = (jnp.zeros((64 * 64, 3), jnp.float32), jnp.int32(1),
            jnp.bool_(True), jnp.asarray(_golden_view(eye)), jscene, jmeta,
            jcfg)
    with jax.disable_jit():
        op_by_op = np.asarray(jrender_frame(*args))
    jitted = np.asarray(jrender_frame(*args))
    np.testing.assert_allclose(port, op_by_op, rtol=RAD_TOL, atol=RAD_TOL)

    def off_jitted(img):
        return ~np.isclose(img, jitted, rtol=RAD_TOL, atol=RAD_TOL).all(-1)

    np.testing.assert_array_equal(off_jitted(port), off_jitted(op_by_op))
    assert off_jitted(port).mean() <= 1 - chip_smoke.GOLDEN_MIN_SHARE


def _frame(use_megakernel, scene_fn=pt.builtin.reference_scene):
    scene, meta, _ = scene_fn(device="cpu")
    cfg = pt.RenderConfig(width=16, height=8, max_bounces=3,
                          use_megakernel=use_megakernel)
    fb = torch.zeros((16 * 8, 3))
    view = pt.Camera(eye=[0.5, 0.0, 2.5]).view_matrix
    return pt.render_frame(fb, 1, True, view, scene, meta, cfg)


def test_megakernel_route_on_cpu_is_the_wavefront():
    """On CPU tensors the megakernel route runs its plain version: the
    same image bit for bit, and no kernel launch."""
    before = mk.LAUNCHES
    np.testing.assert_array_equal(_frame(True).numpy(), _frame(False).numpy())
    assert mk.LAUNCHES == before


def test_megakernel_wrapper_has_no_fallback(monkeypatch):
    """A device other than CPU or CUDA has no route, and the CUDA route
    raises when the toolkit is missing instead of falling back."""
    from tpu_path_tracer_torch.kernels import _build

    scene, meta, _ = pt.builtin.cornell_box(device="meta")
    cfg = pt.RenderConfig(width=4, height=4, use_megakernel=True)
    pix, px, py = pixel_grid(4, 4, "meta")
    with pytest.raises(ValueError, match="no route"):
        mk.path_trace_pixels_megakernel(pix, torch.eye(4, device="meta"),
                                        px, py, scene, meta, cfg)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_supported_routing():
    scene, meta, _ = pt.builtin.reference_scene(device="cpu")
    assert mk.supported(scene, meta, pt.RenderConfig())
    assert scene.triangles.count == 12
    assert mk.resolved_spp(pt.RenderConfig(samples_per_pixel=5,
                                           stratify=True)) == 4


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port without
    loading JAX or the JAX package."""
    code = ("import sys, tpu_path_tracer_torch, "
            "tpu_path_tracer_torch.kernels.megakernel, "
            "tpu_path_tracer_torch.kernels._build, "
            "tpu_path_tracer_torch.kernels.traversal, "
            "tpu_path_tracer_torch.accel.native, "
            "tpu_path_tracer_torch.accel.refit, "
            "tpu_path_tracer_torch.renderer, "
            "tpu_path_tracer_torch.diff.params, "
            "tpu_path_tracer_torch.dist.render_dist, "
            "tpu_path_tracer_torch.cli, tpu_path_tracer_torch.__main__; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'tpu_path_tracer.')) "
            "or m == 'tpu_path_tracer']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.cuda
def test_cuda_megakernel_matches_plain_version(cuda_device):
    """The CUDA kernel against the wavefront on the card, from the same
    PCG states: every pixel within 2e-4 on this small frame, and one
    launch counted."""
    scene, meta, _ = pt.builtin.reference_scene(device=cuda_device)
    cfg = pt.RenderConfig(width=16, height=8, max_bounces=3,
                          use_megakernel=True)
    pix, px, py = pixel_grid(16, 8, cuda_device)
    view = torch.as_tensor(pt.Camera(eye=[0.5, 0.0, 2.5]).view_matrix,
                           device=cuda_device)
    state = trng.seed(pix, 3)
    before = mk.LAUNCHES
    got = mk.path_trace_pixels_megakernel(state, view, px, py, scene, meta,
                                          cfg)
    torch.cuda.synchronize()
    assert mk.LAUNCHES == before + 1
    ref = mk.path_trace_pixels_reference(state, view, px, py, scene, meta,
                                         cfg)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=RAD_TOL, atol=RAD_TOL)
