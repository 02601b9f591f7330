"""Port parity, render layer: the progressive Renderer, the committed JAX
goldens, megakernel routing, and the port's independence from JAX.

Tests that need an NVIDIA GPU carry the ``cuda`` marker and skip here with
a reason; ``python3 chip_smoke.py`` runs the same checks on the card at
full size.
"""

import ctypes
import os
import pathlib
import shutil
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
from tpu_path_tracer_torch.utils import profiling

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
    before = profiling.counts()["megakernel_fwd"]
    np.testing.assert_array_equal(_frame(True).numpy(), _frame(False).numpy())
    assert profiling.counts()["megakernel_fwd"] == before


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
    cfg = pt.RenderConfig(use_megakernel=True)
    assert mk.route(scene, meta, cfg, torch.eye(4),
                    torch.device("cpu")).tracer == mk.TABLES
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


# The forward kernel's tracer (csrc/tracer.cuh) built as plain C++ for the
# CPU: trace_pixel is __host__ __device__ code.  This harness does per
# pixel what the kernel does per thread, on the arguments of the C entry
# point: copy the tables, derive their invariants (prepare_scene), trace.
HOST_FORWARD = r"""
#include <vector>
#include "tracer.cuh"
using namespace tpt;
extern "C" void host_fwd(
    const float* tables, int n_sph, int n_quad, int n_tri, const int* state,
    const int* px, const int* py, float* out, int n, int spp,
    int max_bounces, int grid_n, int use_nee, int has_volumes,
    int rr_start_bounce, float t_min, float t_max, float inf, float p_light,
    float bg_r, float bg_g, float bg_b, float aspect, float fov_factor,
    float w, float h, float sub_scale, float inv_spp) {
  const Params p = {n_sph, n_quad, n_tri, n, spp, max_bounces, grid_n,
                    use_nee, has_volumes, rr_start_bounce, t_min, t_max, inf,
                    p_light, bg_r, bg_g, bg_b, aspect, fov_factor, w, h,
                    sub_scale, inv_spp};
  std::vector<float> scene(scene_floats(p));
  for (int k = 0; k < table_floats(p); ++k) scene[k] = tables[k];
  for (int k = 0; k < scene_invariants(p); ++k) {
    prepare_scene(p, scene.data(), k);
  }
  const Tables<const float> S = tables_at<const float>(scene.data(), p);
  for (int i = 0; i < n; ++i) {
    trace_pixel(p, S, (uint32_t)state[i], (float)px[i], (float)py[i],
                out + 3 * i);
  }
}
"""


@pytest.fixture(scope="module")
def host_forward(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a C++ compiler (g++)")
    csrc = pathlib.Path(mk.__file__).resolve().parent.parent / "csrc"
    out = tmp_path_factory.mktemp("host_forward")
    (out / "host.cpp").write_text(HOST_FORWARD)
    # -ffp-contract=off: no a*b+c contraction, as nvcc's --fmad=false.
    subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", str(csrc), "-o",
                    str(out / "host.so"), str(out / "host.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out / "host.so"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.host_fwd.argtypes = [p, i, i, i] + [p] * 4 + [i] * 7 + [f] * 13
    lib.host_fwd.restype = None
    return lib


# name: (scene, eye, config).  reference_spp4 samples a volume scene more
# than once: the volume pass skips the non-ISOTROPIC spheres' roots but
# keeps their draws, and each sample starts where the last one's stream
# ended.
HOST_FORWARD_CASES = {
    "reference": (pt.builtin.reference_scene, [0.5, 0.0, 2.5],
                  dict(max_bounces=4)),
    "cornell_nee": (pt.builtin.cornell_box, [0, 0, 3.2],
                    dict(max_bounces=4, importance_sampling=True)),
    "reference_spp4": (pt.builtin.reference_scene, [0.5, 0.0, 2.5],
                       dict(max_bounces=4, samples_per_pixel=4,
                            importance_sampling=True)),
}


@pytest.mark.parametrize("name", sorted(HOST_FORWARD_CASES))
def test_forward_kernel_source_on_cpu(host_forward, name):
    """The forward kernel's tracer, built for the CPU, against its plain
    version (the wavefront) from the same PCG states on a 16x16 frame,
    with chip_smoke.py phase 3's tolerance."""
    scene_fn, eye, kw = HOST_FORWARD_CASES[name]
    scene, meta, _ = scene_fn(device="cpu")
    cfg = pt.RenderConfig(width=16, height=16, **kw)
    view = torch.as_tensor(pt.Camera(eye=eye).view_matrix)
    pix, px, py = pixel_grid(16, 16, "cpu")
    state = trng.seed(pix, 3)
    ref = mk.path_trace_pixels_reference(state, view, px, py, scene, meta,
                                         cfg).numpy()
    tables = mk.pack_tables(scene) + (view,)
    flat, counts, st32, px32, py32 = mk._prepare(state, px, py, tables,
                                                 scene)
    got = torch.empty((px.shape[0], 3))
    host_forward.host_fwd(flat.data_ptr(), *counts, st32.data_ptr(),
                          px32.data_ptr(), py32.data_ptr(), got.data_ptr(),
                          *mk._scalar_args(scene, meta, cfg, px.shape[0]))
    got = got.numpy()
    assert np.isfinite(got).all()
    tol = chip_smoke.KERNEL_TOL
    share = np.isclose(got, ref, rtol=tol, atol=tol).all(axis=-1).mean()
    assert share >= chip_smoke.KERNEL_MIN_SHARE, share
    np.testing.assert_allclose(got.mean(0), ref.mean(0),
                               rtol=chip_smoke.KERNEL_MEAN_RTOL, atol=1e-6)
    assert got.max() > 0


def test_ptxas_report_reads_registers_spills_and_smem():
    """The build log's ptxas lines give each kernel's registers, static
    shared memory and spills (the kernels line of chip_smoke.py)."""
    from tpu_path_tracer_torch.kernels import _build

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN1a9sweep_kernelEv' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _ZN1a9sweep_kernelEv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 37 registers, used 1 barriers, 11264 bytes smem",
        "ptxas info    : Compiling entry function '_ZN1a10adjoint_kernelEv' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _ZN1a10adjoint_kernelEv",
        "    280 bytes stack frame, 276 bytes spill stores, 420 bytes spill "
        "loads",
        "ptxas info    : Used 96 registers, used 1 barriers, 280 bytes "
        "cumulative stack size"])
    assert _build.ptxas_report(log, "sweep_kernel") == {
        "registers": 37, "smem_bytes": 11264, "spill_bytes": 0,
        "stack_bytes": 0}
    assert _build.ptxas_report(log, "adjoint_kernel") == {
        "registers": 96, "smem_bytes": 0, "spill_bytes": 696,
        "stack_bytes": 280}
    with pytest.raises(ValueError, match="0 kernels"):
        _build.ptxas_report(log, "missing_kernel")


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
    before = profiling.counts()["megakernel_fwd"]
    got = mk.path_trace_pixels_megakernel(state, view, px, py, scene, meta,
                                          cfg)
    torch.cuda.synchronize()
    assert profiling.counts()["megakernel_fwd"] == before + 1
    ref = mk.path_trace_pixels_reference(state, view, px, py, scene, meta,
                                         cfg)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=RAD_TOL, atol=RAD_TOL)
