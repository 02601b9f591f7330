"""Port parity, training layer: wavefront gradients, scene parameters, the
train step and the ``train``/``grad-check`` commands, against the JAX
package.

Gradient references are ``jax.value_and_grad`` of the JAX wavefront run op
by op (``jax.disable_jit``), like the forward parity tests: compiled by XLA,
which contracts a*b+c into fused multiply-adds, the JAX wavefront takes
other branches than both the port and itself op by op on some paths of the
glass scene and of the 8x8 Cornell box, which moves the loss by 1e-3.  At
these sizes op by op costs no more than compiling.  The tolerance is that
of the JAX package's own kernel gradient tests (``tests/test_pallas.py:
160-167``): every gradient within 2e-3 of its group's largest, the loss
within 1e-6.

Tests that need an NVIDIA GPU carry the ``cuda`` marker and skip here;
``python3 chip_smoke.py`` runs the CUDA backward kernel against its plain
version on the card.
"""

import ctypes
import dataclasses
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpu_path_tracer as tpt
from tpu_path_tracer.core import rng as jrng
from tpu_path_tracer.diff import params as jparams
from tpu_path_tracer.integrator.render import path_trace_pixels as jptp
from tpu_path_tracer.scene.objreader import MeshData

import tpu_path_tracer_torch as pt
from tpu_path_tracer_torch import cli
from tpu_path_tracer_torch.core import rng as trng
from tpu_path_tracer_torch.diff import params as tparams
from tpu_path_tracer_torch.dist import render_dist
from tpu_path_tracer_torch.integrator.render import (path_trace_pixels as
                                                     tptp, pixel_grid)
from tpu_path_tracer_torch.kernels import megakernel as mk
from tpu_path_tracer_torch.scene.objreader import save_obj

GRAD_RTOL = 2e-3   # tests/test_pallas.py:160
LOSS_RTOL = 1e-6   # tests/test_pallas.py:183
SEED = 7


def _port(jscene, jmeta):
    return (pt.scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu"),
            pt.SceneMeta(**dataclasses.asdict(jmeta)))


def _tent_scene():
    """tests/test_pallas.py:72-101: one emissive quad, one glass sphere and
    a 4-triangle tent."""
    b = tpt.SceneBuilder()
    white = b.add_material("white", tpt.LAMBERTIAN, [0.7, 0.7, 0.7])
    light = b.add_material("light", tpt.LAMBERTIAN, [0, 0, 0],
                           emission=[3, 3, 3])
    glass = b.add_material("glass", tpt.GLASS, [1, 1, 1], eta=1.5)
    b.add_quad([-1, 1, -1], [2, 0, 0], [0, 0, 2], light)
    b.add_sphere([0.5, -0.3, 0.2], 0.3, glass)
    tent = [[-0.6, -0.5, 0.0], [0.0, -0.5, -0.6], [0.0, 0.2, -0.2],
            [0.6, -0.5, 0.0]]
    tris = np.asarray([[tent[0], tent[1], tent[2]],
                       [tent[1], tent[3], tent[2]],
                       [tent[0], tent[2], tent[3]],
                       [tent[0], tent[3], tent[1]]], np.float32)
    nrm = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    b.add_mesh(MeshData(vertices=tris.reshape(-1, 3),
                        normals=np.repeat(nrm, 3, axis=0).astype(np.float32)),
               white)
    scene, meta = b.build(bvh="none")
    return scene, meta, b


# name: (JAX scene, eye, center, config, groups, differentiate the view)
GRAD_CASES = {
    # 5 bounces: Russian roulette (from bounce 3) compensates a throughput
    # that the next bounce reads, so its gradient is live; the white walls
    # make the max-channel ties.
    "cornell_nee_5_bounces": (
        lambda: tpt.builtin.cornell_box(), [0, 0, 3.2], [0, 0, 0],
        dict(width=8, height=4, max_bounces=5, importance_sampling=True),
        ("emission", "bsdf", "quads"), False),
    # All four BSDFs and the fog volumes; the camera looks at the sphere
    # stacks so that paths through them reach the NEE pdf.
    "reference_mini": (
        lambda: tpt.builtin.reference_scene(include_mesh=False, mini=True),
        [0.4, -0.4, 1.5], [0.4, -0.6, 0.2],
        dict(width=8, height=8, max_bounces=5, importance_sampling=True),
        ("emission", "bsdf", "spheres"), False),
    "tent_vertices": (
        _tent_scene, [0.0, 0.0, 2.5], [0, 0, 0],
        dict(width=8, height=8, max_bounces=2, importance_sampling=True,
             light_sample_prob=0.9),
        ("emission", "vertices"), False),
    "cornell_view_matrix": (
        lambda: tpt.builtin.cornell_box(), [0, 0, 3.2], [0, 0, 0],
        dict(width=8, height=8, max_bounces=3, importance_sampling=True),
        ("emission",), True),
}


def _jax_value_and_grad(jscene, jmeta, jcfg, view, groups):
    """value_and_grad of mean(radiance^2) with respect to the parameter
    groups and the view matrix, op by op."""
    w, h = jcfg.width, jcfg.height
    pix = jnp.arange(w * h, dtype=jnp.uint32)
    px = (pix % jnp.uint32(w)).astype(jnp.int32)
    py = (pix // jnp.uint32(w)).astype(jnp.int32)

    def loss(p, view):
        s = jparams.apply_params(jscene, p)
        _, rad = jptp(jrng.seed(pix, SEED), view, px, py, s, jmeta, jcfg)
        return jnp.mean(rad ** 2)

    with jax.disable_jit():
        value, (gp, gv) = jax.value_and_grad(loss, argnums=(0, 1))(
            jparams.extract_params(jscene, groups), jnp.asarray(view))
    grads = {k: np.asarray(v) for k, v in gp.items()}
    grads["view_matrix"] = np.asarray(gv)
    return float(value), grads


def _port_value_and_grad(tscene, tmeta, tcfg, view, groups):
    params = {k: v.clone().requires_grad_(True)
              for k, v in tparams.extract_params(tscene, groups).items()}
    view_t = torch.as_tensor(view).requires_grad_(True)
    pix, px, py = pixel_grid(tcfg.width, tcfg.height, "cpu")
    s = tparams.apply_params(tscene, params)
    _, rad = tptp(trng.seed(pix, SEED), view_t, px, py, s, tmeta, tcfg)
    loss = torch.mean(rad ** 2)
    leaves = list(params.values()) + [view_t]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    out = {k: (np.zeros(tuple(t.shape), np.float32) if g is None
               else g.numpy())
           for k, t, g in zip(list(params) + ["view_matrix"], leaves, grads)}
    return float(loss.detach()), out


def _assert_grads_close(ref, got, keys, rtol=GRAD_RTOL, atol=1e-6):
    """tests/test_pallas.py:160-167: every gradient within rtol of its
    group's largest, all finite."""
    for k in keys:
        a, b = ref[k], got[k]
        assert np.all(np.isfinite(a)), f"reference grad {k} not finite"
        assert np.all(np.isfinite(b)), f"port grad {k} not finite"
        scale = max(np.max(np.abs(a)), atol)
        np.testing.assert_allclose(b, a, rtol=0, atol=rtol * scale,
                                   err_msg=f"grad mismatch in {k}")


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_wavefront_grads_match_jax(name):
    """The port's wavefront gradients against the JAX wavefront's, for the
    parameter groups (and the view matrix) of each case; the groups'
    gradients are nonzero, so the check has something to hold."""
    build, eye, center, kw, groups, with_view = GRAD_CASES[name]
    jscene, jmeta, _ = build()
    tscene, tmeta = _port(jscene, jmeta)
    view = pt.Camera(eye=eye, center=center).view_matrix
    jl, jg = _jax_value_and_grad(jscene, jmeta, tpt.RenderConfig(**kw), view,
                                 groups)
    tl, tg = _port_value_and_grad(tscene, tmeta, pt.RenderConfig(**kw), view,
                                  groups)
    assert abs(tl - jl) <= LOSS_RTOL * max(abs(jl), 1.0)
    keys = list(tparams.extract_params(tscene, groups))
    if with_view:
        keys.append("view_matrix")
    _assert_grads_close(jg, tg, keys)
    live = {"emission", "color", "quad_u", "sphere_radius", "tri_a",
            "view_matrix"}.intersection(keys)
    for k in live:
        assert np.abs(tg[k]).max() > 0, f"{k} gradient is zero"


def _cornell_grads(**cfg_kw):
    tscene, tmeta, _ = pt.builtin.cornell_box(device="cpu")
    cfg = pt.RenderConfig(width=8, height=4, max_bounces=5,
                          importance_sampling=True, **cfg_kw)
    view = pt.Camera(eye=[0, 0, 3.2]).view_matrix
    return _port_value_and_grad(tscene, tmeta, cfg, view,
                                ("emission", "bsdf", "quads"))


def test_remat_bounces_gives_the_same_gradients():
    """Replaying each bounce in the backward pass (torch.utils.checkpoint)
    gives the gradients of saving everything, bit for bit: the replay
    draws the same PCG numbers and takes the saved hit-search results."""
    l_remat, g_remat = _cornell_grads(remat_bounces=True)
    l_saved, g_saved = _cornell_grads(remat_bounces=False)
    assert l_remat == l_saved
    for k in g_saved:
        np.testing.assert_array_equal(g_remat[k], g_saved[k], err_msg=k)
    assert np.abs(g_saved["quad_u"]).max() > 0


def test_megakernel_route_on_cpu_gives_the_wavefront_gradients():
    """On CPU tensors ``use_megakernel=True`` runs the plain version, the
    wavefront, with autograd on: the same loss and gradients as the
    wavefront route, and no kernel launch."""
    before = (mk.LAUNCHES, mk.BWD_LAUNCHES)
    l_mk, g_mk = _cornell_grads(use_megakernel=True)
    l_wf, g_wf = _cornell_grads(use_megakernel=False)
    assert l_mk == l_wf
    for k in g_wf:
        np.testing.assert_array_equal(g_mk[k], g_wf[k], err_msg=k)
    assert np.abs(g_mk["emission"]).max() > 0
    assert (mk.LAUNCHES, mk.BWD_LAUNCHES) == before


def test_unroll_budget_error_and_vjp_supported():
    """Gradients of the megakernel route over MAX_UNROLL_BOUNCES bounce
    bodies raise with the JAX package's message, naming the wavefront;
    the forward alone still runs (megakernel.py:812-817)."""
    scene, meta, _ = pt.builtin.cornell_box(device="cpu")
    cfg = pt.RenderConfig(width=4, height=2, use_megakernel=True,
                          max_bounces=mk.MAX_UNROLL_BOUNCES + 1)
    assert not mk.vjp_supported(scene, meta, cfg)
    assert mk.vjp_supported(scene, meta, cfg.replace(max_bounces=64))
    strat = cfg.replace(max_bounces=17, samples_per_pixel=4, stratify=True)
    assert not mk.vjp_supported(scene, meta, strat)
    pix, px, py = pixel_grid(4, 2, "cpu")
    view = torch.as_tensor(pt.Camera(eye=[0, 0, 3.2]).view_matrix)
    params = {k: v.clone().requires_grad_(True) for k, v in
              tparams.extract_params(scene, ("emission",)).items()}
    for c in (cfg, strat):
        with pytest.raises(NotImplementedError, match="wavefront"):
            tptp(trng.seed(pix, 1), view, px, py,
                 tparams.apply_params(scene, params), meta, c)
    with torch.no_grad():
        _, rad = tptp(trng.seed(pix, 1), view, px, py,
                      tparams.apply_params(scene, params), meta, cfg)
    assert rad.shape == (8, 3)


def test_light_pdf_gradient_is_finite_for_ended_paths():
    """A fault found on the card: a path that has ended sits a miss
    distance (1e9) from the light, and the light pdf's division overflowed
    in its backward, putting NaN into the quad gradients of the whole
    frame.  This pixel of a 512x512 Cornell frame (6 bounces, NEE) showed
    it; the JAX wavefront gives finite gradients there."""
    scene, meta, _ = pt.builtin.cornell_box(device="cpu")
    cfg = pt.RenderConfig(width=512, height=512, max_bounces=6,
                          importance_sampling=True)
    params = {k: v.clone().requires_grad_(True) for k, v in
              tparams.extract_params(scene, ("quads",)).items()}
    pix = torch.tensor([39471])
    view = torch.as_tensor(pt.Camera(eye=[0, 0, 3.2]).view_matrix)
    _, rad = tptp(trng.seed(pix, SEED), view, pix % 512, pix // 512,
                  tparams.apply_params(scene, params), meta, cfg)
    grads = torch.autograd.grad(((rad - 0.3) ** 2).sum(),
                                list(params.values()))
    for k, g in zip(params, grads):
        assert torch.isfinite(g).all(), k


def test_params_match_jax():
    """extract_params on the port's scene (made with scene_from_numpy from
    the JAX scene) gives the JAX arrays; apply_params recomputes the quads'
    normal, d and w as JAX does, run op by op."""
    jscene, jmeta, _ = tpt.builtin.reference_scene()
    tscene, _ = _port(jscene, jmeta)
    assert tparams.GROUPS == jparams.GROUPS
    jp = jparams.extract_params(jscene, jparams.GROUPS)
    tp = tparams.extract_params(tscene, tparams.GROUPS)
    assert list(tp) == list(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]),
                                      err_msg=k)
    r = np.random.default_rng(0)
    moved = {k: np.asarray(v) + r.normal(scale=0.05, size=np.shape(v))
             .astype(np.float32) for k, v in jp.items()}
    with jax.disable_jit():
        js = jparams.apply_params(jscene, {k: jnp.asarray(v)
                                           for k, v in moved.items()})
    ts = tparams.apply_params(tscene, {k: torch.from_numpy(v)
                                       for k, v in moved.items()})
    for f in ("q", "u", "v", "normal", "d", "w"):
        np.testing.assert_allclose(getattr(ts.quads, f).numpy(),
                                   np.asarray(getattr(js.quads, f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    np.testing.assert_array_equal(ts.triangles.b.numpy(), moved["tri_b"])
    np.testing.assert_array_equal(ts.materials.eta.numpy(), moved["eta"])
    with pytest.raises(ValueError, match="unknown param groups"):
        tparams.extract_params(tscene, ("lights",))


def test_train_step_matches_jax_and_optax():
    """Three steps of make_train_step (torch.optim.Adam) against
    jax.value_and_grad of the JAX loss and optax.adam from the same start,
    as `cli train` sets it up: target at frame 1, emission and BSDF
    parameters scaled by 0.5.  Losses within 1e-6 relative; parameters
    within 1e-5 (Adam normalizes each step to about lr = 5e-2, so this
    holds the gradients' signs and ratios).  The JAX step is compiled, as
    optax is meant to run; at this seed XLA's contraction changes no
    path."""
    jscene, jmeta, _ = tpt.builtin.cornell_box()
    tscene, tmeta = _port(jscene, jmeta)
    kw = dict(width=8, height=8, max_bounces=3, importance_sampling=True)
    jcfg, tcfg = tpt.RenderConfig(**kw), pt.RenderConfig(**kw)
    view = pt.Camera(eye=[0, 0, 3.2]).view_matrix
    groups, lr = ("emission", "bsdf"), 5e-2

    frame = render_dist.make_sharded_frame_fn(None, tmeta, tcfg)
    n_pix = render_dist.padded_pixels(tcfg)
    with torch.no_grad():
        target = frame(torch.zeros((n_pix, 3)), 1, True, view, tscene)
    start = {k: v * 0.5 for k, v in
             tparams.extract_params(tscene, groups).items()}
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    optimizer = torch.optim.Adam(params.values(), lr=lr)
    step = render_dist.make_train_step(None, tscene, tmeta, tcfg,
                                       tparams.apply_params, optimizer)

    pix = jnp.arange(n_pix, dtype=jnp.uint32)
    px = (pix % jnp.uint32(kw["width"])).astype(jnp.int32)
    py = (pix // jnp.uint32(kw["width"])).astype(jnp.int32)

    def jloss(p):
        s = jparams.apply_params(jscene, p)
        _, rad = jptp(jrng.seed(pix, 1), jnp.asarray(view), px, py, s,
                      jmeta, jcfg)
        return jnp.mean((rad - jnp.asarray(target.numpy())) ** 2)

    adam = optax.adam(lr)

    @jax.jit
    def jstep(p, state):
        loss, g = jax.value_and_grad(jloss)(p)
        updates, state = adam.update(g, state, p)
        return optax.apply_updates(p, updates), state, loss

    jp = {k: jnp.asarray(v.numpy()) for k, v in start.items()}
    jstate = adam.init(jp)
    losses = []
    for _ in range(3):
        loss = step(params, target, 1, view)
        jp, jstate, jl = jstep(jp, jstate)
        assert abs(float(loss) - float(jl)) <= LOSS_RTOL * float(jl)
        losses.append(float(loss))
        for k in jp:
            np.testing.assert_allclose(params[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-5,
                                       err_msg=k)
    assert losses[-1] < losses[0]


def test_cli_grad_check_passes(capsys):
    """`grad-check` in process on the CPU: autodiff against finite
    differences on emission and albedo, PASS and exit code 0."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["grad-check", "--bounces", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert exc.value.code == 0, out
    assert "grad-check: PASS" in out


def test_cli_train_runs(capsys):
    """`train --steps 3` in process on the CPU, through the megakernel
    route (its plain version here): three falling losses and the error
    report."""
    cli.main(["train", "--steps", "3", "--megakernel",
              "--importance-sampling", "--device", "cpu"])
    out = capsys.readouterr().out
    losses = [float(line.split()[-1]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "max param error per group" in out


@pytest.mark.parametrize("method", ["median", "lbvh"])
def test_cli_renders_an_obj_through_a_bvh(tmp_path, method, capsys):
    """`render --scene mesh.obj --bvh <method> --device cpu` on an OBJ that
    save_obj wrote: one 16x16 frame and a PNG."""
    obj = tmp_path / "ico.obj"
    save_obj(str(obj), pt.procedural.icosphere(3, 0.6))
    png = tmp_path / "out.png"
    cli.main(["render", "--scene", str(obj), "--bvh", method, "--width",
              "16", "--height", "16", "--bounces", "3", "--frames", "1",
              "--device", "cpu", "-o", str(png)])
    assert "on cpu" in capsys.readouterr().out
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_without_a_card_raises(monkeypatch):
    """The commands run on the card by default; without one they raise,
    naming --device cpu, and do not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["render"], ["train", "--steps", "1"], ["grad-check"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(argv)


# The backward kernel's source built as plain C++ for the CPU: the adjoint
# (tracer.cuh, megakernel_bwd.cu) is __host__ __device__ code, and without
# nvcc the file leaves out the kernel and keeps the per-pixel functions.
# This drives them over every pixel, with the arguments of the C entry
# point, so the hand-written adjoint is checked here and not only on the
# card.
HOST_ADJOINT = r"""
#include <vector>
#include "megakernel_bwd.cu"
using namespace tpt;
extern "C" void host_bwd(
    const float* tables, int n_sph, int n_quad, int n_tri, const int* state,
    const int* px, const int* py, const float* gout, float* rec,
    float* gtables, int n, int spp, int max_bounces, int grid_n, int use_nee,
    int has_volumes, int rr_start_bounce, float t_min, float t_max,
    float inf, float p_light, float bg_r, float bg_g, float bg_b,
    float aspect, float fov_factor, float w, float h, float sub_scale,
    float inv_spp) {
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
  const Tables<float> G = tables_at<float>(gtables, p);
  const Sink sink = {nullptr, G.light, G.cam, 1};
  for (int i = 0; i < n; ++i) {
    const float g[3] = {gout[3 * i], gout[3 * i + 1], gout[3 * i + 2]};
    trace_pixel_bwd(p, S, G, sink, true, (uint32_t)state[i], (float)px[i],
                    (float)py[i], g, rec, i);
  }
}
extern "C" long long host_bwd_smem(int n_sph, int n_quad, int n_tri) {
  Params p = {};
  p.n_sph = n_sph;
  p.n_quad = n_quad;
  p.n_tri = n_tri;
  return (long long)bwd_smem_bytes(p);
}
"""


@pytest.fixture(scope="module")
def host_adjoint(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a C++ compiler (g++)")
    csrc = pathlib.Path(mk.__file__).resolve().parent.parent / "csrc"
    out = tmp_path_factory.mktemp("host_adjoint")
    (out / "host.cpp").write_text(HOST_ADJOINT)
    # -ffp-contract=off: no a*b+c contraction, as nvcc's --fmad=false.
    subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", str(csrc), "-o",
                    str(out / "host.so"), str(out / "host.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out / "host.so"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.host_bwd.argtypes = [p, i, i, i] + [p] * 6 + [i] * 7 + [f] * 13
    lib.host_bwd.restype = None
    lib.host_bwd_smem.argtypes = [i, i, i]
    lib.host_bwd_smem.restype = ctypes.c_longlong
    return lib


# name: (scene, eye, config, groups); every case differentiates the view.
HOST_CASES = {
    "cornell_nee_6_bounces": (
        lambda: pt.builtin.cornell_box(device="cpu"), [0, 0, 3.2],
        dict(max_bounces=6, importance_sampling=True),
        ("emission", "bsdf", "quads")),
    "reference_nee": (
        lambda: pt.builtin.reference_scene(device="cpu"), [0.5, 0.0, 2.5],
        dict(max_bounces=5, importance_sampling=True),
        ("emission", "bsdf", "spheres", "quads", "vertices")),
    "cornell_stratified_spp4": (
        lambda: pt.builtin.cornell_box(device="cpu"), [0, 0, 3.2],
        dict(max_bounces=3, samples_per_pixel=4, stratify=True,
             importance_sampling=True), ("emission", "bsdf", "quads")),
    # Volumes sampled twice a pixel: the replayed volume pass skips the
    # non-ISOTROPIC spheres' roots but keeps their draws.
    "reference_volumes_spp2": (
        lambda: pt.builtin.reference_scene(device="cpu"), [0.5, 0.0, 2.5],
        dict(max_bounces=4, samples_per_pixel=2),
        ("emission", "bsdf", "spheres")),
    "tent_vertices": (
        lambda: _port(*_tent_scene()[:2]) + (None,), [0.0, 0.0, 2.5],
        dict(max_bounces=2, importance_sampling=True, light_sample_prob=0.9),
        ("emission", "vertices", "spheres")),
}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_backward_kernel_source_on_cpu(host_adjoint, name):
    """The backward kernel's adjoint, built for the CPU, against autograd
    of the wavefront (its plain version, ``megakernel.vjp_reference``) at
    parameter level, with the card's tolerance (chip_smoke.py phase 7)."""
    scene_fn, eye, kw, groups = HOST_CASES[name]
    scene, meta, _ = scene_fn()
    cfg = pt.RenderConfig(width=16, height=16, **kw)
    params = {k: v.clone().requires_grad_(True)
              for k, v in tparams.extract_params(scene, groups).items()}
    params["view_matrix"] = torch.as_tensor(
        pt.Camera(eye=eye).view_matrix).requires_grad_(True)
    s = tparams.apply_params(scene, params)
    pix, px, py = pixel_grid(16, 16, "cpu")
    state = trng.seed(pix, SEED)
    rad = mk.path_trace_pixels_reference(state, params["view_matrix"], px,
                                         py, s, meta, cfg).detach()
    gout = (2.0 * (rad - 0.3) / rad.numel()).contiguous()
    ref = mk.vjp_reference(state, params["view_matrix"], px, py, s, meta,
                           cfg, gout, list(params.values()))

    tables = mk.pack_tables(s) + (params["view_matrix"],)
    flat, counts, st32, px32, py32 = mk._prepare(state, px, py, tables, s)
    grad = torch.zeros_like(flat)
    rec = torch.empty(cfg.max_bounces * mk.REC_FIELDS * px.shape[0])
    host_adjoint.host_bwd(flat.data_ptr(), *counts, st32.data_ptr(),
                          px32.data_ptr(), py32.data_ptr(), gout.data_ptr(),
                          rec.data_ptr(), grad.data_ptr(),
                          *mk._scalar_args(s, meta, cfg, px.shape[0]))
    table_grads = torch.split(grad, [t.numel() for t in tables])
    pairs = [(t, g.reshape(t.shape)) for t, g in zip(tables, table_grads)
             if t.requires_grad]
    got = torch.autograd.grad([t for t, _ in pairs], list(params.values()),
                              [g for _, g in pairs], allow_unused=True)
    keys = list(params)
    as_np = {}
    for k, r, g in zip(keys, ref, got):
        zero = np.zeros(tuple(params[k].shape), np.float32)
        as_np[k] = (zero if r is None else r.numpy(),
                    zero if g is None else g.numpy())
    _assert_grads_close({k: v[0] for k, v in as_np.items()},
                        {k: v[1] for k, v in as_np.items()}, keys)
    assert max(np.abs(v[0]).max() for v in as_np.values()) > 0


def test_backward_block_shared_memory(monkeypatch):
    """The wrappers refuse a scene whose backward block would not fit in
    the shared memory a block may use: the tables, their invariants
    (triangle edges, R * R, the light plane), the tables' gradients and
    128 threads' slots of 52 floats at a stride of 129."""
    scene, _, _ = pt.builtin.reference_scene(device="cpu")
    view = torch.as_tensor(pt.Camera(eye=[0.5, 0.0, 2.5]).view_matrix)
    tables = mk.pack_tables(scene) + (view,)
    n = sum(t.numel() for t in tables)
    n_sph, n_tri = scene.spheres.count, scene.triangles.count
    need = 4 * ((n + 9 * n_tri + n_sph + 11) + n + 52 * 129)
    assert mk.bwd_smem_bytes(scene) == need
    assert need < mk.MAX_SMEM_BYTES
    pix, px, py = pixel_grid(4, 4, "cpu")
    monkeypatch.setattr(mk, "MAX_SMEM_BYTES", need)
    mk._prepare(trng.seed(pix, 1), px, py, tables, scene)
    monkeypatch.setattr(mk, "MAX_SMEM_BYTES", need - 1)
    with pytest.raises(ValueError, match="shared memory"):
        mk._prepare(trng.seed(pix, 1), px, py, tables, scene)


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_backward_block_shared_memory_matches_kernel(host_adjoint, name):
    """The wrapper's count of a backward block's shared memory is the one
    the kernel's entry point launches with (``bwd_smem_bytes`` in
    ``csrc/megakernel_bwd.cu``, built for the CPU)."""
    scene = HOST_CASES[name][0]()[0]
    counts = (scene.spheres.count, scene.quads.count, scene.triangles.count)
    assert host_adjoint.host_bwd_smem(*counts) == mk.bwd_smem_bytes(scene)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run python3 chip_smoke.py there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_backward_matches_plain_version(cuda_device):
    """The CUDA backward kernel against autograd of the wavefront on the
    card, from the same PCG states: every gradient within 2e-3 of its
    group's largest, the loss within 1e-5, and one backward launch."""
    scene, meta, _ = pt.builtin.cornell_box(device=cuda_device)
    cfg = pt.RenderConfig(width=16, height=8, max_bounces=5,
                          importance_sampling=True)
    pix, px, py = pixel_grid(16, 8, cuda_device)
    view = torch.as_tensor(pt.Camera(eye=[0, 0, 3.2]).view_matrix,
                           device=cuda_device)
    groups = ("emission", "bsdf", "quads")
    results = []
    for use_mk in (True, False):
        params = {k: v.clone().requires_grad_(True) for k, v in
                  tparams.extract_params(scene, groups).items()}
        _, rad = tptp(trng.seed(pix, 3), view, px, py,
                      tparams.apply_params(scene, params), meta,
                      cfg.replace(use_megakernel=use_mk))
        loss = torch.mean(rad ** 2)
        before = mk.BWD_LAUNCHES
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        assert mk.BWD_LAUNCHES == before + int(use_mk)
        results.append((float(loss), {k: g.cpu().numpy()
                                      for k, g in zip(params, grads)}))
    (l_k, g_k), (l_p, g_p) = results
    assert abs(l_k - l_p) <= 1e-5 * abs(l_p)
    _assert_grads_close(g_p, g_k, list(g_p))
