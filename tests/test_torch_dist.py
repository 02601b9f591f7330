"""Port parity, multi-process layer: ``dist.sharding`` and
``dist.render_dist`` over ``torch.distributed``, the renderer over a mesh
and the CLI's ``--devices`` / ``--multihost``, on the CPU.

Ranks are real OS processes in a gloo group on localhost, started with
torch's launcher variables as ``tests/test_dist.py`` starts the JAX
package's (``tests/torch_dist_ranks.py`` is their side), one thread each.
Each rank traces its chunk of the global padded pixels, so the gathered
frame must equal the one-process frame bit for bit, pad rows included; the
sharded loss and its gradients sum per-rank shares, so they are held to
the one-process ones within summation order (loss 1e-6 relative, each
gradient 1e-5 of its parameter's largest), and to the JAX package run op
by op (``jax.disable_jit``) at the tolerances of
``tests/test_torch_train.py``.  JAX's own sharded loss cannot be the
reference here: ``shard_map`` run op by op took minutes at 12x11.
"""

import json
import os
import socket
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_path_tracer as tpt
from tpu_path_tracer.core import rng as jrng
from tpu_path_tracer.diff import params as jparams
from tpu_path_tracer.dist import render_dist as jrd
from tpu_path_tracer.dist.sharding import make_mesh as jmake_mesh
from tpu_path_tracer.integrator.render import path_trace_pixels as jptp

import tpu_path_tracer_torch as pt
from tpu_path_tracer_torch import cli
from tpu_path_tracer_torch.accel import native
from tpu_path_tracer_torch.diff.params import apply_params, extract_params
from tpu_path_tracer_torch.dist import render_dist, sharding
from tpu_path_tracer_torch.utils import checkpoint as ckpt

import chip_smoke
import torch_dist_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(REPO, "tests", "torch_dist_ranks.py")
RAD_TOL = 2e-4      # tests/test_pallas.py:52
GRAD_RTOL = 2e-3    # tests/test_torch_train.py:49
LOSS_RTOL = 1e-6    # tests/test_torch_train.py:50
SHARD_GRAD_RTOL = 1e-5
N_PAD = 144         # 12 x 11 = 132 pixels padded for 2 and 3 ranks
TIMEOUT = 300


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(world=None, rank=None, port=None):
    """One thread a process; with a world, the launcher's variables."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if world is not None:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank))
    return env


def _start(argvs, envs, logs):
    procs = []
    for argv, env, log in zip(argvs, envs, logs):
        with open(log, "w") as f:  # the child keeps its own descriptor
            procs.append(subprocess.Popen(argv, env=env, cwd=REPO, stdout=f,
                                          stderr=subprocess.STDOUT))
    return procs


def _finish(procs, logs, timeout=TIMEOUT):
    """Wait for every process; a failed one kills the others at once, and
    so does the time limit.  Returns their outputs."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        failed = any(p.returncode not in (None, 0) for p in procs)
        if failed or time.monotonic() > deadline:
            for p in procs:
                p.kill()
            break
        time.sleep(0.05)
    for p in procs:
        p.wait()
    outs = [open(log).read() for log in logs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out}"
    return outs


def _launch(world, argv, directory, name):
    """``world`` processes of ``argv`` with the launcher's variables."""
    port = _free_port()
    logs = [str(directory / f"{name}.{r}.log") for r in range(world)]
    return _start([argv] * world, [_env(world, r, port)
                                   for r in range(world)], logs), logs


class Jobs:
    """Rank jobs started together; ``result`` waits for one and returns
    each rank's arrays."""

    def __init__(self, directory):
        self.directory = directory
        self.running = {}
        self.done = {}

    def start(self, job, world):
        self.running[job] = _launch(
            world, [sys.executable, RANKS, job, str(self.directory)],
            self.directory, job)

    def result(self, job):
        if job not in self.done:
            _finish(*self.running.pop(job))
            world = len(list(self.directory.glob(f"{job}.*.log")))
            self.done[job] = [dict(np.load(self.directory / f"{job}.{r}.npz"))
                              for r in range(world)]
        return self.done[job]


def _jax_checkpoint(path):
    """Two frames of the JAX renderer over a 2-device virtual mesh
    (``tests/conftest.py``'s CPU devices), saved in its padded layout."""
    jscene, jmeta, _ = tpt.builtin.cornell_box()
    r = tpt.Renderer(jscene, jmeta, tpt.RenderConfig(**ranks.KW),
                     tpt.Camera(eye=ranks.EYE, center=[0, 0, 0]),
                     mesh=jmake_mesh(n_devices=2))
    r.render_animation(2)
    r.save_checkpoint(str(path))


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    directory = tmp_path_factory.mktemp("ranks")
    native.available()  # the BVH library, built once here, not per rank
    _jax_checkpoint(directory / "jax.npz")
    j = Jobs(directory)
    j.start("main", 2)
    j.start("frames", 3)
    j.start("preview", 2)
    yield j
    for procs, _ in j.running.values():
        for p in procs:
            p.kill()
            p.wait()


# ------------------------------------------------------- one-process refs


def _jax_cfg():
    return tpt.RenderConfig(**ranks.KW, use_pallas=False)


def _jax_scene(name):
    if name == "cornell":
        return tpt.builtin.cornell_box()[:2]
    if name == "reference":
        return tpt.builtin.reference_scene(mini=True)[:2]
    return ranks.mirror_sphere_scene(tpt)


def _jax_pixels():
    pix = jnp.arange(N_PAD, dtype=jnp.uint32)
    return pix, (pix % 12).astype(jnp.int32), (pix // 12).astype(jnp.int32)


def _jax_radiance(name):
    """JAX ``_pixel_radiance`` of the padded pixels at the cases' frame,
    op by op."""
    scene, meta = _jax_scene(name)
    with jax.disable_jit():
        rad = jrd._pixel_radiance(jnp.arange(N_PAD, dtype=jnp.uint32),
                                  jnp.int32(ranks.FRAME),
                                  jnp.asarray(ranks.view()), scene, meta,
                                  _jax_cfg())
    return np.asarray(rad)


def _jax_loss(name):
    """``jax.value_and_grad`` of the JAX loss over the padded pixels, op
    by op (what ``make_sharded_loss_fn`` computes, on one device)."""
    scene_name, groups = ranks.LOSSES[name]
    scene, meta = _jax_scene(scene_name)
    pix, px, py = _jax_pixels()
    target = jnp.asarray(ranks.loss_target(N_PAD))

    def loss(p):
        s = jparams.apply_params(scene, p)
        _, rad = jptp(jrng.seed(pix, ranks.FRAME), jnp.asarray(ranks.view()),
                      px, py, s, meta, _jax_cfg())
        return jnp.mean((rad - target) ** 2)

    with jax.disable_jit():
        value, grads = jax.value_and_grad(loss)(
            jparams.extract_params(scene, groups))
    return float(value), {k: np.asarray(v) for k, v in grads.items()}


def _port_frame(name):
    """The port's frame of the padded pixels in one process."""
    scene_name, megakernel = ranks.FRAMES[name]
    scene, meta = ranks.port_scene(scene_name)
    fb = render_dist.make_sharded_frame_fn(None, meta, ranks.cfg(megakernel))(
        torch.zeros((N_PAD, 3)), ranks.FRAME, True, ranks.view(), scene)
    return fb.numpy()


def _port_loss(name):
    scene_name, groups = ranks.LOSSES[name]
    scene, meta = ranks.port_scene(scene_name)
    params = {k: v.clone().requires_grad_(True)
              for k, v in extract_params(scene, groups).items()}
    loss = render_dist.make_sharded_loss_fn(
        None, scene, meta, ranks.cfg(), apply_params)(
        params, torch.from_numpy(ranks.loss_target(N_PAD)), ranks.FRAME,
        ranks.view())
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy()
                                  for k, p in params.items()}


def _assert_grads_close(ref, got, rtol):
    """Every gradient within rtol of its parameter's largest, all finite
    (``tests/test_torch_train.py::_assert_grads_close``)."""
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert np.all(np.isfinite(got[k])), k
        scale = max(float(np.abs(ref[k]).max()), 1e-6)
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=rtol * scale,
                                   err_msg=k)


def _grads_of(result, name):
    prefix = f"grad.{name}."
    return {k[len(prefix):]: v for k, v in result.items()
            if k.startswith(prefix)}


# -------------------------------------------------------------- (a) padding


@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_padded_pixels_matches_jax(world):
    """The padded framebuffer length for ``world`` ranks against the JAX
    package's on a mesh of as many virtual CPU devices.  The port reads
    only the mesh's size, so a stand-in of that size serves (the rank jobs
    hold the real meshes' frames to it)."""
    for w, h in ((12, 11), (16, 8), (900, 600), (7, 3)):
        kw = dict(width=w, height=h)
        mesh = None if world == 1 else types.SimpleNamespace(
            size=lambda: world)
        assert (render_dist.padded_pixels(pt.RenderConfig(**kw), mesh)
                == jrd.padded_pixels(tpt.RenderConfig(**kw),
                                     jmake_mesh(n_devices=world)))


def test_pad_to_multiple():
    from tpu_path_tracer.dist.sharding import pad_to_multiple as jpad
    for n, m in ((132, 16), (132, 24), (144, 16), (0, 8), (1, 8), (7, 1)):
        assert sharding.pad_to_multiple(n, m) == jpad(n, m)
    assert render_dist.pad_to_multiple is sharding.pad_to_multiple


# ------------------------------------------------------- (c) sharded frame


@pytest.mark.parametrize("name", sorted(ranks.FRAMES))
def test_sharded_frame_matches_jax(jobs, name):
    """The gathered 2-rank frame against JAX ``_pixel_radiance`` on the
    same global pixel indices, run op by op (the megakernel route's plain
    version is the wavefront, so both Cornell routes meet the JAX
    wavefront)."""
    ref = _jax_radiance(ranks.FRAMES[name][0])
    got = jobs.result("main")[0][f"frame.{name}"]
    np.testing.assert_allclose(got, ref, rtol=RAD_TOL, atol=RAD_TOL)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name", sorted(ranks.FRAMES))
def test_sharded_frame_equals_one_process(jobs, name, world):
    """The gathered chunks of 2 and 3 ranks equal the one-process frame
    bit for bit on every padded row (pad rows ``py == H`` included)."""
    job = "main" if world == 2 else "frames"
    ref = _port_frame(name)
    assert ref.shape == (N_PAD, 3)
    for res in jobs.result(job):
        np.testing.assert_array_equal(res[f"frame.{name}"], ref)
    assert ref[132:].std() > 0  # the pad rows trace real paths


# ------------------------------------------------ (d) sharded loss, grads


@pytest.mark.parametrize("name", sorted(ranks.LOSSES))
def test_sharded_loss_and_grads_equal_one_process(jobs, name):
    """Over 2 ranks the loss is the global mean on both ranks, within
    1e-6 of the one-process loss, and the summed gradients are the same
    on both ranks and within 1e-5 of each parameter's largest of the
    one-process gradients (they differ by summation order only)."""
    loss, grads = _port_loss(name)
    res0, res1 = jobs.result("main")
    for res in (res0, res1):
        assert abs(float(res[f"loss.{name}"]) - loss) <= LOSS_RTOL * loss
        _assert_grads_close(grads, _grads_of(res, name), SHARD_GRAD_RTOL)
    for k, g in _grads_of(res0, name).items():
        np.testing.assert_array_equal(g, _grads_of(res1, name)[k])
    assert any(np.abs(g).max() > 0 for g in grads.values())


@pytest.mark.parametrize("name", sorted(ranks.LOSSES))
def test_sharded_loss_and_grads_match_jax(jobs, name):
    """The 2-rank loss and gradients against ``jax.value_and_grad`` of the
    JAX loss over the same padded pixel count, op by op."""
    jloss, jgrads = _jax_loss(name)
    res = jobs.result("main")[0]
    assert abs(float(res[f"loss.{name}"]) - jloss) <= LOSS_RTOL * jloss
    _assert_grads_close(jgrads, _grads_of(res, name), GRAD_RTOL)


# ------------------------------------------------------------ (b) bootstrap


def test_init_distributed_two_processes(jobs):
    """Two processes with MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK call
    ``init_distributed()``: each is its rank of 2, and an all-reduce of
    rank + 1 and an all-gather of the ranks cross the processes."""
    for rank, res in enumerate(jobs.result("main")):
        assert int(res["bootstrap.rank"]) == rank
        assert int(res["bootstrap.world"]) == 2
        assert float(res["bootstrap.sum"][0]) == 3.0
        np.testing.assert_array_equal(res["bootstrap.gathered"], [0.0, 1.0])


def test_init_distributed_without_variables(monkeypatch):
    """No launcher variable and no argument: rank 0, no group formed."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert sharding.init_distributed(device="cpu") == 0
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed first"):
        sharding.make_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="rank"):
        sharding.init_distributed("127.0.0.1:1", 2, device="cpu")


# --------------------------------------------------------- (e) train step


def test_train_step_over_two_ranks(jobs):
    """Three Adam steps over 2 ranks: the parameters are equal bit for bit
    on both ranks after each step, and within 1e-5 of the one-process
    ``make_train_step``'s; the losses within 1e-6 and falling."""
    scene, meta = ranks.port_scene("cornell")
    target, params = ranks.train_start(scene, meta, None, N_PAD)
    step = render_dist.make_train_step(
        None, scene, meta, ranks.cfg(), apply_params,
        torch.optim.Adam(params.values(), lr=ranks.LR))
    res0, res1 = jobs.result("main")
    losses = []
    for i in range(ranks.TRAIN_STEPS):
        loss = float(step(params, target, ranks.FRAME, ranks.view()))
        losses.append(loss)
        assert abs(float(res0[f"train.loss.{i}"]) - loss) <= LOSS_RTOL * loss
        for k, p in params.items():
            np.testing.assert_array_equal(res0[f"train.{i}.{k}"],
                                          res1[f"train.{i}.{k}"])
            np.testing.assert_allclose(res0[f"train.{i}.{k}"],
                                       p.detach().numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)
    assert losses[-1] < losses[0]


# ------------------------------------------------------------ (f) renderer


def test_sharded_renderer_matches_single(jobs):
    """``Renderer(mesh=)`` over 2 ranks: 3 frames equal the one-process
    renderer's, so does the image, and a camera move resets."""
    r = ranks.renderer(None)
    r.render_animation(3)
    res = jobs.result("main")[0]
    n = 12 * 11
    assert int(res["renderer.frames"]) == 3
    np.testing.assert_array_equal(res["renderer.fb3"][:n],
                                  r.framebuffer.numpy())
    np.testing.assert_array_equal(res["renderer.display"], r.display())
    r.camera.zoom(-1.0)
    r.step()
    assert int(res["renderer.moved_frames"]) == r.frame_num == 1
    np.testing.assert_array_equal(res["renderer.moved"][:n],
                                  r.framebuffer.numpy())
    assert not np.allclose(res["renderer.moved"], res["renderer.fb3"])


def test_sharded_checkpoint_resumes_in_new_ranks(jobs):
    """A checkpoint at frame 2 holds the gathered padded framebuffer (the
    JAX sharded renderer's layout); new ranks resume it and meet the
    uninterrupted render bit for bit."""
    whole = jobs.result("main")[0]
    fb, frame_num, _ = ckpt.load_checkpoint(
        str(jobs.directory / "port.npz"))
    assert fb.shape == (N_PAD, 3) and frame_num == 2
    jobs.start("resume", 2)
    for res in jobs.result("resume"):
        assert int(res["resumed.at"]) == 2
        assert int(res["resumed.frames"]) == int(whole["whole.frames"]) == 4
        np.testing.assert_array_equal(res["resumed.fb"], whole["whole.fb"])


def test_jax_sharded_checkpoint_continues_in_port_ranks(jobs):
    """The JAX renderer's checkpoint over a 2-device mesh loads into the
    port's 2-rank renderer as it is and continues: the next frame adds the
    port's radiance of frame 3 to it, as the one-process frame does."""
    fb, frame_num, _ = ckpt.load_checkpoint(str(jobs.directory / "jax.npz"))
    res = jobs.result("main")[0]
    assert int(res["from_jax.loaded_frames"]) == frame_num == 2
    np.testing.assert_array_equal(res["from_jax.loaded"], fb)
    scene, meta = ranks.port_scene("cornell")
    want = render_dist.make_sharded_frame_fn(None, meta, ranks.cfg())(
        torch.from_numpy(fb.copy()), 3, False, ranks.view(), scene)
    np.testing.assert_array_equal(res["from_jax.fb"], want.numpy())


# ----------------------------------------------------- (g) measure_scaling


def test_measure_scaling_over_two_ranks(jobs):
    """Over 2 gloo ranks at 16x8: the JAX keys, finite throughputs, and
    the kind of a run whose ranks share one device."""
    for res in jobs.result("main"):
        report = json.loads(str(res["scaling"]))
        assert sorted(report) == sorted(
            ["devices", "tput_1dev_rays_s", "tput_ndev_rays_s",
             "efficiency", "spread_pct", "kind"])
        assert report["devices"] == 2
        for k in ("tput_1dev_rays_s", "tput_ndev_rays_s", "efficiency",
                  "spread_pct"):
            assert np.isfinite(report[k]) and report[k] >= 0, k
        assert report["tput_1dev_rays_s"] > 0
        assert "overhead" in report["kind"]
        assert "NOT a speedup" in report["kind"]


# ------------------------------------------------------------------ (h) CLI


RENDER = ["render", "--device", "cpu", "--width", "12", "--height", "11",
          "--bounces", "3", "--frames", "2"]
TRAIN = ["train", "--device", "cpu", "--steps", "3"]


def _cli(argv, world, tmp_path, name, multihost=False):
    """The command in one process (which starts its own ranks), or under
    ``multihost`` in ``world`` processes with the launcher's variables."""
    cmd = [sys.executable, "-m", "tpu_path_tracer_torch", *argv]
    if multihost:
        procs, logs = _launch(world, cmd, tmp_path, name)
    else:
        logs = [str(tmp_path / f"{name}.log")]
        procs = _start([cmd], [_env()], logs)
    return _finish(procs, logs)


@pytest.fixture(scope="module")
def one_png(tmp_path_factory):
    """The PNG of ``render`` in this process, with no ranks."""
    path = tmp_path_factory.mktemp("one") / "one.png"
    cli.main(RENDER + ["-o", str(path)])
    return path.read_bytes()


def test_cli_render_devices_writes_the_single_process_png(tmp_path, one_png):
    """``render --devices 2`` writes the PNG of ``render`` in one process,
    byte for byte, and reports the ranks once."""
    two = tmp_path / "two.png"
    out, = _cli(RENDER + ["--devices", "2", "-o", str(two)], 2, tmp_path,
                "devices")
    assert two.read_bytes() == one_png
    assert out.count("wrote ") == 1 and "on cpu x 2 ranks" in out


def test_cli_render_multihost(tmp_path, one_png):
    """``render --multihost`` in two processes started with the launcher's
    variables: each says its place, and only rank 0 writes and reports."""
    png = tmp_path / "multi.png"
    out0, out1 = _cli(RENDER + ["--multihost", "-o", str(png)], 2, tmp_path,
                      "multihost", multihost=True)
    assert "multihost: process 0 of 2" in out0
    assert "multihost: process 1 of 2" in out1
    assert "wrote " in out0 and "wrote " not in out1
    assert "frames" not in out1
    assert png.read_bytes() == one_png


def _losses(out):
    return [float(line.split()[-1]) for line in out.splitlines()
            if line.startswith("step")]


@pytest.mark.parametrize("multihost", [False, True],
                         ids=["devices", "multihost"])
def test_cli_train_over_two_ranks(tmp_path, multihost):
    """``train --devices 2`` and ``train --multihost`` in two processes:
    three falling losses and the error line, printed once."""
    argv = TRAIN + (["--multihost"] if multihost else ["--devices", "2"])
    outs = _cli(argv, 2, tmp_path, "train", multihost=multihost)
    losses = _losses(outs[0])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert outs[0].count("max param error per group") == 1
    assert all(not _losses(out) for out in outs[1:])


def test_cli_grad_check_ignores_the_flags(capsys):
    """``grad-check`` takes ``--devices`` and ``--multihost`` and ignores
    them, as the JAX command does: one process, PASS."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["grad-check", "--bounces", "2", "--device", "cpu",
                  "--devices", "2", "--multihost"])
    out = capsys.readouterr().out
    assert exc.value.code == 0, out
    assert "grad-check: PASS" in out and "multihost" not in out


# ------------------------------------------------------- (i) tty preview


def test_preview_over_two_ranks_paints_the_one_process_frames(jobs):
    """The scripted preview (keys a, w, left, q) over 2 ranks: the first
    rank paints what ``run_preview`` paints in one process fed the same
    keys, bit for bit, and the second paints nothing."""
    text, _ = chip_smoke.scripted_preview(ranks.renderer(None))
    res0, res1 = jobs.result("preview")
    assert str(res0["preview.painted"]) == text
    assert text.count("frame ") == len(chip_smoke.PREVIEW_KEYS)
    assert str(res1["preview.painted"]) == ""


def test_preview_over_two_ranks_shares_the_camera(jobs):
    """Both ranks hold the one-process camera (eye, center, up and both
    motion flags) as every frame begins, and after the last."""
    _, cams = chip_smoke.scripted_preview(ranks.renderer(None))
    assert len(cams) == len(chip_smoke.PREVIEW_KEYS) + 1
    assert not np.array_equal(cams[0], cams[-1])   # the keys moved it
    for res in jobs.result("preview"):
        np.testing.assert_array_equal(res["preview.cameras"], cams)


def test_preview_quit_ends_every_rank(jobs):
    """'q' on the first rank ends the loop on both after the frame it came
    with (one frame a list of keys), with the one-process frame count; the
    ranks then leave the group and exit."""
    one = ranks.renderer(None)
    chip_smoke.scripted_preview(one)
    for res in jobs.result("preview"):
        assert len(res["preview.cameras"]) == len(chip_smoke.PREVIEW_KEYS) + 1
        assert int(res["preview.frames"]) == one.frame_num


def test_preview_without_a_tty_fails_every_rank(jobs):
    """No terminal on the first rank: every rank raises before any frame,
    and none waits for the others."""
    for res in jobs.result("preview"):
        assert "tty" in str(res["preview.no_tty"])


INTERACTIVE = ["render", "--device", "cpu", "--width", "12", "--height",
               "11", "--bounces", "2", "--interactive", "--max-fps", "20"]


def _interactive_argvs(how, png):
    cmd = [sys.executable, "-m", "tpu_path_tracer_torch", *INTERACTIVE,
           "-o", str(png)]
    if how == "devices":
        return [cmd + ["--devices", "2"]], [_env()]
    port = _free_port()
    return [cmd + ["--multihost"]] * 2, [_env(2, r, port) for r in range(2)]


@pytest.mark.parametrize("how", ["devices", "multihost"])
def test_cli_interactive_over_ranks_without_a_tty_fails(tmp_path, how):
    """``render --interactive`` over two ranks with no terminal: the
    command fails on every rank, naming the tty, and does not hang."""
    argvs, envs = _interactive_argvs(how, tmp_path / "o.png")
    procs = [subprocess.Popen(a, env=e, cwd=REPO, stdin=subprocess.DEVNULL,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a, e in zip(argvs, envs)]
    for p in procs:
        out, _ = p.communicate(timeout=TIMEOUT)
        assert p.returncode != 0 and "needs a tty" in out, out
    assert not (tmp_path / "o.png").exists()


@pytest.mark.parametrize("how", ["devices", "multihost"])
def test_cli_interactive_over_ranks_in_a_terminal(tmp_path, how):
    """``render --interactive`` over two ranks with a pseudo-terminal on
    the first: it paints frames there, an orbit key moves the view, 'q'
    ends every rank, and the first rank alone writes the PNG."""
    import pty
    import select

    png = tmp_path / "o.png"
    argvs, envs = _interactive_argvs(how, png)
    master, slave = pty.openpty()
    procs = [subprocess.Popen(argvs[0], env=envs[0], cwd=REPO, stdin=slave,
                              stdout=slave, stderr=slave)]
    procs += [subprocess.Popen(a, env=e, cwd=REPO, stdin=subprocess.DEVNULL,
                               stdout=subprocess.DEVNULL,
                               stderr=subprocess.DEVNULL)
              for a, e in zip(argvs[1:], envs[1:])]
    os.close(slave)
    seen, sent = b"", []
    deadline = time.monotonic() + TIMEOUT
    try:
        while procs[0].poll() is None and time.monotonic() < deadline:
            if select.select([master], [], [], 0.1)[0]:
                try:
                    seen += os.read(master, 65536)
                except OSError:   # the terminal closed with the process
                    break
            frames = seen.count(b"frame ")
            if frames >= 2 and not sent:
                os.write(master, b"a")
                sent.append((frames, b"a"))
            elif sent and len(sent) == 1 and frames >= sent[0][0] + 2:
                os.write(master, b"q")
                sent.append((frames, b"q"))
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        os.close(master)
    text = seen.decode(errors="replace")
    assert [p.returncode for p in procs] == [0] * len(procs), text[-2000:]
    assert len(sent) == 2 and text.count("wrote ") == 1, text[-2000:]
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
