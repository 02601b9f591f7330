"""Port parity, user layer: the renderer's loop (stats, FPS cap, logs),
checkpoint and resume, PNG I/O, the tty preview's painter and reset loop,
and the render command's options; the cases of ``tests/test_renderer.py``
and ``tests/test_preview.py`` for the port, on the CPU.  Checkpoints cross
between the two packages in both directions.
"""

import time

import numpy as np
import pytest
import torch

import tpu_path_tracer as tpt

import tpu_path_tracer_torch as pt
from tpu_path_tracer_torch import cli
from tpu_path_tracer_torch.preview import _paint, run_preview
from tpu_path_tracer_torch.utils import checkpoint as ckpt
from tpu_path_tracer_torch.utils.image import read_png, write_png
from tpu_path_tracer_torch.utils.profiling import FrameStats, device_trace


def small_renderer(pkg=pt, **kw):
    """tests/test_renderer.py:17-21: the Cornell box at 16x12, 3 bounces."""
    scene, meta, _ = (pkg.builtin.cornell_box() if pkg is tpt
                      else pkg.builtin.cornell_box(device="cpu"))
    cfg = pkg.RenderConfig(width=16, height=12, max_bounces=3)
    cam = pkg.Camera(eye=[0, 0, 3.2], center=[0, 0, 0])
    return pkg.Renderer(scene, meta, cfg, cam, **kw)


def test_progressive_accumulation_and_motion_reset():
    r = small_renderer()
    r.render_animation(3)
    assert r.frame_num == 3
    fb3 = r.framebuffer.numpy().copy()
    # Camera motion resets accumulation on the next frame
    # (renderer.js:174-180 semantics).
    r.camera.zoom(-1.0)
    r.step()
    assert r.frame_num == 1
    assert not np.allclose(r.framebuffer.numpy(), fb3)


def test_render_single_frame_and_display():
    r = small_renderer()
    r.render_single_frame(spp=4)
    assert r.frame_num == 1
    img = r.display()
    assert img.shape == (12, 16, 3) and img.dtype == np.uint8


def test_checkpoint_roundtrip(tmp_path):
    r = small_renderer()
    r.render_animation(2)
    path = str(tmp_path / "ck.npz")
    r.save_checkpoint(path)
    fb = r.framebuffer.numpy().copy()

    r2 = small_renderer()
    r2.load_checkpoint(path)
    assert r2.frame_num == 2
    np.testing.assert_array_equal(r2.framebuffer.numpy(), fb)
    np.testing.assert_allclose(r2.camera.eye, r.camera.eye)
    # Resumed render continues identically to an uninterrupted one.
    r.step(reset=False)
    r2.step(reset=False)
    np.testing.assert_array_equal(r.framebuffer.numpy(),
                                  r2.framebuffer.numpy())
    # The file is the JAX package's: the same keys, nothing left behind.
    with np.load(path) as z:
        assert sorted(z.files) == ["center", "eye", "frame_num",
                                   "framebuffer", "up"]
    assert [p.name for p in tmp_path.iterdir()] == ["ck.npz"]
    with pytest.raises(ValueError, match="does not match"):
        pt.Renderer(r.scene, r.meta, r.cfg.replace(width=8)) \
            .load_checkpoint(path)


def test_periodic_checkpoints_resume_like_an_uninterrupted_render(tmp_path):
    """``render_animation(4, path, checkpoint_every=2)`` leaves the state of
    frame 4; a new renderer resumed from the snapshot of frame 2 reaches
    the same framebuffer at frame 4."""
    path = str(tmp_path / "run.npz")
    r = small_renderer()
    r.render_animation(2, checkpoint_path=path, checkpoint_every=2)
    fb2, frame_num, cam = ckpt.load_checkpoint(path)
    assert frame_num == 2 and cam is not None
    np.testing.assert_array_equal(fb2, r.framebuffer.numpy())
    r.render_animation(2)
    resumed = small_renderer()
    resumed.load_checkpoint(path)
    resumed.render_animation(2, checkpoint_path=path, checkpoint_every=2)
    assert resumed.frame_num == 4
    np.testing.assert_array_equal(resumed.framebuffer.numpy(),
                                  r.framebuffer.numpy())
    assert ckpt.load_checkpoint(path)[1] == 4


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_the_packages(writer, tmp_path):
    """A checkpoint written by the JAX ``Renderer`` loads in the port's and
    the other way round: frame count, framebuffer bits and camera pose."""
    src, dst = ((small_renderer(tpt), small_renderer())
                if writer == "jax" else (small_renderer(),
                                         small_renderer(tpt)))
    src.render_animation(2)
    src.camera.eye = np.float32([0.1, 0.2, 3.0])
    path = str(tmp_path / "ck.npz")
    src.save_checkpoint(path)
    dst.load_checkpoint(path)
    assert dst.frame_num == 2
    np.testing.assert_array_equal(np.asarray(dst.framebuffer),
                                  np.asarray(src.framebuffer))
    np.testing.assert_array_equal(dst.camera.eye, src.camera.eye)
    np.testing.assert_array_equal(dst.camera.center, src.camera.center)
    dst.step(reset=False)
    assert dst.frame_num == 3
    assert np.isfinite(np.asarray(dst.framebuffer)).all()


def test_png_roundtrip(tmp_path):
    img = (np.random.default_rng(0).uniform(0, 255, (7, 5, 3))
           .astype(np.uint8))
    p = str(tmp_path / "t.png")
    write_png(p, img)
    np.testing.assert_array_equal(read_png(p), img)
    from tpu_path_tracer.utils.image import read_png as jread
    np.testing.assert_array_equal(jread(p), img)
    (tmp_path / "bad.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(tmp_path / "bad.png"))


def test_frame_stats_report_matches_jax():
    """The same frame times give the JAX package's numbers and report
    line."""
    from tpu_path_tracer.utils.profiling import FrameStats as JStats
    a, b = FrameStats(window=3), JStats(window=3)
    for s in (a, b):
        s.end()                         # no begin: ignored
        for ms in (4.0, 2.0, 6.0, 8.0):
            s.begin()
            s.times.append(ms * 1e-3)   # the window keeps the last three
            s._t0 = None
            s.frames += 1
    assert a.frames == b.frames == 4
    assert a.avg_ms == b.avg_ms and a.fps == b.fps
    assert a.report(192) == b.report(192)
    assert a.report(192).startswith("frames=4 avg=5.33ms fps=187.5 ")
    assert FrameStats().report(10) == JStats().report(10)


def test_renderer_logs_and_fps_cap(capsys):
    """``log_performance`` prints the report every 100 frames,
    ``log_count_of_samples`` the sample count every frame, and ``max_fps``
    holds the loop to its budget."""
    r = small_renderer(log_performance=True, log_count_of_samples=True)
    r.cfg = r.cfg.replace(width=4, height=4, max_bounces=1)
    r.framebuffer = torch.zeros((16, 3))
    r.render_animation(100)
    out = capsys.readouterr().out.splitlines()
    assert out.count("Total Samples: 100") == 1
    assert [ln for ln in out if ln.startswith("frames=")] == [
        r.stats.report(16)]
    assert r.stats.frames == 100 and len(r.stats.times) == 100

    capped = small_renderer(max_fps=20.0)
    start = time.perf_counter()
    capped.render_animation(4)
    assert time.perf_counter() - start >= 4 / 20.0
    assert capped.stats.frames == 4


def test_device_trace_writes_a_chrome_trace(tmp_path):
    r = small_renderer()
    with device_trace(str(tmp_path / "trace")) as log_dir:
        r.step()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert log_dir == str(tmp_path / "trace")


# ---------------------------------------------------------------- preview


def test_paint_half_blocks():
    img = np.zeros((4, 3, 3), np.uint8)
    img[0, :] = [255, 0, 0]   # top row red
    img[1, :] = [0, 255, 0]   # bottom row green
    out = _paint(img)
    lines = out.split("\n")
    assert len(lines) == 2                      # 4 rows -> 2 cell lines
    assert lines[0].count("▀") == 3
    assert "38;2;255;0;0" in lines[0]           # fg = top pixel
    assert "48;2;0;255;0" in lines[0]           # bg = bottom pixel
    assert lines[0].endswith("\x1b[0m")
    from tpu_path_tracer.preview import _paint as jpaint
    assert out == jpaint(img)


def test_paint_odd_height_drops_last_row():
    img = np.full((5, 2, 3), 7, np.uint8)
    assert len(_paint(img).split("\n")) == 2


def test_preview_requires_tty(monkeypatch):
    scene, meta, _ = pt.builtin.cornell_box(device="cpu")
    cfg = pt.RenderConfig(width=8, height=8, max_bounces=1)
    r = pt.Renderer(scene, meta, cfg)
    monkeypatch.setattr("sys.stdin", type("F", (), {
        "isatty": staticmethod(lambda: False)})())
    with pytest.raises(RuntimeError, match="tty"):
        run_preview(r)


def test_camera_motion_resets_accumulation():
    """The interactive loop's contract: orbit/zoom/pan set motion flags and
    the next step restarts accumulation at frame 1 (renderer.js:174-180)."""
    scene, meta, _ = pt.builtin.cornell_box(device="cpu")
    cfg = pt.RenderConfig(width=8, height=8, max_bounces=1)
    r = pt.Renderer(scene, meta, cfg,
                    camera=pt.Camera(eye=[0, 0, 3.2], center=[0, 0, 0]))
    r.step()
    r.step()
    assert r.frame_num == 2
    r.camera.orbit((0.0, 0.0), (500.0, 0.0))
    r.step()
    assert r.frame_num == 1          # reset by the motion flag
    r.camera.moving = False          # mouse-up
    r.step()
    assert r.frame_num == 2          # accumulating again
    r.camera.zoom(1.0)
    r.step()
    assert r.frame_num == 1
    r.camera.move_left()
    r.step()
    assert r.frame_num == 1


def test_preview_loop_steps_paints_and_quits(monkeypatch, capsys):
    """``run_preview`` with the terminal stubbed, beside the JAX preview on
    the same keys: both render, paint the frame, turn 's' into a zoom (which
    restarts the accumulation) and 'a' into an orbit, and leave on 'q' with
    the terminal restored.  In both, the orbit's ``moving`` flag is cleared
    before a frame polls it, so the orbit moves the eye and the count goes
    on: the port keeps the JAX package's order."""
    import sys
    import termios
    import tty

    import tpu_path_tracer as tpt
    import tpu_path_tracer.preview as jpreview
    import tpu_path_tracer_torch.preview as preview

    monkeypatch.setattr(sys, "stdin", type("F", (), {
        "isatty": staticmethod(lambda: True),
        "fileno": staticmethod(lambda: 0)})())
    restored = []
    monkeypatch.setattr(termios, "tcgetattr", lambda fd: ["attrs"])
    monkeypatch.setattr(termios, "tcsetattr",
                        lambda fd, when, attrs: restored.append(attrs))
    monkeypatch.setattr(tty, "setcbreak", lambda fd: None)
    script = [[], ["s"], [], ["a"], [], ["q"]]
    kw = dict(width=8, height=8, max_bounces=1)

    scene, meta, _ = pt.builtin.cornell_box(device="cpu")
    r = pt.Renderer(scene, meta, pt.RenderConfig(**kw),
                    camera=pt.Camera(eye=[0, 0, 3.2], center=[0, 0, 0]))
    jscene, jmeta, _ = tpt.builtin.cornell_box()
    jr = tpt.Renderer(jscene, jmeta, tpt.RenderConfig(**kw),
                      camera=tpt.Camera(eye=[0, 0, 3.2], center=[0, 0, 0]))
    counts = []
    for module, renderer in ((preview, r), (jpreview, jr)):
        keys = iter(script)
        monkeypatch.setattr(module, "_read_keys", lambda timeout: next(keys))
        eye = renderer.camera.eye.copy()
        module.run_preview(renderer, max_fps=1000.0)
        out = capsys.readouterr().out
        assert out.count("▀") == 6 * 4 * 8   # six frames of 4 x 8 cells
        counts.append([int(part.split()[0])
                       for part in out.split("frame ")[1:]])
        assert not np.array_equal(renderer.camera.eye, eye)
        assert not renderer.camera.moving
    assert restored == [["attrs"], ["attrs"]]
    # Zoom after frame 2 restarts at 1; the orbit after frame 2 does not.
    assert counts[0] == counts[1] == [1, 2, 1, 2, 3, 4]
    np.testing.assert_array_equal(r.camera.eye, jr.camera.eye)


# -------------------------------------------------------------------- CLI


def _render(argv, capsys):
    cli.main(["render", "--scene", "cornell", "--width", "16", "--height",
              "12", "--bounces", "3", "--device", "cpu"] + argv)
    return capsys.readouterr().out


def test_cli_checkpoint_and_resume_equal_an_uninterrupted_render(tmp_path,
                                                                 capsys):
    """``render --checkpoint`` then ``render --resume``: 2 + 2 frames give
    the PNG of 4 frames in one go, and the checkpoint says frame 4."""
    ck, a, b = (str(tmp_path / n) for n in ("ck.npz", "a.png", "b.png"))
    out = _render(["--frames", "2", "--checkpoint", ck, "--checkpoint-every",
                   "1", "-o", a], capsys)
    assert f"checkpoint -> {ck}" in out
    assert ckpt.load_checkpoint(ck)[1] == 2
    out = _render(["--frames", "2", "--resume", ck, "--checkpoint", ck, "-o",
                   a], capsys)
    assert "resumed at frame 2" in out and "(4 accumulated)" in out
    assert ckpt.load_checkpoint(ck)[1] == 4
    _render(["--frames", "4", "-o", b], capsys)
    np.testing.assert_array_equal(read_png(a), read_png(b))
    assert read_png(a).shape == (12, 16, 3)


def test_cli_logs(tmp_path, capsys):
    """``--log-samples`` and ``--log-performance`` print what the JAX
    command prints: a sample count per frame, the report every 100."""
    out = _render(["--frames", "100", "--width", "4", "--height", "4",
                   "--bounces", "1", "--log-samples", "--log-performance",
                   "--max-fps", "0", "-o", str(tmp_path / "o.png")], capsys)
    lines = out.splitlines()
    assert "Total Samples: 1" in lines and "Total Samples: 100" in lines
    assert sum(ln.startswith("frames=100 avg=") for ln in lines) == 1


def test_cli_interactive_needs_a_tty(tmp_path, monkeypatch):
    """``--interactive`` reaches the preview, which asks for a terminal."""
    monkeypatch.setattr("sys.stdin", type("F", (), {
        "isatty": staticmethod(lambda: False)})())
    with pytest.raises(RuntimeError, match="tty"):
        cli.main(["render", "--interactive", "--width", "8", "--height", "8",
                  "--device", "cpu", "-o", str(tmp_path / "o.png")])
