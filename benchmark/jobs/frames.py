"""Progressive frames as the upstream's interactive session shows them:
the program's ``Renderer.step`` and then ``Renderer.display()`` (the
tone-mapped 8-bit image on the host) every frame, accumulating.

Set-up builds the renderer and shows two frames, a reset and one more.
The window starts the session anew (a reset, as a camera move makes) and
goes on frame after frame.  Frames to check are its first and
``check_frames - 1`` more, each the first frame after a moment of the
window drawn from the seed; for each the framebuffer before and after and
the displayed image are kept.  The reference then follows each checked
frame from the program's framebuffer before it: it cannot repeat
thousands of frames, so it checks the start (the reset frame) and each
later frame's increment alone.
"""

from __future__ import annotations

import time

import torch

from .. import system
from ..compare import FrameTally
from ..reference import film as rf
from ..reference import integrator as ri
from ..reference import scene as rs
from ..reference import work as rw


class Job:
    KIND = "frames"
    UNITS = {"frame_mrays": "Mray/s"}

    def __init__(self, ctx):
        self.ctx = ctx
        self.job = ctx.traffic
        self.n = self.job["width"] * self.job["height"]
        self.rays = self.n * self.job["spp"]
        gen = torch.Generator().manual_seed(ctx.seed % 2 ** 63)
        self.moments = sorted(torch.rand(
            self.job["check_frames"] - 1, generator=gen).tolist())
        self.checked = []
        self.first_window = True

    def setup(self):
        scene, meta = system.build_scene(self.ctx.desc, self.ctx.device)
        self.renderer = system.program().Renderer(
            scene, meta, system.render_config(self.job),
            camera=system.camera(self.ctx.config))
        for reset in (True, False):  # both of the film's paths
            self.renderer.step(reset=reset)
            self.renderer.display()

    def window(self, seconds=None, units=None, spans=None):
        """Frames for ``seconds`` (or ``units`` frames).  The first window
        of a run resets the session and keeps the frames to check."""
        first, self.first_window = self.first_window, False
        todo = list(self.moments) if first else []
        n = 0
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            keep = first and (n == 0 or (todo and now >= todo[0] * seconds))
            if keep and n:
                todo.pop(0)
            r = self.renderer
            with spans("frames.step"):
                before = r.framebuffer.clone() if keep and n else None
                r.step(reset=first and n == 0)
            with spans("frames.display"):
                img = r.display()
            if keep:
                self.checked.append((r.frame_num, n == 0, before,
                                     r.framebuffer.clone(), img))
            n += 1
            if (n >= units) if units else (time.perf_counter() - t0
                                           >= seconds):
                break
        self.ctx.sync()
        dt = time.perf_counter() - t0
        return {"frame_mrays": n * self.rays / dt / 1e6}, n, dt

    def failed(self) -> int:
        return 0

    def release(self):
        del self.renderer

    # --------------------------------------------------------- reference
    def _reference_setup(self, dtype):
        dev = self.ctx.device
        c = self.ctx.config
        scene = rs.build(self.ctx.desc, dev, dtype)
        view = torch.as_tensor(rs.target_to(
            c["eye"], c["center"], c.get("up", [0, 1, 0])), device=dev
        ).to(dtype)
        return scene, view

    def _radiance(self, scene, view, frame_num, work=None):
        return ri.render(scene, frame_num, view, self.job,
                         self.job["ref_block"], work).float()

    def _increment(self, fb_before, fb_after, reset):
        return fb_after if reset else fb_after - fb_before

    def check(self):
        work = {}
        scene, view = self._reference_setup(torch.float32)
        tally = FrameTally()
        for frame_num, reset, before, after, img in self.checked:
            dev_img = torch.as_tensor(img).to(after.device).reshape(-1, 3)
            r_ref = self._radiance(scene, view, frame_num, work)
            fb_ref = rf.accumulate(before, r_ref, reset)
            tally.add(self._increment(before, after, reset),
                      self._increment(before, fb_ref, reset), dev_img,
                      rf.display(after, frame_num))
        per_frame = {k: float(v) / len(self.checked) for k, v in work.items()}
        for k in ("lanes", "facing_quads", "spans", "events"):
            per_frame.setdefault(k, 0.0)
        bounds = {"megakernel_fwd": rw.megakernel_bound(
            per_frame, rw.scene_counts(scene), self.n, self.job["nee"],
            False)["bound_ms"]}
        return tally.numbers(), bounds

    def control_readings(self):
        """The numbers of the control: the reference in bfloat16 in the
        program's place, from the program's framebuffer before each
        checked frame, its display in bfloat16 too."""
        scene, view = self._reference_setup(torch.float32)
        scene16, view16 = self._reference_setup(torch.bfloat16)
        tally = FrameTally()
        for frame_num, reset, before, after, img in self.checked:
            r_ref = self._radiance(scene, view, frame_num)
            r_ctl = self._radiance(scene16, view16, frame_num)
            fb_ref = rf.accumulate(before, r_ref, reset)
            fb_ctl = rf.accumulate(before, r_ctl, reset)
            tally.add(self._increment(before, fb_ctl, reset),
                      self._increment(before, fb_ref, reset),
                      rf.display(fb_ctl.to(torch.bfloat16), frame_num),
                      rf.display(fb_ctl, frame_num))
        return {"control_bf16": tally.numbers()}
