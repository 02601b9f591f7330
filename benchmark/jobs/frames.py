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

On several ranks (``ctx.mesh``) the renderer splits the framebuffer into
the ranks' contiguous row chunks and gathers them for every display.
Rank 0 decides when the window ends and which frames are kept
(``ctx.agree``, once a frame, between the step and the display).  Each
rank keeps its own chunk and the displayed image, and checks its own
rows: its increment, and its rows of rank 0's displayed image against the
reference's display of its own chunk (so the gather's order and the
exchange are checked too); the tallies are summed over the ranks.
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
            camera=system.camera(self.ctx.config), mesh=self.ctx.mesh)
        for reset in (True, False):  # both of the film's paths
            self.renderer.step(reset=reset)
            self.renderer.display()

    def window(self, seconds=None, units=None, spans=None):
        """Frames for ``seconds`` (or ``units`` frames).  The first window
        of a run resets the session and keeps the frames to check."""
        first, self.first_window = self.first_window, False
        todo = list(self.moments) if first else []
        n = 0
        keep = first
        t0 = time.perf_counter()
        while True:
            r = self.renderer
            reset = first and n == 0
            with spans("frames.step"):
                before = r.framebuffer.clone() if keep and n else None
                r.step(reset=reset)
            n += 1
            # Whether this frame is the window's last and whether the next
            # is kept, decided while the device traces this one (on several
            # ranks, rank 0's decisions reach the others meanwhile).
            now = time.perf_counter() - t0
            done, keep_next = self.ctx.agree(
                (n >= units) if units else now >= seconds,
                bool(todo) and now >= todo[0] * seconds)
            with spans("frames.display"):
                img = r.display()
            if keep:
                self.checked.append((r.frame_num, reset, before,
                                     r.framebuffer.clone(), img))
            keep = keep_next
            if keep:
                todo.pop(0)
            if done:
                break
        self.ctx.sync()
        dt = time.perf_counter() - t0
        return {"frame_mrays": n * self.rays / dt / 1e6}, n, dt

    @property
    def kept(self):
        """The frame numbers kept for the check."""
        return [c[0] for c in self.checked]

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

    def _rows(self):
        """(start, stop, chunk): the frame's pixels in this rank's chunk,
        and the chunk's length (the whole frame in one process)."""
        chunk = self.checked[0][3].shape[0]
        start = self.ctx.rank * chunk
        return start, min(start + chunk, self.n), chunk

    def _mine(self):
        """The checked frames cut to this rank's pixels: (frame number,
        reset, framebuffer before, after, displayed image).  On several
        ranks the image is rank 0's, the one its user sees, whose rows
        rank 0 hands to each rank."""
        start, stop, chunk = self._rows()
        m = stop - start
        group = self.ctx.group
        for frame_num, reset, before, after, img in self.checked:
            image = torch.as_tensor(img).reshape(-1, 3)
            if group is None:
                shown = image[start:stop]
            else:
                padded = torch.zeros((group.world * chunk, 3),
                                     dtype=image.dtype)
                padded[:self.n] = image
                shown = group.from_lead(
                    list(padded.split(chunk)) if group.rank == 0 else None,
                    padded[:chunk])[:m]
            yield (frame_num, reset, None if before is None else before[:m],
                   after[:m], shown.to(after.device))

    def _radiance(self, scene, view, frame_num, work=None):
        start, stop, _ = self._rows()
        return ri.render(scene, frame_num, view, self.job,
                         self.job["ref_block"], work,
                         pixels=(start, stop)).float()

    def _increment(self, fb_before, fb_after, reset):
        return fb_after if reset else fb_after - fb_before

    def check(self):
        work = {}
        scene, view = self._reference_setup(torch.float32)
        tally = FrameTally()
        for frame_num, reset, before, after, shown in self._mine():
            r_ref = self._radiance(scene, view, frame_num, work)
            fb_ref = rf.accumulate(before, r_ref, reset)
            tally.add(self._increment(before, after, reset),
                      self._increment(before, fb_ref, reset), shown,
                      rf.display(after, frame_num))
        per_frame = {k: float(v) / len(self.checked) for k, v in work.items()}
        for k in ("lanes", "facing_quads", "spans", "events"):
            per_frame.setdefault(k, 0.0)
        start, stop, _ = self._rows()
        bounds = {"megakernel_fwd": rw.megakernel_bound(
            per_frame, rw.scene_counts(scene), stop - start, self.job["nee"],
            False)["bound_ms"]}
        return tally.numbers(self.ctx.total), bounds

    def _shown(self, fb, frame_num, swap=False):
        """This rank's rows of the image that the reference's chunks
        ``fb`` of every rank, gathered in rank order (ranks 0 and 1
        swapped with ``swap``), display."""
        start, stop, chunk = self._rows()
        padded = torch.zeros((chunk, 3), dtype=fb.dtype)
        padded[:stop - start] = fb.cpu()
        parts = self.ctx.group.rows(padded)
        if swap:
            parts[0], parts[1] = parts[1], parts[0]
        image = rf.display(torch.cat(parts)[:self.n], frame_num)
        return image[start:stop].to(fb.device)

    def control_readings(self):
        """The numbers of the control: the reference in bfloat16 in the
        program's place, from the program's framebuffer before each
        checked frame, its display in bfloat16 too.  On several ranks also
        two faults planted in the reference put in the program's place:
        ranks 0 and 1's chunks swapped in the gathered image, and the last
        rank's increment dropped."""
        scene, view = self._reference_setup(torch.float32)
        scene16, view16 = self._reference_setup(torch.bfloat16)
        control, swapped, dropped = FrameTally(), FrameTally(), FrameTally()
        last = self.ctx.group is not None and (
            self.ctx.rank == self.ctx.group.world - 1)
        for frame_num, reset, before, after, _ in self._mine():
            r_ref = self._radiance(scene, view, frame_num)
            r_ctl = self._radiance(scene16, view16, frame_num)
            fb_ref = rf.accumulate(before, r_ref, reset)
            fb_ctl = rf.accumulate(before, r_ctl, reset)
            d_ref = self._increment(before, fb_ref, reset)
            control.add(self._increment(before, fb_ctl, reset), d_ref,
                        rf.display(fb_ctl.to(torch.bfloat16), frame_num),
                        rf.display(fb_ctl, frame_num))
            if self.ctx.group is None:
                continue
            own = rf.display(fb_ref, frame_num)
            swapped.add(d_ref, d_ref, self._shown(fb_ref, frame_num, True),
                        own)
            fb_drop = fb_ref
            if last:
                fb_drop = torch.zeros_like(fb_ref) if reset else before
            dropped.add(self._increment(before, fb_drop, reset), d_ref,
                        self._shown(fb_drop, frame_num),
                        rf.display(fb_drop, frame_num))
        out = {"control_bf16": control.numbers(self.ctx.total)}
        if self.ctx.group is not None:
            out["fault_chunks_swapped"] = swapped.numbers(self.ctx.total)
            out["fault_increment_dropped"] = dropped.numbers(self.ctx.total)
        return out
