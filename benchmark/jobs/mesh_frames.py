"""Progressive frames of a scene of many triangles: ``frames``' job (the
program's ``Renderer.step`` and then ``Renderer.display()`` every frame),
checked against ``reference.integrator_mesh``, whose hit search tests the
triangles in blocks of the traffic's ``tri_block``.

The program routes such a scene as it routes any OBJ mesh: the BVH its
builder makes, the wavefront integrator and the BVH walk.  Beside the
frames' bounds ``check`` gives ``mesh_frame``, the least time of the whole
frame's work (``reference.work_mesh``), which reads the same whatever
kernels do the frame.  The control adds a planted fault: the reference
with the first block of triangles dropped, put in the program's place.
"""

from __future__ import annotations

import torch

from ..compare import FrameTally
from ..reference import film as rf
from ..reference import integrator_mesh as rm
from ..reference import scene as rs
from ..reference import work as rw
from ..reference import work_mesh as wm
from .frames import Job as Frames


class Job(Frames):
    def _radiance(self, scene, view, frame_num, work=None):
        if work is not None:
            self.work = work  # the check's tally of the reference's work
        start, stop, _ = self._rows()
        return rm.render(scene, frame_num, view, self.job,
                         self.job["ref_block"], self.job["tri_block"], work,
                         pixels=(start, stop)).float()

    def check(self):
        numbers, bounds = super().check()
        per_frame = {k: float(v) / len(self.checked)
                     for k, v in self.work.items()}
        start, stop, _ = self._rows()
        counts = rw.scene_counts(rs.build(self.ctx.desc, "cpu"))
        bounds["mesh_frame"] = wm.frame_bound(
            per_frame, counts["triangles"], stop - start, self.job["nee"],
            counts["has_light"])["bound_ms"]
        return numbers, bounds

    def control_readings(self):
        """``frames``' control, and the reference with its first
        ``tri_block`` triangles dropped in the program's place."""
        out = super().control_readings()
        scene, view = self._reference_setup(torch.float32)
        k = self.job["tri_block"]
        holed = scene._replace(triangles={
            f: v[k:] for f, v in scene.triangles.items()})
        dropped = FrameTally()
        for frame_num, reset, before, _, _ in self._mine():
            fb_ref = rf.accumulate(
                before, self._radiance(scene, view, frame_num), reset)
            fb_bad = rf.accumulate(
                before, self._radiance(holed, view, frame_num), reset)
            shown = rf.display(fb_bad, frame_num)
            dropped.add(self._increment(before, fb_bad, reset),
                        self._increment(before, fb_ref, reset), shown, shown)
        out["fault_block_dropped"] = dropped.numbers(self.ctx.total)
        return out
