"""Inverse rendering: the program's train step
(``dist.render_dist.make_train_step`` with ``torch.optim.Adam``) over the
material tables, against a target rendered from the true scene.

Set-up builds the step and the optimizer, renders the target, perturbs the
parameters by factors drawn from the seed and takes the first steps
(``check_steps``) through the window's own call, each at a fresh frame
number; those steps are what the reference follows.  The window goes on
with the same step object.  Every frame number comes from a base drawn
from the seed.
"""

from __future__ import annotations

import time

import torch

from .. import system
from ..compare import train_numbers
from ..reference import integrator as ri
from ..reference import scene as rs
from ..reference import train as rt
from ..reference import work as rw

GROUPS = ("emission", "bsdf")


class Job:
    KIND = "train"
    UNITS = {"train_mrays": "Mray/s"}

    def __init__(self, ctx):
        self.ctx = ctx
        self.job = ctx.traffic
        self.rays = self.job["width"] * self.job["height"] * self.job["spp"]
        gen = torch.Generator().manual_seed(ctx.seed % 2 ** 63)
        self.base = int(torch.randint(1, 2 ** 24, (1,), generator=gen))
        lo, hi = self.job["perturb"]
        m = len(ctx.desc["materials"])
        self.factors = {k: lo + (hi - lo) * torch.rand(shape, generator=gen)
                        for k, shape in (
                            ("emission", (m, 3)), ("color", (m, 3)),
                            ("specular_color", (m, 3)),
                            ("specular_strength", (m,)), ("roughness", (m,)),
                            ("eta", (m,)))}
        self.losses = []

    # ----------------------------------------------------------- program
    def setup(self):
        dev = self.ctx.device
        from tpu_path_tracer_torch.diff.params import (apply_params,
                                                       extract_params)
        from tpu_path_tracer_torch.dist.render_dist import (
            make_sharded_frame_fn, make_train_step)

        scene, meta = system.build_scene(self.ctx.desc, dev)
        cfg = system.render_config(self.job)
        self.view = torch.as_tensor(
            system.camera(self.ctx.config).view_matrix, device=dev)
        n = self.job["width"] * self.job["height"]
        with torch.no_grad():
            self.target = make_sharded_frame_fn(None, meta, cfg)(
                torch.zeros((n, 3), device=dev), self.base, True, self.view,
                scene)
        true = extract_params(scene, GROUPS)
        self.params = {k: (v * self.factors[k].to(dev)).detach().clone()
                       .requires_grad_(True) for k, v in true.items()}
        p0 = {k: v.detach().clone() for k, v in self.params.items()}
        self.opt = torch.optim.Adam(self.params.values(), lr=self.job["lr"])
        self.step = make_train_step(None, scene, meta, cfg, apply_params,
                                    self.opt)
        self.frame = self.base + 1
        beta1 = self.opt.defaults["betas"][0]
        losses, grads = [], None
        for _ in range(self.job["check_steps"]):
            losses.append(self._step())
            if grads is None:
                # Adam's first moment after one step is (1 - beta1) g; a
                # leaf that got no gradient has no state and a gradient 0.
                grads = {k: self.opt.state[p]["exp_avg"].detach().clone()
                         / (1.0 - beta1) if "exp_avg" in self.opt.state[p]
                         else torch.zeros_like(p.detach())
                         for k, p in self.params.items()}
        self.readings = {
            "losses": [float(x) for x in losses], "grads": grads,
            "change": {k: v.detach() - p0[k]
                       for k, v in self.params.items()}}
        self.losses = []

    def _step(self):
        loss = self.step(self.params, self.target, self.frame, self.view)
        self.frame += 1
        return loss

    def window(self, seconds=None, units=None, spans=None):
        n = 0
        t0 = time.perf_counter()
        while True:
            with spans("train.step"):
                self.losses.append(self._step())
            n += 1
            if (n >= units) if units else (time.perf_counter() - t0
                                           >= seconds):
                break
        self.ctx.sync()
        dt = time.perf_counter() - t0
        return {"train_mrays": n * self.rays / dt / 1e6}, n, dt

    def failed(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def release(self):
        del self.step, self.opt, self.params, self.target
        self.losses = []

    # --------------------------------------------------------- reference
    def reference(self, dtype=torch.float32, work=None, rows=None,
                  grad_scale=None):
        """The reference's readings of the first steps, in ``dtype``."""
        dev, job = self.ctx.device, self.job
        scene = rs.build(self.ctx.desc, dev, dtype)
        c = self.ctx.config
        view = torch.as_tensor(rs.target_to(
            c["eye"], c["center"], c.get("up", [0, 1, 0])), device=dev
        ).to(dtype)
        block = job["ref_block"]
        target = ri.render(scene, self.base, view, job, block)
        p0 = {k: (scene.materials[k].float() * self.factors[k].to(dev))
              .to(dtype) for k in self.factors}
        frames = [self.base + 1 + k for k in range(job["check_steps"])]
        out = rt.first_steps(scene, p0, target, frames, view, job, job["lr"],
                             block, work, rows, grad_scale)
        out["grads"] = {k: v.float() for k, v in out["grads"].items()}
        out["change"] = {k: v.float() for k, v in out["change"].items()}
        return out, scene

    def check(self):
        """The numbers compared, and the kernels' bounds from the work the
        reference traced."""
        work = {}
        ref, scene = self.reference(work=work)
        self.ref_readings = ref
        steps = self.job["check_steps"]
        per_step = {k: float(v) / steps for k, v in work.items()}
        for k in ("lanes", "facing_quads", "spans", "events"):
            per_step.setdefault(k, 0.0)
        n_pix = self.job["width"] * self.job["height"]
        counts = rw.scene_counts(scene)
        bounds = {
            "megakernel_fwd": rw.megakernel_bound(
                per_step, counts, n_pix, self.job["nee"], False)["bound_ms"],
            "megakernel_bwd": rw.megakernel_bound(
                per_step, counts, n_pix, self.job["nee"], True)["bound_ms"]}
        return train_numbers(self.readings, ref), bounds

    def control_readings(self):
        """The numbers of the control (the reference in bfloat16 in the
        program's place) and of the faults planted in the reference in
        the program's place: half of the pixels left out, the mean taken
        over the rest; the emission's gradient doubled."""
        ref, _ = self.reference()
        n_half = self.job["width"] * self.job["height"] // 2
        out = {}
        for name, kw in (("control_bf16", {"dtype": torch.bfloat16}),
                         ("fault_half_batch", {"rows": n_half}),
                         ("fault_grad_altered",
                          {"grad_scale": {"emission": 2.0}})):
            got, _ = self.reference(**kw)
            out[name] = train_numbers(got, ref)
        # A step that leaves the state unchanged: every change is 0.
        change = self.readings["change"]
        still = dict(self.readings, change={
            k: torch.zeros_like(v) for k, v in change.items()})
        out["fault_state_unchanged"] = train_numbers(still, ref)
        return out

