"""Wavefront path-tracing integrator
(``tpu_path_tracer.integrator.path_tracer``).

The reference's per-thread radiance loop (``ray_color``,
``shaders/traceRay.wgsl:3-83``) becomes a Python loop over bounces in which
every lane advances one bounce per step as dense SoA state
``(rng, ray, radiance, throughput, alive)``.  Retired lanes are masked, not
removed, and keep drawing random numbers, so every lane's PCG stream
advances by the same count per bounce.

Per bounce (plain mode, ``traceRay.wgsl:60-68``): miss → radiance +=
background * throughput, lane retires; hit → radiance += front-face
emission * throughput, then throughput *= mix(color, specColor,
doSpecular) and the ray is re-aimed by ``material_scatter``.  NEE/MIS mode
(``traceRay.wgsl:24-58``) mixes a light-quad sample with the BSDF sample
for diffuse lanes.  As in the JAX package, a degenerate pdf ends the lane
and keeps its accumulated radiance.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core import rng
from ..core.config import RenderConfig
from ..core.types import Ray, SceneData, SceneMeta
from ..kernels.hit import find_hit, shade_hit
from ..utils import profiling
from . import lights
from .bsdf import lambertian_pdf, material_scatter


def trace(rand_state, ray: Ray, scene: SceneData, meta: SceneMeta,
          cfg: RenderConfig):
    """Estimate radiance along each ray; returns ``(rand_state,
    radiance [N, 3])``.

    Differentiable with respect to the scene tensors and the ray: the hit
    search (``find_hit``) is detached, and gradients flow through the
    re-shaded hit, the BSDF, the NEE pdf chain and the Russian-roulette
    compensation.  With ``cfg.remat_bounces`` and grad mode on, the
    differentiable part of each bounce runs under
    ``torch.utils.checkpoint``, as the JAX package's ``jax.checkpoint``
    with its ``save_only_these_names`` policy
    (``path_tracer.py:51-59,123-137``): the backward pass keeps only the
    state between bounces and the three hit-search results (``ptype``,
    ``pidx``, ``vol_u``), and replays the rest of the bounce from them, so
    the replay never repeats the hit search.  The PCG state goes in and
    out of the replayed part explicitly, so the replay draws the same
    numbers.

    The call is the span ``wavefront.trace``, and each bounce adds one to
    the counter ``wavefront_bounces`` (``utils.profiling``)."""
    with profiling.span("wavefront.trace"):
        return _trace(rand_state, ray, scene, meta, cfg)


def _trace(rand_state, ray: Ray, scene: SceneData, meta: SceneMeta,
           cfg: RenderConfig):
    device = ray.origin.device
    background = torch.as_tensor(np.asarray(cfg.background, np.float32),
                                 device=device)
    n = ray.origin.shape[0]
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=device)
    throughput = torch.ones_like(radiance)
    alive = torch.ones((n,), dtype=torch.bool, device=device)
    use_nee = cfg.importance_sampling and meta.has_light
    if use_nee:
        lq, lu, lv = (x[None] for x in lights.light_quad(scene))

    def shade_and_scatter(rand_state, origin, direction, radiance,
                          throughput, alive, ptype, pidx, vol_u, bounce_idx):
        cur_ray = Ray(origin=origin, dir=direction)
        rec = shade_hit(cur_ray, ptype, pidx, vol_u, scene, cfg)

        # Miss: background * throughput, lane retires (traceRay.wgsl:12-16).
        miss = alive & ~rec.hit
        radiance = radiance + torch.where(
            miss[:, None], background * throughput, 0.0)
        live = alive & rec.hit

        # Unidirectional emission: front faces only (traceRay.wgsl:18-22).
        emission = scene.materials.emission[rec.material_id]
        emission = torch.where(rec.front_face[:, None], emission, 0.0)
        radiance = radiance + torch.where(
            live[:, None], emission * throughput, 0.0)

        rand_state, srec = material_scatter(rand_state, direction, rec,
                                            scene.materials)

        if use_nee:
            # NEE/MIS for non-skip (pure diffuse) lanes — traceRay.wgsl:26-57.
            rand_state, light_dir = lights.sample_on_quad(
                rand_state, lq, lu, lv, rec.p)
            rand_state, u_mix = rng.uniform(rand_state)
            chosen = torch.where((u_mix > cfg.light_sample_prob)[:, None],
                                 srec.diffuse_dir, light_dir)
            lam_pdf = lambertian_pdf(chosen, rec.normal)
            l_pdf = lights.quad_light_pdf(rec.p, chosen, lq, lu, lv)
            pdf = (cfg.light_sample_prob * l_pdf
                   + (1.0 - cfg.light_sample_prob) * lam_pdf)
            degenerate = pdf <= 1e-5
            mis_thr = throughput * (
                lam_pdf[:, None] * srec.attenuation
                / torch.clamp(pdf, min=1e-12)[:, None])
            use_mis = live & ~srec.skip_pdf
            new_dir = torch.where(use_mis[:, None], chosen, srec.dir)
            new_thr = torch.where(use_mis[:, None],
                                  mis_thr, throughput * srec.attenuation)
            live = live & ~(use_mis & degenerate)
        else:
            new_dir = srec.dir
            new_thr = throughput * srec.attenuation

        throughput = torch.where(live[:, None], new_thr, throughput)
        origin = torch.where(live[:, None], rec.p, origin)
        direction = torch.where(live[:, None], new_dir, direction)
        alive = live

        # Russian roulette from bounce rr_start_bounce on
        # (traceRay.wgsl:70-79): survive with p = max throughput channel,
        # survivors compensate by 1/p.
        rand_state, u_rr = rng.uniform(rand_state)
        p_survive = torch.amax(throughput, dim=-1)
        if bounce_idx >= cfg.rr_start_bounce:
            alive = alive & ~(u_rr > p_survive)
            throughput = torch.where(
                alive[:, None],
                throughput / torch.clamp(p_survive, min=1e-12)[:, None],
                throughput)
        return rand_state, origin, direction, radiance, throughput, alive

    remat = cfg.remat_bounces and torch.is_grad_enabled()
    origin, direction = ray.origin, ray.dir
    for bounce_idx in range(cfg.max_bounces):
        profiling.count("wavefront_bounces")
        rand_state, ptype, pidx, vol_u = find_hit(
            rand_state, Ray(origin=origin, dir=direction), scene, meta, cfg,
            alive=alive)
        state = (rand_state, origin, direction, radiance, throughput, alive,
                 ptype, pidx, vol_u, bounce_idx)
        if remat:
            state = checkpoint(shade_and_scatter, *state,
                               use_reentrant=False, preserve_rng_state=False)
        else:
            state = shade_and_scatter(*state)
        rand_state, origin, direction, radiance, throughput, alive = state

    return rand_state, radiance
