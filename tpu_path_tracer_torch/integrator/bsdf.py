"""Branchless BSDF sampling for all four material families
(``tpu_path_tracer.integrator.bsdf``).

Every lane evaluates all four samplers and the result is selected by
material type, so every lane draws the same 8 uniforms per bounce in the
same order: r1, r2 (cosine), u_spec, f1, f2 (mirror fuzz), u_refl, u_hg,
u_phi.  That draw order is the contract the CUDA megakernel replays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng, vecmath as vm
from ..core.config import GLASS, LAMBERTIAN, MIRROR, PI
from ..core.types import HitRecord, Materials


class ScatterRecord(NamedTuple):
    """SoA of WGSL ``ScatterRecord`` (header.wgsl:127-131) plus what the
    NEE/MIS combiner needs."""
    dir: torch.Tensor          # [N, 3] sampled outgoing direction
    attenuation: torch.Tensor  # [N, 3] throughput multiplier
    skip_pdf: torch.Tensor     # [N] bool — specular-ish lanes bypass MIS
    diffuse_dir: torch.Tensor  # [N, 3] the pure-diffuse candidate (NEE mixing)


def schlick_reflectance(cosine, ref_idx):
    """``reflectance`` — importanceSampling.wgsl:1-5."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def henyey_greenstein_cos(g, u):
    """Sample cos(theta) from the HG phase function (``scatterRay.wgsl:80``),
    with the isotropic g -> 0 limit made explicit."""
    small = torch.abs(g) < 1e-4
    safe_g = torch.where(small, 1.0, g)
    frac = (1.0 - g * g) / (1.0 - g + 2.0 * g * u)
    general = (1.0 + g * g - frac * frac) / (2.0 * safe_g)
    isotropic = 1.0 - 2.0 * u
    return torch.clamp(torch.where(small, isotropic, general), -1.0, 1.0)


def material_scatter(rand_state, wi: torch.Tensor, rec: HitRecord,
                     materials: Materials):
    """Sample an outgoing ray for every lane; returns
    ``(rand_state, ScatterRecord)``."""
    mid = rec.material_id
    mtype = materials.mtype[mid]
    color = materials.color[mid]
    spec_color = materials.specular_color[mid]
    spec_strength = materials.specular_strength[mid]
    roughness = materials.roughness[mid]
    eta = materials.eta[mid]
    n = rec.normal

    # --- LAMBERTIAN ---------------------------------------------------
    ub, vb, wb = vm.onb_from_w(n)
    rand_state, cos_local = rng.cosine_wrt_z(rand_state)
    diffuse_dir = vm.normalize(vm.onb_local(ub, vb, wb, cos_local))
    rand_state, u_spec = rng.uniform(rand_state)
    do_specular = (u_spec < spec_strength).to(torch.float32)
    reflected = vm.reflect(wi, n)
    specular_dir = vm.normalize(
        vm.mix(reflected, diffuse_dir, roughness[:, None]))
    lam_dir = vm.normalize(
        vm.mix(diffuse_dir, specular_dir, do_specular[:, None]))
    lam_skip = do_specular > 0.5

    # --- MIRROR -------------------------------------------------------
    rand_state, fuzz = rng.uniform_in_unit_sphere(rand_state)
    mirror_dir = vm.normalize(reflected + roughness[:, None] * fuzz)

    # --- GLASS --------------------------------------------------------
    # eta is 0 on non-glass materials; guard the reciprocal.
    ir = torch.where(rec.front_face, 1.0 / torch.clamp(eta, min=1e-8), eta)
    unit = vm.normalize(wi)
    cos_t = torch.clamp(vm.dot(-unit, n), max=1.0)
    sin_t = vm.safe_sqrt(1.0 - cos_t * cos_t)
    rand_state, u_refl = rng.uniform(rand_state)
    must_reflect = (ir * sin_t > 1.0) | (schlick_reflectance(cos_t, ir)
                                         > u_refl)
    glass_dir = vm.normalize(torch.where(
        must_reflect[:, None], vm.reflect(unit, n),
        vm.refract(unit, n, ir)))

    # --- ISOTROPIC (Henyey-Greenstein about the incident dir) ---------
    g = spec_strength
    rand_state, u_hg = rng.uniform(rand_state)
    cos_hg = henyey_greenstein_cos(g, u_hg)
    sin_hg = vm.safe_sqrt(1.0 - cos_hg * cos_hg)
    rand_state, u_phi = rng.uniform(rand_state)
    phi = 2.0 * PI * u_phi
    hg_local = torch.stack(
        [sin_hg * torch.cos(phi), sin_hg * torch.sin(phi), cos_hg], dim=-1)
    uw, vw, ww = vm.onb_from_w(wi)
    iso_dir = vm.normalize(vm.onb_local(uw, vw, ww, hg_local))

    # --- select by material type --------------------------------------
    mt = mtype[:, None]
    out_dir = torch.where(
        mt == LAMBERTIAN, lam_dir,
        torch.where(mt == MIRROR, mirror_dir,
                    torch.where(mt == GLASS, glass_dir, iso_dir)))
    is_lam = mtype == LAMBERTIAN
    skip_pdf = torch.where(is_lam, lam_skip, True)
    do_spec_final = torch.where(is_lam, do_specular, 0.0)
    attenuation = vm.mix(color, spec_color, do_spec_final[:, None])

    return rand_state, ScatterRecord(
        dir=out_dir, attenuation=attenuation, skip_pdf=skip_pdf,
        diffuse_dir=diffuse_dir)


def lambertian_pdf(direction, normal):
    """``onb_lambertian_scattering_pdf`` (importanceSampling.wgsl:73-76):
    max(0, cos(theta)/pi) against the shading normal."""
    cosine = vm.dot(vm.normalize(direction), vm.normalize(normal))
    return torch.clamp(cosine / PI, min=0.0)
