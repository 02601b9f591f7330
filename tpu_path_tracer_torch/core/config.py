"""Render configuration.

Counterpart of ``tpu_path_tracer.core.config``: the same fields, defaults
and material enums, so a ``RenderConfig`` means the same render in both
packages.  The TPU knobs ``lane_multiple`` and ``use_pallas`` have no
counterpart here.
"""

from __future__ import annotations

import dataclasses

# Material type enum — shaders/header.wgsl:4-8.
LAMBERTIAN = 0
MIRROR = 1
GLASS = 2
ISOTROPIC = 3
ANISOTROPIC = 4  # declared but unused in the reference

# Numeric guards — shaders/header.wgsl:1-3, :37-38.
PI = 3.1415926535897932385
MIN_FLOAT = 0.0001
MAX_FLOAT = 999999999.999
RAY_TMIN = 0.000001


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters.

    Defaults mirror the reference: 1 spp/frame, up to 100 bounces, no
    stratification, no NEE/MIS (``shaders/header.wgsl:9-12``), cyan background
    (``shaders/traceRay.wgsl:8``), 60 degree vertical FOV
    (``shaders/main.wgsl:7``), Russian roulette after bounce 2
    (``shaders/traceRay.wgsl:70-79``).
    """

    width: int = 900            # index.html:17
    height: int = 600           # index.html:18
    samples_per_pixel: int = 1  # NUM_SAMPLES, header.wgsl:9
    max_bounces: int = 100      # MAX_BOUNCES, header.wgsl:10
    stratify: bool = False      # STRATIFY, header.wgsl:11
    importance_sampling: bool = False  # IMPORTANCE_SAMPLING, header.wgsl:12
    light_sample_prob: float = 0.2     # traceRay.wgsl:43,49
    rr_start_bounce: int = 3           # "i > 2" — traceRay.wgsl:71
    background: tuple = (0.0, 1.0, 1.0)  # traceRay.wgsl:8
    fov_degrees: float = 60.0          # main.wgsl:7
    t_min: float = RAY_TMIN            # header.wgsl:37
    t_max: float = MAX_FLOAT           # header.wgsl:38
    # Route whole-frame tracing through the fused CUDA megakernel
    # (kernels/megakernel.py) when the scene supports it.  On CPU tensors
    # that route runs the kernel's plain version, the wavefront.
    use_megakernel: bool = False
    # Wavefront gradients: replay each bounce in the backward pass
    # (torch.utils.checkpoint) instead of saving its intermediates; only the
    # state between bounces and the hit-search results are kept
    # (integrator/path_tracer.py).
    remat_bounces: bool = True

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
