"""Built-in scenes (``tpu_path_tracer.scene.builtin``).

``reference_scene`` reproduces the reference's hard-coded default scene —
fog+glass sphere pairs (``lib/scene.js:36-103``), the 8-quad Cornell-like
room with an emissive ceiling (``lib/scene.js:105-162``) and the rotated
glass cube mesh (``lib/scene.js:164-187``).  ``cornell_box`` is the simpler
diffuse analytic scene.  Materials are registered in the same order as in
the JAX package, so material ids match.  Both build on the first CUDA
device unless ``device`` says otherwise.
"""

from __future__ import annotations

import math

from ..core.config import GLASS, ISOTROPIC, LAMBERTIAN, MIRROR
from .builder import SceneBuilder
from . import procedural
from .transform import Transform


def reference_scene(include_mesh: bool = True, bvh: str = "auto",
                    mini: bool = False, device="cuda"):
    """The default scene of ``lib/scene.js``.  ``mini=True`` keeps one
    fog+glass pair per color stack (6 spheres + the lone glass sphere).
    Returns ``(SceneData, SceneMeta, SceneBuilder)``."""
    b = SceneBuilder()
    b.add_material("default", LAMBERTIAN, [1, 0, 0])

    pink = [0.94, 0.70, 0.75]
    green = [0.56, 0.93, 0.56]
    blue = [0.52, 0.8, 0.92]

    def fog_glass_pair(center, radius, fog_color, density_inv, glass_eta):
        """A fog sphere nested in an identical glass shell —
        lib/scene.js:46-76 (roughness channel stores -1/density)."""
        fog = b.add_material("fog", ISOTROPIC, fog_color,
                             specular_strength=0.00001,
                             roughness=density_inv, eta=0.0)
        glass = b.add_material("gg4t", GLASS, [1, 1, 1],
                               specular_strength=0.0, roughness=0.0,
                               eta=glass_eta)
        b.add_sphere(center, radius, fog)
        b.add_sphere(center, radius, glass)

    # Left stack (green fog, eta 1.5) — lib/scene.js:46-56.
    fog_glass_pair([-0.3, -0.65, 0.3], 0.35, green, -1 / 4, 1.5)
    if not mini:
        fog_glass_pair([-0.3, -0.05, 0.3], 0.25, green, -1 / 4, 1.5)
        fog_glass_pair([-0.3, 0.3, 0.3], 0.10, green, -1 / 4, 1.5)
        fog_glass_pair([-0.3, 0.45, 0.3], 0.05, green, -1 / 4, 1.5)
    # Middle (blue fog, eta 1) + lone glass sphere — lib/scene.js:59-63.
    fog_glass_pair([0.5, -0.65, -0.2], 0.35, blue, -1 / 7, 1.0)
    b.add_sphere([0.5, 0.1, 0.2], 0.2,
                 b.add_material("gg4t", GLASS, [1, 1, 1], eta=1.5))
    # Right stack (pink fog, eta 1) — lib/scene.js:66-76.
    fog_glass_pair([1.3, -0.65, 0.3], 0.35, pink, -1 / 10, 1.0)
    if not mini:
        fog_glass_pair([1.3, -0.05, 0.3], 0.25, pink, -1 / 10, 1.0)
        fog_glass_pair([1.3, 0.3, 0.3], 0.10, pink, -1 / 10, 1.0)
        fog_glass_pair([1.3, 0.45, 0.3], 0.05, pink, -1 / 10, 1.0)

    # Quad materials — lib/scene.js:107-113.
    b.add_material("red", LAMBERTIAN, [0.75, 0.1, 0.1], [0.75, 0.1, 0.1],
                   specular_strength=0.05, roughness=0.95)
    b.add_material("green", LAMBERTIAN, [0.05, 0.55, 0.05], [0.05, 0.55, 0.05],
                   specular_strength=0.05, roughness=0.95)
    b.add_material("blue", LAMBERTIAN, [0.05, 0.05, 0.55], [0.05, 0.05, 0.55],
                   specular_strength=0.05, roughness=0.95)
    b.add_material("white", LAMBERTIAN, [0.76, 0.70, 0.51], [0.76, 0.70, 0.51],
                   specular_strength=0.05, roughness=0.95)
    b.add_material("glossywhite", LAMBERTIAN, [0.76, 0.70, 0.51],
                   [0.76, 0.70, 0.51], specular_strength=0.3, roughness=0.1)
    b.add_material("black", LAMBERTIAN, [0.2, 0.2, 0.2], [0.2, 0.2, 0.2],
                   specular_strength=0.05, roughness=0.95)
    b.add_material("glass", MIRROR, [0.95, 0.95, 0.95])

    # Quads — lib/scene.js:115-157 (order matters: the emissive ceiling is
    # first, so get_lights picks it).
    b.add_quad([-1, 1, -1], [3, 0, 0], [0, 0, 2],
               b.add_material("tWall", LAMBERTIAN, [0, 0, 0], [0, 0, 0],
                              emission=[2, 2, 2]))
    b.add_quad([-1, -1, -1], [3, 0, 0], [0, 2, 0], b.material("black"))
    b.add_quad([-1, -1, 1], [0, 0, -2], [0, 2, 0], b.material("red"))
    b.add_quad([2, -1, -1], [0, 0, 2], [0, 2, 0], b.material("green"))
    b.add_quad([-1, 1, -1], [3, 0, 0], [0, 0, 2], b.material("white"))
    b.add_quad([2, -1, -1], [-3, 0, 0], [0, 0, 2], b.material("glossywhite"))
    b.add_quad([100, -1, -100], [-200, 0, 0], [0, 0, 200], b.material("white"))
    b.add_quad([2, -1, 1], [-3, 0, 0], [0, 2, 0],
               b.add_material("fWall", LAMBERTIAN, [0.15, 0.15, 0.15]))

    if include_mesh:
        # The glass cube — lib/scene.js:166-187: cube.obj (half-extent
        # 0.270893), material glassBox (eta 2.5), rotated pi/10 about Y.
        b.add_material("dragonMat", LAMBERTIAN, [0.0, 0.37, 0.20],
                       [0.0, 0.95, 0.95], specular_strength=0.4,
                       roughness=0.3, eta=2.5)
        glass_box = b.add_material("glassBox", LAMBERTIAN,
                                   [0.95, 0.95, 0.95], eta=2.5)
        t = Transform()
        t.update(Transform.rotate(math.pi / 10, [0, 1, 0]))
        b.add_mesh(procedural.cube(), glass_box, t)

    scene, meta = b.build(bvh=bvh, device=device)
    return scene, meta, b


def cornell_box(light_emission=(15.0, 15.0, 15.0), bvh: str = "auto",
                with_spheres: bool = True, device="cuda"):
    """Analytic Cornell box: 5 diffuse walls + area light (+2 diffuse
    spheres), built from the reference's commented 'classic' layout
    (``lib/scene.js:128-132``)."""
    b = SceneBuilder()
    red = b.add_material("red", LAMBERTIAN, [0.65, 0.05, 0.05])
    green = b.add_material("green", LAMBERTIAN, [0.12, 0.45, 0.15])
    white = b.add_material("white", LAMBERTIAN, [0.73, 0.73, 0.73])
    light = b.add_material("light", LAMBERTIAN, [0, 0, 0],
                           emission=light_emission)

    # Light first (get_lights picks the first emissive quad).
    b.add_quad([-0.3, 0.999, -0.3], [0.6, 0, 0], [0, 0, 0.6], light)
    b.add_quad([-1, -1, -1], [2, 0, 0], [0, 2, 0], white)    # back
    b.add_quad([-1, -1, 1], [0, 0, -2], [0, 2, 0], red)      # left
    b.add_quad([1, -1, -1], [0, 0, 2], [0, 2, 0], green)     # right
    b.add_quad([-1, 1, -1], [2, 0, 0], [0, 0, 2], white)     # top
    b.add_quad([1, -1, -1], [-2, 0, 0], [0, 0, 2], white)    # bottom

    if with_spheres:
        b.add_sphere([-0.45, -0.6, -0.2], 0.4, white)
        b.add_sphere([0.45, -0.7, 0.3], 0.3, red)

    scene, meta = b.build(bvh=bvh, device=device)
    return scene, meta, b
