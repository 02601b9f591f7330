"""The upstream's default scene (``lib/scene.js:36-187``): fog spheres in
glass shells in three stacks and a lone glass sphere, an 8-quad room with
an emissive ceiling, and the glass cube (``assets/cube.obj``) rotated
pi/10 about Y."""

from __future__ import annotations

import math

from ._describe import Description, cube, rotation

LAMBERTIAN, MIRROR, GLASS, ISOTROPIC = 0, 1, 2, 3


def describe(args: dict) -> dict:
    s = Description()
    s.material("default", LAMBERTIAN, [1, 0, 0])
    pink, green, blue = [0.94, 0.70, 0.75], [0.56, 0.93, 0.56], \
        [0.52, 0.8, 0.92]

    def fog_glass_pair(center, radius, fog_color, density_inv, glass_eta):
        # lib/scene.js:46-76: the roughness channel holds -1/density.
        fog = s.material("fog", ISOTROPIC, fog_color,
                         specular_strength=0.00001, roughness=density_inv)
        glass = s.material("gg4t", GLASS, [1, 1, 1], eta=glass_eta)
        s.sphere(center, radius, fog)
        s.sphere(center, radius, glass)

    for y, r in ((-0.65, 0.35), (-0.05, 0.25), (0.3, 0.10), (0.45, 0.05)):
        fog_glass_pair([-0.3, y, 0.3], r, green, -1 / 4, 1.5)
    fog_glass_pair([0.5, -0.65, -0.2], 0.35, blue, -1 / 7, 1.0)
    s.sphere([0.5, 0.1, 0.2], 0.2, s.material("gg4t", GLASS, [1, 1, 1],
                                              eta=1.5))
    for y, r in ((-0.65, 0.35), (-0.05, 0.25), (0.3, 0.10), (0.45, 0.05)):
        fog_glass_pair([1.3, y, 0.3], r, pink, -1 / 10, 1.0)

    for name, col, sstr, rough in (
            ("red", [0.75, 0.1, 0.1], 0.05, 0.95),
            ("green", [0.05, 0.55, 0.05], 0.05, 0.95),
            ("blue", [0.05, 0.05, 0.55], 0.05, 0.95),
            ("white", [0.76, 0.70, 0.51], 0.05, 0.95),
            ("glossywhite", [0.76, 0.70, 0.51], 0.3, 0.1),
            ("black", [0.2, 0.2, 0.2], 0.05, 0.95)):
        s.material(name, LAMBERTIAN, col, col, specular_strength=sstr,
                   roughness=rough)
    s.material("glass", MIRROR, [0.95, 0.95, 0.95])

    # The emissive ceiling first, so that it is the light.
    s.quad([-1, 1, -1], [3, 0, 0], [0, 0, 2],
           s.material("tWall", LAMBERTIAN, [0, 0, 0], [0, 0, 0],
                      emission=[2, 2, 2]))
    s.quad([-1, -1, -1], [3, 0, 0], [0, 2, 0], s.find("black"))
    s.quad([-1, -1, 1], [0, 0, -2], [0, 2, 0], s.find("red"))
    s.quad([2, -1, -1], [0, 0, 2], [0, 2, 0], s.find("green"))
    s.quad([-1, 1, -1], [3, 0, 0], [0, 0, 2], s.find("white"))
    s.quad([2, -1, -1], [-3, 0, 0], [0, 0, 2], s.find("glossywhite"))
    s.quad([100, -1, -100], [-200, 0, 0], [0, 0, 200], s.find("white"))
    s.quad([2, -1, 1], [-3, 0, 0], [0, 2, 0],
           s.material("fWall", LAMBERTIAN, [0.15, 0.15, 0.15]))

    s.material("dragonMat", LAMBERTIAN, [0.0, 0.37, 0.20], [0.0, 0.95, 0.95],
               specular_strength=0.4, roughness=0.3, eta=2.5)
    glass_box = s.material("glassBox", LAMBERTIAN, [0.95, 0.95, 0.95],
                           eta=2.5)
    vertices, normals = cube()
    s.mesh(vertices, normals, glass_box, rotation(math.pi / 10, [0, 1, 0]))
    return s.done()
