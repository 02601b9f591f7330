"""The analytic Cornell box: five diffuse walls, a 0.6 x 0.6 area light
and two diffuse spheres, the classic layout the upstream comments at
``lib/scene.js:128-132``."""

from __future__ import annotations

from ._describe import Description

LAMBERTIAN = 0


def describe(args: dict) -> dict:
    e = args.get("light_emission", [15.0, 15.0, 15.0])
    s = Description()
    red = s.material("red", LAMBERTIAN, [0.65, 0.05, 0.05])
    green = s.material("green", LAMBERTIAN, [0.12, 0.45, 0.15])
    white = s.material("white", LAMBERTIAN, [0.73, 0.73, 0.73])
    light = s.material("light", LAMBERTIAN, [0, 0, 0], emission=e)
    # The light first: the first emissive quad is the one sampled.
    s.quad([-0.3, 0.999, -0.3], [0.6, 0, 0], [0, 0, 0.6], light)
    s.quad([-1, -1, -1], [2, 0, 0], [0, 2, 0], white)    # back
    s.quad([-1, -1, 1], [0, 0, -2], [0, 2, 0], red)      # left
    s.quad([1, -1, -1], [0, 0, 2], [0, 2, 0], green)     # right
    s.quad([-1, 1, -1], [2, 0, 0], [0, 0, 2], white)     # top
    s.quad([1, -1, -1], [-2, 0, 0], [0, 0, 2], white)    # bottom
    s.sphere([-0.45, -0.6, -0.2], 0.4, white)
    s.sphere([0.45, -0.7, 0.3], 0.3, red)
    return s.done()
