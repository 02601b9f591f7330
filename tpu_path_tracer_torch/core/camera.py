"""Orbit camera with gl-matrix ``targetTo`` semantics.

Feature parity with ``lib/camera.js``: ``set_camera`` builds a view matrix via
``mat4.targetTo`` (``lib/camera.js:32``); mouse-drag orbit rotates the eye
about world Y (``:44-53``); wheel zoom translates the eye along the stored
view direction (``:35-42``); arrow keys pan eye+center (``:55-74``).  The DOM
event plumbing (``:76-133``) maps to plain methods here.  A copy of
``tpu_path_tracer.core.camera``, so that the port imports nothing of JAX.

The camera is pure host-side NumPy: its only output consumed by device code is
the 4x4 ``view_matrix`` (column-basis [x, y, z, eye]), matching the single
per-frame uniform upload in the reference (``renderer.js:183-184``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def target_to(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """gl-matrix ``mat4.targetTo``: rotation+translation with z-basis =
    normalize(eye - target), as consumed by ``shaders/shootRay.wgsl:54-60``."""
    eye = np.asarray(eye, np.float32)
    z = eye - np.asarray(target, np.float32)
    zlen = np.dot(z, z)
    if zlen > 0:
        z = z / np.sqrt(zlen)
    x = np.cross(np.asarray(up, np.float32), z)
    xlen = np.dot(x, x)
    if xlen > 0:
        x = x / np.sqrt(xlen)
    y = np.cross(z, x)
    ylen = np.dot(y, y)
    if ylen > 0:
        y = y / np.sqrt(ylen)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = x
    m[:3, 1] = y
    m[:3, 2] = z
    m[:3, 3] = eye
    return m


def rotate_y(p: np.ndarray, origin: np.ndarray, rad: float) -> np.ndarray:
    """gl-matrix ``vec3.rotateY`` used by the orbit drag (``lib/camera.js:51``)."""
    p = np.asarray(p, np.float32) - origin
    c, s = np.cos(rad), np.sin(rad)
    out = np.array([s * p[2] + c * p[0], p[1], c * p[2] - s * p[0]], np.float32)
    return out + origin


@dataclasses.dataclass
class Camera:
    eye: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    center: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32))
    zoom_speed: float = 0.1       # lib/camera.js:15
    move_speed: float = 0.01      # lib/camera.js:16
    keypress_move_speed: float = 0.1  # lib/camera.js:17
    moving: bool = False          # MOVING/keyPress flags the renderer polls to
    key_press: bool = False       # reset accumulation (renderer.js:174-180)

    def __post_init__(self):
        self.direction = np.zeros(3, np.float32)
        self.view_matrix = np.eye(4, dtype=np.float32)
        self.set_camera(self.eye, self.center, self.up)

    def set_camera(self, eye=None, center=None, up=None):
        """``lib/camera.js:25-33``."""
        if eye is not None:
            self.eye = np.asarray(eye, np.float32).copy()
        if center is not None:
            self.center = np.asarray(center, np.float32).copy()
        if up is not None:
            self.up = np.asarray(up, np.float32).copy()
        self.direction = self.eye - self.center
        self.view_matrix = target_to(self.eye, self.center, self.up)

    def zoom(self, delta: float):
        """Wheel zoom along the stored view direction (``lib/camera.js:35-42``)."""
        self.eye = self.eye + self.direction * self.zoom_speed * np.sign(delta)
        self.key_press = True
        self.set_camera()

    def orbit(self, old_xy, new_xy):
        """Mouse-drag orbit about world Y (``lib/camera.js:44-53``)."""
        dx = (new_xy[0] - old_xy[0]) * np.pi / 180.0 * self.move_speed
        self.eye = rotate_y(self.eye, np.zeros(3, np.float32), dx)
        self.moving = True
        self.set_camera()

    def _pan(self, delta):
        self.eye = self.eye + delta
        self.center = self.center + delta
        self.key_press = True
        self.set_camera()

    # Arrow-key pans — lib/camera.js:55-74 (note the reference's inverted
    # left/right & up/down signs are preserved).
    def move_left(self):
        self._pan(np.array([self.keypress_move_speed, 0, 0], np.float32))

    def move_right(self):
        self._pan(np.array([-self.keypress_move_speed, 0, 0], np.float32))

    def move_up(self):
        self._pan(np.array([0, -self.keypress_move_speed, 0], np.float32))

    def move_down(self):
        self._pan(np.array([0, self.keypress_move_speed, 0], np.float32))

    def consume_motion_flags(self) -> bool:
        """True if accumulation must reset (camera moved since last frame) —
        the renderer-side poll at ``renderer.js:174-180``."""
        moved = self.moving or self.key_press
        self.key_press = False
        return moved
