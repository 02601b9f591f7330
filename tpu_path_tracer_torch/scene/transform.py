"""Host-side object transforms (NumPy).

Parity with ``lib/transform.js``: compose translate/scale/rotate matrices with
``update(*mats)`` where later arguments multiply on the LEFT
(``lib/transform.js:42-58`` — gl-matrix ``mat4.mul(M, t_i, M)`` in a loop), and
store both the model matrix and its inverse (``:38-40``).
"""

from __future__ import annotations

import numpy as np


def translation(x: float, y: float, z: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = (x, y, z)
    return m


def scaling(sx: float, sy: float, sz: float) -> np.ndarray:
    return np.diag([sx, sy, sz, 1.0]).astype(np.float64)


def rotation(theta: float, axis) -> np.ndarray:
    """Axis-angle rotation (gl-matrix ``mat4.fromRotation`` semantics)."""
    axis = np.asarray(axis, np.float64)
    n = axis / np.linalg.norm(axis)
    x, y, z = n
    c, s = np.cos(theta), np.sin(theta)
    t = 1.0 - c
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = [
        [t * x * x + c, t * x * y - s * z, t * x * z + s * y],
        [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
        [t * x * z - s * y, t * y * z + s * x, t * z * z + c],
    ]
    return m


class Transform:
    """Composable model transform with cached inverse."""

    def __init__(self):
        self.model = np.eye(4, dtype=np.float64)
        self.inv_model = np.eye(4, dtype=np.float64)

    def update(self, *mats: np.ndarray) -> "Transform":
        """Compose; ``update(A, B, C)`` yields ``C @ B @ A`` applied to points
        (A first), matching ``lib/transform.js:42-58``."""
        if mats:
            m = np.eye(4, dtype=np.float64)
            for mat in mats:
                m = mat @ m
            self.model = m
            self.inv_model = np.linalg.inv(m)
        return self

    # Convenience pass-throughs mirroring the reference's fluent style
    # (lib/transform.js:60-87):
    @staticmethod
    def translate(x, y, z):
        return translation(x, y, z)

    @staticmethod
    def scale(sx, sy, sz):
        return scaling(sx, sy, sz)

    @staticmethod
    def rotate(theta, axis):
        return rotation(theta, axis)

    def apply_points(self, pts: np.ndarray) -> np.ndarray:
        """Transform ``[..., 3]`` points by the model matrix."""
        return pts @ self.model[:3, :3].T + self.model[:3, 3]

    def apply_normals(self, nrm: np.ndarray) -> np.ndarray:
        """Transform ``[..., 3]`` normals by transpose(inverse(model)) — the
        WGSL normal path at ``shaders/common.wgsl:231``."""
        return nrm @ self.inv_model[:3, :3]
