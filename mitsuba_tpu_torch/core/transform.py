"""4x4 homogeneous transforms, host-side numpy (a copy of the subset of
``mitsuba_tpu/core/transform.py`` that scene building uses). A Transform
keeps its inverse alongside, like the reference."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Transform(NamedTuple):
    m: np.ndarray      # (4, 4)
    inv: np.ndarray    # (4, 4)

    @staticmethod
    def identity() -> "Transform":
        return Transform(np.eye(4), np.eye(4))

    @staticmethod
    def translate(v) -> "Transform":
        v = np.asarray(v, dtype=np.float64)
        m = np.eye(4)
        m[:3, 3] = v
        i = np.eye(4)
        i[:3, 3] = -v
        return Transform(m, i)

    @staticmethod
    def scale(v) -> "Transform":
        v = np.broadcast_to(np.asarray(v, dtype=np.float64), (3,))
        m = np.diag(np.concatenate([v, [1.0]]))
        i = np.diag(np.concatenate([1.0 / v, [1.0]]))
        return Transform(m, i)

    @staticmethod
    def rotate(axis, angle_deg) -> "Transform":
        axis = np.asarray(axis, dtype=np.float64)
        axis = axis / np.linalg.norm(axis)
        a = np.deg2rad(angle_deg)
        c, s = np.cos(a), np.sin(a)
        x, y, z = axis
        K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
        R3 = np.eye(3) * c + s * K + (1 - c) * np.outer(axis, axis)
        m = np.eye(4)
        m[:3, :3] = R3
        i = np.eye(4)
        i[:3, :3] = R3.T
        return Transform(m, i)

    @staticmethod
    def look_at(origin, target, up) -> "Transform":
        """Camera-to-world (reference Transform::lookAt): the camera looks
        down +Z, +X right, +Y up."""
        origin = np.asarray(origin, dtype=np.float64)
        target = np.asarray(target, dtype=np.float64)
        up = np.asarray(up, dtype=np.float64)
        d = target - origin
        d = d / np.linalg.norm(d)
        left = np.cross(up / np.linalg.norm(up), d)
        left = left / np.linalg.norm(left)
        new_up = np.cross(d, left)
        m = np.eye(4)
        m[:3, 0] = left
        m[:3, 1] = new_up
        m[:3, 2] = d
        m[:3, 3] = origin
        return Transform(m, np.linalg.inv(m))

    def __mul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.inv @ self.inv)

    def inverse(self) -> "Transform":
        return Transform(self.inv, self.m)

    def apply_point(self, p):
        p = np.asarray(p, dtype=np.float64)
        r = self.m[:3, :3] @ p.T + self.m[:3, 3:4] if p.ndim == 2 else self.m[:3, :3] @ p + self.m[:3, 3]
        w = self.m[3, :3] @ p.T + self.m[3, 3] if p.ndim == 2 else self.m[3, :3] @ p + self.m[3, 3]
        return (r / w).T if p.ndim == 2 else r / w

    def apply_normal(self, n):
        n = np.asarray(n, dtype=np.float64)
        A = self.inv[:3, :3].T
        return (A @ n.T).T if n.ndim == 2 else A @ n
